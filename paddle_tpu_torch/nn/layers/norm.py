"""``LayerNorm`` (counterpart of ``paddle_tpu/nn/layers/norm.py``)."""
from __future__ import annotations

from .. import initializer as I
from ..functional.norm import layer_norm
from ..layer_base import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """Layer normalization over the trailing ``normalized_shape`` axes
    with a weight (ones) and a bias (zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight,
                          self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
