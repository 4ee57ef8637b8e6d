"""``Linear`` and ``Embedding`` (counterpart of
``paddle_tpu/nn/layers/common.py``)."""
from __future__ import annotations

import torch

from .. import initializer as I
from ..functional.common import embedding, linear
from ..layer_base import Layer

__all__ = ["Linear", "Embedding"]


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` (Paddle's
    layout, Xavier-normal) and ``bias`` ``[out]`` (zeros);
    ``bias_attr=False`` means no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, standard normal; the
    ``padding_idx`` row starts at zero and its lookups come out zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "sparse embedding gradients come with the sparse slice "
                "of the port")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"
