"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): the ``layer_norm`` the training
path calls, which passes its operands through the AMP hook under the
JAX package's op name."""
from __future__ import annotations

import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalize over the trailing ``normalized_shape`` axes, then scale
    and shift; computed in f32 (a bf16 ``x`` meets the f32 weights that
    AMP O2 leaves on norm layers) and returned in ``x``'s dtype, as the
    JAX package casts its result back to the input's dtype."""
    x, weight, bias = _amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(s) for s in normalized_shape)
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), shape, w, b, epsilon).to(x.dtype)
