"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``). Each is the JAX package's
formula in torch ops; ``softmax`` and ``log_softmax``, on the O1 black
list, pass their operand through the AMP hook first. The in-place forms
(``relu_``, ``elu_``, ``softmax_``, ``tanh_``) write into ``x`` and
return it. ``rrelu`` in training draws its slopes from ``generator``
(default: the device's), uniform in ``[lower, upper)``; in eval (and in
the JAX package, which leaves the draws to the caller) the slope is
their mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast
from ...core.generator import default_generator

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "log_sigmoid", "silu",
    "swish", "mish", "softmax", "softmax_", "log_softmax", "softplus",
    "softshrink", "hardshrink", "tanhshrink", "hardsigmoid", "hardswish",
    "hardtanh", "leaky_relu", "elu", "elu_", "celu", "selu", "prelu",
    "rrelu", "glu", "tanh", "tanh_", "maxout", "softsign",
    "thresholded_relu", "swiglu",
]


def _dtype(dtype):
    from ..initializer import to_dtype

    return None if dtype is None else to_dtype(dtype)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return torch.relu_(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=False`` (the default, as in the JAX package)
    is the exact erf form, ``True`` the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def silu(x, name=None):
    return F.silu(x)


def swish(x, name=None):
    return F.silu(x)


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def tanh(x, name=None):
    return torch.tanh(x)


def tanh_(x, name=None):
    return torch.tanh_(x)


def softsign(x, name=None):
    return x / (1 + x.abs())


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp_cast("softmax", x)
    return torch.softmax(x, axis, dtype=_dtype(dtype))


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp_cast("log_softmax", x)
    return torch.log_softmax(x, axis, dtype=_dtype(dtype))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``log(1 + exp(beta x)) / beta``, linear where ``beta x`` passes
    ``threshold``."""
    return F.softplus(x, beta, threshold)


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


def elu_(x, alpha=1.0, name=None):
    return F.elu_(x, alpha)


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight * x``: one weight, or one per
    channel (axis 1 for ``NC...`` layouts, else the last)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.ndim
        ch = 1 if data_format.startswith("NC") and x.ndim > 1 else x.ndim - 1
        shape[ch] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None,
          generator=None):
    if training:
        gen = generator if generator is not None else \
            default_generator(x.device)
        slope = torch.rand(x.shape, generator=gen, device=x.device,
                           dtype=x.dtype) * (upper - lower) + lower
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def swiglu(x, y=None, name=None):
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def maxout(x, groups, axis=1, name=None):
    ax = axis if axis >= 0 else x.ndim + axis
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + \
        tuple(x.shape[ax + 1:])
    return x.reshape(shape).amax(ax + 1)
