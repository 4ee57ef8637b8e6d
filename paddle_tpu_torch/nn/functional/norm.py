"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``layer_norm``, ``batch_norm``,
``group_norm``, ``instance_norm``, ``rms_norm``,
``local_response_norm`` and ``normalize``. The ones on the O1 lists
(``layer_norm``, ``batch_norm``, ``group_norm``, ``instance_norm``,
``rms_norm``, ``normalize``: all black) pass their operands through the
AMP hook under the JAX package's op name.

``batch_norm`` in training normalizes by the batch statistics (biased
variance), with gradients through them, and updates the running
statistics in place as ``m * old + (1 - m) * batch`` with the unbiased
variance (torch's ``momentum`` is ``1 - m``): one fused
``torch.batch_norm`` call, so the update also runs inside a captured
CUDA graph. The JAX package takes the batch statistics of the input
before its AMP cast, rounded to the input's dtype; the port takes them
of the cast (f32) input, so under O1 a bf16 input's running statistics
differ from the JAX package's by that rounding. In eval, or with
``use_global_stats``, the running statistics normalize.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast

__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "normalize", "rms_norm"]


def _channel_axis(ndim, data_format):
    return ndim - 1 if data_format[-1] == "C" and len(data_format) > 2 \
        else 1


def _f32(t):
    return None if t is None else t.float()


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
    return F.layer_norm(x.float(), shape, _f32(weight), _f32(bias),
                        epsilon).to(x.dtype)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalization over every axis but the channel axis (``C``
    last in ``data_format`` for channel-last layouts), in f32, returned
    in ``x``'s dtype; see the module note for the running statistics."""
    use_batch = training and use_global_stats is not True
    if use_batch:
        x, weight, bias = _amp_cast("batch_norm", x, weight, bias)
    else:
        # the running statistics are operands of the op, as in the JAX
        # package's eval path (and so in its census)
        x, running_mean, running_var, weight, bias = _amp_cast(
            "batch_norm", x, running_mean, running_var, weight, bias)
    ch = _channel_axis(x.ndim, data_format)
    h = x.float()
    if ch != 1:
        h = h.movedim(ch, 1)
    out = torch.batch_norm(h, _f32(weight), _f32(bias), running_mean,
                           running_var, use_batch, 1.0 - momentum, epsilon,
                           torch.backends.cudnn.enabled)
    if ch != 1:
        out = out.movedim(1, ch)
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x / sqrt(mean(x^2) + eps)`` over the last axis (the mean of
    squares in f32, its inverse root in ``x``'s dtype), times
    ``weight``."""
    x, weight = _amp_cast("rms_norm", x, weight)
    ms = x.float().square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(ms + epsilon).to(x.dtype)
    return out if weight is None else out * weight


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    if data_format[-1] == "C" and len(data_format) > 2:
        raise NotImplementedError("group_norm supports NC... layouts")
    x, weight, bias = _amp_cast("group_norm", x, weight, bias)
    return F.group_norm(x.float(), int(num_groups), _f32(weight),
                        _f32(bias), epsilon).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalized over its spatial axes (the
    running statistics are not read or updated, as in the JAX
    package)."""
    x, weight, bias = _amp_cast("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.ndim))
    h = x.float()
    var, mean = torch.var_mean(h, axes, correction=0, keepdim=True)
    out = (h - mean) / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum / size) ** beta``, the sum of squares over
    ``size`` neighbouring channels (``size // 2`` before)."""
    half = size // 2
    sq = x.square()
    pad = [0, 0] * (x.ndim - 2) + [half, size - half - 1]
    padded = F.pad(sq, pad)
    c = x.shape[1]
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(1, i, c)
    return x / torch.pow(k + alpha * acc / size, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis``, the norm at least
    ``epsilon``."""
    (x,) = _amp_cast("normalize", x)
    if p == 2:
        norm = x.square().sum(axis, keepdim=True).sqrt()
    else:
        norm = x.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
    return x / torch.clamp(norm, min=epsilon)
