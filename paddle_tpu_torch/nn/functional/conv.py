"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``).

The JAX package computes convolutions with ``lax.conv_general_dilated``
outside any Pallas kernel, so the port calls cuDNN through
``torch.nn.functional.conv{1,2,3}d`` and ``conv_transpose{1,2,3}d``, as
a plain large matrix product stays ``torch.matmul``. The public
functions keep the JAX package's layouts: ``NCHW``-family by default,
``NHWC``/``NLC``/``NDHWC`` moved to channels-first around the call; the
weight is Paddle's ``[out, in/groups, k...]`` (a transpose's
``[in, out/groups, k...]``, torch's own layouts). Every padding form of
``_padding`` is taken: an int, per-dim ints, (lo, hi) pairs (flat or
nested, with or without the batch and channel pairs), ``"SAME"`` and
``"VALID"``. XLA's ``"SAME"`` pads ``total // 2`` low and the rest high,
unevenly at stride > 1 where torch's ``padding="same"`` refuses any
stride but 1, so the pairs are computed here and uneven ones go through
``F.pad``. A transpose is the full transposed convolution cropped by
the pairs (``output_padding`` widens the high side with rows that hold
the bias alone), which is what the JAX package's dilated convolution
gives; its ``"SAME"`` raises there (``lax.conv_general_dilated`` takes
no string padding with an input dilation), and here too. Every
function passes its operands through the AMP hook under the JAX op name
(``conv2d``, ``conv2d_transpose``, ..., all on the O1 white list).

The port sets no cuDNN flag: an f32 convolution on the card follows
torch's ``torch.backends.cudnn.allow_tf32``, TF32 by default (about
three decimal digits). ``chip_smoke.py`` turns TF32 off, so its f32
checks compare full f32 convolutions.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(x) for x in v) * n
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _padding(padding, n):
    """Paddle padding: int, list[int] (per-dim), list of pairs, or
    SAME/VALID."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        if len(padding) == n + 2:
            padding = padding[2:]
        return [tuple(p) for p in padding]
    raise ValueError(f"bad padding {padding!r}")


def _same_pairs(sizes, kernel, stride, dilation):
    """XLA's SAME: output ``ceil(in / stride)``, the total padding split
    ``total // 2`` low, the rest high."""
    pairs = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        eff = (k - 1) * d + 1
        out = -(-size // s)
        total = max((out - 1) * s + eff - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _pad_spatial(x, pairs):
    """``x`` padded (or, for negative entries, cropped) by ``pairs`` over
    its trailing spatial dims; ``F.pad`` takes them last dim first."""
    flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
    return F.pad(x, flat) if any(flat) else x


def _conv_nd(n, x, weight, bias, stride, padding, dilation, groups,
             data_format):
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = _amp_cast(f"conv{n}d", x, weight, bias)
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)
    if channel_last:
        x = x.movedim(-1, 1)
    pad = _padding(padding, n)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = _same_pairs(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x, sym = _pad_spatial(x, pad), 0
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    out = conv(x, weight, bias, stride, sym, dilation, groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    df)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def _conv_transpose_nd(n, x, weight, bias, stride, padding, output_padding,
                       dilation, groups, data_format):
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = _amp_cast(f"conv{n}d_transpose", x, weight, bias)
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)
    out_pad = _tuplize(output_padding, n)
    if channel_last:
        x = x.movedim(-1, 1)
    pad = _padding(padding, n)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        # the JAX package hands "SAME" to lax.conv_general_dilated with an
        # lhs dilation, which refuses string padding
        raise ValueError(
            "String padding is not implemented for transposed convolution "
            "using this op. Please either exactly specify the required "
            "padding or use conv_transpose.")
    conv_t = (F.conv_transpose1d, F.conv_transpose2d,
              F.conv_transpose3d)[n - 1]
    full = conv_t(x, weight, None, stride, 0, 0, groups, dilation)
    # rows past the full output that output_padding adds see no input:
    # they hold the bias alone, as the dilated convolution gives them
    out = _pad_spatial(full, [(-lo, op - hi)
                              for (lo, hi), op in zip(pad, out_pad)])
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * n)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose_nd(1, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, df)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(2, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(3, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format)
