"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``).

The JAX package pools with ``lax.reduce_window`` outside any Pallas
kernel; the port takes torch's pooling functionals where they compute
the same windows and plain tensor code where they do not. The JAX
semantics kept:

- Windows: ``kernel``, ``stride`` (default the kernel), ``padding`` in
  every form of ``conv._padding`` but strings; ``ceil_mode`` widens the
  high side by ``stride - 1``. Max pooling pads with -inf, so a padded
  element never wins.
- ``exclusive`` (the inverse of torch's ``count_include_pad``): the
  average over the window's elements inside the input (with padding),
  else over the whole window.
- ``return_mask``: the flat index of the max *inside its window*
  (``_pool_indices``), first on ties, int64, not torch's flat index into
  the input; it raises for ``padding != 0``, as ``max_unpool*``, which
  reads those window indices, does.
- Adaptive pooling: bin ``i`` of ``out`` spans ``floor(i * in / out)``
  to ``ceil((i + 1) * in / out)``, each spatial axis in turn; it raises
  for channel-last layouts.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .conv import _padding, _tuplize

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def _window(n, kernel, stride, padding, ceil_mode):
    """Kernel, stride and the (lo, hi) pads of each spatial axis, the
    ``ceil_mode`` widening applied where the kernel is wider than 1."""
    kernel = _tuplize(kernel, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    pad = _padding(padding, n)
    if isinstance(pad, str):
        raise ValueError("string padding not supported for pooling yet")
    if ceil_mode:
        pad = [(lo, hi + s - 1) if k > 1 else (lo, hi)
               for (lo, hi), s, k in zip(pad, stride, kernel)]
    return kernel, stride, [tuple(p) for p in pad]


def _padded(x, pads, value):
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _pool_nd(n, kind, x, kernel_size, stride, padding, ceil_mode,
             exclusive, data_format):
    channel_last = data_format in _CHANNEL_LAST
    kernel, stride, pads = _window(n, kernel_size, stride, padding,
                                   ceil_mode)
    if channel_last:
        x = x.movedim(-1, 1)
    if kind == "max":
        low = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1]
        out = pool(_padded(x, pads, low), kernel, stride)
    else:
        pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[n - 1]
        # window sums over the zero-padded input, divided by the window
        # size or (exclusive) by the count of real elements in it
        out = pool(_padded(x, pads, 0.0), kernel, stride)
        if exclusive and any(p != (0, 0) for p in pads):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / pool(_padded(ones, pads, 0.0), kernel, stride)
    return out.movedim(1, -1) if channel_last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(1, "avg", x, kernel_size, stride, padding, ceil_mode,
                    exclusive, "NCW")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(2, "avg", x, kernel_size, stride, padding, ceil_mode,
                    exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(3, "avg", x, kernel_size, stride, padding, ceil_mode,
                    exclusive, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    out = _pool_nd(1, "max", x, kernel_size, stride, padding, ceil_mode,
                   True, "NCW")
    return (out, _pool_indices(1, x, out, kernel_size, stride, padding)) \
        if return_mask else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool_nd(2, "max", x, kernel_size, stride, padding, ceil_mode,
                   True, data_format)
    return (out, _pool_indices(2, x, out, kernel_size, stride, padding)) \
        if return_mask else out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool_nd(3, "max", x, kernel_size, stride, padding, ceil_mode,
                   True, data_format)
    return (out, _pool_indices(3, x, out, kernel_size, stride, padding)) \
        if return_mask else out


def _offset_slices(pos, out_sp, stride):
    """The strided slices of the input that window offset ``pos`` reads
    for every output position."""
    return (slice(None), slice(None)) + tuple(
        slice(p, p + (o - 1) * s + 1, s)
        for p, o, s in zip(pos, out_sp, stride))


def _pool_indices(n, x, out, kernel_size, stride, padding):
    """Flat within-window index of the max (the reference's
    ``return_mask``): each window offset contributes one strided slice,
    and the first offset holding the max wins. ``padding`` must be 0."""
    kernel = _tuplize(kernel_size, n)
    stride_t = _tuplize(stride if stride is not None else kernel_size, n)
    if _padding(padding, n) != [(0, 0)] * n:
        raise NotImplementedError("return_mask requires padding=0")
    out_sp = out.shape[2:]
    patches = [x[_offset_slices(pos, out_sp, stride_t)]
               for pos in itertools.product(*(range(k) for k in kernel))]
    return torch.stack(patches).argmax(0)


def _adaptive_pool(n, kind, x, output_size, data_format):
    if data_format in _CHANNEL_LAST:
        raise NotImplementedError(
            "adaptive pooling supports NCHW-family only")
    out_size = tuple(output_size) if isinstance(output_size, (list, tuple)) \
        else (int(output_size),) * n
    r = x
    for i in range(n):
        axis = 2 + i
        in_s, out_s = x.shape[axis], out_size[i]
        if out_s is None or in_s == out_s:
            continue
        pieces = []
        for b in range(out_s):
            lo, hi = (b * in_s) // out_s, -(-((b + 1) * in_s) // out_s)
            seg = r.narrow(axis, lo, hi - lo)
            pieces.append(seg.amax(axis, keepdim=True) if kind == "max"
                          else seg.mean(axis, keepdim=True))
        r = torch.cat(pieces, axis)
    return r


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(1, "avg", x, output_size, "NCW")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(2, "avg", x, output_size, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(3, "avg", x, output_size, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(1, "max", x, output_size, "NCW")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(2, "max", x, output_size, "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(3, "max", x, output_size, "NCDHW")


def _max_unpool(n, x, indices, kernel_size, stride, padding, output_size):
    """Inverse of max_pool with ``return_mask``: each pooled value goes
    back to its window's winning offset (the largest where windows
    overlap), every other element 0."""
    kernel = _tuplize(kernel_size, n)
    stride_t = _tuplize(stride if stride is not None else kernel_size, n)
    if _padding(padding, n) != [(0, 0)] * n:
        raise NotImplementedError("max_unpool requires padding=0")
    sp_in = x.shape[2:]
    if output_size is not None:
        sp_out = tuple(int(s) for s in tuple(output_size)[-n:])
    else:
        sp_out = tuple((sp_in[i] - 1) * stride_t[i] + kernel[i]
                       for i in range(n))
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    acc = torch.full(tuple(x.shape[:2]) + sp_out, float("-inf"),
                     dtype=x.dtype, device=x.device)
    for k, pos in enumerate(itertools.product(*(range(s) for s in kernel))):
        at = _offset_slices(pos, sp_in, stride_t)
        acc[at] = torch.maximum(acc[at], torch.where(indices == k, x, neg))
    return torch.where(torch.isneginf(acc), torch.zeros_like(acc), acc)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(1, x, indices, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(2, x, indices, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(3, x, indices, kernel_size, stride, padding,
                       output_size)
