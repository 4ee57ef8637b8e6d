"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``): ``linear``, ``embedding``, the
dropouts, ``one_hot``, ``pad``, resizing, pixel and channel shuffles,
``unfold``/``fold``, ``cosine_similarity``, ``bilinear``,
``label_smooth``, ``affine_grid`` and ``grid_sample``, each the JAX
package's formula in torch ops. ``linear`` passes its operands through
the AMP hook under the JAX package's op name. The dropouts draw their
masks from ``generator`` (default: the device's), so a captured CUDA
graph draws fresh masks on every replay from a generator registered with
it. ``interpolate``'s ``"bilinear"``/``"linear"``/``"trilinear"`` and
``"bicubic"`` without ``align_corners`` resize as JAX's ``image.resize``
does (half-pixel centres, Keys' cubic with a = -0.5, antialiased when
shrinking), which torch's ``F.interpolate`` does not.
``class_center_sample`` raises: it samples class centres across the
model-parallel group (A10).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast
from ...core.generator import default_generator

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold", "fold",
    "affine_grid", "grid_sample", "cosine_similarity", "bilinear",
    "label_smooth", "class_center_sample",
]


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``; ``weight`` is ``[in, out]`` (Paddle's
    layout)."""
    x, weight, bias = _amp_cast("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; rows at
    ``padding_idx`` come out zero."""
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Paddle's dropout: keep with probability ``1 - p`` (one mask over
    the ``axis`` dims when given, broadcast over the rest), scaled by
    ``1 / (1 - p)`` in ``upscale_in_train`` mode; ``downscale_in_infer``
    scales by ``1 - p`` at inference instead. ``generator`` draws the
    mask (default: the device's)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    gen = generator if generator is not None else default_generator(x.device)
    keep = (torch.rand(shape, generator=gen, device=x.device)
            < 1.0 - p).to(x.dtype)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels dropped: one mask over (N, C)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU-preserving dropout: dropped entries take ``-alpha * scale``,
    then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    gen = generator if generator is not None else default_generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def one_hot(x, num_classes, name=None):
    return F.one_hot(x.long(), num_classes).float()


def _pad_pairs(nd, pad, data_format):
    """(lo, hi) per dim, first dim first: the full form (2 * ndim
    entries, dim by dim) or the partial form over the trailing spatial
    dims, given last dim first (Paddle's ``[left, right, top,
    bottom]``)."""
    if torch.is_tensor(pad):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    sp = [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]
    if data_format in ("NCHW", "NCL", "NCDHW"):
        return [(0, 0), (0, 0)] + sp[::-1]
    return [(0, 0)] + sp[::-1] + [(0, 0)]


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``mode``: ``constant`` (``value``), ``reflect``, ``replicate`` or
    ``circular``."""
    pairs = _pad_pairs(x.ndim, pad, data_format)
    while pairs and pairs[0] == (0, 0):
        pairs = pairs[1:]
    flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, value=value)
    lead = x.ndim - len(pairs)
    if mode in ("reflect", "replicate", "circular") and lead < 1:
        raise ValueError(f"pad: mode {mode!r} pads at most ndim - 1 dims")
    return F.pad(x, flat, mode=mode)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _keys_cubic(t):
    t = t.abs()
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _triangle(t):
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _resize_weights(in_s, out_s, kernel, device):
    """JAX's ``image.resize`` weights ``[in, out]`` of one axis:
    half-pixel sample points, the kernel widened by ``in / out`` when
    shrinking (antialiasing), each column normalised, columns whose
    sample lies outside the input zeroed."""
    inv = in_s / out_s
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_s, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    pos = torch.arange(in_s, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - pos[:, None]).abs() / kscale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_s - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of an ``NC...`` tensor to ``size`` (or
    ``floor(in * scale_factor)``): ``nearest`` (source ``floor(i * in /
    out)``), ``area`` (adaptive average), ``linear``/``bilinear``/
    ``trilinear`` and ``bicubic`` (as JAX's ``image.resize``, or, linear
    with ``align_corners``, corner-aligned interpolation)."""
    if data_format[-1] == "C" and len(data_format) > 2:
        raise NotImplementedError("interpolate supports NC... layouts")
    n_sp = x.ndim - 2
    in_sp = tuple(x.shape[2:])
    if size is not None:
        if torch.is_tensor(size):
            size = size.tolist()
        out_sp = tuple(int(s) for s in (size if isinstance(size, (list, tuple))
                                        else [size] * n_sp))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * n_sp
        out_sp = tuple(int(np.floor(in_sp[i] * float(sf[i])))
                       for i in range(n_sp))
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic", "area": "area"}[mode]
    if method == "area":
        from .pooling import _adaptive_pool

        return _adaptive_pool(n_sp, "avg", x, out_sp, "NC")
    r = x
    for i in range(n_sp):
        ax, in_s, out_s = 2 + i, in_sp[i], out_sp[i]
        if method == "nearest":
            idx = torch.floor(torch.arange(out_s, device=x.device) * in_s
                              / out_s).long()
            r = r.index_select(ax, idx)
        elif align_corners and method == "linear":
            if out_s == 1 or in_s == 1:
                pos = torch.zeros(out_s, device=x.device)
            else:
                pos = torch.arange(out_s, device=x.device) * (in_s - 1) \
                    / (out_s - 1)
            lo = torch.floor(pos).long()
            hi = torch.clamp(lo + 1, 0, in_s - 1)
            shape = [1] * r.ndim
            shape[ax] = out_s
            w = (pos - lo).to(x.dtype).reshape(shape)
            r = r.index_select(ax, lo) * (1 - w) + r.index_select(ax, hi) * w
        elif in_s != out_s:
            kernel = _triangle if method == "linear" else _keys_cubic
            w = _resize_weights(in_s, out_s, kernel, x.device)
            r = torch.tensordot(r.movedim(ax, -1).float(), w, dims=1) \
                .movedim(-1, ax).to(x.dtype)
    return r


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    n, c, h, w = x.shape
    oc = c // (r * r)
    return x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3) \
        .reshape(n, oc, h * r, w * r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    n, c, h, w = x.shape
    return x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4) \
        .reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def _pair(v):
    from .conv import _tuplize

    return _tuplize(v, 2)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding blocks as columns, ``[N, C * kh * kw, L]``, channel
    major."""
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations),
                    _pair(paddings), _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The inverse layout of ``unfold``, overlapping blocks summed."""
    return F.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                  _pair(dilations), _pair(paddings), _pair(strides))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(axis)
    na = (x1 * x1).sum(axis).sqrt()
    nb = (x2 * x2).sum(axis).sqrt()
    return dot / torch.clamp(na * nb, min=eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias)``, ``W`` ``[out, in1,
    in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError(
        "class_center_sample samples class centres across the model-"
        "parallel group: it comes with the port's tensor-parallel slice "
        "(ROADMAP A10)")


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """A 2-D affine sampling grid: theta ``[N, 2, 3]``, ``out_shape``
    ``[N, C, H, W]`` -> ``[N, H, W, 2]`` in [-1, 1] coordinates."""
    h, w = int(out_shape[2]), int(out_shape[3])
    dev, dt = theta.device, theta.dtype
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev, dtype=dt)
        ys = torch.linspace(-1.0, 1.0, h, device=dev, dtype=dt)
    else:
        xs = (torch.arange(w, device=dev, dtype=dt) * 2 + 1) / w - 1
        ys = (torch.arange(h, device=dev, dtype=dt) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``NCHW`` ``x`` at ``grid`` ``[N, H, W, 2]`` (normalized x,
    y): ``bilinear`` or ``nearest`` (round half to even); ``zeros``,
    ``border`` or ``reflection`` padding; the JAX package's coordinate
    rules."""
    n, _, h, w = x.shape

    def unnormalize(c, size):
        if align_corners:
            return (c + 1) / 2 * (size - 1)
        return ((c + 1) * size - 1) / 2

    def pad_index(idx, size):
        if padding_mode == "border":
            return torch.clamp(idx, 0, size - 1), None
        if padding_mode == "reflection":
            if align_corners:
                span = 2 * (size - 1)
                m = torch.remainder(idx.abs(), span) if size > 1 else idx * 0
                return torch.where(m > size - 1, span - m, m), None
            span = 2 * size
            m = torch.remainder((idx + 0.5).abs(), span)
            m = torch.where(m > size, span - m, m) - 0.5
            return torch.clamp(m, 0, size - 1), None
        valid = (idx >= 0) & (idx <= size - 1)
        return torch.clamp(idx, 0, size - 1), valid

    def gather(iy, ix, valid):
        b = torch.arange(n, device=x.device)[:, None, None]
        v = x.permute(0, 2, 3, 1)[b, iy.long(), ix.long()]   # [N, Hg, Wg, C]
        if valid is not None:
            v = torch.where(valid[..., None], v, torch.zeros_like(v))
        return v

    gx = unnormalize(grid[..., 0], w)
    gy = unnormalize(grid[..., 1], h)
    if mode == "nearest":
        ix, vx = pad_index(torch.round(gx), w)
        iy, vy = pad_index(torch.round(gy), h)
        return gather(iy, ix, None if vx is None else vx & vy) \
            .movedim(-1, 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    out = 0.0
    for (dy, wyy), (dx, wxx) in itertools.product(
            ((0, 1 - wy), (1, wy)), ((0, 1 - wx), (1, wx))):
        ix, vx = pad_index(x0 + dx, w)
        iy, vy = pad_index(y0 + dy, h)
        out = out + gather(iy, ix, None if vx is None else vx & vy) * \
            (wxx * wyy)[..., None]
    return out.movedim(-1, 1)
