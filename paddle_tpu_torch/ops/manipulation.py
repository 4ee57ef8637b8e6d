"""Shape and layout ops (counterpart of ``paddle_tpu/ops/manipulation.py``).

Paddle's meaning, held to the JAX package's functions where it is not
torch's: ``transpose(x, perm)`` permutes every axis; ``split(x, n)``
with an int cuts ``n`` equal sections (a list gives the sizes, one of
them -1 for the rest); ``gather(x, index, axis)`` is ``index_select``;
``scatter(overwrite=False)`` zeroes the indexed rows, then adds every
update (repeated indices add up); ``expand`` keeps a dimension where the
shape says -1; ``flatten(start_axis, stop_axis)``; ``nonzero(as_tuple=
True)`` returns one ``[n, 1]`` tensor per axis; ``unique`` also returns
each value's first index when asked; ``argsort(descending=True)`` is the
stable ascending order reversed. ``nonzero``, ``masked_select`` and
``unique`` have data-dependent shapes: on the card torch reads the
count back, as the JAX package reads its arrays on the host.
"""
from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np
import torch

from ..core.dtype import to_torch_dtype
from ..core.tensor import to_tensor
from .registry import register_op

__all__: list = []


def _export(name, fn, methods=(), differentiable=True, amp=True, **kw):
    op = register_op(name, fn, methods=methods,
                     differentiable=differentiable, tags=("manipulation",),
                     amp=amp, **kw)
    globals()[name] = op
    __all__.append(name)
    return op


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def _ints(seq):
    if torch.is_tensor(seq):
        seq = seq.tolist()
    if isinstance(seq, (int, np.integer)):
        return int(seq)
    return [int(s.item() if torch.is_tensor(s) else s) for s in seq]


def _int(v):
    return int(v.item() if torch.is_tensor(v) else v)


# ------------------------------------------------------------- reshape
def reshape(x, shape, name=None):
    return torch.reshape(_t(x), tuple(_ints(shape)))


def reshape_(x, shape, name=None):
    """``x`` reshaped in place: its storage rebound (torch refuses that
    for a tensor that requires a gradient, where the JAX package
    rebinds it)."""
    return x.set_(x.contiguous().view(tuple(_ints(shape))))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return _t(x).view(to_torch_dtype(shape_or_dtype))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _t(x)
    if x.ndim == 0:
        return x.reshape(-1)
    return torch.flatten(x, int(start_axis), int(stop_axis))


def squeeze(x, axis=None, name=None):
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    ax = _ints(axis)
    ax = [ax] if isinstance(ax, int) else ax
    return torch.squeeze(x, tuple(a % x.ndim for a in ax
                                  if x.shape[a % x.ndim] == 1))


def unsqueeze(x, axis, name=None):
    x = _t(x)
    ax = _ints(axis)
    ax = [ax] if isinstance(ax, int) else ax
    n = x.ndim + len(ax)
    for a in sorted(a % n for a in ax):
        x = x.unsqueeze(a)
    return x


for _n in ("reshape", "view", "flatten", "squeeze", "unsqueeze"):
    _export(_n, globals()[_n], methods=[_n])
_export("reshape_", reshape_, methods=["reshape_"], inplace_of="reshape")


def transpose(x, perm=None, name=None):
    x = _t(x)
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    return x.permute(_ints(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_t(x), _ints(source), _ints(destination))


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_t(x), int(axis0), int(axis1))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_t(x), int(k), list(axes))


def flip(x, axis, name=None):
    ax = _ints(axis)
    return torch.flip(_t(x), ax if isinstance(ax, list) else [ax])


def roll(x, shifts, axis=None, name=None):
    return torch.roll(_t(x), _ints(shifts),
                      None if axis is None else _ints(axis))


for _n in ("transpose", "moveaxis", "swapaxes", "rot90", "flip", "roll"):
    _export(_n, globals()[_n], methods=[_n])


# ------------------------------------------------------- concat / split
def concat(x: Sequence, axis=0, name=None):
    return torch.cat([_t(t) for t in x], _int(axis))


def stack(x: Sequence, axis=0, name=None):
    return torch.stack([_t(t) for t in x], int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """An int is a count of equal sections (the axis must divide by
    it); a list gives the sizes, one of them -1 for the rest."""
    x = _t(x)
    ax = _int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {ax} (size {dim}) is not divisible by "
                f"num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _ints(num_or_sections)
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - sum(s for s in sections if s >= 0)
    return list(torch.split(x, sections, ax))


def chunk(x, chunks, axis=0, name=None):
    # a smaller trailing chunk on a dimension that does not divide
    x = _t(x)
    ax = int(axis) % x.ndim
    dim, n = x.shape[ax], int(chunks)
    if dim % n == 0:
        return split(x, n, ax)
    per = -(-dim // n)
    sections = [per] * (dim // per) + ([dim - per * (dim // per)]
                                       if dim % per else [])
    return split(x, sections, ax)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(_t(x), int(axis)))


def unbind(input, axis=0):
    return unstack(input, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), tuple(_ints(repeat_times)))


def expand(x, shape, name=None):
    """``broadcast_to`` where a -1 (or 0) keeps the input's dimension."""
    x = _t(x)
    target = _ints(shape)
    cur = list(x.shape)
    full = [cur[len(cur) - (len(target) - i)]
            if s in (-1, 0) and len(target) - i <= len(cur) else s
            for i, s in enumerate(target)]
    return x.expand(full)


def expand_as(x, y, name=None):
    return _t(x).expand(tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(_t(x), tuple(_ints(shape)))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


for _n in ("concat", "stack", "split", "chunk", "unstack", "unbind", "tile",
           "expand", "expand_as", "broadcast_to", "broadcast_tensors"):
    _export(_n, globals()[_n],
            methods=[_n] if _n in ("split", "chunk", "tile", "expand",
                                   "expand_as", "broadcast_to", "unbind")
            else ())


# ------------------------------------------------------- gather/scatter
def gather(x, index, axis=0, name=None):
    """``index_select`` along ``axis``; an ``[n, 1]`` index counts as
    ``[n]``, and a multi-dimensional index makes its shape there."""
    x, index = _t(x), _t(index)
    ax = _int(axis) % x.ndim
    if index.ndim == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    out = torch.index_select(x, ax, index.reshape(-1))
    return out.reshape(x.shape[:ax] + index.shape + x.shape[ax + 1:])


def gather_nd(x, index, name=None):
    index = _t(index)
    return _t(x)[tuple(index.unbind(-1))]


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(_t(arr), _t(indices), int(axis))


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    arr, idx = _t(arr), _t(indices)
    ax = int(axis) % arr.ndim
    v = torch.broadcast_to(torch.as_tensor(values, device=arr.device),
                           idx.shape).to(arr.dtype)
    if reduce == "assign":
        return torch.scatter(arr, ax, idx, v)
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    return torch.scatter_reduce(arr, ax, idx, v, _REDUCE[reduce],
                                include_self=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates``; with ``overwrite=
    False`` those rows are zeroed first and every update added, so
    repeated indices add up."""
    x, idx = _t(x), _t(index).reshape(-1)
    u = _t(updates).to(x.dtype)
    if overwrite:
        return x.index_copy(0, idx, u)
    return x.index_fill(0, idx, 0).index_add(0, idx, u)


def scatter_nd_add(x, index, updates, name=None):
    x, index = _t(x), _t(index)
    return x.index_put(tuple(index.unbind(-1)), _t(updates).to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = _t(updates)
    zeros = torch.zeros(tuple(_ints(shape)), dtype=u.dtype, device=u.device)
    return scatter_nd_add(zeros, index, u)


def index_select(x, index, axis=0, name=None):
    return torch.index_select(_t(x), int(axis), _t(index).reshape(-1))


def index_sample(x, index):
    return torch.take_along_dim(_t(x), _t(index), 1)


def index_add(x, index, axis, value, name=None):
    x = _t(x)
    return torch.index_add(x, int(axis), _t(index).reshape(-1),
                           _t(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = _t(x)
    return x.index_put(tuple(_t(i) for i in indices), _t(value).to(x.dtype),
                       accumulate=bool(accumulate))


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(_t(x), repeats,
                                   None if axis is None else int(axis))


for _n in ("gather", "gather_nd", "take_along_axis", "put_along_axis",
           "scatter", "scatter_nd_add", "scatter_nd", "index_select",
           "index_sample", "index_add", "index_put", "repeat_interleave"):
    _export(_n, globals()[_n], methods=[_n])


# ---------------------------------------------------------------- pad
_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's ``pad``: ``2 * ndim`` entries pad every axis, first axis
    first; fewer pad the spatial axes of ``data_format``, last axis
    first (torch's order)."""
    x = _t(x)
    p = _ints(pad)
    nd = x.ndim
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(p) // 2
        width = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        for i, d in enumerate(reversed(range(first, first + n_spatial))):
            width[d] = (p[2 * i], p[2 * i + 1])
    if mode == "constant":
        flat = [w for pair in reversed(width) for w in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads the last 1-3 axes of a batched tensor in these modes:
    # move the padded axes last, under two leading axes
    padded = [d for d in range(nd) if width[d] != (0, 0)]
    if not padded:
        return x
    rest = [d for d in range(nd) if d not in padded]
    y = x.permute(rest + padded)
    lead = y.shape[:len(rest)]
    y = y.reshape((1, -1) + tuple(y.shape[len(rest):]))
    flat = [w for d in reversed(padded) for w in width[d]]
    y = torch.nn.functional.pad(y, flat, mode=_PAD_MODES[mode])
    y = y.reshape(tuple(lead) + tuple(y.shape[2:]))
    inv = np.argsort(rest + padded).tolist()
    return y.permute(inv)


_export("pad", pad)


# ------------------------------------------------------ sort / search
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    v, i = torch.topk(_t(x), _int(k), int(axis), largest=bool(largest),
                      sorted=True)
    return v, i


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(_t(x), dim=int(axis), descending=bool(descending),
                      stable=True).values


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """The stable ascending order, reversed for ``descending`` (so tied
    values come latest index first, as in the JAX package)."""
    i = torch.argsort(_t(x), dim=int(axis), stable=True)
    return torch.flip(i, [int(axis)]) if descending else i


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(_t(sorted_sequence), _t(values),
                              out_int32=bool(out_int32), right=bool(right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


for _n in ("topk", "sort", "argsort", "searchsorted", "bucketize"):
    _export(_n, globals()[_n], methods=[_n],
            differentiable=_n in ("topk", "sort"),
            amp=_n in ("topk", "sort"))


# -------------------------------------------- data-dependent shapes
def nonzero(x, as_tuple=False):
    x = _t(x)
    if as_tuple:
        return tuple(i[:, None] for i in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def masked_select(x, mask, name=None):
    x = _t(x)
    return x[torch.broadcast_to(_t(mask).bool(), x.shape)]


def masked_fill(x, mask, value, name=None):
    x = _t(x)
    v = value.item() if torch.is_tensor(value) else value
    return x.masked_fill(_t(mask).bool(), v)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique``: the sorted distinct values, and with the
    flags each one's first index, the inverse (the input's shape when
    ``axis`` is None) and the counts, int64."""
    x = _t(x)
    dim = None if axis is None else int(axis)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    if not (return_index or return_inverse or return_counts):
        return vals
    outs = [vals]
    if return_index:
        flat_inv = inv.reshape(-1)
        pos = torch.arange(flat_inv.numel(), device=x.device)
        first = torch.full((vals.shape[0 if dim is None else dim],),
                           flat_inv.numel(), dtype=torch.int64,
                           device=x.device)
        outs.append(first.scatter_reduce(0, flat_inv, pos, "amin"))
    if return_inverse:
        outs.append(inv.to(torch.int64))
    if return_counts:
        outs.append(counts.to(torch.int64))
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = _t(x)
    a = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        a, return_inverse=True, return_counts=True,
        dim=None if axis is None else int(axis))
    outs = [vals]
    if return_inverse:
        outs.append(inv.reshape(-1).to(torch.int64))
    if return_counts:
        outs.append(counts.to(torch.int64))
    return outs[0] if len(outs) == 1 else tuple(outs)


for _n in ("nonzero", "masked_select", "masked_fill", "unique",
           "unique_consecutive"):
    _export(_n, globals()[_n], methods=[_n],
            differentiable=_n == "masked_fill", amp=_n == "masked_fill")


# ------------------------------------------------------------- casting
def cast(x, dtype):
    return _t(x).to(to_torch_dtype(dtype))


def astype(x, dtype):
    return cast(x, dtype)


_export("cast", cast, methods=["cast", "astype"])


def slice(input, axes, starts, ends):
    """Slices ``[start, end)`` of ``axes``, clamped to each axis."""
    x = _t(input)
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(_ints(axes), _ints(starts), _ints(ends)):
        dim = x.shape[ax]
        s2 = builtins.max(s + dim, 0) if s < 0 else builtins.min(s, dim)
        e2 = builtins.max(e + dim, 0) if e < 0 else builtins.min(e, dim)
        idx[ax] = builtins.slice(s2, e2)
    return x[tuple(idx)]


_export("slice", slice)


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python's ``start:end:stride`` on each of ``axes`` (a negative
    stride walks backwards)."""
    x = _t(x)
    for ax, s, e, st in zip(_ints(axes), _ints(starts), _ints(ends),
                            _ints(strides)):
        r = range(*builtins.slice(s, e, st).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(r), dtype=torch.long,
                                                   device=x.device))
    return x


_export("strided_slice", strided_slice)


def crop(x, shape=None, offsets=None, name=None):
    """A ``shape`` window from ``offsets``, each offset clamped so that
    the window fits (as a dynamic slice clamps it)."""
    x = _t(x)
    shape = _ints(shape) if shape is not None else list(x.shape)
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    for ax, (o, n) in enumerate(zip(offsets, shape)):
        o = builtins.min(builtins.max(o, 0), x.shape[ax] - n)
        x = x.narrow(ax, o, n)
    return x


_export("crop", crop)


def as_complex(x, name=None):
    x = _t(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = _t(x)
    return torch.stack([x.real, x.imag], -1)


def real(x, name=None):
    return torch.real(_t(x))


def imag(x, name=None):
    x = _t(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


for _n in ("as_complex", "as_real", "real", "imag"):
    _export(_n, globals()[_n], methods=[_n])
