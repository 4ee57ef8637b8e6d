"""The long tail of Paddle's ops (counterpart of
``paddle_tpu/ops/extras.py``): ``add_n``, ``bincount``, ``diagonal``,
``diag_embed``, ``kron``, ``complex``, ``clip_by_norm``, ``logit``,
``nanmedian``, ``mode``, ``renorm``, ``logcumsumexp``, ``nextafter``,
``polygamma``, ``i0e``, ``i1e``, ``gather_tree``, ``edit_distance``,
``squared_l2_norm``, ``shard_index``, ``temporal_shift``,
``fill_diagonal`` and ``truncated_normal``.

``edit_distance`` runs its Levenshtein recurrence on the tensors'
device, one vectorized row of the table per hypothesis token, where the
JAX package loops on the host; ``mode`` breaks a tie of counts toward
the smallest value and returns its last index, as the JAX package does.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.dtype import to_torch_dtype
from ..core.tensor import to_tensor
from .math import _flat_axes, _keep
from .random import _truncated_normal
from .registry import register_op

__all__ = [
    "add_n", "bincount", "diagonal", "diag_embed", "kron", "complex",
    "clip_by_norm", "logit", "nanmedian", "mode", "renorm",
    "logcumsumexp", "nextafter", "polygamma", "i0e", "i1e",
    "gather_tree", "edit_distance", "squared_l2_norm", "shard_index",
    "temporal_shift", "fill_diagonal", "truncated_normal",
]


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def add_n(inputs, name=None):
    ts = [_t(x) for x in (inputs if isinstance(inputs, (list, tuple))
                          else [inputs])]
    return sum(ts[1:], ts[0])


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    if weights is None:
        return torch.bincount(x, minlength=int(minlength))
    # an index_add, which is differentiable in the weights
    w = _t(weights)
    n = max(int(x.max()) + 1 if x.numel() else 0, int(minlength))
    return torch.zeros(n, dtype=w.dtype, device=w.device).index_add(
        0, x, w)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(_t(input), offset, dim1, dim2)


def kron(x, y, name=None):
    return torch.kron(_t(x), _t(y))


def complex(real, imag, name=None):
    return torch.complex(_t(real), _t(imag))


def clip_by_norm(x, max_norm, name=None):
    a = _t(x)
    n = a.square().sum().sqrt()
    return torch.where(n > max_norm, a * (max_norm / n), a)


def logit(x, eps=None, name=None):
    p = _t(x)
    if eps is not None:
        p = p.clamp(eps, 1 - eps)
    return torch.log(p) - torch.log1p(-p)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """The median of the values that are not NaN, the two middle values
    averaged."""
    x = _t(x)
    flat, ax = _flat_axes(x, axis)
    if ax is None:
        return _keep(torch.nanquantile(flat.reshape(-1), 0.5),
                     x, axis, keepdim)
    out = torch.nanquantile(flat, 0.5, ax, keepdim=bool(keepdim) and
                            isinstance(axis, int))
    return _keep(out, x, axis, keepdim)


def mode(x, axis=-1, keepdim=False, name=None):
    """``(values, indices)``: the most frequent value along ``axis`` (a
    tie of counts goes to the smallest value) and the index of its last
    occurrence."""
    a = _t(x)
    moved = a.movedim(axis, -1)
    n = moved.shape[-1]
    s = torch.sort(moved, -1).values
    step = torch.ones(s.shape[:-1] + (1,), dtype=torch.int64,
                      device=a.device)
    runs = torch.cumsum(torch.cat([step, (s[..., 1:] != s[..., :-1])
                                   .long()], -1), -1)
    counts = torch.zeros(s.shape[:-1] + (n + 1,), dtype=torch.int64,
                         device=a.device).scatter_add(
        -1, runs, torch.ones_like(runs))
    best = counts.argmax(-1)
    pos = (runs <= best[..., None]).sum(-1) - 1
    vals = torch.gather(s, -1, pos[..., None])[..., 0]
    match = moved == vals[..., None]
    idx = (n - 1) - torch.flip(match, [-1]).long().argmax(-1)
    if keepdim:
        vals = vals[..., None].movedim(-1, axis)
        idx = idx[..., None].movedim(-1, axis)
    return vals, idx


def renorm(x, p, axis, max_norm, name=None):
    a = _t(x)
    dims = tuple(d for d in range(a.ndim) if d != axis % a.ndim)
    norms = (a.abs() ** p).sum(dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    return a * factor


def logcumsumexp(x, axis=None, dtype=None, name=None):
    a = _t(x)
    if dtype is not None:
        a = a.to(to_torch_dtype(dtype))
    if axis is None:
        return torch.logcumsumexp(a.reshape(-1), 0)
    return torch.logcumsumexp(a, int(axis))


def nextafter(x, y, name=None):
    return torch.nextafter(_t(x), _t(y))


def polygamma(x, n, name=None):
    return torch.polygamma(int(n), _t(x))


def i0e(x, name=None):
    return torch.special.i0e(_t(x))


def i1e(x, name=None):
    return torch.special.i1e(_t(x))


def squared_l2_norm(x, name=None):
    return _t(x).square().sum().reshape(1)


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace: ``ids`` and ``parents`` ``[max_time,
    batch, beam]`` to the full sequences, walked from the last step."""
    ids, parents = _t(ids), _t(parents)
    beams = torch.arange(ids.shape[2], device=ids.device,
                         dtype=ids.dtype).expand(ids.shape[1:])
    outs = []
    for step in range(ids.shape[0] - 1, -1, -1):
        outs.append(torch.take_along_dim(ids[step], beams, 1))
        beams = torch.take_along_dim(parents[step], beams, 1)
    return torch.stack(outs[::-1], 0)


def _compact(seq, lengths, ignored):
    """Each row's first ``lengths`` tokens without the ``ignored`` ones,
    moved to the front (order kept), and the new lengths."""
    pos = torch.arange(seq.shape[1], device=seq.device)
    keep = pos[None] < lengths[:, None]
    if ignored:
        keep &= ~torch.isin(seq, torch.as_tensor(ignored, device=seq.device))
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.take_along_dim(seq, order, 1), keep.sum(1)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """The Levenshtein distance of each row's hypothesis to its label
    (divided by the label's length when ``normalized``), f32 ``[b, 1]``,
    and the row count, int64 ``[1]``."""
    hyp, ref = _t(input), _t(label)
    b, dev = hyp.shape[0], hyp.device
    hl = _t(input_length).reshape(-1).to(dev) if input_length is not None \
        else torch.full((b,), hyp.shape[1], device=dev)
    rl = _t(label_length).reshape(-1).to(dev) if label_length is not None \
        else torch.full((b,), ref.shape[1], device=dev)
    hyp, hl = _compact(hyp, hl, ignored_tokens)
    ref, rl = _compact(ref, rl, ignored_tokens)
    cols = torch.arange(ref.shape[1] + 1, device=dev, dtype=torch.float32)
    dp = cols.expand(b, -1).clone()
    for i in range(hyp.shape[1]):
        cost = (hyp[:, i:i + 1] != ref).float()
        # a[j] = min(prev[j] + 1, prev[j-1] + cost[j]); row[j] =
        # min over k <= j of a[k] + (j - k), a running minimum
        a = torch.cat([dp[:, :1] + 1, torch.minimum(dp[:, 1:] + 1,
                                                    dp[:, :-1] + cost)], 1)
        row = torch.cummin(a - cols, 1).values + cols
        dp = torch.where((i < hl)[:, None], row, dp)
    d = torch.gather(dp, 1, rl[:, None].long())
    if normalized:
        d = d / rl[:, None].clamp(min=1).float()
    return d, torch.tensor([b], dtype=torch.int64, device=dev)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range [0, {nshards})")
    ids = _t(input)
    shard_size = (index_num + nshards - 1) // nshards
    return torch.where(ids // shard_size == shard_id, ids % shard_size,
                       ignore_value)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's channel shift across the ``seg_num`` time segments of each
    clip: the first ``shift_ratio`` of the channels from the next
    segment, the second from the previous one."""
    a = _t(x)
    if data_format == "NHWC":
        a = a.permute(0, 3, 1, 2)
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                     v[:, :-1, fold:2 * fold]], 1)
    out = torch.cat([back, fwd, v[:, :, 2 * fold:]], 2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    if wrap:
        raise NotImplementedError(
            "fill_diagonal(wrap=True) (tall-matrix diagonal wrapping) "
            "is not supported")
    a = _t(x)
    rows, cols = a.shape[-2], a.shape[-1]
    n = max(min(rows + min(offset, 0), cols - max(offset, 0)), 0)
    idx = torch.arange(n, device=a.device)
    out = a.clone()
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = value
    return out


def truncated_normal(shape, mean=0.0, std=1.0, dtype=None, a=-2.0, b=2.0,
                     name=None):
    """A normal cut to ``[a, b]`` standard deviations, f32 unless
    ``dtype``, on the current place."""
    dt = torch.float32 if dtype is None else to_torch_dtype(dtype)
    return _truncated_normal(shape, mean, std, a, b, dt, resolve_device())


_METHODS = {"bincount", "diagonal", "kron", "logit", "nanmedian", "mode",
            "logcumsumexp"}
for _name in __all__:
    _diff = _name not in ("edit_distance", "truncated_normal")
    globals()[_name] = register_op(
        _name, globals()[_name],
        methods=(_name,) if _name in _METHODS else (),
        differentiable=_diff, tags=("extras",), amp=_diff)
