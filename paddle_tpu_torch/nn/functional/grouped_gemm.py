"""Ragged grouped GEMM and the no-drop MoE FFN.

Counterpart of ``paddle_tpu/nn/functional/grouped_gemm.py`` (the
serving half: forward only, no autograd). An MoE expert bank is E
independent GEMMs over CONTIGUOUS row segments of a token matrix sorted
by expert id: expert ``e`` owns rows ``offsets[e]:offsets[e+1]``.

- ``grouped_work_map`` — the work-unit schedule ``(gids, tids, lo,
  hi)`` of the per-expert ``offsets`` (a device tensor), built with
  torch ops on their device, integer for integer the JAX package's map.
  A unit is one (expert, row-tile) visit; ``nwu = t_pad // bm + 2 * E +
  1`` depends on shapes only, so the kernel's grid does too. The kernel
  decodes each block's unit from ``offsets`` itself, by the same
  integers (``kernel_work_map`` reads them back for the check), so no
  map is built between launches and nothing syncs with the host.
- ``grouped_gemm`` — ``y[r] = act(x[r] @ w[e(r)] + bias[e(r)])`` in
  fp32, cast to ``out_dtype``; rows past ``offsets[E]`` are exact 0.
  On a CUDA tensor it launches the kernel of ``csrc/grouped_gemm.cu``
  at the card's row tile ``DEFAULT_BLOCK_ROWS``; on a CPU tensor it
  runs the plain version ``grouped_gemm_plain`` (a per-expert loop of
  segment products in fp32).
- ``moe_route`` (fp32 softmax router, top-k with the lower index first
  on ties, as the JAX package's top-k), ``_sort_by_expert`` (stable sort by
  expert) and ``moe_ffn_nodrop`` (route, sort, FFN1 with the activation
  fused, FFN2 in fp32, gate-weighted combine: no capacity, no dropped
  token).

``FLAGS_moe_grouped_backend`` takes the JAX package's values: on a
CUDA tensor ``auto``, ``pallas`` and ``interpret`` launch the kernel and
``xla`` (the plain walk) raises; on a CPU tensor every value runs the
plain version. The expert-parallel ``moe_ffn_ep`` comes with the
tensor/expert-parallel serving slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _kernels

__all__ = ["grouped_work_map", "grouped_gemm", "grouped_gemm_plain",
           "moe_route", "moe_ffn_nodrop", "moe_ffn_ep",
           "DEFAULT_BLOCK_ROWS"]

#: the kernel's row tile on the card: one unit covers up to 64 rows of
#: one expert (the JAX package tiles by 128 for the TPU's matrix unit;
#: the map's integers are the JAX map's at either height)
DEFAULT_BLOCK_ROWS = 64

_ACTIVATIONS = {None: 0, "gelu": 1, "relu": 2}
_BACKENDS = ("auto", "pallas", "interpret", "xla")


def _cdiv(a, b):
    return -(-a // b)


def _apply_activation(acc, activation):
    if activation == "gelu":
        # the JAX package's gelu is the tanh approximation
        return F.gelu(acc, approximate="tanh")
    if activation == "relu":
        return F.relu(acc)
    return acc


def resolve_backend(what: str, backend: str, device) -> str:
    """``kernel`` or ``plain`` for one call: CPU tensors always take
    the plain version; on the card every JAX value but ``xla`` names
    the kernel, and ``xla`` (the plain walk) raises — nothing sends a
    CUDA tensor to a plain version."""
    if backend not in _BACKENDS:
        raise ValueError(f"{what} backend={backend!r}: expected 'auto', "
                         "'pallas', 'interpret' or 'xla'")
    if torch.device(device).type != "cuda":
        return "plain"
    if backend == "xla":
        raise ValueError(
            f"{what} backend='xla' names the plain walk, which runs on "
            "the CPU only; on the card the kernel of csrc/grouped_gemm.cu "
            "serves every shape")
    return "kernel"


# ---------------------------------------------------------------------
# Work-unit map (device offsets -> static-shape schedule)
# ---------------------------------------------------------------------

def grouped_work_map(offsets, t_pad: int, bm: int):
    """The JAX package's work-unit schedule, built on ``offsets``'
    device. ``offsets``: int32 ``[E+1]`` cumulative row offsets
    (``offsets[E]`` = real rows); ``t_pad`` a multiple of ``bm``.

    Returns int32 ``(gids, tids, lo, hi)``, each ``[t_pad//bm + 2E +
    1]``: unit ``u`` computes row tile ``tids[u]`` against expert
    ``gids[u]``, masked to rows ``[lo[u], hi[u])``. ``tids`` is
    non-decreasing, every tile has at least one unit (the first unit of
    a tile is the one that zero-fills its rows past ``offsets[E]`` in
    the kernel), and trailing inactive units alias the last tile with
    an empty mask."""
    dev = offsets.device
    off = offsets.to(torch.int64)
    E = off.shape[0] - 1
    nm = t_pad // bm
    nwu = nm + 2 * E + 1
    ext = torch.cat([off, torch.tensor([t_pad], dtype=torch.int64,
                                       device=dev)])          # [E+2]
    t_lo = torch.div(ext[:-1], bm, rounding_mode="floor")     # [E+1]
    t_hi = _cdiv(ext[1:], bm)
    counts = (t_hi - t_lo).clamp_min(0)
    counts = torch.where(torch.arange(E + 1, device=dev) < E,
                         counts.clamp_min(1), counts)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)])             # [E+2]
    u = torch.arange(nwu, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(starts[1:].contiguous(), u, right=True)
    segc = seg.clamp_max(E)
    tid = t_lo[segc] + (u - starts[segc])
    active = u < starts[E + 1]
    tid = torch.where(active, tid, torch.full_like(tid, nm - 1)) \
        .clamp(0, nm - 1)
    gid = segc.clamp_max(E - 1)
    is_real = active & (seg < E)
    zero = torch.zeros_like(u)
    lo = torch.where(is_real, ext[segc], zero)
    hi = torch.where(is_real, ext[segc + 1], zero)
    return tuple(t.to(torch.int32) for t in (gid, tid, lo, hi))


def kernel_work_map(offsets, T: int):
    """The units the CUDA kernels decode from ``offsets`` (on the card)
    for T rows, as int32 ``(gids, tids, lo, hi)`` — for holding them to
    ``grouped_work_map`` at ``DEFAULT_BLOCK_ROWS``."""
    what = "kernel_work_map"
    bm = DEFAULT_BLOCK_ROWS
    E, nm = offsets.shape[0] - 1, _cdiv(T, bm)
    offsets = offsets.to(torch.int32).contiguous()
    fn = _kernels.lib("grouped_gemm").ptt_grouped_work_map
    outs = [torch.empty(nm + 2 * E + 1, dtype=torch.int32,
                        device=offsets.device) for _ in range(4)]
    _kernels.check(fn(offsets.data_ptr(), E, nm, bm,
                      *(t.data_ptr() for t in outs),
                      _kernels.stream_ptr(offsets.device)), what)
    return tuple(outs)


# ---------------------------------------------------------------------
# The grouped GEMM: plain version and kernel
# ---------------------------------------------------------------------

def grouped_gemm_plain(x, w, offsets, *, bias=None, activation=None,
                       out_dtype=None):
    """Plain version: for each expert, its segment's product with W cast
    to x's dtype, accumulated in fp32 (bf16 products are exact in fp32),
    ``+ bias`` (fp32), the activation, then ``out_dtype``; rows past
    ``offsets[E]`` stay 0. Reads ``offsets`` on the host."""
    T, K = x.shape
    E, _, N = w.shape
    out = torch.zeros((T, N), dtype=torch.float32, device=x.device)
    off = [int(v) for v in offsets.tolist()]
    for e in range(E):
        lo, hi = off[e], min(off[e + 1], T)
        if hi <= lo:
            continue
        acc = x[lo:hi].float() @ w[e].to(x.dtype).float()
        if bias is not None:
            acc = acc + bias.reshape(E, N)[e].float()
        out[lo:hi] = _apply_activation(acc, activation)
    return out.to(out_dtype or x.dtype)


#: launches of the CUDA kernel, counted once each has been issued
#: without an error (plain CPU calls do not count)
launches = 0


def _grouped_gemm_cuda(x, w, offsets, bias, activation, out_dtype):
    what = "grouped_gemm"
    T, K = x.shape
    E, _, N = w.shape
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: x is {x.dtype} and w {w.dtype}; the "
                        "kernel takes w in x's dtype")
    vec = 16 // x.element_size()
    if K % vec or N % vec:
        raise ValueError(f"{what}: K ({K}) and N ({N}) must be multiples "
                         f"of {vec} for {x.dtype}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one "
                         "of None, 'gelu', 'relu'")
    if bias is not None:
        if bias.numel() != E * N:
            raise ValueError(f"{what}: bias must be [E, N] = [{E}, {N}]")
        bias = bias.reshape(E, N)
    offsets = offsets.to(torch.int32)
    for t in (x, w, offsets, bias):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: x and w must be 16-byte aligned")
    fn = _kernels.lib("grouped_gemm").ptt_grouped_gemm
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    if T == 0:
        return out
    _kernels.check(fn(
        x.data_ptr(), w.data_ptr(), _kernels.ptr(bias),
        0 if bias is None else _kernels.dtype_code(bias, what),
        offsets.data_ptr(), out.data_ptr(), _kernels.dtype_code(out, what),
        _kernels.dtype_code(x, what), T, K, N, E, DEFAULT_BLOCK_ROWS,
        _ACTIVATIONS[activation], _kernels.stream_ptr(x.device)), what)
    global launches
    launches += 1
    return out


def grouped_gemm(x, w, offsets, *, bias=None, activation=None,
                 out_dtype=None, backend="auto"):
    """Ragged grouped GEMM: ``y[r] = act(x[r] @ w[e(r)] + bias[e(r)])``.

    ``x`` ``[T, K]`` rows SORTED by expert; ``w`` ``[E, K, N]`` (in x's
    dtype on the card); ``offsets`` int32 ``[E+1]`` on x's device
    (``offsets[E] <= T``; rows past it come out 0); ``bias`` ``[E, N]``
    (or ``[E, 1, N]``). The product accumulates in fp32; bias and the
    activation apply to the fp32 sum; the result is cast to
    ``out_dtype`` (default x's dtype). ``backend``: see the module
    docstring. Forward only (serving)."""
    E, _, N = w.shape
    if offsets.shape[0] != E + 1:
        raise ValueError(
            f"grouped_gemm: offsets has {offsets.shape[0]} entries for "
            f"{E} experts (need E+1)")
    out_dtype = out_dtype or x.dtype
    if resolve_backend("grouped_gemm", backend, x.device) == "plain":
        return grouped_gemm_plain(x, w, offsets, bias=bias,
                                  activation=activation,
                                  out_dtype=out_dtype)
    return _grouped_gemm_cuda(x, w, offsets, bias, activation, out_dtype)


# ---------------------------------------------------------------------
# No-drop MoE FFN (route -> sort -> ragged FFN1/act/FFN2 -> combine)
# ---------------------------------------------------------------------

def _bincount(idx, n: int):
    """Counts of the values 0..n-1 in ``idx`` (int64, all in range),
    without ``torch.bincount``, which reads the maximum back to the host
    on the card."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, idx, torch.ones_like(idx))


def moe_route(x, gate_w, top_k: int):
    """fp32 gate routing: logits, softmax, top-k and the top-k
    renormalization all in fp32 whatever the compute dtype. Top-k takes
    the first ``top_k`` of a STABLE descending sort, so ties pick the
    lower expert index first, as the JAX package's top-k.

    Returns ``(probs [T, E] f32, topk_val [T, k] f32 normalized,
    topk_idx [T, k] int32)``."""
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_val, topk_idx = vals[:, :top_k], idx[:, :top_k]
    topk_val = topk_val / topk_val.sum(-1, keepdim=True)
    return probs, topk_val, topk_idx.to(torch.int32)


def _sort_by_expert(topk_idx, E: int):
    """``(order [T*k], offsets [E+1], counts [E])`` int32 for the
    expert-sorted row layout; ``order`` is a STABLE argsort, so
    same-expert tokens keep their batch order."""
    flat_e = topk_idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True).to(torch.int32)
    counts = _bincount(flat_e, E).to(torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=flat_e.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    return order, offsets, counts


def moe_ffn_nodrop(x, gate_w, w1, b1, w2, b2, *, top_k: int,
                   activation="gelu", backend="auto"):
    """No-drop MoE FFN over flat tokens ``x [T, d]``: fp32 router,
    tokens stable-sorted by expert, two ragged grouped GEMMs (FFN1 with
    the activation fused, in x's dtype; FFN2 in fp32), then unsort and
    the gate-weighted sum of the k contributions.

    ``w1 [E, d, dff]``, ``b1 [E, dff]``, ``w2 [E, dff, d]``, ``b2 [E,
    d]``. Returns ``(y [T, d] in x's dtype, probs f32, topk_idx,
    counts [E] int32)``."""
    T, d = x.shape
    E = w1.shape[0]
    probs, topk_val, topk_idx = moe_route(x, gate_w, top_k)
    order, offsets, counts = _sort_by_expert(topk_idx, E)
    # row r of the sorted matrix is token order[r] // k
    x_rows = x[torch.div(order.long(), top_k, rounding_mode="floor")]
    h = grouped_gemm(x_rows, w1, offsets, bias=b1, activation=activation,
                     out_dtype=x.dtype, backend=backend)
    y_rows = grouped_gemm(h, w2, offsets, bias=b2, out_dtype=torch.float32,
                          backend=backend)
    y_flat = torch.zeros((T * top_k, d), dtype=torch.float32,
                         device=x.device)
    y_flat[order.long()] = y_rows
    y = (y_flat.reshape(T, top_k, d) * topk_val[..., None]).sum(1)
    return y.to(x.dtype), probs, topk_idx, counts


def moe_ffn_ep(*args, **kwargs):
    """The expert-parallel MoE FFN comes with the tensor/expert-parallel
    serving slice of the port."""
    raise NotImplementedError(
        "moe_ffn_ep (the expert-parallel all_to_all exchange) comes with "
        "the tensor/expert-parallel serving slice of the port")
