"""Ragged grouped GEMM and the no-drop MoE FFN, forward and backward.

Counterpart of ``paddle_tpu/nn/functional/grouped_gemm.py``. An MoE
expert bank is E independent GEMMs over CONTIGUOUS row segments of a
token matrix sorted by expert id: expert ``e`` owns rows
``offsets[e]:offsets[e+1]``.

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
  On a CUDA tensor it launches kernel B14 of ``csrc/grouped_gemm.cu``
  at the card's row tile ``DEFAULT_BLOCK_ROWS``; on a CPU tensor it
  runs the plain version ``grouped_gemm_plain`` (a per-expert loop of
  segment products in fp32): the op ``ptt::grouped_gemm``. It is
  differentiable in x, w and bias (a gradient registered on the op, the
  JAX package's custom VJP step by step): with an activation, one more
  B14 call recomputes ``z = x @ w[e] + b`` in f32 and ``dz = act'(z) *
  g`` in f32 (tanh-GELU or ReLU); ``dx`` is B14 in its backward mode
  (``ptt::grouped_gemm_dx``), which reads the bank ``[E, K, N]`` as
  ``w[e]^T`` in place (no transposed copy); ``dw`` is kernel B15; ``db``
  is the segment sum of ``dz`` over the live rows, torch ops on the
  device with nothing read back.
- the weight gradient ``dw[e] = x[seg_e]^T @ dz[seg_e]`` ``[E, K, N]``
  (``ptt::grouped_dw``): kernel B15 on a CUDA tensor (in bf16 a
  persistent walk of 128 x 256 tiles of ``[K, N]``, heaviest expert
  first, which the kernel works out from ``offsets`` itself;
  ``dw_tile_order`` renders it in PyTorch and ``kernel_dw_tile_order``
  reads it back), ``grouped_dw_plain`` (a per-expert loop in f32; rows past
  ``offsets[E]`` add nothing, an expert with no rows gets exact zeros)
  on a CPU tensor.
- ``moe_route`` (fp32 softmax router, top-k with the lower index first
  on ties, as the JAX package's top-k), ``_sort_by_expert`` (stable sort by
  expert) and ``moe_ffn_nodrop`` (route, sort, FFN1 with the activation
  fused, FFN2 in fp32, gate-weighted combine: no capacity, no dropped
  token), differentiable in x, the gate (through the top-k values) and
  the banks.

Precision of the backward's f32 operand. The JAX kernel multiplies
``dot_general(dz, w.astype(dz.dtype), precision=DEFAULT)``: on a TPU the
DEFAULT precision feeds the matrix unit bf16 operands, so a bf16 model's
f32 ``dz`` is rounded to bf16 there, while the JAX CPU walk multiplies
in exact f32. The port's kernels do what the TPU does: ``dz`` is rounded
to x's dtype once (bf16 for a bf16 bank) and both dx and dw run on the
tensor cores with f32 accumulators; an f32 bank keeps f32 and runs
exact f32 products on the CUDA cores. The plain versions keep the JAX
walk's f32 ``dz``; the card's check holds the kernels to them within
what rounding ``dz`` to bf16 moves the plain version (the witness).

``FLAGS_moe_grouped_backend`` takes the JAX package's values: on a
CUDA tensor ``auto``, ``pallas`` and ``interpret`` launch the kernels,
forward and backward, and ``xla`` (the plain walk) raises; on a CPU
tensor every value runs the plain versions. The expert-parallel
``moe_ffn_ep`` comes with the tensor/expert-parallel serving slice of
the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _kernels

__all__ = ["grouped_work_map", "grouped_gemm", "grouped_gemm_plain",
           "card_shape_error",
           "grouped_dw_plain", "dw_tile_order",
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
            "the CPU only; on the card the kernels of csrc/grouped_gemm.cu "
            "serve every shape")
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


def grouped_dw_plain(x, dz, offsets, E: int):
    """Plain version of B15: for each expert, its segment's ``x^T @ dz``
    in fp32, ``[E, K, N]``; rows past ``offsets[E]`` add nothing and an
    expert with no rows gets exact zeros. Reads ``offsets`` on the
    host."""
    T, K = x.shape
    N = dz.shape[1]
    dw = torch.zeros((E, K, N), dtype=torch.float32, device=x.device)
    off = [min(int(v), T) for v in offsets.tolist()]
    for e in range(E):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            dw[e] = x[lo:hi].float().T @ dz[lo:hi].float()
    return dw


#: B15's bf16 tile on the card: 128 rows of K by 256 columns of N; the
#: kernel ranks at most DW_MAX_EXPERTS experts in shared memory
DW_TILE_K, DW_TILE_N = 128, 256
DW_MAX_EXPERTS = 1024


def dw_tile_order(offsets, K: int, N: int):
    """The tiles B15's bf16 kernel walks, in order, as the kernel works
    them out from ``offsets`` on the device: int32 ``[E * cdiv(K, 128) *
    cdiv(N, 256)]`` ids ``e * per + m * nt + n`` (``nt`` column tiles,
    ``per`` tiles an expert), every tile of every expert once, empty
    experts included, the experts by row count, heaviest first (ties by
    index) and an expert's tiles consecutive."""
    offsets = offsets.to(torch.int32)
    per = _cdiv(K, DW_TILE_K) * _cdiv(N, DW_TILE_N)
    order = torch.argsort(offsets[1:] - offsets[:-1], descending=True,
                          stable=True)
    tiles = torch.arange(per, dtype=torch.int64, device=offsets.device)
    return (order[:, None] * per + tiles).reshape(-1).to(torch.int32)


def kernel_dw_tile_order(offsets, K: int, N: int):
    """The walk B15's bf16 kernel computes from ``offsets`` (on the card),
    written out by the same device code, for holding it to
    ``dw_tile_order``."""
    what = "kernel_dw_tile_order"
    E = offsets.shape[0] - 1
    offsets = offsets.to(torch.int32).contiguous()
    tiles = torch.empty(E * _cdiv(K, DW_TILE_K) * _cdiv(N, DW_TILE_N),
                        dtype=torch.int32, device=offsets.device)
    _kernels.check(_kernels.lib("grouped_gemm").ptt_grouped_dw_tiles(
        offsets.data_ptr(), E, K, N, tiles.data_ptr(),
        _kernels.stream_ptr(offsets.device)), what)
    return tiles


#: launches of B14 (forward, recompute and backward mode) and of B15,
#: counted once each has been issued without an error (plain CPU calls
#: do not count)
launches = 0
dw_launches = 0


def _check_on_card(what, x, tensors):
    for t in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def card_shape_error(K: int, N: int, dtype) -> str | None:
    """Why B14 on the card refuses a ``[T, K] x [E, K, N]`` product (or
    its backward mode's ``[T, N] x [E, K, N]^T``) in ``dtype``, or None.
    Its rows move in 16-byte pieces: the bf16 kernel's TMA tensor maps
    need 16-byte row strides of x and of the bank, the f32 kernel's
    cp.async 16-byte chunks, so K and N are multiples of 8 (bf16) or 4
    (f32)."""
    vec = 16 // dtype.itemsize
    if K % vec or N % vec:
        return (f"K ({K}) and N ({N}) must be multiples of {vec} for "
                f"{dtype}")
    return None


def _grouped_gemm_cuda(x, w, offsets, bias, activation, out_dtype,
                       trans_w=False):
    """B14. ``trans_w``: the backward mode, ``x [T, N] @ w[e]^T`` over the
    ``[E, K, N]`` bank read in place, out ``[T, K]``."""
    what = "grouped_gemm backward (dx)" if trans_w else "grouped_gemm"
    T = x.shape[0]
    E, Kw, Nw = w.shape
    K, N = (Nw, Kw) if trans_w else (Kw, Nw)
    if x.shape[1] != K:
        raise ValueError(f"{what}: x is {tuple(x.shape)}, the bank "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: x is {x.dtype} and w {w.dtype}; the "
                        "kernel takes w in x's dtype")
    refused = card_shape_error(K, N, x.dtype)
    if refused:
        raise ValueError(f"{what}: {refused}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one "
                         "of None, 'gelu', 'relu'")
    if bias is not None:
        if bias.numel() != E * N:
            raise ValueError(f"{what}: bias must be [E, N] = [{E}, {N}]")
        bias = bias.reshape(E, N)
    offsets = offsets.to(torch.int32)
    _check_on_card(what, x, (x, w, offsets, bias))
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        # a layer view w1[l] of an [L, E, K, N] stack is aligned whenever
        # K and N pass the gate above
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
        _ACTIVATIONS[activation], int(trans_w),
        _kernels.stream_ptr(x.device)), what)
    global launches
    launches += 1
    return out


def _grouped_dw_cuda(x, dz, offsets, E: int, out_dtype):
    """B15: ``[E, K, N]`` in ``out_dtype`` from x and dz in one dtype."""
    what = "grouped_dw"
    T, K = x.shape
    N = dz.shape[1]
    if dz.shape[0] != T or dz.dtype != x.dtype:
        raise TypeError(f"{what}: dz must be [{T}, N] in x's dtype "
                        f"({x.dtype}), not {tuple(dz.shape)} {dz.dtype}")
    vec = 16 // x.element_size()
    if K % vec or N % vec:
        raise ValueError(f"{what}: K ({K}) and N ({N}) must be multiples "
                         f"of {vec} for {x.dtype}")
    if x.dtype == torch.bfloat16 and E > DW_MAX_EXPERTS:
        raise ValueError(f"{what}: the bf16 kernel takes at most "
                         f"{DW_MAX_EXPERTS} experts, not {E}")
    offsets = offsets.to(torch.int32)
    if offsets.shape[0] != E + 1:
        raise ValueError(f"{what}: offsets needs E+1 = {E + 1} entries")
    _check_on_card(what, x, (x, dz, offsets))
    if x.data_ptr() % 16 or dz.data_ptr() % 16:
        raise ValueError(f"{what}: x and dz must be 16-byte aligned")
    fn = _kernels.lib("grouped_gemm").ptt_grouped_dw
    if T == 0:
        return torch.zeros((E, K, N), dtype=out_dtype, device=x.device)
    out = torch.empty((E, K, N), dtype=out_dtype, device=x.device)
    _kernels.check(fn(x.data_ptr(), dz.data_ptr(), offsets.data_ptr(),
                      out.data_ptr(), _kernels.dtype_code(out, what),
                      _kernels.dtype_code(x, what), T, K, N, E,
                      _kernels.stream_ptr(x.device)), what)
    global dw_launches
    dw_launches += 1
    return out


# ---------------------------------------------------------------------
# Routes of one call: the kernels, or their plain versions
# ---------------------------------------------------------------------

def _gemm(x, w, offsets, bias, activation, out_dtype, route):
    if route == "plain":
        return grouped_gemm_plain(x, w, offsets, bias=bias,
                                  activation=activation, out_dtype=out_dtype)
    return _grouped_gemm_cuda(x, w, offsets, bias, activation, out_dtype)


def _dx(dz, w, offsets, out_dtype, route):
    """``dz @ w[e]^T`` per segment, ``out_dtype``."""
    if route == "plain":
        return grouped_gemm_plain(dz, w.transpose(1, 2), offsets,
                                  out_dtype=out_dtype)
    return _grouped_gemm_cuda(dz, w, offsets, None, None, out_dtype,
                              trans_w=True)


def _dw(x, dz, offsets, E, out_dtype, route):
    if route == "plain":
        return grouped_dw_plain(x, dz, offsets, E).to(out_dtype)
    return _grouped_dw_cuda(x, dz, offsets, E, out_dtype)


def _act_grad(z, g, activation):
    """``act'(z) * g`` in f32: the JAX package's vjp of its
    activation (tanh-GELU; ReLU with gradient 0 at 0)."""
    if activation == "gelu":
        return torch.ops.aten.gelu_backward(g, z, approximate="tanh")
    if activation == "relu":
        return g * (z > 0)
    return g


def _segment_sum(dz, offsets, E: int):
    """``db[e] = sum of dz over e's rows`` f32 ``[E, N]``, rows past
    ``offsets[E]`` left out; torch ops on dz's device, nothing read
    back."""
    T, N = dz.shape
    rows = torch.arange(T, device=dz.device)
    off = offsets.to(torch.int64)
    row_e = torch.searchsorted(off[1:].contiguous(), rows, right=True) \
        .clamp_max(E - 1)
    live = (rows < off[-1]).unsqueeze(1)
    return torch.zeros((E, N), dtype=torch.float32, device=dz.device) \
        .index_add_(0, row_e, torch.where(live, dz, 0.0))


# the ops of B14 (forward and backward mode) and B15: each takes its
# route (``resolve_backend``: the kernel on a CUDA tensor, the plain
# version on a CPU tensor) and the route function (``_gemm``, ``_dx``,
# ``_dw``) by name at the call

def _gemm_impl(x, w, offsets, bias, activation, out_dtype):
    return _gemm(x, w, offsets, bias, activation, out_dtype,
                 resolve_backend("grouped_gemm", "auto", x.device))


def _dx_impl(dz, w, offsets, out_dtype):
    return _dx(dz, w, offsets, out_dtype,
               resolve_backend("grouped_gemm", "auto", w.device))


def _dw_impl(x, dz, offsets, E, out_dtype):
    return _dw(x, dz, offsets, E, out_dtype,
               resolve_backend("grouped_dw", "auto", x.device))


_gemm_op = _kernels.define_op(
    "grouped_gemm",
    "(Tensor x, Tensor w, Tensor offsets, Tensor? bias, str? activation, "
    "ScalarType out_dtype) -> Tensor", _gemm_impl,
    lambda x, w, offsets, bias, activation, out_dtype:
    x.new_empty((x.shape[0], w.shape[2]), dtype=out_dtype))
_dx_op = _kernels.define_op(
    "grouped_gemm_dx",
    "(Tensor dz, Tensor w, Tensor offsets, ScalarType out_dtype) -> Tensor",
    _dx_impl, lambda dz, w, offsets, out_dtype:
    dz.new_empty((dz.shape[0], w.shape[1]), dtype=out_dtype))
_dw_op = _kernels.define_op(
    "grouped_dw",
    "(Tensor x, Tensor dz, Tensor offsets, int E, ScalarType out_dtype) -> "
    "Tensor", _dw_impl, lambda x, dz, offsets, E, out_dtype:
    x.new_empty((E, x.shape[1], dz.shape[1]), dtype=out_dtype))


def _gemm_setup(ctx, inputs, output):
    x, w, offsets, bias, activation, _ = inputs
    ctx.save_for_backward(x, w, bias, offsets)
    ctx.activation = activation


def _gemm_backward(ctx, g):
    """The JAX package's ``_grouped_core`` VJP step by step: the
    pre-activation recomputed (B14), ``dz = act'(z) * g`` in f32, then dx
    (B14's backward mode), dw (B15) and db (segment sum), each only where
    an input needs it. The kernels take the f32 dz rounded to x's dtype
    (the TPU's DEFAULT precision); the plain versions the f32 dz
    itself."""
    x, w, bias, offsets = ctx.saved_tensors
    E = w.shape[0]
    dz = g.float()
    if ctx.activation:
        z = _kernels.call(_gemm_op, x, w, offsets, bias, None,
                          torch.float32)
        dz = _act_grad(z, dz, ctx.activation)
        del z
    route = resolve_backend("grouped_gemm", "auto", x.device)
    dz_op = dz.to(x.dtype).contiguous() if route == "kernel" else dz
    need_x, need_w, _, need_b = ctx.needs_input_grad[:4]
    dx = _kernels.call(_dx_op, dz_op, w, offsets, x.dtype) if need_x \
        else None
    dw = _kernels.call(_dw_op, x, dz_op, offsets, E, w.dtype) if need_w \
        else None
    db = None
    if need_b:
        db = _segment_sum(dz, offsets, E).to(bias.dtype).reshape(bias.shape)
    return dx, dw, None, db, None, None


_kernels.register_autograd(_gemm_op, _gemm_backward, _gemm_setup)


def grouped_gemm(x, w, offsets, *, bias=None, activation=None,
                 out_dtype=None, backend="auto"):
    """Ragged grouped GEMM: ``y[r] = act(x[r] @ w[e(r)] + bias[e(r)])``.

    ``x`` ``[T, K]`` rows SORTED by expert; ``w`` ``[E, K, N]`` (in x's
    dtype on the card); ``offsets`` int32 ``[E+1]`` on x's device
    (``offsets[E] <= T``; rows past it come out 0); ``bias`` ``[E, N]``
    (or ``[E, 1, N]``). The product accumulates in fp32; bias and the
    activation apply to the fp32 sum; the result is cast to
    ``out_dtype`` (default x's dtype). The op ``ptt::grouped_gemm``,
    differentiable in x, w and bias through its registered gradient.
    ``backend``: see the module docstring."""
    E, _, N = w.shape
    if offsets.shape[0] != E + 1:
        raise ValueError(
            f"grouped_gemm: offsets has {offsets.shape[0]} entries for "
            f"{E} experts (need E+1)")
    resolve_backend("grouped_gemm", backend, x.device)
    return _kernels.call(_gemm_op, x, w, offsets, bias, activation,
                         out_dtype or x.dtype)


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
