"""Ragged batched-LoRA delta GEMM.

Counterpart of ``paddle_tpu/nn/functional/lora.py``. Batched multi-LoRA
serving is the MoE grouped-GEMM problem with another bank: the tenants
share one base weight stream, and each token's low-rank delta ``x @
A[s] @ B[s]`` is a ragged grouped product over tokens SORTED BY ADAPTER
SLOT.

- ``sort_by_adapter`` — a stable sort of the chunk's per-token slot ids
  in which BASE-MODEL tokens (slot < 0 or >= S) sort past every adapter,
  after ``offsets[S]``, where the delta is zero by construction.
- ``lora_delta`` — ONE launch per projection computes every adapter's
  delta for every token: the work units of ``grouped_gemm`` over the
  slots, and per unit two chained products, ``[rows, K] x [K, R]`` down
  to the rank in fp32 and ``[rows, R] x [R, N]`` back up, B in fp32. On
  a CUDA tensor it launches ``csrc/grouped_gemm.cu``'s LoRA entry (a
  cluster of 8 blocks a unit of rows, each summing one K slice, the
  slices added in rank order); on a CPU tensor it runs the plain version
  ``lora_delta_plain``.
- ``pad_rank`` pads ranks to the weight dtype's sublane tile (int8 32,
  bf16 16, f32 8), the bank's layout in both packages; padded rank
  columns are zero and contribute exact +0.0.

``FLAGS_lora_delta_backend`` resolves as ``FLAGS_moe_grouped_backend``:
``xla`` raises on the card, every value runs the plain version on the
CPU. Inference only.
"""
from __future__ import annotations

import torch

from ... import _kernels
from .grouped_gemm import (DEFAULT_BLOCK_ROWS, _bincount, _cdiv,
                           resolve_backend)

__all__ = ["lora_delta", "lora_delta_plain", "sort_by_adapter",
           "inverse_order", "pad_rank", "MAX_RANK"]

#: sublane tile by item size (the JAX package's table, kept here)
_SUBLANES = {1: 32, 2: 16, 4: 8}
#: the largest padded rank the kernel holds in shared memory
MAX_RANK = 32


def pad_rank(rank: int, dtype) -> int:
    """LoRA rank padded up to ``dtype``'s sublane tile (int8: 32, bf16:
    16, f32: 8)."""
    sub = _SUBLANES.get(torch.empty((), dtype=dtype).element_size(), 8)
    return _cdiv(int(rank), sub) * sub


def sort_by_adapter(slot_ids, n_slots: int):
    """``(order [T], offsets [S+1], counts [S])`` int32 for the
    adapter-sorted rows of one chunk. ``slot_ids`` int ``[T]``; ``< 0``
    or ``>= n_slots`` marks a base-model token, which sorts to the tail
    past ``offsets[S]``. ``order`` is a STABLE argsort."""
    flat = slot_ids.reshape(-1).long()
    key = torch.where((flat < 0) | (flat >= n_slots),
                      torch.full_like(flat, n_slots), flat)
    order = torch.argsort(key, stable=True).to(torch.int32)
    counts = _bincount(key, n_slots + 1)[:n_slots].to(torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=flat.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    return order, offsets, counts


def inverse_order(order):
    """Inverse permutation: ``inv[order[r]] = r``."""
    T = order.shape[0]
    inv = torch.empty(T, dtype=torch.int32, device=order.device)
    inv[order.long()] = torch.arange(T, dtype=torch.int32,
                                     device=order.device)
    return inv


def _check_bank(what, x, a, b, offsets):
    T, K = x.shape
    S, Ka, R = a.shape
    if offsets.shape[0] != S + 1:
        raise ValueError(
            f"{what}: offsets has {offsets.shape[0]} entries for {S} "
            "adapter slots (need S+1)")
    if Ka != K or b.shape[0] != S or b.shape[1] != R:
        raise ValueError(
            f"{what}: bank mismatch x={tuple(x.shape)} a={tuple(a.shape)} "
            f"b={tuple(b.shape)} (need a [S, K, R], b [S, R, N])")


def lora_delta_plain(x, a, b, offsets, *, out_dtype=None):
    """Plain version: per slot, ``h = x_seg @ A[s]`` (A cast to x's
    dtype, fp32 accumulation), then ``h @ B[s]`` in fp32; rows past
    ``offsets[S]`` stay 0. Reads ``offsets`` on the host."""
    what = "lora_delta"
    _check_bank(what, x, a, b, offsets)
    T = x.shape[0]
    S = a.shape[0]
    out = torch.zeros((T, b.shape[-1]), dtype=torch.float32,
                      device=x.device)
    off = [int(v) for v in offsets.tolist()]
    for s in range(S):
        lo, hi = off[s], min(off[s + 1], T)
        if hi <= lo:
            continue
        h = x[lo:hi].float() @ a[s].to(x.dtype).float()
        out[lo:hi] = h @ b[s].float()
    return out if out_dtype is None else out.to(out_dtype)


#: launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def _lora_delta_cuda(x, a, b, offsets, out_dtype):
    what = "lora_delta"
    T, K = x.shape
    S, _, R = a.shape
    N = b.shape[-1]
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: a is {a.dtype} and b {b.dtype}; the "
                        "kernel takes one bank dtype")
    if R > MAX_RANK:
        raise ValueError(f"{what}: rank {R} exceeds the kernel's "
                         f"{MAX_RANK}")
    offsets = offsets.to(torch.int32)
    for t in (x, a, b, offsets):
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    fn = _kernels.lib("grouped_gemm").ptt_lora_delta
    out = torch.empty((T, N), dtype=out_dtype or torch.float32,
                      device=x.device)
    if T == 0:
        return out

    def code(t):
        return _kernels.dtype_code(t, what)
    _kernels.check(fn(
        x.data_ptr(), code(x), a.data_ptr(), code(a), b.data_ptr(),
        code(b), offsets.data_ptr(), out.data_ptr(), code(out), T, K, N,
        S, R, DEFAULT_BLOCK_ROWS, _kernels.stream_ptr(x.device)), what)
    global launches
    launches += 1
    return out


def lora_delta(x, a, b, offsets, *, out_dtype=None, backend="auto"):
    """ONE ragged launch: ``delta[r] = x[r] @ a[s(r)] @ b[s(r)]`` for
    every adapter of the bank, where slot ``s`` owns the sorted rows
    ``offsets[s]:offsets[s+1]``.

    ``x`` ``[T, K]`` rows sorted by slot (``sort_by_adapter``); ``a``
    ``[S, K, R]``; ``b`` ``[S, R, N]`` (the adapter scale folded in at
    load); ``offsets`` int32 ``[S+1]`` on x's device. Rows past
    ``offsets[S]`` (base-model tokens, padding) get an exact 0 delta.
    Returns ``[T, N]`` in ``out_dtype`` (default fp32, for adding onto a
    base projection's fp32 result): the op ``ptt::lora_delta``."""
    _check_bank("lora_delta", x, a, b, offsets)
    resolve_backend("lora_delta", backend, x.device)
    return _kernels.call(_lora_op, x, a, b, offsets, out_dtype)


def _lora_impl(x, a, b, offsets, out_dtype):
    """``ptt::lora_delta``: the launch on a CUDA tensor, the plain version
    on a CPU tensor."""
    if resolve_backend("lora_delta", "auto", x.device) == "plain":
        return lora_delta_plain(x, a, b, offsets, out_dtype=out_dtype)
    return _lora_delta_cuda(x, a, b, offsets, out_dtype)


_lora_op = _kernels.define_op(
    "lora_delta",
    "(Tensor x, Tensor a, Tensor b, Tensor offsets, ScalarType? out_dtype) "
    "-> Tensor", _lora_impl, lambda x, a, b, offsets, out_dtype:
    x.new_empty((x.shape[0], b.shape[-1]),
                dtype=out_dtype or torch.float32))
