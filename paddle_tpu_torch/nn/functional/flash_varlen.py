"""Paged prefill attention — chunked prefill over the paged KV pool.

Counterpart of the paged part of ``paddle_tpu/nn/functional/
flash_varlen.py``: the queries of a prompt chunk attend, causally, the
sequence's cached pages (previous chunks, prefix pages shared with
other requests) and the chunk's own K/V, all read IN PLACE from the
page-major pool through the block table, with the JAX package's
layouts:

  q            [batch, chunk, num_q_heads, head_dim]   kv-major heads
  key_cache    [num_pages, num_kv_heads, page_size, head_dim]
  value_cache  [num_pages, num_kv_heads, page_size, head_dim]
  block_tables [batch, pages_per_seq] int32            ABSOLUTE page ids
  start        [batch] int32                           chunk offsets

``paged_prefill_attention`` launches ``csrc/flash_varlen.cu`` on a CUDA
tensor and runs its plain version ``_paged_prefill_plain`` on a CPU
tensor. An int8 pool (each side ``(int8 rows, f32 scale plane)``) has
no kernel, as in the JAX package, where it is XLA's dense gather: the
plain version dequantizes it, on the card too. The packed varlen flash
forward/backward of the JAX module comes with the training slice of
the port.
"""
from __future__ import annotations

import torch

from ... import _kernels

__all__ = ["paged_prefill_attention"]


def _dense_side(side, ids, n_kv: int, d: int):
    """One pool side's pages at ``ids`` [b, pp] as fp32 [b, n_kv, S, d];
    an int8 side ``(rows, plane)`` comes out dequantized."""
    b, pp = ids.shape
    rows = side[0] if isinstance(side, tuple) else side
    ps = rows.shape[2]
    # [b, pp, n_kv, ps, d] -> [b, n_kv, S, d]
    g = rows[ids].transpose(1, 2).reshape(b, n_kv, pp * ps, d).float()
    if isinstance(side, tuple):
        cols = (ids[:, :, None] * ps
                + torch.arange(ps, device=ids.device)).reshape(b, -1)
        g = g * side[1][:, cols].transpose(0, 1)[..., None]
    return g


def _paged_prefill_plain(q, key_cache, value_cache, block_tables, start, *,
                         n_kv: int, scale=None):
    """Plain version of the kernel (the JAX package's ``_paged_fwd_xla``
    semantics, as one dense gather): query ``t`` of row ``b`` attends
    every key at position ``<= start[b] + t`` below the table's span, in
    fp32; a table id outside the pool names no page and is not attended;
    a query with nothing to attend returns zeros. Also the attention of
    an int8 pool, whose sides are ``(int8 rows, f32 scale plane)``: the
    gathered rows are dequantized first."""
    b, c, n_q, d = q.shape
    rows = key_cache[0] if isinstance(key_cache, tuple) else key_cache
    P, _, ps, _ = rows.shape
    pp = block_tables.shape[1]
    S = pp * ps
    g = n_q // n_kv
    scale = float(scale if scale is not None else d ** -0.5)
    ids = block_tables.long()
    in_pool = (ids >= 0) & (ids < P)                          # [b, pp]
    ids = torch.where(in_pool, ids, 0)
    kg = _dense_side(key_cache, ids, n_kv, d)
    vg = _dense_side(value_cache, ids, n_kv, d)
    qh = q.reshape(b, c, n_kv, g, d).float() * scale
    lg = torch.einsum("btngd,bnsd->bngts", qh, kg)
    pos_q = start.long().to(q.device)[:, None] \
        + torch.arange(c, device=q.device)[None, :]             # [b, c]
    pos_k = torch.arange(S, device=q.device)
    mask = (pos_k[None, None, :] <= pos_q[:, :, None]) \
        & in_pool.repeat_interleave(ps, dim=1)[:, None, :]      # [b, c, S]
    mask = mask[:, None, None]
    lg = torch.where(mask, lg, torch.finfo(torch.float32).min)
    p = torch.exp(lg - lg.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bngts,bnsd->btngd", p, vg) \
        / p.sum(-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, c, n_q, d).to(q.dtype)


#: launches of the CUDA kernel, counted after each returns without an
#: error (plain CPU calls do not count)
launches = 0


def paged_prefill_attention(q, key_cache, value_cache, block_tables, start,
                            *, n_kv: int, scale=None):
    """Chunk-over-paged-pool attention, reading K/V IN PLACE.

    q: ``[b, c, n_q_heads, d]`` chunk queries at positions ``start[b] ..
    start[b]+c-1``; ``block_tables`` ``[b, pp]`` hold ABSOLUTE
    (layer-offset) page ids; the chunk's own K/V must already be written
    to the pool (the prefill write happens first, on the same stream).
    Queries attend causally: key position <= query position, below the
    table's span ``pp * page_size`` — the cached prefix plus the
    in-chunk triangle. A table id outside the pool names no page (not
    read). Scores, softmax and accumulation are fp32. ``start`` stays on
    the device: nothing here syncs with the host. Returns ``[b, c,
    n_q_heads, d]`` in q's dtype.
    """
    what = "paged_prefill_attention"
    if q.device.type != "cuda":
        return _paged_prefill_plain(q, key_cache, value_cache, block_tables,
                                    start, n_kv=n_kv, scale=scale)
    if isinstance(key_cache, tuple) or isinstance(value_cache, tuple):
        raise TypeError(f"{what}: the kernel reads a bf16/f32 pool; an "
                        "int8 pool takes the dense gather "
                        "(_paged_prefill_plain)")
    b, c, n_q, d = q.shape
    P, n_kv_pool, ps, d_pool = key_cache.shape
    pp = block_tables.shape[1]
    if (n_kv != n_kv_pool or n_q % n_kv or n_q // n_kv > 8 or d > 256
            or d_pool != d):
        raise ValueError(
            f"{what}: needs n_q a multiple of n_kv = {n_kv} (the pool's "
            f"heads) with a group of at most 8 and head_dim <= 256 "
            f"matching the pool; got q {tuple(q.shape)}, pool "
            f"{tuple(key_cache.shape)}")
    if value_cache.shape != key_cache.shape:
        raise ValueError(f"{what}: the K and V pools differ in shape")
    if tuple(start.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"{what}: start must be [b] and block_tables "
                         "[b, pages_per_seq]")
    for name, t in (("key_cache", key_cache), ("value_cache", value_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}; "
                            "the kernel takes one dtype")
    for name, t in (("start", start), ("block_tables", block_tables)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32")
    for t in (q, key_cache, value_cache, block_tables, start):
        if t.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")
    dt = _kernels.dtype_code(q, what)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    fn = _kernels.lib("flash_varlen").ptt_paged_prefill_attention
    _kernels.check(fn(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(), dt, b, c,
        n_q, n_kv, d, ps, pp, P, scale, _kernels.stream_ptr(q.device)), what)
    global launches
    launches += 1
    return out
