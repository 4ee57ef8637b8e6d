"""Paged-KV decode attention — the serving attention path.

Counterpart of ``paddle_tpu/nn/functional/paged_attention.py``, with
the same layouts (PAGE-MAJOR, head-major pages):

  q            [batch, num_q_heads, head_dim]        one decode token/seq
  key_cache    [num_pages, num_kv_heads, page_size, head_dim]
  value_cache  [num_pages, num_kv_heads, page_size, head_dim]
  seq_lens     [batch] int32
  block_tables [batch, pages_per_seq] int32          page ids per sequence

A layer-folded pool holds layer ``l``'s page ``p`` at physical page
``l * pool_pages + p``; block tables hold LAYER-LOCAL ids and
``pool_base`` selects the layer's region. Page 0 of a region is the
reserved scratch page.

``paged_decode_attention_inplace`` is the serving kernel (append the
current token's K/V and attend, in place on the pool): on a CUDA tensor
it launches ``csrc/paged_attention.cu``, on a CPU tensor it runs its
plain version ``_paged_decode_plain``. The semantics are those of the
block tables (``paged_attention_plain``, the JAX package's
``_xla_paged``): a page shared by two rows is read by both.
"""
from __future__ import annotations

import torch

from ... import _kernels

__all__ = ["paged_attention_plain", "paged_decode_attention_inplace",
           "write_kv_pages", "write_prefill_kv_pages",
           "STREAM_CHUNK_TOKENS", "stream_chunk_pages"]

# target token count per stream chunk of the JAX decode kernel; the
# engines round their pool allocation with it (inference/engine.py
# _round_pool_pages), so page accounting matches the JAX package's
STREAM_CHUNK_TOKENS = 1024


def stream_chunk_pages(page_size: int) -> int:
    """Full-target pages-per-chunk for a page size (the pool-size
    rounding quantum)."""
    return max(1, STREAM_CHUNK_TOKENS // max(page_size, 1))


def paged_attention_plain(q, key_cache, value_cache, seq_lens,
                          block_tables):
    """Single-token decode attention over ``seq_lens[b]`` cached tokens
    (the JAX package's ``_xla_paged``): gather the row's pages through
    its block table, fp32 scores and softmax, masked past the length.
    ``block_tables`` hold ABSOLUTE page ids."""
    b, n_q, d = q.shape
    _, n_kv, page_size, _ = key_cache.shape
    pages_per_seq = block_tables.shape[1]
    max_len = pages_per_seq * page_size
    tables = block_tables.long()
    k = key_cache[tables]                          # [b, pp, n_kv, ps, d]
    v = value_cache[tables]
    group = n_q // n_kv
    qh = q.reshape(b, n_kv, group, d)
    logits = torch.einsum("bngd,bpnsd->bngps", qh.float(),
                          k.float()) * (d ** -0.5)
    logits = logits.reshape(b, n_kv, group, max_len)
    pos = torch.arange(max_len, device=q.device)
    mask = pos[None, :] < seq_lens.to(q.device)[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1) \
        .reshape(b, n_kv, group, pages_per_seq, page_size)
    out = torch.einsum("bngps,bpnsd->bngd", w, v.float())
    return out.reshape(b, n_q, d).to(q.dtype)


def write_kv_pages(key_cache, value_cache, new_k, new_v, positions,
                   block_tables):
    """Scatter one new token's K/V per sequence into the paged cache,
    IN PLACE. new_k/new_v: [batch, n_kv, head_dim]; positions: [batch]
    0-based slot of the new token; ``block_tables`` absolute ids.
    Returns the (same) caches."""
    page_size = key_cache.shape[2]
    b = positions.shape[0]
    pos = positions.long()
    page_ids = block_tables.long()[torch.arange(b, device=pos.device),
                                   pos // page_size]
    slots = pos % page_size
    key_cache[page_ids, :, slots] = new_k.to(key_cache.dtype)
    value_cache[page_ids, :, slots] = new_v.to(value_cache.dtype)
    return key_cache, value_cache


def write_prefill_kv_pages(key_cache, value_cache, k, v, block_tables,
                           start=None, valid_lens=None):
    """Write a prompt chunk's K/V ([batch, seq, n_kv, d]) into pages,
    IN PLACE. ``start`` ([batch]): per-sequence position offset (default
    0). ``valid_lens`` ([batch]): rows ``>= valid_lens[b]`` are padding,
    routed to the scratch page 0. Returns the (same) caches."""
    b, s, n_kv, d = k.shape
    page_size = key_cache.shape[2]
    tables = block_tables.long()
    dev = key_cache.device
    if start is None:
        pos = torch.arange(s, device=dev)
        page_ids = tables[:, pos // page_size]                 # [b, s]
        slots = (pos % page_size).expand(b, s)
    else:
        pos2 = start.long().to(dev)[:, None] \
            + torch.arange(s, device=dev)[None, :]
        pidx = torch.clamp(pos2 // page_size, max=tables.shape[1] - 1)
        page_ids = torch.gather(tables, 1, pidx)
        slots = pos2 % page_size
    if valid_lens is not None:
        valid = torch.arange(s, device=dev)[None, :] \
            < valid_lens.long().to(dev)[:, None]
        page_ids = torch.where(valid, page_ids, 0)
        slots = torch.where(valid, slots, 0)
    key_cache[page_ids, :, slots] = k.to(key_cache.dtype)
    value_cache[page_ids, :, slots] = v.to(value_cache.dtype)
    return key_cache, value_cache


def _paged_decode_plain(q, new_k, new_v, key_cache, value_cache, seq_lens,
                        block_tables, pool_base=0, pool_pages=None):
    """Plain version of the decode kernel: the guarded append, then
    attention over the row's cached tokens plus the current one.

    For a row with room this is ``write_kv_pages`` followed by
    ``paged_attention_plain`` over ``seq_lens + 1``. A row whose table
    is full (``seq_lens >= pages_per_seq * page_size``) keeps its pool
    untouched and attends its whole table plus the operand token, as
    the kernel does. A table id outside the layer region ``[0,
    pool_pages)`` (default: the rest of the pool from ``pool_base``)
    names no page: its tokens are not attended and an append into it is
    skipped, so nothing outside the region is read or written."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = key_cache.shape
    pp = block_tables.shape[1]
    cap = pp * ps
    base = int(pool_base)
    region = key_cache.shape[0] - base if pool_pages is None \
        else int(pool_pages)
    local = block_tables.long()
    in_region = (local >= 0) & (local < region)            # [b, pp]
    tables = torch.where(in_region, local, 0) + base
    lens = seq_lens.long()
    write_page = torch.clamp(lens // ps, max=pp - 1)[:, None]
    room = (lens < cap) & in_region.gather(1, write_page)[:, 0]
    if bool(room.any()):
        rows = room.nonzero().flatten()
        write_kv_pages(key_cache, value_cache, new_k[rows], new_v[rows],
                       lens[rows], tables[rows])
    group = n_q // n_kv
    scale = d ** -0.5
    qh = q.reshape(b, n_kv, group, d).float()
    kg = key_cache[tables].float()                 # [b, pp, n_kv, ps, d]
    vg = value_cache[tables].float()
    logits = torch.einsum("bngd,bpnsd->bngps", qh, kg) * scale
    logits = logits.reshape(b, n_kv, group, cap)
    pos = torch.arange(cap, device=q.device)
    mask = (pos[None, :] < torch.clamp(lens, max=cap)[:, None]) \
        & in_region.repeat_interleave(ps, dim=1)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    # the current token joins from the operands (cast to the pool dtype
    # exactly as the append stores it)
    nk = new_k.to(key_cache.dtype).float()
    nv = new_v.to(value_cache.dtype).float()
    cur = torch.einsum("bngd,bnd->bng", qh, nk)[..., None] * scale
    w = torch.softmax(torch.cat([logits, cur], dim=-1), dim=-1)
    out = torch.einsum("bngps,bpnsd->bngd",
                       w[..., :cap].reshape(b, n_kv, group, pp, ps), vg)
    out = out + w[..., cap:] * nv[:, :, None, :]
    return out.reshape(b, n_q, d).to(q.dtype)


#: launches of the CUDA kernel, counted once each has been issued
#: without error (plain CPU calls do not count)
launches = 0


def paged_decode_attention_inplace(q, new_k, new_v, key_cache,
                                   value_cache, seq_lens, block_tables,
                                   pool_base=None, pool_pages=None):
    """Fused KV append + decode attention, IN PLACE on the pool.

    seq_lens = tokens already cached EXCLUDING the current token (its
    write position). Returns (out [b, n_q, d], key_cache, value_cache)
    with the pools updated in place. ``pool_base``/``pool_pages``: the
    layer region ``[pool_base, pool_base + pool_pages)`` of the folded
    pool that the (layer-local) tables index; ``pool_pages`` defaults to
    the rest of the pool. A region past the pool raises; a table id
    outside the region names no page (not read, not written).

    A row with ``seq_lens >= pages_per_seq * page_size`` has nowhere to
    append: its write is skipped (the pool stays untouched) and its
    attention still folds in the operand token — the caller must grow
    the table before retrying.
    """
    what = "paged_decode_attention_inplace"
    P = key_cache.shape[0]
    base = 0 if pool_base is None else int(pool_base)
    region = P - base if pool_pages is None else int(pool_pages)
    if base < 0 or region <= 0 or base + region > P:
        raise ValueError(f"{what}: layer region [{base}, {base + region}) "
                         f"is not inside the pool of {P} pages")
    if q.device.type != "cuda":
        out = _paged_decode_plain(q, new_k, new_v, key_cache, value_cache,
                                  seq_lens, block_tables, base, region)
        return out, key_cache, value_cache
    b, n_q, d = q.shape
    _, n_kv, ps, d_pool = key_cache.shape
    pp = block_tables.shape[1]
    if (n_kv == 0 or n_q % n_kv or n_q // n_kv > 8 or d > 256
            or d_pool != d):
        raise ValueError(
            f"{what}: needs n_q a multiple of n_kv with a group of at "
            f"most 8 and head_dim <= 256 matching the pool; got q "
            f"{tuple(q.shape)}, pool {tuple(key_cache.shape)}")
    if tuple(new_k.shape) != (b, n_kv, d) or new_v.shape != new_k.shape \
            or value_cache.shape != key_cache.shape:
        raise ValueError(f"{what}: new_k/new_v must be [b, n_kv, d] = "
                         f"{(b, n_kv, d)} and the pools alike")
    if tuple(seq_lens.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"{what}: seq_lens must be [b] and block_tables "
                         "[b, pages_per_seq]")
    for name, t in (("new_k", new_k), ("new_v", new_v),
                    ("key_cache", key_cache),
                    ("value_cache", value_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is "
                            f"{q.dtype}; the kernel takes one dtype")
    for name, t in (("seq_lens", seq_lens), ("block_tables", block_tables)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32")
    tensors = (q, new_k, new_v, key_cache, value_cache, seq_lens,
               block_tables)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")
    dt = _kernels.dtype_code(q, what)
    out = torch.empty_like(q)
    fn = _kernels.lib("paged_attention").ptt_paged_decode_attention
    _kernels.check(fn(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        key_cache.data_ptr(), value_cache.data_ptr(), seq_lens.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(), dt, b, n_q, n_kv, d, ps,
        pp, base, region, d ** -0.5, _kernels.stream_ptr(q.device)), what)
    global launches
    launches += 1
    return out, key_cache, value_cache
