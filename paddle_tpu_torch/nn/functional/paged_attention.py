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

The int8 KV pool (``kv_dtype="int8"``) keeps each side as a pair
``(int8 rows [pages, n_kv, page_size, d], f32 scale plane [n_kv,
pages * page_size])``: token rows quantized per (token, head) by
``quantize_kv_rows``, the scale of page ``p``'s slot ``s`` in plane
column ``p * page_size + s``. ``paged_decode_attention_inplace_q`` is
its decode kernel (``csrc/paged_attention_q.cu``; plain version
``_paged_decode_q_plain``); ``write_prefill_kv_pages`` and
``gather_kv_pages`` take either pool form.

``paged_attention`` is the public decode op (attend ``seq_lens`` cached
tokens, no append), routed by ``FLAGS_paged_attention_backend`` to the
kernels of ``csrc/paged_backends.cu``: ``stream`` (B7, the
pool-streaming kernel, ``stream_paged``), ``fused`` (B8, the TPU's one
program per sequence; on the card B1's tile walk with no current token,
``fused_paged``), ``pallas`` (B9, the stock kernel's compute
blocks, ``pallas_paged``). ``xla`` names the plain gather
``paged_attention_plain``. On a CPU tensor each wrapper runs its plain
version (``_stream_paged_plain``, ``_fused_paged_plain``,
``_pallas_paged_plain``); on a CUDA tensor it launches its kernel or
raises, and ``xla`` raises. B7 masks the layer region by
``pool_membership``, the block tables' own map, so a page two rows hold
is read by both (the JAX kernel's one-owner ``build_pool_ownership`` is
ported for parity and is wrong for shared pages).
"""
from __future__ import annotations

import torch

from ... import _kernels
from ...core.flags import flag
from ...quantization.dynamic import dynamic_act_quant

__all__ = ["paged_attention", "last_paged_attention_backend",
           "paged_attention_plain", "paged_decode_attention_inplace",
           "paged_decode_attention_inplace_q", "quantize_kv_rows",
           "write_kv_pages", "write_prefill_kv_pages", "gather_kv_pages",
           "STREAM_CHUNK_TOKENS", "stream_chunk_pages", "pool_membership",
           "build_pool_ownership", "stream_paged", "fused_paged",
           "pallas_paged", "BACKEND_HEAD_DIMS", "STREAM_KERNEL_CHUNK",
           "decode_q_plan", "stream_walk", "stream_live_pages"]

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


def quantize_kv_rows(x):
    """Per-(row..., head) symmetric int8 quantization of K/V token rows
    x [..., n_kv, d] -> (q int8 [..., n_kv, d], scale f32 [..., n_kv]):
    ``scale = max(absmax / 127, 1e-8)``, ``q = clip(round(x / scale),
    -127, 127)``."""
    return dynamic_act_quant(x, 1e-8)


def _write_q_rows(side, x, page_ids, slots):
    """Quantize rows x [..., n_kv, d] and store them IN PLACE in an int8
    pool side ``(rows, plane)`` at pages ``page_ids`` / slots ``slots``
    (same leading shape as x; absolute page ids): int8 rows into the
    pages, scales into plane columns ``page * page_size + slot``."""
    pool, plane = side
    n_kv = x.shape[-2]
    xq, xs = quantize_kv_rows(x)
    pool[page_ids, :, slots] = xq
    cols = (page_ids * pool.shape[2] + slots).reshape(-1)
    plane[:, cols] = xs.reshape(-1, n_kv).t()
    return side


def write_prefill_kv_pages(key_cache, value_cache, k, v, block_tables,
                           start=None, valid_lens=None):
    """Write a prompt chunk's K/V ([batch, seq, n_kv, d]) into pages,
    IN PLACE. ``start`` ([batch]): per-sequence position offset (default
    0). ``valid_lens`` ([batch]): rows ``>= valid_lens[b]`` are padding,
    routed to the scratch page 0. An int8 pool (``(rows, plane)``
    sides) takes the rows quantized per (token, head). Returns the
    (same) caches."""
    b, s, n_kv, d = k.shape
    quant = isinstance(key_cache, tuple)
    page_size = (key_cache[0] if quant else key_cache).shape[2]
    tables = block_tables.long()
    dev = k.device
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
    if quant:
        return (_write_q_rows(key_cache, k, page_ids, slots),
                _write_q_rows(value_cache, v, page_ids, slots))
    key_cache[page_ids, :, slots] = k.to(key_cache.dtype)
    value_cache[page_ids, :, slots] = v.to(value_cache.dtype)
    return key_cache, value_cache


def gather_kv_pages(cache_side, block_tables):
    """One cache side's pages gathered token-major, [b, S, n_kv, d] with
    S = table width * page size (token t = page t // ps, slot t % ps);
    an int8 side comes out dequantized in fp32. The dense K/V view of
    the chunked prefill's ``gather`` backend and of the int8 pool.
    ``block_tables`` hold ABSOLUTE page ids."""
    quant = isinstance(cache_side, tuple)
    pool = cache_side[0] if quant else cache_side
    b, P = block_tables.shape
    _, n_kv, ps, d = pool.shape
    tables = block_tables.long()
    g = pool[tables].transpose(2, 3).reshape(b, P * ps, n_kv, d)
    if quant:
        cols = (tables[:, :, None] * ps
                + torch.arange(ps, device=tables.device)).reshape(b, -1)
        scales = cache_side[1][:, cols].permute(1, 2, 0)   # [b, S, n_kv]
        g = g.float() * scales[..., None]
    return g


def _layer_region(what, n_pages, pool_base, pool_pages):
    """(base, size) of the layer region ``[pool_base, pool_base +
    pool_pages)`` (defaults: 0, the rest of the pool); raises unless it
    lies inside the pool of ``n_pages`` pages."""
    base = 0 if pool_base is None else int(pool_base)
    region = n_pages - base if pool_pages is None else int(pool_pages)
    if base < 0 or region <= 0 or base + region > n_pages:
        raise ValueError(f"{what}: layer region [{base}, {base + region}) "
                         f"is not inside the pool of {n_pages} pages")
    return base, region


def _region_tables(block_tables, pool_base, pool_pages, n_pages):
    """Absolute page ids of layer-local tables, and the in-region mask:
    a table id outside ``[0, pool_pages)`` (default: the rest of the
    pool) names no page — it maps to the region's page 0, masked."""
    base = int(pool_base)
    region = n_pages - base if pool_pages is None else int(pool_pages)
    local = block_tables.long()
    in_region = (local >= 0) & (local < region)
    return torch.where(in_region, local, 0) + base, in_region


def _paged_decode_plain(q, new_k, new_v, key_cache, value_cache, seq_lens,
                        block_tables, pool_base=0, pool_pages=None,
                        skip_last_tile=False):
    """Plain version of the decode kernel: the guarded append, then
    attention over the row's cached tokens plus the current one.

    For a row with room this is ``write_kv_pages`` followed by
    ``paged_attention_plain`` over ``seq_lens + 1``. A row whose table
    is full (``seq_lens >= pages_per_seq * page_size``) keeps its pool
    untouched and attends its whole table plus the operand token, as
    the kernel does. A table id outside the layer region ``[0,
    pool_pages)`` (default: the rest of the pool from ``pool_base``)
    names no page: its tokens are not attended and an append into it is
    skipped, so nothing outside the region is read or written.

    ``skip_last_tile`` leaves out each row's last 16-token tile
    (``DECODE_Q_TILE``) that holds an attended token (the chip check's
    control)."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = key_cache.shape
    pp = block_tables.shape[1]
    cap = pp * ps
    tables, in_region = _region_tables(block_tables, pool_base, pool_pages,
                                       key_cache.shape[0])
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
    n_tok = torch.clamp(lens, max=cap)
    mask = (pos[None, :] < n_tok[:, None]) \
        & in_region.repeat_interleave(ps, dim=1)
    if skip_last_tile:
        last = torch.clamp(n_tok - 1, min=0) // DECODE_Q_TILE
        mask = mask & (pos[None, :] // DECODE_Q_TILE != last[:, None])
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

#: tokens a tile of the tensor-core decode kernels, B1's, B6's and B8's
#: (a warp's unit of work)
DECODE_Q_TILE = 16
_DECODE_Q_MAX_SPLIT = 16
#: the card's grid limit on its second dimension (the batch rows)
_GRID_Y_MAX = 65535


def decode_q_plan(b: int, n_kv: int, span: int, sms: int) -> tuple:
    """``(n_split, blocks)`` of the tensor-core decode kernels (B1 and B8
    on a bf16 pool, B6 on an int8 one, bf16 q): a block of 4 warps per (row,
    kv head), or per (row, kv head, split) with each split a contiguous
    share of the row's 16-token tiles. A row is split only where ``b *
    n_kv`` blocks leave the card's ``sms`` SMs short of two blocks each:
    into as many splits as fill two an SM, at most 16, each at least 8
    tiles (two a warp) of the table's span ``span`` (``pages_per_seq *
    page_size``). Raises past the grid's limit of 65535 rows."""
    if b > _GRID_Y_MAX:
        raise ValueError(f"paged decode attention: batch {b} exceeds the "
                         f"kernel grid's limit of {_GRID_Y_MAX} rows")
    base = b * n_kv
    tiles = -(-span // DECODE_Q_TILE)
    n_split = 1
    if 0 < base < 2 * sms:
        n_split = max(1, min(-(-2 * sms // base), tiles // 8,
                             _DECODE_Q_MAX_SPLIT))
    return n_split, base * n_split


def _on_card(t) -> bool:
    return t.device.type == "cuda"


_sm_count = _kernels.sm_count


def _decode_split(q, b: int, n_kv: int, d: int, span: int, mma: bool):
    """``(n_split, workspace)`` of a tensor-core decode launch: bf16 q on
    a kernel that splits (``mma``) takes ``decode_q_plan``'s split and,
    when it splits, an f32 workspace of every split's partials (outputs,
    then m and l) and an int32 ticket a (row, kv head), zeroed by the
    launch; otherwise one block a (row, kv head) and none. Raises past
    the grid's limit of 65535 rows."""
    n_split, _ = decode_q_plan(b, n_kv, span, _sm_count(q.device))
    if q.dtype != torch.bfloat16 or not mma or n_split == 1:
        return 1, None
    rows = b * n_kv
    g = q.shape[1] // n_kv
    return n_split, torch.empty(rows * n_split * g * (d + 2) + rows,
                                dtype=torch.float32, device=q.device)


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

    On the card bf16 at a head_dim that is a multiple of 32 runs the
    tensor-core kernel with ``decode_q_plan``'s split (one launch, a
    workspace when it splits); f32 and other head dims the CUDA-core
    kernel.
    """
    what = "paged_decode_attention_inplace"
    P = key_cache.shape[0]
    base, region = _layer_region(what, P, pool_base, pool_pages)
    if not _on_card(q):
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
    n_split, ws = _decode_split(q, b, n_kv, d, pp * ps, d % 32 == 0)
    out = torch.empty_like(q)
    fn = _kernels.lib("paged_attention").ptt_paged_decode_attention
    _kernels.check(fn(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        key_cache.data_ptr(), value_cache.data_ptr(), seq_lens.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(), _kernels.ptr(ws), dt, b,
        n_q, n_kv, d, ps, pp, base, region, n_split, d ** -0.5,
        _kernels.stream_ptr(q.device)), what)
    global launches
    launches += 1
    return out, key_cache, value_cache


def _paged_decode_q_plain(q, new_k, new_v, kq_pool, ks_plane, vq_pool,
                          vs_plane, seq_lens, block_tables, pool_base=0,
                          pool_pages=None, skip_last_page=False):
    """Plain version of the int8-KV decode kernel (the port's contract;
    ``paged_decode_attention_inplace_q``):

    - the guarded append: new_k/new_v quantized per (row, kv head) into
      slot ``seq_lens % ps`` of page ``table[seq_lens // ps]`` and their
      scales into the planes; skipped for a full table or a page outside
      the layer region;
    - q quantized per (row, q head); cached token t (through the row's
      table, ``t < seq_lens``, in the region) has logit
      ``int32(qq . kq[t]) * (qs * d^-0.5) * k_scale[t]`` (an exact
      integer dot: |sum| < 2^24 is exact in fp32 too);
    - the current token joins from the operands: logit
      ``(qq * qs) . new_k * d^-0.5``, value ``new_v``;
    - fp32 softmax over both; output ``sum_t w_t * v_scale[t] * vq[t]
      + w_cur * new_v``, cast to q's dtype.

    ``skip_last_page`` leaves out each row's last page that holds an
    attended token (the chip check's control).
    """
    b, n_q, d = q.shape
    _, n_kv, ps, _ = kq_pool.shape
    pp = block_tables.shape[1]
    cap = pp * ps
    tables, in_region = _region_tables(block_tables, pool_base, pool_pages,
                                       kq_pool.shape[0])
    lens = seq_lens.long()
    write_page = torch.clamp(lens // ps, max=pp - 1)[:, None]
    room = (lens < cap) & in_region.gather(1, write_page)[:, 0]
    if bool(room.any()):
        rows = room.nonzero().flatten()
        pages = tables[rows].gather(1, write_page[rows])[:, 0]
        slots = lens[rows] % ps
        _write_q_rows((kq_pool, ks_plane), new_k[rows], pages, slots)
        _write_q_rows((vq_pool, vs_plane), new_v[rows], pages, slots)
    g = n_q // n_kv
    scale = d ** -0.5
    qq, qs = quantize_kv_rows(q)                     # [b, n_q, d], [b, n_q]
    qq = qq.reshape(b, n_kv, g, d).float()
    qss = (qs * scale).reshape(b, n_kv, g)
    cols = (tables[:, :, None] * ps
            + torch.arange(ps, device=q.device)).reshape(b, cap)
    ks = ks_plane[:, cols].permute(1, 0, 2)          # [b, n_kv, cap]
    vs = vs_plane[:, cols].permute(1, 0, 2)
    kg = kq_pool[tables].float()                     # [b, pp, n_kv, ps, d]
    vg = vq_pool[tables].float()
    dots = torch.einsum("bngd,bpnsd->bngps", qq, kg).reshape(b, n_kv, g,
                                                              cap)
    logits = dots * qss[..., None] * ks[:, :, None, :]
    pos = torch.arange(cap, device=q.device)
    n_tok = torch.clamp(lens, max=cap)
    mask = (pos[None, :] < n_tok[:, None]) \
        & in_region.repeat_interleave(ps, dim=1)
    if skip_last_page:
        last = torch.clamp(n_tok - 1, min=0) // ps
        mask = mask & (pos[None, :] // ps != last[:, None])
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.finfo(torch.float32).min)
    qd = qq * qs.reshape(b, n_kv, g)[..., None]
    nk, nv = new_k.float(), new_v.float()
    cur = torch.einsum("bngd,bnd->bng", qd, nk)[..., None] * scale
    w = torch.softmax(torch.cat([logits, cur], dim=-1), dim=-1)
    # a select, not a product: the scale of a slot nobody wrote may be NaN
    vs = torch.where(mask[:, None, :], vs, 0.0)
    wv = (w[..., :cap] * vs[:, :, None, :]).reshape(b, n_kv, g, pp, ps)
    out = torch.einsum("bngps,bpnsd->bngd", wv, vg)
    out = out + w[..., cap:] * nv[:, :, None, :]
    return out.reshape(b, n_q, d).to(q.dtype)


#: launches of the int8-KV CUDA kernel (plain CPU calls do not count)
q_launches = 0


def paged_decode_attention_inplace_q(q, new_k, new_v, kq_pool, ks_plane,
                                     vq_pool, vs_plane, seq_lens,
                                     block_tables, pool_base=None,
                                     pool_pages=None):
    """int8-KV variant of ``paged_decode_attention_inplace``: append the
    current token (quantized) and attend, IN PLACE on the int8 pool.

    kq_pool/vq_pool [pages, n_kv, page_size, d] int8; ks_plane/vs_plane
    [n_kv, pages * page_size] f32. q [b, n_q, d], new_k/new_v [b, n_kv,
    d] in one float dtype. Returns ``(out [b, n_q, d], kq_pool,
    ks_plane, vq_pool, vs_plane)`` with the pool updated in place. The
    function is ``_paged_decode_q_plain``'s; ``pool_base``/
    ``pool_pages`` and the guards are those of
    ``paged_decode_attention_inplace``. Masking follows each row's
    block table, so a page shared by two rows is read by both. On the
    card a bf16 q runs the tensor-core kernel with ``decode_q_plan``'s
    split (one launch, a workspace when it splits), f32 the CUDA-core
    kernel.
    """
    what = "paged_decode_attention_inplace_q"
    P = kq_pool.shape[0]
    base, region = _layer_region(what, P, pool_base, pool_pages)
    if not _on_card(q):
        out = _paged_decode_q_plain(q, new_k, new_v, kq_pool, ks_plane,
                                    vq_pool, vs_plane, seq_lens,
                                    block_tables, base, region)
        return out, kq_pool, ks_plane, vq_pool, vs_plane
    b, n_q, d = q.shape
    _, n_kv, ps, d_pool = kq_pool.shape
    pp = block_tables.shape[1]
    if (n_kv == 0 or n_q % n_kv or n_q // n_kv > 8 or d > 256
            or d_pool != d):
        raise ValueError(
            f"{what}: needs n_q a multiple of n_kv with a group of at "
            f"most 8 and head_dim <= 256 matching the pool; got q "
            f"{tuple(q.shape)}, pool {tuple(kq_pool.shape)}")
    plane = (n_kv, P * ps)
    if (tuple(new_k.shape) != (b, n_kv, d) or new_v.shape != new_k.shape
            or vq_pool.shape != kq_pool.shape
            or tuple(ks_plane.shape) != plane
            or tuple(vs_plane.shape) != plane):
        raise ValueError(f"{what}: new_k/new_v must be [b, n_kv, d] = "
                         f"{(b, n_kv, d)}, the pools alike and the scale "
                         f"planes {plane}")
    if tuple(seq_lens.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"{what}: seq_lens must be [b] and block_tables "
                         "[b, pages_per_seq]")
    for name, t, dt in (("new_k", new_k, q.dtype), ("new_v", new_v, q.dtype),
                        ("kq_pool", kq_pool, torch.int8),
                        ("vq_pool", vq_pool, torch.int8),
                        ("ks_plane", ks_plane, torch.float32),
                        ("vs_plane", vs_plane, torch.float32),
                        ("seq_lens", seq_lens, torch.int32),
                        ("block_tables", block_tables, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel "
                            f"takes {dt}")
    for t in (q, new_k, new_v, kq_pool, ks_plane, vq_pool, vs_plane,
              seq_lens, block_tables):
        if t.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")
    dt = _kernels.dtype_code(q, what)
    n_split, ws = _decode_split(q, b, n_kv, d, pp * ps, True)
    out = torch.empty_like(q)
    fn = _kernels.lib("paged_attention_q").ptt_paged_decode_attention_q
    _kernels.check(fn(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        kq_pool.data_ptr(), ks_plane.data_ptr(), vq_pool.data_ptr(),
        vs_plane.data_ptr(), seq_lens.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), _kernels.ptr(ws), dt, b, n_q, n_kv, d, ps, pp, base,
        region, P * ps, n_split, d ** -0.5,
        _kernels.stream_ptr(q.device)), what)
    global q_launches
    q_launches += 1
    return out, kq_pool, ks_plane, vq_pool, vs_plane


# ---------------------------------------------------------------------
# The decode backends: kernels B7-B9 and the public paged_attention
# ---------------------------------------------------------------------

#: the values of FLAGS_paged_attention_backend
BACKENDS = ("auto", "stream", "fused", "xla", "pallas")

#: head dims the fused and pallas kernels are built for (stream: the
#: multiples of 128 among them)
BACKEND_HEAD_DIMS = (64, 96, 128, 256)

#: region tokens a chunk of the pool-streaming kernel (B7): one block of
#: the kernel stages one chunk of a kv head's region and rounds the
#: chunk's probabilities, taken against the chunk's own max, to the pool
#: dtype; the plain version cuts the region at the same points
STREAM_KERNEL_CHUNK = 64

_NEG = -1e30                 # the TPU kernels' NEG
#: the stock TPU kernel's finite mask value (-0.7 * float32 max)
_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: query rows a pass of B7's bf16 walk (4 warps of 16)
STREAM_ROWS = 64
#: the pages a run of B7's bf16 walk may span: its membership columns are
#: staged in shared memory once a pass
_STREAM_MAX_RUN_PAGES = 128

#: launches of the three kernels, counted once each has been issued
#: without error (plain CPU calls do not count); B7 launches twice a
#: call, its partials and their merge
stream_launches = 0
fused_launches = 0
pallas_launches = 0

_LAST_BACKEND = [None]


def last_paged_attention_backend():
    """The backend the most recent ``paged_attention`` call took:
    ``"stream"``, ``"fused"``, ``"pallas"`` or ``"xla"``."""
    return _LAST_BACKEND[0]


def backend_flag() -> str:
    """``FLAGS_paged_attention_backend``, checked against its values."""
    backend = flag("paged_attention_backend")
    if backend not in BACKENDS:
        raise ValueError(
            f"FLAGS_paged_attention_backend={backend!r}: valid values "
            "are 'auto', 'stream', 'fused', 'xla', 'pallas'")
    return backend


def check_stream_head_dim(d: int) -> None:
    """The ``stream`` backend's head_dim rule (the reference's message)."""
    if d % 128 != 0:
        raise ValueError(
            "paged_attention backend 'stream' requires head_dim to be a "
            f"multiple of 128 (lane width); got {d}. Use 'auto' to fall "
            "back automatically.")


def pool_membership(block_tables, seq_lens, pool_pages: int,
                    page_size: int):
    """B7's mask: ``[b, pool_pages]`` int32 whose entry ``[r, p]`` is the
    index ``j`` of page ``p`` in row ``r``'s (layer-local) block table
    where ``j * page_size < seq_lens[r]``, else -1; token ``(p, s)`` of
    the region is attended by row ``r`` when ``j >= 0`` and ``j *
    page_size + s < seq_lens[r]``. A page two rows hold is valid for
    both. An id outside ``[0, pool_pages)`` is dropped, as the JAX
    package's scatter with ``mode="drop"``. Built on the tables' device
    by one scatter, with no host read; layer-independent, so a decode
    step can build it once for every layer."""
    b, pp = block_tables.shape
    dev = block_tables.device
    j = torch.arange(pp, dtype=torch.int32, device=dev)
    tables = block_tables.to(torch.int32)
    live = ((j[None, :] * page_size
             < seq_lens.to(device=dev, dtype=torch.int32)[:, None])
            & (tables >= 0) & (tables < pool_pages))
    # dropped entries land in a spare column that is cut off
    idx = torch.where(live, tables, pool_pages).long()
    out = torch.full((b, pool_pages + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, idx, j.expand(b, pp).contiguous())
    return out[:, :pool_pages].contiguous()


def build_pool_ownership(block_tables, seq_lens, pool_pages: int,
                         page_size: int):
    """The JAX package's ownership map of a layer region (its
    ``build_pool_ownership``, integer for integer): ``(owner_tok
    [pool_pages * page_size] int32, the row that owns each token slot or
    -1; pos_tok, the slot's position in its owner's sequence)``. Entries
    at or past a row's length are padding and own nothing; ids outside
    ``[0, pool_pages)`` are dropped.

    It keeps ONE owner a page: a page that two rows hold (the prefix
    cache's shared pages) is owned by whichever write lands last, and a
    kernel masking by it hides the page from the other row. B7 masks by
    ``pool_membership`` instead; this map serves the parity tests and
    the chip check's control."""
    b, pp = block_tables.shape
    ps = int(page_size)
    dev = block_tables.device
    jstart = torch.arange(pp, dtype=torch.int32, device=dev)[None, :] * ps
    tables = block_tables.to(torch.int32)
    valid = ((jstart < seq_lens.to(device=dev, dtype=torch.int32)[:, None])
             & (tables >= 0) & (tables < pool_pages))
    idx = torch.where(valid, tables, pool_pages).reshape(-1).long()
    rows = torch.arange(b, dtype=torch.int32, device=dev)[:, None] \
        .expand(b, pp).reshape(-1)
    pidx = torch.arange(pp, dtype=torch.int32, device=dev)[None, :] \
        .expand(b, pp).reshape(-1)
    owner_page = torch.full((pool_pages + 1,), -1, dtype=torch.int32,
                            device=dev).index_put_((idx,), rows)
    page_index = torch.zeros(pool_pages + 1, dtype=torch.int32,
                             device=dev).index_put_((idx,), pidx)
    owner_tok = owner_page[:pool_pages].repeat_interleave(ps)
    slot = torch.arange(ps, dtype=torch.int32, device=dev)
    pos_tok = (page_index[:pool_pages].repeat_interleave(ps) * ps
               + slot.repeat(pool_pages))
    return owner_tok, pos_tok


def stream_walk(b: int, g: int, n_kv: int, pool_pages: int, page_size: int,
                sms: int) -> tuple:
    """``(blocks, chunks_per_block, run_pages, passes)`` of B7's bf16
    walk: the layer region's ``nch = ceil(pool_pages * page_size / 64)``
    chunks of a kv head cut into runs of ``chunks_per_block``, one block a
    run, ``blocks`` a head, about two blocks an SM of the card's ``sms``
    in all; a run spans at most ``run_pages`` region pages (at most 128,
    its membership columns staged in shared memory); the ``b * g`` query
    rows go in ``passes`` of 64. Raises past the grid's limit of 65535
    kv heads."""
    if n_kv > _GRID_Y_MAX:
        raise ValueError(f"stream_paged: {n_kv} kv heads exceed the kernel "
                         f"grid's limit of {_GRID_Y_MAX}")
    nch = -(-pool_pages * page_size // STREAM_KERNEL_CHUNK)
    blocks = max(1, min(nch, -(-2 * sms // n_kv)))
    cap = max(1, (_STREAM_MAX_RUN_PAGES - 1) * page_size
              // STREAM_KERNEL_CHUNK)
    cpb = min(-(-nch // blocks), cap)
    blocks = -(-nch // cpb)
    run_pages = -(-cpb * STREAM_KERNEL_CHUNK // page_size) + 1
    return blocks, cpb, run_pages, -(-b * g // STREAM_ROWS)


def stream_live_pages(membership, g: int):
    """The region pages B7's bf16 walk reads: ``[passes, pool_pages]``
    bool, page ``p`` live in pass ``i`` when a batch row of that pass's
    query rows (``64 i .. 64 i + 63`` of the ``b * g``, row ``r`` of batch
    row ``r // g``) holds it (``membership >= 0``); the kernel tests its
    staged columns the same way. Built on the device, with no host
    read."""
    b, P = membership.shape
    passes = -(-b * g // STREAM_ROWS)
    rows = torch.arange(passes * STREAM_ROWS, device=membership.device)
    held = membership >= 0                                   # [b, P]
    bi = torch.clamp(rows // g, max=b - 1)
    held_rows = held[bi] & (rows < b * g)[:, None]           # [rows, P]
    return held_rows.reshape(passes, STREAM_ROWS, P).any(1)


def _pallas_ppcb(pages_per_seq: int, page_size: int) -> int:
    """Pages a compute block of the stock kernel (B9): at most 512 tokens,
    a divisor of the table width (the JAX ``_pallas_paged``'s rule)."""
    ppcb = max(1, min(pages_per_seq, 512 // max(page_size, 1)))
    while pages_per_seq % ppcb:
        ppcb -= 1
    return ppcb


def _region_tokens(side, base: int, pages: int):
    """One pool side's layer region as f32 ``[n_kv, pages * ps, d]``."""
    r = side[base:base + pages]
    return r.permute(1, 0, 2, 3).reshape(r.shape[1], -1, r.shape[3]).float()


def _stream_paged_plain(q, key_cache, value_cache, seq_lens, block_tables,
                        pool_base: int, pool_pages: int, membership=None,
                        ownership=None, chunk: int = STREAM_KERNEL_CHUNK,
                        round_p: bool = True):
    """Plain version of B7 (the JAX ``_stream_paged`` with the block
    tables' mask): the layer region ``[pool_base, pool_base +
    pool_pages)`` in chunks of ``chunk`` tokens; per chunk and query row
    the chunk's max ``m`` over the row's tokens, ``p = exp(s - m)``, ``l
    = sum p`` and ``acc = p V`` with q and p cast to the pool dtype
    first, as the TPU kernel casts them; the chunks merged by
    log-sum-exp, ``out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M)
    l_c, 1e-30)``. A row that attends nothing gets 0. ``membership``
    defaults to ``pool_membership``; ``ownership`` (a
    ``build_pool_ownership`` pair) masks instead as the JAX kernel does,
    one owner a page. ``round_p=False`` keeps p in f32 (the chip check's
    witness of what that rounding moves)."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = key_cache.shape
    g = n_q // n_kv
    dt = key_cache.dtype
    dev = q.device
    T = pool_pages * ps
    nch = -(-T // chunk)
    pad = nch * chunk - T
    k = _region_tokens(key_cache, pool_base, pool_pages)
    v = _region_tokens(value_cache, pool_base, pool_pages)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    lens = seq_lens.to(dev).long()[:, None]
    tok = torch.arange(nch * chunk, device=dev)
    in_region = tok < T
    tok = torch.clamp(tok, max=T - 1)
    if ownership is not None:
        owner, pos = (t.to(dev).long() for t in ownership)
        rows = torch.arange(b, device=dev)[:, None]
        valid = (owner[tok][None, :] == rows) & (pos[tok][None, :] < lens)
    else:
        if membership is None:
            membership = pool_membership(block_tables, seq_lens, pool_pages,
                                         ps)
        j = membership.to(dev).long()[:, tok // ps]           # [b, tokens]
        valid = (j >= 0) & (j * ps + tok % ps < lens)
    valid = (valid & in_region).reshape(b, 1, 1, nch, chunk)
    qh = q.to(dt).float().reshape(b, n_kv, g, d)
    s = torch.einsum("bngd,ntd->bngt", qh, k).reshape(
        b, n_kv, g, nch, chunk) * (d ** -0.5)
    m = torch.where(valid, s, _NEG).amax(-1)                  # [b,n,g,nch]
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bngck,nckd->bngcd",
                       p.to(dt).float() if round_p else p,
                       v.reshape(n_kv, nch, chunk, d))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (w[..., None] * acc).sum(-2) \
        / torch.clamp((w * l).sum(-1), min=1e-30)[..., None]
    return out.reshape(b, n_q, d).to(q.dtype)


def _fused_paged_plain(q, key_cache, value_cache, seq_lens, block_tables,
                       skip_last_page=False):
    """Plain version of B8 (the JAX ``_fused_paged``): each row walks its
    table's pages in order with an f32 online softmax per page (q scaled
    in f32, masked past ``seq_lens``), ``out = acc / max(l, 1e-30)``; a
    row that attends nothing gets 0. ``block_tables`` hold ABSOLUTE ids.
    ``skip_last_page`` leaves out each row's last page that holds an
    attended token (the chip check's control)."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = key_cache.shape
    pp = block_tables.shape[1]
    g = n_q // n_kv
    dev = q.device
    lens = seq_lens.to(dev).long()
    last = torch.clamp(lens - 1, min=0) // ps
    qf = q.float().reshape(b, n_kv, g, d) * (d ** -0.5)
    m = torch.full((b, n_kv, g, 1), _NEG, device=dev)
    l = torch.zeros((b, n_kv, g, 1), device=dev)
    acc = torch.zeros((b, n_kv, g, d), device=dev)
    slot = torch.arange(ps, device=dev)
    for pg in range(pp):
        ids = block_tables[:, pg].long()
        k, v = key_cache[ids].float(), value_cache[ids].float()
        logits = torch.einsum("bngd,bnsd->bngs", qf, k)
        valid = pg * ps + slot[None, :] < lens[:, None]
        if skip_last_page:
            valid = valid & (last != pg)[:, None]
        valid = valid[:, None, None, :]
        logits = torch.where(valid, logits, _NEG)
        pm = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - pm)
        w = torch.where(valid, torch.exp(logits - pm), 0.0)
        l = l * alpha + w.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bngs,bnsd->bngd", w, v)
        m = pm
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, n_q, d).to(q.dtype)


def _pallas_paged_plain(q, key_cache, value_cache, seq_lens, block_tables,
                        skip_last_page=False):
    """Plain version of B9 (the stock paged attention kernel behind the JAX
    ``_pallas_paged``): q scaled in f32; for each compute block of
    ``_pallas_ppcb`` pages that starts below the row's length, ``s = q
    k`` plus the mask value past the length, ``m_cur = max s``, ``p =
    exp(s - m_cur)``, ``l_cur = sum p``, ``o_cur = p V``, and the
    renormalising update ``o = (l_prev a o + b o_cur) / l_next`` with
    ``a = exp(m_prev - m_next)``, ``b = exp(m_cur - m_next)``, ``l_next =
    a l_prev + b l_cur``. A row of length 0 runs no block: 0.
    ``block_tables`` hold ABSOLUTE ids; K and V are read in the pool's
    dtype (the stock kernel rounds an f32 pool's pages to bf16; the port
    keeps f32). ``skip_last_page`` as in ``_fused_paged_plain``."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = key_cache.shape
    pp = block_tables.shape[1]
    g = n_q // n_kv
    dev = q.device
    ppcb = _pallas_ppcb(pp, ps)
    bk = ppcb * ps
    lens = seq_lens.to(dev).long()
    last = torch.clamp(lens - 1, min=0) // ps
    qf = q.float().reshape(b, n_kv, g, d) * (d ** -0.5)
    m_prev = torch.full((b, n_kv, g, 1), -float("inf"), device=dev)
    l_prev = torch.zeros((b, n_kv, g, 1), device=dev)
    o = torch.zeros((b, n_kv, g, d), device=dev)
    tok = torch.arange(bk, device=dev)
    for i in range(pp // ppcb):
        ids = block_tables[:, i * ppcb:(i + 1) * ppcb].long()   # [b, ppcb]

        def side(pool):
            return pool[ids].float().permute(0, 2, 1, 3, 4).reshape(
                b, n_kv, bk, d)
        k, v = side(key_cache), side(value_cache)
        qk = torch.einsum("bngd,bntd->bngt", qf, k)
        mask = i * bk + tok[None, :] < lens[:, None]
        if skip_last_page:
            mask = mask & (i * ppcb + tok[None, :] // ps != last[:, None])
        qk = qk + torch.where(mask, 0.0, _MASK_VALUE)[:, None, None, :]
        m_cur = qk.amax(-1, keepdim=True)
        p = torch.exp(qk - m_cur)
        l_cur = p.sum(-1, keepdim=True)
        m_next = torch.maximum(m_prev, m_cur)
        alpha = torch.exp(m_prev - m_next)
        beta = torch.exp(m_cur - m_next)
        l_next = alpha * l_prev + beta * l_cur
        o_cur = torch.einsum("bngt,bntd->bngd", p, v)
        o_new = (l_prev * alpha * o + beta * o_cur) / l_next
        active = (i * bk < lens)[:, None, None, None]
        o = torch.where(active, o_new, o)
        m_prev = torch.where(active, m_next, m_prev)
        l_prev = torch.where(active, l_next, l_prev)
    return o.reshape(b, n_q, d).to(q.dtype)


def _check_backend_operands(what, q, key_cache, value_cache, seq_lens,
                            block_tables, head_dims, tables_cols=None):
    """The kernels' operand contract; raises on what they do not take."""
    if q.dim() != 3 or key_cache.dim() != 4:
        raise ValueError(f"{what}: q must be [b, n_q, d] and the pools "
                         "[pages, n_kv, page_size, d]")
    b, n_q, d = q.shape
    _, n_kv, ps, d_pool = key_cache.shape
    if (n_kv == 0 or n_q % n_kv or n_q // n_kv > 8 or d_pool != d
            or value_cache.shape != key_cache.shape):
        raise ValueError(
            f"{what}: needs n_q a multiple of n_kv with a group of at most "
            f"8 and pools of q's head_dim alike; got q {tuple(q.shape)}, "
            f"pool {tuple(key_cache.shape)}")
    if d not in head_dims:
        raise NotImplementedError(
            f"{what}: head_dim {d}: the CUDA kernel is built for "
            f"{head_dims}")
    if tuple(seq_lens.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b \
            or (tables_cols is not None
                and block_tables.shape[1] != tables_cols):
        raise ValueError(f"{what}: seq_lens must be [b] and the tables "
                         f"[b, {tables_cols or 'pages_per_seq'}]")
    for name, t in (("key_cache", key_cache), ("value_cache", value_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}; "
                            "the kernel takes one dtype")
    for name, t in (("seq_lens", seq_lens), ("tables", block_tables)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32")
    for t in (q, key_cache, value_cache, seq_lens, block_tables):
        if t.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")
    return _kernels.dtype_code(q, what)


def stream_paged(q, key_cache, value_cache, seq_lens, block_tables,
                 pool_base=None, pool_pages=None, membership=None):
    """Kernel B7, pool-streaming decode attention over the layer region
    ``[pool_base, pool_base + pool_pages)`` (default: the whole pool)
    that the LAYER-LOCAL ``block_tables`` index; ``membership`` is a
    precomputed ``pool_membership`` (built here when None). On a CUDA
    tensor, head_dim 128 or 256, two launches: the partials (bf16:
    ``stream_walk``'s runs of chunks, a state per block and row; f32: one
    per 64-token chunk and kv head), then their merge; on a CPU tensor
    the plain version ``_stream_paged_plain``."""
    what = "stream_paged"
    ps = key_cache.shape[2]
    base, region = _layer_region(what, key_cache.shape[0], pool_base,
                                 pool_pages)
    if membership is None:
        membership = pool_membership(block_tables, seq_lens, region, ps)
    if not _on_card(q):
        return _stream_paged_plain(q, key_cache, value_cache, seq_lens,
                                   block_tables, base, region, membership)
    dt = _check_backend_operands(what, q, key_cache, value_cache, seq_lens,
                                 membership, (128, 256), region)
    b, n_q, d = q.shape
    n_kv = key_cache.shape[1]
    g = n_q // n_kv
    if q.dtype == torch.bfloat16:
        blocks, cpb, run_pages, _ = stream_walk(b, g, n_kv, region, ps,
                                                _sm_count(q.device))
    else:
        blocks, cpb, run_pages = -(-region * ps // STREAM_KERNEL_CHUNK), 1, 1
    # f32 (m, l) pairs, then the unnormalised outputs, a partial a row
    ws = torch.empty(n_kv * blocks * b * g * (d + 2), dtype=torch.float32,
                     device=q.device)
    ws_acc = ws[n_kv * blocks * b * g * 2:]
    out = torch.empty_like(q)
    fn = _kernels.lib("paged_backends").ptt_paged_stream
    _kernels.check(fn(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        seq_lens.data_ptr(), membership.data_ptr(), ws.data_ptr(),
        ws_acc.data_ptr(), out.data_ptr(), dt, b, n_q, n_kv, d, ps, base,
        region, blocks, cpb, run_pages, d ** -0.5,
        _kernels.stream_ptr(q.device)), what)
    global stream_launches
    stream_launches += 2
    return out


def _paged_kernel(what, fn_name, q, key_cache, value_cache, seq_lens,
                  block_tables, extra=()):
    """Launch B8 or B9 over ABSOLUTE tables; returns the output.
    ``extra``: the arguments after ``num_pages`` (B9: its ``ppcb``), then
    the workspace and split of ``_decode_split``."""
    dt = _check_backend_operands(what, q, key_cache, value_cache, seq_lens,
                                 block_tables, BACKEND_HEAD_DIMS)
    b, n_q, d = q.shape
    P, n_kv, ps, _ = key_cache.shape
    if ps % 16:
        raise ValueError(f"{what}: page_size {ps} must be a multiple of 16 "
                         "(the kernel's 16-token slices)")
    n_split, ws = _decode_split(q, b, n_kv, d, block_tables.shape[1] * ps,
                                mma=True)
    out = torch.empty_like(q)
    fn = getattr(_kernels.lib("paged_backends"), fn_name)
    _kernels.check(fn(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        seq_lens.data_ptr(), block_tables.data_ptr(), out.data_ptr(), dt, b,
        n_q, n_kv, d, ps, block_tables.shape[1], P, *extra,
        _kernels.ptr(ws), n_split, d ** -0.5,
        _kernels.stream_ptr(q.device)), what)
    return out


def fused_paged(q, key_cache, value_cache, seq_lens, block_tables):
    """Kernel B8, decode attention over ABSOLUTE ``block_tables`` with no
    current token; on a CPU tensor the plain version ``_fused_paged_plain``.
    On the card bf16 runs B1's tile walk (a block of 4 warps a (row, kv
    head), or a split of its tiles by ``decode_q_plan``, one launch with
    a workspace when it splits); f32 one block a row."""
    if not _on_card(q):
        return _fused_paged_plain(q, key_cache, value_cache, seq_lens,
                                  block_tables)
    out = _paged_kernel("fused_paged", "ptt_paged_fused", q, key_cache,
                        value_cache, seq_lens, block_tables)
    global fused_launches
    fused_launches += 1
    return out


def pallas_paged(q, key_cache, value_cache, seq_lens, block_tables):
    """Kernel B9, the stock paged attention kernel's function over
    ABSOLUTE ``block_tables``, reading the page-major pool in place; on a
    CPU tensor the plain version ``_pallas_paged_plain`` (the stock
    schedule: compute blocks of ``_pallas_ppcb`` pages, the renormalising
    update). On the card bf16 runs B8's tile walk under its own name
    (``pallas_paged_mma``: a block of 4 warps a (row, kv head), or a split
    of its tiles by ``decode_q_plan``, one launch with a workspace when it
    splits); f32 keeps the compute blocks, one block a (row, kv head)."""
    if not _on_card(q):
        return _pallas_paged_plain(q, key_cache, value_cache, seq_lens,
                                   block_tables)
    ppcb = _pallas_ppcb(block_tables.shape[1], key_cache.shape[2])
    out = _paged_kernel("pallas_paged", "ptt_paged_pallas", q, key_cache,
                        value_cache, seq_lens, block_tables, (ppcb,))
    global pallas_launches
    pallas_launches += 1
    return out


def paged_attention(q, key_cache, value_cache, seq_lens, block_tables,
                    pool_base=None, pool_pages=None, ownership=None):
    """Single-token decode attention over a paged KV cache: row ``r``
    attends its ``seq_lens[r]`` cached tokens through its block table.

    ``pool_base``/``pool_pages`` describe a layer-folded pool: the tables
    hold LAYER-LOCAL ids and the layer's region starts at physical page
    ``pool_base`` (defaults: the whole pool). ``ownership``: a
    precomputed ``pool_membership`` map, for the ``stream`` backend.

    ``FLAGS_paged_attention_backend``: ``auto`` takes ``stream`` on a
    CUDA tensor when head_dim is a multiple of 128 and ``pool_base`` is
    given, else ``fused``; on a CPU tensor ``xla``. ``stream`` (B7) needs
    head_dim % 128 == 0 and drops a table id outside the region;
    ``fused`` (B8), ``pallas`` (B9) and ``xla`` (the plain gather, CPU
    only) read the absolute page ``pool_base + id``, which must lie in
    the pool. Each backend treats a row of length 0 as its reference
    function does: 0 for the kernels, the mean of the table's V rows for
    ``xla``."""
    backend = backend_flag()
    d = q.shape[-1]
    on_card = q.device.type == "cuda"
    if backend == "auto":
        if on_card:
            backend = "stream" if (d % 128 == 0 and pool_base is not None) \
                else "fused"
        else:
            backend = "xla"
    if backend == "stream":
        check_stream_head_dim(d)
        _LAST_BACKEND[0] = "stream"
        return stream_paged(q, key_cache, value_cache, seq_lens,
                            block_tables, pool_base=pool_base,
                            pool_pages=pool_pages, membership=ownership)
    if backend == "xla" and on_card:
        raise ValueError(
            "FLAGS_paged_attention_backend='xla' names the plain gather, "
            "which runs on the CPU only; on the card the kernels of "
            "csrc/paged_backends.cu serve 'stream', 'fused' and 'pallas'")
    tables = block_tables if pool_base is None else block_tables + pool_base
    _LAST_BACKEND[0] = backend
    if backend == "pallas":
        return pallas_paged(q, key_cache, value_cache, seq_lens, tables)
    if backend == "fused":
        return fused_paged(q, key_cache, value_cache, seq_lens, tables)
    return paged_attention_plain(q, key_cache, value_cache, seq_lens, tables)
