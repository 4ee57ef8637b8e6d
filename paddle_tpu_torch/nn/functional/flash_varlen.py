"""Varlen flash attention: the packed training kernels and paged prefill.

Counterpart of ``paddle_tpu/nn/functional/flash_varlen.py``, both halves.

**Packed** (``flash_varlen_packed``, the ``flash_attn_unpadded`` path): a
packed batch ``[total_tokens, heads, head_dim]`` whose segments are cut by
``cu_seqlens`` offsets. Key κ is visible from query ι iff both lie in the
same segment and, under ``causal``, ι's in-segment position is at least
κ's. ``varlen_block_map`` turns ``cu_seqlens`` into the visit intervals
(q tile i visits k tiles ``kstart[i] .. +klen[i]``; k tile j is visited by
q tiles ``qstart2[j] .. +qlen2[j]``) and the per-tile segment aggregates,
with torch ops on ``cu_seqlens``' device and no host read; every field
equals the JAX map's. ``PackedFlashFunction`` (the JAX ``_packed_core``
custom VJP) runs, on a CUDA tensor, kernel B11 (forward: ``out`` and an
f32 ``lse``) and, in its backward, ``delta = sum(dout * out)`` as a
PyTorch reduction, then B12 (dq over the forward map) and B13 (dk, dv
over the transposed map), all in ``csrc/flash_varlen_packed.cu``; on a
CPU tensor it runs the plain versions ``_packed_fwd_plain`` and
``_packed_bwd_plain``, the tile walks of the JAX ``_packed_fwd_xla`` and
``_packed_bwd_xla`` in f32 and O(T·d) memory (no ``[T, T]`` tensor). A
query that sees no key gets ``out = 0`` and ``lse = -1e30``, as in the
reference. ``backend`` takes the JAX values: ``auto`` and ``pallas`` run
the kernels on a CUDA tensor and the plain versions on a CPU tensor;
``interpret`` and ``xla`` name plain versions, which run on the CPU only
and raise for a CUDA tensor.

**Paged** (``paged_prefill_attention``): chunked prefill over the paged
KV pool. The queries of a prompt chunk attend, causally, the sequence's
cached pages (previous chunks, prefix pages shared with other requests)
and the chunk's own K/V, all read IN PLACE from the page-major pool
through the block table, with the JAX package's layouts:

  q            [batch, chunk, num_q_heads, head_dim]   kv-major heads
  key_cache    [num_pages, num_kv_heads, page_size, head_dim]
  value_cache  [num_pages, num_kv_heads, page_size, head_dim]
  block_tables [batch, pages_per_seq] int32            ABSOLUTE page ids
  start        [batch] int32                           chunk offsets

``paged_prefill_attention`` launches ``csrc/flash_varlen.cu`` on a CUDA
tensor and runs its plain version ``_paged_prefill_plain`` on a CPU
tensor. A bf16 pool at a head_dim of ``PREFILL_MMA_HEAD_DIMS`` takes the
tensor-core kernel, whose grid ``prefill_grid`` sizes from the shapes and
the card's SM count: q tiles of 64 query vectors, each tile's key range
cut into ``n_split`` slices merged in the kernel. An int8 pool (each side
``(int8 rows, f32 scale plane)``) has no kernel, as in the JAX package,
where it is XLA's dense gather: the plain version dequantizes it, on the
card too.
"""
from __future__ import annotations

import dataclasses

import torch

from ... import _kernels

__all__ = ["paged_prefill_attention", "prefill_grid", "varlen_block_map",
           "BlockMap", "PREFILL_MMA_HEAD_DIMS",
           "flash_varlen_packed", "PackedFlashFunction", "packed_fwd",
           "packed_bwd", "packed_fwd_plain", "packed_bwd_plain",
           "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K", "VARLEN_HEAD_DIMS"]


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

#: head dims of the tensor-core kernel (bf16); an f32 pool or another
#: head_dim takes the CUDA-core kernel
PREFILL_MMA_HEAD_DIMS = (64, 96, 128, 256)
#: query vectors (chunk rows x the g heads of a kv head) a block owns
PREFILL_Q_VECTORS = 64
_PREFILL_MAX_SPLIT = 16


def prefill_grid(b: int, c: int, n_kv: int, g: int, span: int, d: int,
                 sms: int) -> tuple:
    """``(q_tiles, n_split, blocks)`` of the tensor-core kernel: a block
    owns 64 query vectors (``64 // g`` chunk rows) of one kv head and one
    of ``n_split`` slices of their key range. ``n_split`` is as many
    slices as keep two blocks on each of the card's ``sms`` SMs, at most
    16, each at least two key tiles of the widest walk (``span``, the
    table's positions); 1 when the q tiles alone fill the card."""
    q_tiles = -(-c // (PREFILL_Q_VECTORS // g))
    base = q_tiles * n_kv * b
    widest = -(-span // (32 if d > 128 else 64))  # key tiles of the walk
    n_split = max(1, min(2 * sms // base, widest // 2, _PREFILL_MAX_SPLIT))
    return q_tiles, n_split, base * n_split


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if not _on_card(q):
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
    n_split, ws = 1, None
    if q.dtype == torch.bfloat16 and d in PREFILL_MMA_HEAD_DIMS:
        q_tiles, n_split, _ = prefill_grid(b, c, n_kv, n_q // n_kv, pp * ps,
                                           d, _sm_count(q.device))
        if n_split > 1:
            # f32 partials (outputs, then m and l) and an int32 counter a
            # q tile (zeroed by the launch)
            tiles = q_tiles * n_kv * b
            ws = torch.empty(tiles * n_split * PREFILL_Q_VECTORS * (d + 2)
                             + tiles, dtype=torch.float32, device=q.device)
    fn = _kernels.lib("flash_varlen").ptt_paged_prefill_attention
    _kernels.check(fn(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        _kernels.ptr(ws), dt, b, c, n_q, n_kv, d, ps, pp, P, n_split, scale,
        _kernels.stream_ptr(q.device)), what)
    global launches
    launches += 1
    return out


# ---------------------------------------------------------------------
# Packed varlen flash attention: block map
# ---------------------------------------------------------------------

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_NEG = -1e30          # masked score; lse of a row that sees no key
_NEG_SAFE = -5e29     # lse floor in the backward: exp(_NEG - it) is 0
#: head dims the CUDA kernels are built for; another multiple of 8 below
#: 256 runs zero-padded to the next of them, a wider head raises on the
#: card
VARLEN_HEAD_DIMS = (64, 96, 128, 256)
#: the kernels' tiles, (q rows, keys), of the forward and dq walks and of
#: the dk/dv walk, by dtype; lse, delta and the per-token metadata are
#: padded to a multiple of 64 rows, a whole number of every tile
_CARD_TILES = {torch.bfloat16: ((64, 64), (32, 64)),
               torch.float32: ((32, 32), (32, 32))}
_CARD_PAD = 64
_BACKENDS = ("auto", "pallas", "interpret", "xla")

#: launches of B11, B12 and B13, counted after each returns without an
#: error (plain CPU calls do not count)
fwd_varlen_launches = 0
dq_varlen_launches = 0
dkv_varlen_launches = 0


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass
class BlockMap:
    """The JAX ``BlockMap``: per-tile visit intervals and segment
    aggregates, int32 tensors on ``cu_seqlens``' device.

    Forward map: q tile ``i`` visits k tiles ``kstart[i] ..
    kstart[i]+klen[i]-1``. Transposed map (the dk/dv walk): k tile ``j``
    is visited by q tiles ``qstart2[j] .. qstart2[j]+qlen2[j]-1``.
    ``qshi``/``kshi`` take the segment of a tile's LAST row, pad rows
    included (the phantom segment ``nseg``), so a partly padded tile is
    never interior. ``n_active = sum(klen)`` counts the visited tiles.
    """
    kstart: torch.Tensor   # [nq]
    klen: torch.Tensor     # [nq]
    qslo: torch.Tensor     # [nq] segment of the tile's first row
    qshi: torch.Tensor     # [nq] segment of its last row
    qpos0: torch.Tensor    # [nq] in-segment position of its first row
    kslo: torch.Tensor     # [nk]
    kshi: torch.Tensor     # [nk]
    kmax: torch.Tensor     # [nk] in-segment position of its last row
    qstart2: torch.Tensor  # [nk]
    qlen2: torch.Tensor    # [nk]
    qmeta: torch.Tensor    # [2, tq_pad]: segment, in-segment position
    kmeta: torch.Tensor    # [2, tk_pad]
    n_active: torch.Tensor  # scalar


def _take(a, idx):
    """``a[idx]`` with the index clamped into range, as a JAX gather."""
    return a[idx.clamp(0, a.shape[0] - 1).long()]


def _seg_pos(cu, total_pad: int):
    """Per-token (segment, in-segment position) of a padded packed axis.
    Tokens past ``cu[-1]`` land in the phantom segment ``nseg``."""
    pos = torch.arange(total_pad, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True,
                             out_int32=True)
    return seg, pos - _take(cu, seg)


def varlen_block_map(cu_q, cu_k, total_q_pad: int, total_k_pad: int,
                     block_q: int, block_k: int, causal: bool) -> BlockMap:
    """The block-skipping visit map of ``cu_seqlens`` (int ``[nseg+1]``
    offsets) over axes padded to ``total_*_pad`` (whole tiles), built
    with torch ops on the offsets' device: nothing is read back to the
    host. Every field equals the JAX ``varlen_block_map``'s."""
    cu_q = torch.as_tensor(cu_q).to(torch.int32)
    cu_k = torch.as_tensor(cu_k).to(torch.int32)
    dev = cu_q.device
    nseg = cu_q.shape[0] - 1
    nq, nk = total_q_pad // block_q, total_k_pad // block_k
    tqr, tkr = cu_q[nseg], cu_k[nseg]        # real token counts, on device
    cu_k_ext = torch.cat([cu_k, tkr[None]])  # segment nseg is empty
    cu_q_ext = torch.cat([cu_q, tqr[None]])
    seg_q, off_q = _seg_pos(cu_q, total_q_pad)
    seg_k, off_k = _seg_pos(cu_k, total_k_pad)

    # forward map: per q tile, the contiguous k-tile interval
    row_lo = torch.arange(nq, dtype=torch.int32, device=dev) * block_q
    row_hi = torch.minimum((row_lo + block_q - 1).clamp(min=0),
                           (tqr - 1).clamp(min=0))   # last REAL row
    row_hi = torch.maximum(row_hi, row_lo)
    qslo = _take(seg_q, row_lo.clamp(max=total_q_pad - 1))
    qshi_c = _take(seg_q, row_hi)
    qshi = _take(seg_q, (row_lo + block_q - 1).clamp(max=total_q_pad - 1))
    qpos0 = _take(off_q, row_lo.clamp(max=total_q_pad - 1))
    kstart_tok = _take(cu_k, qslo.clamp(max=nseg))
    kend_tok = _take(cu_k_ext, qshi_c.clamp(max=nseg) + 1)
    if causal:
        lim = _take(cu_k, qshi_c.clamp(max=nseg)) \
            + (row_hi - _take(cu_q, qshi_c.clamp(max=nseg))) + 1
        kend_tok = torch.minimum(kend_tok, torch.maximum(lim, kstart_tok))
    kstart = kstart_tok // block_k
    klen = (_cdiv(kend_tok, block_k) - kstart).clamp(min=0)
    klen = torch.where(row_lo < tqr, klen, 0)
    kstart = kstart.clamp(max=max(nk - 1, 0))

    # per-k-tile aggregates
    col_lo = torch.arange(nk, dtype=torch.int32, device=dev) * block_k
    col_hi = torch.minimum((col_lo + block_k - 1).clamp(min=0),
                           (tkr - 1).clamp(min=0))
    col_hi = torch.maximum(col_hi, col_lo)
    col_hi_raw = (col_lo + block_k - 1).clamp(max=total_k_pad - 1)
    kslo = _take(seg_k, col_lo.clamp(max=total_k_pad - 1))
    kshi_c = _take(seg_k, col_hi)
    kshi = _take(seg_k, col_hi_raw)
    kmax = _take(off_k, col_hi_raw)

    # transposed map: per k tile, the attending q-tile interval
    qstart_tok = _take(cu_q, kslo.clamp(max=nseg))
    if causal:
        # the first attending row of the tile's first segment sits at the
        # tile's first in-segment key position, inside the segment
        qstart_tok = torch.minimum(
            qstart_tok + _take(off_k, col_lo.clamp(max=total_k_pad - 1)),
            _take(cu_q_ext, kslo.clamp(max=nseg) + 1))
    qend_tok = _take(cu_q_ext, kshi_c.clamp(max=nseg) + 1)
    qstart2 = qstart_tok // block_q
    qlen2 = (_cdiv(qend_tok, block_q) - qstart2).clamp(min=0)
    qlen2 = torch.where(col_lo < tkr, qlen2, 0)
    qstart2 = qstart2.clamp(max=max(nq - 1, 0))

    i32 = torch.int32
    return BlockMap(
        kstart=kstart.to(i32), klen=klen.to(i32), qslo=qslo, qshi=qshi,
        qpos0=qpos0, kslo=kslo, kshi=kshi, kmax=kmax,
        qstart2=qstart2.to(i32), qlen2=qlen2.to(i32),
        qmeta=torch.stack([seg_q, off_q]), kmeta=torch.stack([seg_k, off_k]),
        n_active=klen.sum(dtype=i32))


# ---------------------------------------------------------------------
# Plain versions of kernels B11-B13 (the JAX XLA tile walks)
# ---------------------------------------------------------------------

def _tile_mask(sq, pq, sk, pk, active, causal: bool):
    """``[n, bq, bk]`` visibility of n tile pairs from per-token
    (segment, position); inactive visit slots see nothing."""
    msk = sq[:, :, None] == sk[:, None, :]
    if causal:
        msk = msk & (pq[:, :, None] >= pk[:, None, :])
    return msk & active[:, None, None]


def _packed_fwd_plain(qt, kt, vt, bm: BlockMap, scale: float, causal: bool,
                      block_q: int, block_k: int):
    """The JAX ``_packed_fwd_xla``: ``qt``/``kt``/``vt`` ``[h, T_pad, d]``;
    every q tile takes visit slot s (k tile ``kstart + s``) together, with
    an online softmax in f32. Returns ``(out [h, tq_pad, d] f32, lse [h,
    tq_pad] f32)``. Memory O(T·block_k); the slot count is read back to
    the host (this version is not the card's path)."""
    h, tq, d = qt.shape
    tk = kt.shape[1]
    bq, bk = block_q, block_k
    nq, nk = tq // bq, tk // bk
    q4 = (qt.float() * scale).reshape(h, nq, bq, d)
    k4 = kt.float().reshape(h, nk, bk, d)
    v4 = vt.float().reshape(h, nk, bk, d)
    sq4, pq4 = bm.qmeta[0].reshape(nq, bq), bm.qmeta[1].reshape(nq, bq)
    sk4, pk4 = bm.kmeta[0].reshape(nk, bk), bm.kmeta[1].reshape(nk, bk)
    m = qt.new_full((h, nq, bq), _NEG, dtype=torch.float32)
    l = qt.new_zeros((h, nq, bq), dtype=torch.float32)
    acc = qt.new_zeros((h, nq, bq, d), dtype=torch.float32)
    for s in range(int(bm.klen.max()) if nq else 0):
        j = (bm.kstart + s).clamp(0, nk - 1).long()
        msk = _tile_mask(sq4, pq4, sk4[j], pk4[j], s < bm.klen, causal)[None]
        lg = torch.einsum("hnqd,hnkd->hnqk", q4, k4[:, j])
        lg = torch.where(msk, lg, _NEG)
        pm = torch.maximum(m, lg.amax(-1))
        alpha = torch.exp(m - pm)
        p = torch.exp(lg - pm[..., None]) * msk
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("hnqk,hnkd->hnqd", p,
                                                    v4[:, j])
        m = pm
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(h, tq, d)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)),
                      _NEG).reshape(h, tq)
    return out, lse


def _packed_bwd_plain(qt, kt, vt, dot_, lse, delta, bm: BlockMap,
                      scale: float, causal: bool, block_q: int,
                      block_k: int):
    """The JAX ``_packed_bwd_xla``: dq over the forward map, dk and dv
    over the transposed map, f32, from ``lse`` and ``delta`` ``[h,
    tq_pad]``. Returns ``(dq [h, tq_pad, d], dk, dv [h, tk_pad, d])``."""
    h, tq, d = qt.shape
    tk = kt.shape[1]
    bq, bk = block_q, block_k
    nq, nk = tq // bq, tk // bk
    qf4 = (qt.float() * scale).reshape(h, nq, bq, d)
    do4 = dot_.float().reshape(h, nq, bq, d)
    k4 = kt.float().reshape(h, nk, bk, d)
    v4 = vt.float().reshape(h, nk, bk, d)
    lse4 = lse.clamp(min=_NEG_SAFE).reshape(h, nq, bq)
    dl4 = delta.reshape(h, nq, bq)
    sq4, pq4 = bm.qmeta[0].reshape(nq, bq), bm.qmeta[1].reshape(nq, bq)
    sk4, pk4 = bm.kmeta[0].reshape(nk, bk), bm.kmeta[1].reshape(nk, bk)

    dq = qt.new_zeros((h, nq, bq, d), dtype=torch.float32)
    for s in range(int(bm.klen.max()) if nq else 0):
        j = (bm.kstart + s).clamp(0, nk - 1).long()
        msk = _tile_mask(sq4, pq4, sk4[j], pk4[j], s < bm.klen, causal)[None]
        ktile = k4[:, j]
        lg = torch.where(msk, torch.einsum("hnqd,hnkd->hnqk", qf4, ktile),
                         _NEG)
        p = torch.exp(lg - lse4[..., None]) * msk
        dp = torch.einsum("hnqd,hnkd->hnqk", do4, v4[:, j])
        ds = p * (dp - dl4[..., None])
        dq = dq + torch.einsum("hnqk,hnkd->hnqd", ds, ktile)
    dq = (dq * scale).reshape(h, tq, d)

    dk = qt.new_zeros((h, nk, bk, d), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for s in range(int(bm.qlen2.max()) if nk else 0):
        t = (bm.qstart2 + s).clamp(0, nq - 1).long()
        msk = _tile_mask(sq4[t], pq4[t], sk4, pk4, s < bm.qlen2,
                         causal)[None]
        qtile, dtile = qf4[:, t], do4[:, t]
        lg = torch.where(msk, torch.einsum("hnqd,hnkd->hnqk", qtile, k4),
                         _NEG)
        p = torch.exp(lg - lse4[:, t][..., None]) * msk
        dv = dv + torch.einsum("hnqk,hnqd->hnkd", p, dtile)
        dp = torch.einsum("hnqd,hnkd->hnqk", dtile, v4)
        ds = p * (dp - dl4[:, t][..., None])
        dk = dk + torch.einsum("hnqk,hnqd->hnkd", ds, qtile)
    return dq, dk.reshape(h, tk, d), dv.reshape(h, tk, d)


def _pad_rows(x, target: int, value=0.0):
    """``x`` ``[h, n, ...]`` padded (or cut) along axis 1 to ``target``."""
    n = x.shape[1]
    if n == target:
        return x
    if n > target:
        return x[:, :target]
    pad = x.new_full((x.shape[0], target - n, *x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def _packed_prepare(q, k, v, cu_q, cu_k, causal: bool, bq: int, bk: int):
    """The JAX ``_packed_prepare``: ``[h, T_pad, d]`` copies padded to
    whole tiles, and the block map at ``(bq, bk)``."""
    tq, tk = q.shape[0], k.shape[0]
    tqp, tkp = _cdiv(tq, bq) * bq, _cdiv(tk, bk) * bk
    qt = _pad_rows(q.transpose(0, 1), tqp)
    kt = _pad_rows(k.transpose(0, 1), tkp)
    vt = _pad_rows(v.transpose(0, 1), tkp)
    return qt, kt, vt, varlen_block_map(cu_q, cu_k, tqp, tkp, bq, bk, causal)


def packed_delta(out, dout, t_pad: int):
    """``delta = sum(dout * out)`` over the head dim, f32 ``[h, t_pad]``
    (pad rows 0): a PyTorch reduction beside the backward kernels."""
    return _pad_rows((out.float() * dout.float()).sum(-1).t(),
                     t_pad).contiguous()


def packed_fwd_plain(q, k, v, cu_q, cu_k, *, scale: float, causal: bool,
                     block_q: int = DEFAULT_BLOCK_Q,
                     block_k: int = DEFAULT_BLOCK_K):
    """``(out [tq, h, d] in q's dtype, lse [h, tq_pad] f32)`` of packed
    ``[t, h, d]`` operands by ``_packed_fwd_plain``."""
    qt, kt, vt, bm = _packed_prepare(q, k, v, cu_q, cu_k, causal, block_q,
                                     block_k)
    out, lse = _packed_fwd_plain(qt, kt, vt, bm, scale, causal, block_q,
                                 block_k)
    return out[:, :q.shape[0]].transpose(0, 1).to(q.dtype), lse


def packed_bwd_plain(q, k, v, out, lse, dout, cu_q, cu_k, *, scale: float,
                     causal: bool, block_q: int = DEFAULT_BLOCK_Q,
                     block_k: int = DEFAULT_BLOCK_K):
    """``(dq, dk, dv)`` in the inputs' dtypes by ``_packed_bwd_plain``;
    ``lse`` ``[h, >= tq]`` from either forward (its pad rows are not
    read for any real row)."""
    tq, tk = q.shape[0], k.shape[0]
    qt, kt, vt, bm = _packed_prepare(q, k, v, cu_q, cu_k, causal, block_q,
                                     block_k)
    tqp = qt.shape[1]
    dot_ = _pad_rows(dout.transpose(0, 1), tqp)
    lse = _pad_rows(lse[:, :tq], tqp, _NEG)
    dq, dk, dv = _packed_bwd_plain(qt, kt, vt, dot_, lse,
                                   packed_delta(out, dout, tqp), bm, scale,
                                   causal, block_q, block_k)
    return (dq[:, :tq].transpose(0, 1).to(q.dtype),
            dk[:, :tk].transpose(0, 1).to(k.dtype),
            dv[:, :tk].transpose(0, 1).to(v.dtype))


# ---------------------------------------------------------------------
# Kernels B11-B13
# ---------------------------------------------------------------------

def _on_card(t) -> bool:
    return t.device.type == "cuda"


def kernel_head_dim(d: int, built, what: str) -> int:
    """The built kernel width that serves head_dim ``d``: ``d`` itself,
    or for another multiple of 8 below the widest the next built width,
    to which the caller zero-pads the head axis (exact: zero columns add
    nothing to q.k and give zero columns of the outputs and gradients).
    Another head raises: the flash kernels keep a warp's 16 x head_dim
    output in registers, which at 256 already takes half of a thread's
    255; a wider head needs the output split across warps or passes."""
    if d % 8 == 0:
        for w in built:
            if d <= w:
                return w
        raise NotImplementedError(
            f"{what}: head_dim {d}: the CUDA kernels are built for {built} "
            f"and take any multiple of 8 up to {max(built)} zero-padded; a "
            "wider head needs its register-held output split across warps "
            "or passes, and no model the repo supports uses one (ROADMAP.md "
            "queue C)")
    raise NotImplementedError(
        f"{what}: head_dim {d} is not a multiple of 8: the kernels copy "
        "rows in 16-byte pieces and take k in steps of 16; the flash "
        "route admits multiples of 8 only")


def pad_head(t, width: int):
    """``t`` with its last axis zero-padded to ``width``."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def padded_fwd(fwd, built, what: str, q, k, v, *rest):
    """``fwd(q, k, v, *rest) -> (out, lse)`` at the kernels' built head
    width (``kernel_head_dim`` of ``built``): q, k and v zero-padded,
    the caller's (true) scale in ``rest``, ``out`` sliced back; ``lse``
    is unchanged."""
    d = q.shape[-1]
    w = kernel_head_dim(d, built, what)
    if w == d:
        return fwd(q, k, v, *rest)
    out, lse = fwd(pad_head(q, w), pad_head(k, w), pad_head(v, w), *rest)
    return out[..., :d], lse


def padded_bwd(bwd, built, what: str, q, k, v, out, lse, dout, *rest):
    """``bwd(q, k, v, out, lse, dout, *rest) -> (dq, dk, dv)`` at the
    built head width as ``padded_fwd``: q, k, v, out and dout
    zero-padded, dq, dk and dv sliced back (their padded columns are
    0)."""
    d = q.shape[-1]
    w = kernel_head_dim(d, built, what)
    if w == d:
        return bwd(q, k, v, out, lse, dout, *rest)
    q, k, v, out, dout = (pad_head(t, w) for t in (q, k, v, out, dout))
    return tuple(t[..., :d] for t in bwd(q, k, v, out, lse, dout, *rest))


def _card_pad(n: int) -> int:
    return _cdiv(n, _CARD_PAD) * _CARD_PAD


def _check_packed(what, q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape[1:] != q.shape[1:] \
            or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must be [t, h, d] with one "
                         "h and d")
    tq, h, d = q.shape
    if d not in VARLEN_HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: head_dim {d}: the CUDA kernels are built for "
            f"{VARLEN_HEAD_DIMS} (packed_fwd/bwd pad to them)")
    if tq == 0 or k.shape[0] == 0:
        raise ValueError(f"{what}: empty packed batch (tq {tq}, tk "
                         f"{k.shape[0]})")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must share device and "
                             "dtype")
    _kernels.dtype_code(q, what)
    tile = _CARD_TILES[q.dtype][0][0]
    if max(_cdiv(tq, tile), _cdiv(k.shape[0], tile)) > 65535:
        raise ValueError(f"{what}: more than 65535 tiles of {tile} rows "
                         "(the grid's second axis)")


def _strided(t):
    """``t`` if its last axis is contiguous and its row and head strides
    keep 16-byte alignment, else a contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _card_map(cu_q, cu_k, tq: int, tk: int, dtype, causal: bool,
              transposed: bool):
    """``(map pointers, tq_pad, tk_pad, keep-alive)`` for a kernel: the
    block map at the kernel's tile, its 11 int32 arrays in the C order
    (order, start, len, qslo, qshi, qpos0, kslo, kshi, kmax, qmeta,
    kmeta), ``order`` the walked tiles longest walk first."""
    bq, bk = _CARD_TILES[dtype][int(transposed)]
    tqp, tkp = _card_pad(tq), _card_pad(tk)
    bm = varlen_block_map(cu_q, cu_k, tqp, tkp, bq, bk, causal)
    start, length = (bm.qstart2, bm.qlen2) if transposed else \
        (bm.kstart, bm.klen)
    order = torch.argsort(length, descending=True, stable=True) \
        .to(torch.int32)
    arrays = [t.contiguous() for t in (
        order, start, length, bm.qslo, bm.qshi, bm.qpos0, bm.kslo, bm.kshi,
        bm.kmax, bm.qmeta, bm.kmeta)]
    return [t.data_ptr() for t in arrays], tqp, tkp, arrays


def _shape_args(what, q, k, v, tqp, tkp, causal, scale):
    tq, h, d = q.shape
    return (_kernels.dtype_code(q, what), tq, k.shape[0], tqp, tkp, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), int(causal), float(scale),
            _kernels.stream_ptr(q.device))


def _varlen_fwd_cuda(q, k, v, cu_q, cu_k, causal: bool, scale: float):
    """B11: ``(out [tq, h, d], lse [h, tq_pad] f32)``, one launch."""
    what = "flash_varlen_packed forward"
    _check_packed(what, q, k, v)
    fn = _kernels.lib("flash_varlen_packed").ptt_flash_varlen_fwd
    q, k, v = _strided(q), _strided(k), _strided(v)
    ptrs, tqp, tkp, _keep = _card_map(cu_q, cu_k, q.shape[0], k.shape[0],
                                      q.dtype, causal, False)
    out = q.new_empty(q.shape)
    lse = q.new_empty((q.shape[1], tqp), dtype=torch.float32)
    _kernels.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), *ptrs,
                      *_shape_args(what, q, k, v, tqp, tkp, causal, scale)),
                   what)
    global fwd_varlen_launches
    fwd_varlen_launches += 1
    return out, lse


def _bwd_operands(what, q, k, v, dout, lse, delta):
    _check_packed(what, q, k, v)
    lib = _kernels.lib("flash_varlen_packed")
    tq, h, d = q.shape
    tqp = _card_pad(tq)
    if tuple(dout.shape) != (tq, h, d) or not dout.is_contiguous() \
            or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout must be contiguous {(tq, h, d)} in "
                         "q's dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (h, tqp) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous f32 "
                             f"{(h, tqp)}")
    return lib, _strided(q), _strided(k), _strided(v)


def _varlen_bwd_dq_cuda(q, k, v, dout, lse, delta, cu_q, cu_k, causal: bool,
                        scale: float):
    """B12: dq ``[tq, h, d]``, one launch over the forward map."""
    what = "flash_varlen_packed backward (dq)"
    lib, q, k, v = _bwd_operands(what, q, k, v, dout, lse, delta)
    ptrs, tqp, tkp, _keep = _card_map(cu_q, cu_k, q.shape[0], k.shape[0],
                                      q.dtype, causal, False)
    dq = q.new_empty(q.shape)
    _kernels.check(lib.ptt_flash_varlen_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *ptrs,
        *_shape_args(what, q, k, v, tqp, tkp, causal, scale)), what)
    global dq_varlen_launches
    dq_varlen_launches += 1
    return dq


def _varlen_bwd_dkv_cuda(q, k, v, dout, lse, delta, cu_q, cu_k,
                         causal: bool, scale: float):
    """B13: dk and dv ``[tk, h, d]``, one launch over the transposed
    map."""
    what = "flash_varlen_packed backward (dk, dv)"
    lib, q, k, v = _bwd_operands(what, q, k, v, dout, lse, delta)
    ptrs, tqp, tkp, _keep = _card_map(cu_q, cu_k, q.shape[0], k.shape[0],
                                      q.dtype, causal, True)
    dk = k.new_empty(k.shape)
    dv = v.new_empty(v.shape)
    _kernels.check(lib.ptt_flash_varlen_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *ptrs, *_shape_args(what, q, k, v, tqp, tkp, causal, scale)), what)
    global dkv_varlen_launches
    dkv_varlen_launches += 1
    return dk, dv


def _varlen_bwd_cuda(q, k, v, out, lse, dout, cu_q, cu_k, causal: bool,
                     scale: float):
    """``(dq, dk, dv)``: ``delta`` by a PyTorch reduction, then B12 and
    B13."""
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    delta = packed_delta(out, dout, lse.shape[1])
    dq = _varlen_bwd_dq_cuda(q, k, v, dout, lse, delta, cu_q, cu_k, causal,
                             scale)
    dk, dv = _varlen_bwd_dkv_cuda(q, k, v, dout, lse, delta, cu_q, cu_k,
                                  causal, scale)
    return dq, dk, dv


def _route(what: str, backend: str, t) -> str:
    """``kernel`` or ``plain``: a CPU tensor takes the plain version
    under every value; a CUDA tensor the kernels under ``auto`` and
    ``pallas``, and ``interpret`` or ``xla`` (plain versions) raise."""
    if backend not in _BACKENDS:
        raise ValueError(f"{what} backend={backend!r}: expected 'auto', "
                         "'pallas', 'interpret' or 'xla'")
    if not _on_card(t):
        return "plain"
    if backend in ("interpret", "xla"):
        raise ValueError(
            f"{what} backend={backend!r} names a plain version, which runs "
            "on the CPU only; on the card the kernels of "
            "csrc/flash_varlen_packed.cu serve every packing")
    return "kernel"


def packed_fwd(q, k, v, cu_q, cu_k, *, scale: float, causal: bool,
               block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
               backend: str = "auto"):
    """``(out, lse)``: B11 on a CUDA tensor (its own 64- or 32-row tiles;
    ``block_q``/``block_k`` tile the plain walk), the plain version on a
    CPU tensor."""
    if _route("flash_varlen_packed", backend, q) == "kernel":
        return padded_fwd(_varlen_fwd_cuda, VARLEN_HEAD_DIMS,
                          "flash_varlen_packed", q, k, v, cu_q, cu_k,
                          causal, scale)
    return packed_fwd_plain(q, k, v, cu_q, cu_k, scale=scale, causal=causal,
                            block_q=block_q, block_k=block_k)


def packed_bwd(q, k, v, out, lse, dout, cu_q, cu_k, *, scale: float,
               causal: bool, block_q: int = DEFAULT_BLOCK_Q,
               block_k: int = DEFAULT_BLOCK_K, backend: str = "auto"):
    """``(dq, dk, dv)``: ``delta`` by a PyTorch reduction, then B12 and
    B13 on a CUDA tensor (zero-padded as the forward); the plain version
    on a CPU tensor."""
    if _route("flash_varlen_packed", backend, q) == "kernel":
        return padded_bwd(_varlen_bwd_cuda, VARLEN_HEAD_DIMS,
                          "flash_varlen_packed", q, k, v, out, lse, dout,
                          cu_q, cu_k, causal, scale)
    return packed_bwd_plain(q, k, v, out, lse, dout, cu_q, cu_k, scale=scale,
                            causal=causal, block_q=block_q, block_k=block_k)


class PackedFlashFunction(torch.autograd.Function):
    """The JAX ``_packed_core`` custom VJP: the forward keeps ``out`` and
    the f32 ``lse``; the backward runs dq and dk/dv over the block map."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal: bool, scale: float,
                block_q: int, block_k: int, backend: str):
        out, lse = packed_fwd(q, k, v, cu_q, cu_k, scale=scale,
                              causal=causal, block_q=block_q,
                              block_k=block_k, backend=backend)
        ctx.save_for_backward(q, k, v, cu_q, cu_k, out, lse)
        ctx.args = dict(scale=scale, causal=causal, block_q=block_q,
                        block_k=block_k, backend=backend)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cu_q, cu_k, out, lse = ctx.saved_tensors
        dq, dk, dv = packed_bwd(q, k, v, out, lse, dout, cu_q, cu_k,
                                **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_varlen_packed(q, k, v, cu_seqlens_q, cu_seqlens_k, *, scale=None,
                        causal=False, block_q=None, block_k=None,
                        backend="auto"):
    """Segment-aware block-skipping flash attention over a packed batch.

    q/k/v: ``[total, heads, head_dim]``; ``cu_seqlens_*``: int ``[nseg+1]``
    offsets (moved to q's device; never read on the host). Returns
    ``[total_q, heads, head_dim]`` in q's dtype, differentiable through
    ``PackedFlashFunction`` (gradients in the inputs' dtypes).
    """
    bq = int(block_q or DEFAULT_BLOCK_Q)
    bk = int(block_k or DEFAULT_BLOCK_K)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    cu = []
    for c in (cu_seqlens_q, cu_seqlens_k):
        c = torch.as_tensor(c)
        if c.device != q.device:
            c = c.to(q.device)
        cu.append(c if c.dtype == torch.int32 else c.to(torch.int32))
    return PackedFlashFunction.apply(q, k, v, cu[0], cu[1], bool(causal),
                                     scale, bq, bk, backend)
