"""Parity of paddle_tpu_torch's paged decode attention with paddle_tpu's.

The same numpy inputs go through the JAX functions (the decode kernel
in Pallas interpret mode, as tests/test_paged_backends.py runs it, and
the XLA gather reference ``_xla_paged``) and through the port's plain
versions on CPU tensors. Tolerances: both sides compute fp32 scores,
softmax and weighted sums, in another summation order — 2e-5 absolute
on outputs of magnitude ~1. Pool writes are compared bytewise.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.paged_attention import (
    _xla_paged, paged_decode_attention_inplace as jax_decode_inplace,
    write_kv_pages as jax_write_kv_pages,
    write_prefill_kv_pages as jax_write_prefill)
from paddle_tpu_torch.nn.functional import paged_attention as pa

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

TOL = 2e-5


def _tables(rng, lens, pp, ps, P, extra=1):
    """Distinct random pages (never the scratch page 0) covering
    ``lens + extra`` tokens per row, zero-padded."""
    b = len(lens)
    tables = np.zeros((b, pp), np.int32)
    perm = list(rng.permutation(np.arange(1, P)))
    for r, n in enumerate(lens):
        need = min(-(-(int(n) + extra) // ps), pp)
        if n == 0 and extra == 0:
            continue
        tables[r, :need] = [perm.pop() for _ in range(need)]
    return tables


def _case(g, seed=5, lens=(5, 0, 13, 9, 16, 3), d=128):
    rng = np.random.RandomState(seed)
    b, n_kv, ps = len(lens), 2, 4
    n_q = n_kv * g
    pp, P, L = 6, 40, 2
    arrs = dict(
        q=rng.randn(b, n_q, d).astype(np.float32),
        nk=rng.randn(b, n_kv, d).astype(np.float32),
        nv=rng.randn(b, n_kv, d).astype(np.float32),
        kp=rng.randn(L * P, n_kv, ps, d).astype(np.float32),
        vp=rng.randn(L * P, n_kv, ps, d).astype(np.float32),
        lens=np.asarray(lens, np.int32),
        tables=_tables(rng, lens, pp, ps, P))
    return arrs, P


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_kernel(a, base, pages, dtype="float32"):
    """The JAX decode kernel (interpret mode) on ``a``'s arrays cast to
    ``dtype``: (out, key pool, value pool) as float32 numpy arrays."""
    jd = jnp.dtype(dtype)
    res = jax_decode_inplace(
        *(jnp.asarray(a[k]).astype(jd) for k in ("q", "nk", "nv", "kp",
                                                 "vp")),
        jnp.asarray(a["lens"]), jnp.asarray(a["tables"]), pool_base=base,
        pool_pages=pages)
    return tuple(np.asarray(r.astype(jnp.float32)) for r in res)


@functools.lru_cache(maxsize=None)
def _jax_case(g, layer, dtype="float32"):
    """The JAX kernel on ``_case(g)`` at ``layer``, run once for the
    tests that share it."""
    a, P = _case(g)
    return _jax_kernel(a, layer * P, P, dtype)


def _overfull_case():
    lens = (24, 5)                            # 24 = pp * ps: full
    a, P = _case(1, seed=3, lens=lens)
    a["tables"] = _tables(np.random.RandomState(9), lens, 6, 4, P, extra=0)
    return a, P


@functools.lru_cache(maxsize=None)
def _jax_overfull():
    a, P = _overfull_case()
    return _jax_kernel(a, 0, P)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_decode_plain_matches_jax_kernel(g, layer):
    """Append + attend: the port's plain version against the JAX
    kernel (interpret mode) — outputs within TOL, pools bytewise."""
    a, P = _case(g)
    base = layer * P
    out_j, ck_j, cv_j = _jax_case(g, layer)
    kp, vp = _t(a["kp"]), _t(a["vp"])
    out_t, ck_t, cv_t = pa.paged_decode_attention_inplace(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), kp, vp, _t(a["lens"]),
        _t(a["tables"]), pool_base=base, pool_pages=P)
    assert ck_t is kp and cv_t is vp          # in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(cv_j))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_plain_matches_write_then_xla_paged(g, d):
    """The plain version is write_kv_pages + _xla_paged over lens + 1
    for every row with room (page edges 4, 8, 12 and an idle row)."""
    a, P = _case(g, seed=11, lens=(4, 0, 8, 12, 3, 7), d=d)
    base = P
    tables = a["tables"] + base
    ck_j, cv_j = jax_write_kv_pages(
        jnp.asarray(a["kp"]), jnp.asarray(a["vp"]), jnp.asarray(a["nk"]),
        jnp.asarray(a["nv"]), jnp.asarray(a["lens"]), jnp.asarray(tables))
    ref = _xla_paged(jnp.asarray(a["q"]), ck_j, cv_j,
                     jnp.asarray(a["lens"] + 1), jnp.asarray(tables))
    kp, vp = _t(a["kp"]), _t(a["vp"])
    out, _, _ = pa.paged_decode_attention_inplace(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), kp, vp, _t(a["lens"]),
        _t(a["tables"]), pool_base=base)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ck_j))


def test_overfull_row_is_a_noop_write():
    """A row whose table is full keeps the pool bytewise untouched and
    still attends its whole table plus the operand token — as the JAX
    kernel does."""
    a, P = _overfull_case()
    kp, vp = _t(a["kp"]), _t(a["vp"])
    k0 = kp.clone()
    out, _, _ = pa.paged_decode_attention_inplace(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), kp, vp, _t(a["lens"]),
        _t(a["tables"]))
    row0_pages = torch.from_numpy(a["tables"][0]).long()
    assert torch.equal(kp[row0_pages], k0[row0_pages])
    # row 1 did append (pos 5 -> page 1, slot 1)
    pg = int(a["tables"][1, 1])
    assert torch.equal(kp[pg, :, 1], _t(a["nk"])[1])
    out_j, ck_j, _ = _jax_overfull()
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ck_j))


def test_shared_prefix_page_follows_block_tables():
    """Two rows sharing page 1 (rows [[1,2,0],[1,3,0]], lens [20,18]):
    the port attends through each row's table, as _xla_paged does.
    The JAX decode kernel's one-owner-per-page mask does not: its row 0
    is off by ~1.04 here while row 1 agrees (ROADMAP.md, queue C) —
    checked below so the recorded fault stays reproducible."""
    a = _shared_case()
    ref, _, _ = _shared_refs()
    out, _, _ = pa.paged_decode_attention_inplace(
        *(_t(a[k]) for k in ("q", "nk", "nv", "kp", "vp", "lens",
                             "tables")))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
    out_j, _, _ = _jax_kernel(a, 0, None)
    err_j = np.abs(out_j - ref).reshape(2, -1).max(axis=1)
    assert err_j[0] > 0.5 and err_j[1] < TOL


def _shared_case():
    """Rows [[1,2,0],[1,3,0]] sharing page 1, lens [20, 18], page 8."""
    rng = np.random.RandomState(0)
    b, n_kv, d, ps, P = 2, 2, 128, 8, 6
    return dict(q=rng.randn(b, n_kv, d).astype(np.float32),
                nk=rng.randn(b, n_kv, d).astype(np.float32),
                nv=rng.randn(b, n_kv, d).astype(np.float32),
                kp=rng.randn(P, n_kv, ps, d).astype(np.float32),
                vp=rng.randn(P, n_kv, ps, d).astype(np.float32),
                lens=np.array([20, 18], np.int32),
                tables=np.array([[1, 2, 0], [1, 3, 0]], np.int32))


@functools.lru_cache(maxsize=None)
def _shared_refs():
    """The JAX block-table reference on ``_shared_case``: write_kv_pages
    + _xla_paged over lens + 1 (out, key pool, value pool)."""
    a = _shared_case()
    ck_j, cv_j = jax_write_kv_pages(
        *(jnp.asarray(a[k]) for k in ("kp", "vp", "nk", "nv", "lens",
                                      "tables")))
    ref = _xla_paged(jnp.asarray(a["q"]), ck_j, cv_j,
                     jnp.asarray(a["lens"] + 1), jnp.asarray(a["tables"]))
    return tuple(np.asarray(r) for r in (ref, ck_j, cv_j))


@pytest.mark.parametrize("base,pages", [(-1, 10), (0, 81), (40, 41),
                                        (79, 2), (10, 0)])
def test_layer_region_outside_the_pool_raises(base, pages):
    """The layer region [pool_base, pool_base + pool_pages) must lie in
    the pool (80 pages here), on the CPU as on the card."""
    a, P = _case(1)
    with pytest.raises(ValueError, match="layer region"):
        pa.paged_decode_attention_inplace(
            _t(a["q"]), _t(a["nk"]), _t(a["nv"]), _t(a["kp"]), _t(a["vp"]),
            _t(a["lens"]), _t(a["tables"]), pool_base=base, pool_pages=pages)


def test_table_id_outside_the_region_names_no_page():
    """A table id at or past pool_pages (or negative) is neither read
    nor written: row 0 (length 8 of 3 pages of 4, its third page out of
    the region) computes what the same row with a full two-page table
    computes, and the pool stays bytewise untouched outside the
    appends of in-region rows."""
    a, P = _case(1, seed=17, lens=(8, 5))
    base = P
    full = a["tables"][:, :2].copy()
    over = np.concatenate([full, np.zeros((2, 1), np.int32)], axis=1)
    over[0, 2] = P                       # first id past the region
    over[1, 2] = -3
    kp, vp = _t(a["kp"]), _t(a["vp"])
    k0, v0 = kp.clone(), vp.clone()
    out, _, _ = pa.paged_decode_attention_inplace(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), kp, vp, _t(a["lens"]),
        _t(over), pool_base=base, pool_pages=P)
    kp2, vp2 = k0.clone(), v0.clone()
    ref, _, _ = pa.paged_decode_attention_inplace(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), kp2, vp2, _t(a["lens"]),
        _t(full), pool_base=base, pool_pages=P)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=TOL)
    # row 0 is full in the two-page table: no append in either call;
    # row 1 appends at position 5 (page index 1) in both
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert not torch.equal(kp, k0)       # row 1's append happened


@pytest.mark.parametrize("g", [1, 2])
def test_paged_attention_plain_matches_xla_paged(g):
    a, P = _case(g, seed=21, lens=(1, 4, 5, 12, 23, 24))
    out = pa.paged_attention_plain(_t(a["q"]), _t(a["kp"]), _t(a["vp"]),
                                   _t(a["lens"]), _t(a["tables"]))
    ref = _xla_paged(jnp.asarray(a["q"]), jnp.asarray(a["kp"]),
                     jnp.asarray(a["vp"]), jnp.asarray(a["lens"]),
                     jnp.asarray(a["tables"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("mode", ["fresh", "start", "start_valid"])
def test_write_prefill_kv_pages_matches_jax(mode):
    rng = np.random.RandomState(4)
    b, s, n_kv, d, ps, P = 3, 6, 2, 8, 4, 12
    kp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    vp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    k = rng.randn(b, s, n_kv, d).astype(np.float32)
    v = rng.randn(b, s, n_kv, d).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    kw = {}
    if mode != "fresh":
        kw["start"] = np.array([0, 3, 5], np.int32)
    if mode == "start_valid":
        kw["valid_lens"] = np.array([6, 2, 4], np.int32)
    ck_j, cv_j = jax_write_prefill(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), **{n: jnp.asarray(x) for n, x in kw.items()})
    ck_t, cv_t = pa.write_prefill_kv_pages(
        _t(kp), _t(vp), _t(k), _t(v), _t(tables),
        **{n: _t(x) for n, x in kw.items()})
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


def test_write_kv_pages_matches_jax():
    rng = np.random.RandomState(8)
    b, n_kv, d, ps, P = 3, 2, 8, 4, 9
    kp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    vp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    nk = rng.randn(b, n_kv, d).astype(np.float32)
    nv = rng.randn(b, n_kv, d).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    ck_j, cv_j = jax_write_kv_pages(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(pos), jnp.asarray(tables))
    ck_t, cv_t = pa.write_kv_pages(_t(kp), _t(vp), _t(nk), _t(nv), _t(pos),
                                   _t(tables))
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


def test_bf16_pool_plain_path():
    """bf16 pool: the operand token is rounded to the pool dtype exactly
    as the append stores it, so attending from the pool after the write
    gives the same result as the fused plain version."""
    a, P = _case(2, seed=13)
    bf = torch.bfloat16
    q, nk, nv = (_t(a[n]).to(bf) for n in ("q", "nk", "nv"))
    kp, vp = _t(a["kp"]).to(bf), _t(a["vp"]).to(bf)
    out, _, _ = pa.paged_decode_attention_inplace(
        q, nk, nv, kp, vp, _t(a["lens"]), _t(a["tables"]))
    ref = pa.paged_attention_plain(q, kp, vp, _t(a["lens"]) + 1,
                                   _t(a["tables"]))
    assert out.dtype == bf
    # both round the same fp32 result to bf16 after another summation
    # order: at most one bf16 ulp apart (2^-8 below magnitude 2)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=2 ** -7)


def test_stream_chunk_pages_matches_jax():
    from paddle_tpu.nn.functional.paged_attention import (
        STREAM_CHUNK_TOKENS, stream_chunk_pages)

    assert pa.STREAM_CHUNK_TOKENS == STREAM_CHUNK_TOKENS
    for ps in (1, 4, 16, 64, 2048):
        assert pa.stream_chunk_pages(ps) == stream_chunk_pages(ps)


# ---------------------------------------------------------------------
# B1's tensor-core kernel on the card: its split plan, a tile-order
# rendering of its arithmetic, and the card route (library faked)
# ---------------------------------------------------------------------

def _split_tiles(n_tok, n_split):
    """The tensor-core decode kernels' walk (``decode::walk`` of
    ``csrc/decode_tiles.cuh``) rendered: ``[(t_lo, t_hi)]`` of 16-token
    tiles a split, split ``s`` taking ``s * n // n_split`` up to ``(s +
    1) * n // n_split`` of ``n = cdiv(n_tok, 16)``; warp ``w`` of its
    block takes tiles ``t_lo + w``, ``+ 4``, ... Only split 0 appends."""
    n = -(-n_tok // pa.DECODE_Q_TILE)
    return [(s * n // n_split, (s + 1) * n // n_split)
            for s in range(n_split)]


@pytest.mark.parametrize("n_tok", [0, 1, 15, 16, 17, 100, 272, 1023])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 16])
def test_split_tiles_cover_each_token_once(n_tok, n_split):
    """Over the splits' tile ranges and the 4 warps of each block (tiles
    t_lo + w, + 4, ...), every 16-token tile of a row is walked exactly
    once, in split order, and the tiles cover the row's tokens."""
    spans = _split_tiles(n_tok, n_split)
    assert len(spans) == n_split
    walked = [t for lo, hi in spans for w in range(4)
              for t in range(lo + w, hi, 4)]
    n_tiles = -(-n_tok // pa.DECODE_Q_TILE)
    assert sorted(walked) == list(range(n_tiles))
    assert [lo for lo, _ in spans] == sorted(lo for lo, _ in spans)
    assert all(hi - lo >= 0 for lo, hi in spans)
    assert n_tiles * pa.DECODE_Q_TILE >= n_tok


@pytest.mark.parametrize("b,n_kv,span,want", [
    (32, 16, 17 * 16, (1, 512)),      # the decode rung (d128 and MoE d64)
    (2, 16, 17 * 16, (2, 64)),        # short of blocks, 17 tiles: two
    (4, 16, 64 * 16, (5, 320)),       # long rows: two blocks an SM
])
def test_decode_plan_at_b1_shapes(b, n_kv, span, want):
    assert pa.decode_q_plan(b, n_kv, span, 132) == want


def _bf16_parts(w):
    """Three bf16 parts hi + mid + lo of fp32 weights, as the kernel
    packs them (each part rounded to nearest even)."""
    hi = w.to(torch.bfloat16).float()
    r1 = w - hi
    mid = r1.to(torch.bfloat16).float()
    return hi, mid, (r1 - mid).to(torch.bfloat16).float()


def _b1_tiles(q, nk, nv, kp, vp, lens, tables, base, region, n_split):
    """B1's tensor-core kernel rendered in PyTorch, tile for tile: per
    (row, kv head) and split of ``_split_tiles``, only split 0
    appending; warp w walking tiles t_lo + w, + 4, ... of 16 tokens, an
    fp32 online softmax a tile, P V with the weights as three bf16 parts;
    the warps' states merged, then the splits' in split order with the
    current token from the operands. Returns (out, appends)."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = kp.shape
    g, pp, T = n_q // n_kv, tables.shape[1], pa.DECODE_Q_TILE
    cap, scale, inf = pp * ps, d ** -0.5, float("inf")
    out = torch.empty(b, n_q, d, dtype=q.dtype)
    appends = 0

    def fold(states):                     # [(m, l, acc)] -> (mx, l, acc)
        mx = torch.stack([m for m, _, _ in states]).max(0).values
        fin = torch.isfinite(mx)
        f = [torch.where(fin, torch.exp(m - mx), 0.0) for m, _, _ in states]
        return (mx, sum(l * fw for (_, l, _), fw in zip(states, f)),
                sum(a * fw[:, None] for (_, _, a), fw in zip(states, f)))
    for r in range(b):
        n = int(lens[r])
        n_tok = min(n, cap)
        for h in range(n_kv):
            qh = q[r, h * g:(h + 1) * g].float()
            splits = []
            for s, (t_lo, t_hi) in enumerate(
                    _split_tiles(n_tok, n_split)):
                if s == 0 and n < cap and 0 <= tables[r, n // ps] < region:
                    page = base + int(tables[r, n // ps])
                    kp[page, h, n % ps] = nk[r, h]
                    vp[page, h, n % ps] = nv[r, h]
                    appends += 1
                warps = []
                for w in range(4):
                    m = torch.full((g,), -inf)
                    l, acc = torch.zeros(g), torch.zeros(g, d)
                    for t in range(t_lo + w, t_hi, 4):
                        tok = torch.arange(t * T, (t + 1) * T)
                        ids = tables[r, torch.clamp(tok // ps, max=pp - 1)]
                        ok = (tok < n_tok) & (ids >= 0) & (ids < region)
                        if not bool(ok.any()):
                            continue
                        pages = base + torch.where(ok, ids, 0).long()
                        kt = torch.where(ok[:, None],
                                         kp[pages, h, tok % ps].float(), 0.0)
                        vt = torch.where(ok[:, None],
                                         vp[pages, h, tok % ps].float(), 0.0)
                        x = torch.where(ok, (qh @ kt.T) * scale, -inf)
                        mn = torch.maximum(m, x.max(1).values)
                        alpha = torch.exp(m - mn)
                        p = torch.where(ok, torch.exp(x - mn[:, None]), 0.0)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + sum(
                            part @ vt for part in _bf16_parts(p))
                        m = mn
                    warps.append((m, l, acc))
                splits.append(fold(warps))
            cur = (qh @ nk[r, h].float()) * scale
            mx, l, acc = fold([(cur, torch.ones(g),
                                nv[r, h].float().expand(g, d))] + splits)
            out[r, h * g:(h + 1) * g] = (acc / l[:, None]).to(q.dtype)
    return out, appends


#: the tile rendering's cases: inputs and region of each, and the JAX
#: result it is held to (shared with the tests above)
_TILE_CASES = {
    "rows": lambda: (_case(2)[0], _case(2)[1], _case(2)[1],
                     _jax_case(2, 1)),
    "rows_bf16": lambda: (_case(2)[0], _case(2)[1], _case(2)[1],
                          _jax_case(2, 1, "bfloat16")),
    "full_table": lambda: (_overfull_case()[0], 0, _overfull_case()[1],
                           _jax_overfull()),
    "shared_page": lambda: (_shared_tile_case()[0], _case(2)[1],
                            _case(2)[1], _jax_shared_tile()),
}


def _shared_tile_case():
    """``_case(2)`` with rows 2 and 4 (lengths 13 and 16) on the same
    first page, full in both, which neither row writes."""
    a, P = _case(2)
    a["tables"] = a["tables"].copy()
    a["tables"][4, 0] = a["tables"][2, 0]
    return a, P


@functools.lru_cache(maxsize=None)
def _jax_shared_tile():
    """The JAX block-table reference on ``_shared_tile_case`` at layer 1:
    write_kv_pages + _xla_paged over lens + 1 (out, key pool, value
    pool)."""
    a, P = _shared_tile_case()
    tables = jnp.asarray(a["tables"] + P)
    ck, cv = jax_write_kv_pages(
        *(jnp.asarray(a[k]) for k in ("kp", "vp", "nk", "nv", "lens")),
        tables)
    ref = _xla_paged(jnp.asarray(a["q"]), ck, cv,
                     jnp.asarray(a["lens"] + 1), tables)
    return tuple(np.asarray(r) for r in (ref, ck, cv))


@pytest.mark.parametrize("case", sorted(_TILE_CASES))
@pytest.mark.parametrize("n_split", [1, 3])
def test_tile_rendering_matches_jax(case, n_split):
    """B1's tile-order arithmetic (16-token tiles, a softmax a tile,
    three-part bf16 weights, warps then splits merged in order) against
    the JAX decode kernel in interpret mode (the cases of the tests
    above: an idle row and a page edge, in f32 within 2e-5 and in bf16
    within the chip check's 2^-7; a full table), and on rows that share
    a page against the JAX block-table reference (the JAX kernel's
    one-owner map is wrong there, ROADMAP queue C). Pools after the
    append bytewise equal; one append a (row, kv head) with room, by
    split 0 alone."""
    a, base, region, (want, ck, cv) = _TILE_CASES[case]()
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    tol = 2 ** -7 if dtype == torch.bfloat16 else TOL
    t = {k: _t(a[k]).to(dtype) for k in ("q", "nk", "nv", "kp", "vp")}
    lens, tables = _t(a["lens"]), _t(a["tables"])
    out, appends = _b1_tiles(t["q"], t["nk"], t["nv"], t["kp"], t["vp"],
                             lens, tables, base, region, n_split)
    np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=0)
    np.testing.assert_array_equal(t["kp"].float().numpy(), ck)
    np.testing.assert_array_equal(t["vp"].float().numpy(), cv)
    ps = t["kp"].shape[2]
    cap = tables.shape[1] * ps
    room = [int(n) < cap and 0 <= int(tables[r, int(n) // ps]) < region
            for r, n in enumerate(lens)]
    assert appends == sum(room) * t["kp"].shape[1]


class _Lib:
    def __init__(self):
        self.calls = []

    def ptt_paged_decode_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,d,lens,n_split", [
    (torch.bfloat16, 64, (17, 200, 5, 0) * 8, 1),    # 512 blocks
    (torch.bfloat16, 128, (1000, 700), 8),
    (torch.bfloat16, 40, (1000, 700), 1),             # CUDA-core kernel
    (torch.float32, 128, (1000, 700), 1),
])
def test_card_tensors_reach_the_kernel_with_their_split(monkeypatch, dtype,
                                                        d, lens, n_split):
    """With the card faked, the wrapper hands the library decode_q_plan's
    split for bf16 at a head_dim that is a multiple of 32 (otherwise one
    block a row and head), a workspace of the partials and tickets only
    when it splits, and counts one launch; nothing reaches the plain
    version."""
    from paddle_tpu_torch import _kernels

    lib = _Lib()

    def refuse(*a, **k):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(pa, "_on_card", lambda t: True)
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "_paged_decode_plain", refuse)
    monkeypatch.setattr(_kernels, "lib", lambda name: lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    b, n_kv, g, ps, pp = len(lens), 2 if len(lens) < 8 else 16, 4, 16, 64
    P = b * pp + 1
    pool = torch.zeros(P, n_kv, ps, d, dtype=dtype)
    q = torch.zeros(b, n_kv * g, d, dtype=dtype)
    nk = torch.zeros(b, n_kv, d, dtype=dtype)
    tables = torch.arange(1, b * pp + 1, dtype=torch.int32).reshape(b, pp)
    before = pa.launches
    out, _, _ = pa.paged_decode_attention_inplace(
        q, nk, nk.clone(), pool, pool.clone(),
        torch.tensor(lens, dtype=torch.int32), tables, pool_base=0,
        pool_pages=P)
    assert pa.launches == before + 1 and out.shape == q.shape
    (args,) = lib.calls
    # ws, dtype, b, n_q, n_kv, d, page_size, pp, base, region, n_split
    assert (args[8] is None) == (n_split == 1)
    assert args[9:19] == (int(dtype == torch.bfloat16), b, n_kv * g, n_kv,
                          d, ps, pp, 0, P, n_split)
