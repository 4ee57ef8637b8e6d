"""Parity of paddle_tpu_torch's paged decode attention with paddle_tpu's.

The same numpy inputs go through the JAX functions (the decode kernel
in Pallas interpret mode, as tests/test_paged_backends.py runs it, and
the XLA gather reference ``_xla_paged``) and through the port's plain
versions on CPU tensors. Tolerances: both sides compute fp32 scores,
softmax and weighted sums, in another summation order — 2e-5 absolute
on outputs of magnitude ~1. Pool writes are compared bytewise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.paged_attention import (
    _xla_paged, paged_decode_attention_inplace as jax_decode_inplace,
    write_kv_pages as jax_write_kv_pages,
    write_prefill_kv_pages as jax_write_prefill)
from paddle_tpu_torch.nn.functional import paged_attention as pa

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


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_decode_plain_matches_jax_kernel(g, layer):
    """Append + attend: the port's plain version against the JAX
    kernel (interpret mode) — outputs within TOL, pools bytewise."""
    a, P = _case(g)
    base = layer * P
    out_j, ck_j, cv_j = jax_decode_inplace(
        jnp.asarray(a["q"]), jnp.asarray(a["nk"]), jnp.asarray(a["nv"]),
        jnp.asarray(a["kp"]), jnp.asarray(a["vp"]), jnp.asarray(a["lens"]),
        jnp.asarray(a["tables"]), pool_base=base, pool_pages=P)
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
    lens = (24, 5)                            # 24 = pp * ps: full
    a, P = _case(1, seed=3, lens=lens)
    a["tables"] = _tables(np.random.RandomState(9), lens, 6, 4, P, extra=0)
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
    out_j, ck_j, _ = jax_decode_inplace(
        jnp.asarray(a["q"]), jnp.asarray(a["nk"]), jnp.asarray(a["nv"]),
        jnp.asarray(a["kp"]), jnp.asarray(a["vp"]), jnp.asarray(a["lens"]),
        jnp.asarray(a["tables"]), pool_base=0, pool_pages=P)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ck_j))


def test_shared_prefix_page_follows_block_tables():
    """Two rows sharing page 1 (rows [[1,2,0],[1,3,0]], lens [20,18]):
    the port attends through each row's table, as _xla_paged does.
    The JAX decode kernel's one-owner-per-page mask does not: its row 0
    is off by ~1.04 here while row 1 agrees (ROADMAP.md, queue C) —
    checked below so the recorded fault stays reproducible."""
    rng = np.random.RandomState(0)
    b, n_kv, d, ps, P = 2, 2, 128, 8, 6
    q = rng.randn(b, n_kv, d).astype(np.float32)
    nk = rng.randn(b, n_kv, d).astype(np.float32)
    nv = rng.randn(b, n_kv, d).astype(np.float32)
    kp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    vp = rng.randn(P, n_kv, ps, d).astype(np.float32)
    lens = np.array([20, 18], np.int32)
    tables = np.array([[1, 2, 0], [1, 3, 0]], np.int32)
    ck_j, cv_j = jax_write_kv_pages(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(lens), jnp.asarray(tables))
    ref = _xla_paged(jnp.asarray(q), ck_j, cv_j, jnp.asarray(lens + 1),
                     jnp.asarray(tables))
    out, _, _ = pa.paged_decode_attention_inplace(
        _t(q), _t(nk), _t(nv), _t(kp), _t(vp), _t(lens), _t(tables))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    out_j, _, _ = jax_decode_inplace(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(lens), jnp.asarray(tables))
    err_j = np.abs(np.asarray(out_j) - np.asarray(ref)).reshape(b, -1) \
        .max(axis=1)
    assert err_j[0] > 0.5 and err_j[1] < TOL


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
