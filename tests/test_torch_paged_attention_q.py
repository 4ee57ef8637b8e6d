"""Parity of paddle_tpu_torch's int8-KV decode attention with paddle_tpu's.

The int8 pool: int8 token rows plus f32 per-(token, head) scale planes
[n_kv, pages * page_size]. The same numpy inputs go through the JAX
functions (the int8 decode kernel in Pallas interpret mode, as
tests/test_paged_backends.py runs it; ``quantize_kv_rows``,
``write_kv_pages`` and ``_xla_paged`` for a dequantized reference) and
through the port's plain version on CPU tensors.

Tolerances. Against the dequantized reference (q quantized per row,
the pool dequantized, the current token exact): 1e-5 absolute, fp32 on
both sides in another order. Against the JAX kernel: 0.03 absolute —
the TPU kernel also re-quantizes the softmax weights per chunk to run
P.V on the int8 MXU, which the port does not (measured max 0.0098 on
these inputs). Written int8 rows and scale planes are compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.paged_attention import (
    _xla_paged, gather_kv_pages as jax_gather,
    paged_decode_attention_inplace_q as jax_decode_q,
    quantize_kv_rows as jax_quantize, write_kv_pages as jax_write,
    write_prefill_kv_pages as jax_write_prefill)
from paddle_tpu_torch.nn.functional import paged_attention as pa

TOL_REF = 1e-5
TOL_KERNEL = 0.03


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_pool(rng, pages, n_kv, ps, d):
    """Random rows quantized per (token, head) with the JAX quantizer:
    (int8 rows, f32 plane [n_kv, pages * ps])."""
    q, s = jax_quantize(jnp.asarray(
        rng.randn(pages, n_kv, ps, d).astype(np.float32)))
    q, s = np.asarray(q), np.asarray(s)                  # s [P, n_kv, ps]
    plane = np.ascontiguousarray(
        np.transpose(s, (1, 0, 2)).reshape(n_kv, pages * ps))
    return q, plane


def _tables(rng, lens, pp, ps, P, extra=1):
    tables = np.zeros((len(lens), pp), np.int32)
    perm = list(rng.permutation(np.arange(1, P)))
    for r, n in enumerate(lens):
        need = min(-(-(int(n) + extra) // ps), pp)
        tables[r, :need] = [perm.pop() for _ in range(need)]
    return tables


def _case(g=1, seed=7, lens=(5, 0, 13, 9), d=128, n_kv=2, ps=4, pp=6,
          P=16, L=2):
    rng = np.random.RandomState(seed)
    b = len(lens)
    kq, ks = _int8_pool(rng, L * P, n_kv, ps, d)
    vq, vs = _int8_pool(rng, L * P, n_kv, ps, d)
    return dict(
        q=rng.randn(b, n_kv * g, d).astype(np.float32),
        nk=rng.randn(b, n_kv, d).astype(np.float32),
        nv=rng.randn(b, n_kv, d).astype(np.float32),
        kq=kq, ks=ks, vq=vq, vs=vs, lens=np.asarray(lens, np.int32),
        tables=_tables(rng, lens, pp, ps, P), P=P, ps=ps)


def _port(a, tables=None, base=0, P=None):
    pools = [_t(a[k]) for k in ("kq", "ks", "vq", "vs")]
    out = pa.paged_decode_attention_inplace_q(
        _t(a["q"]), _t(a["nk"]), _t(a["nv"]), *pools, _t(a["lens"]),
        _t(a["tables"] if tables is None else tables), pool_base=base,
        pool_pages=a["P"] if P is None else P)
    assert all(o is p for o, p in zip(out[1:], pools))      # in place
    return out[0].numpy(), [p.numpy() for p in pools]


def _jax(a, base=0):
    out = jax_decode_q(
        *(jnp.asarray(a[k]) for k in ("q", "nk", "nv", "kq", "ks", "vq",
                                      "vs", "lens", "tables")),
        pool_base=base, pool_pages=a["P"])
    return np.asarray(out[0]), [np.asarray(o) for o in out[1:]]


def _dequant_reference(a, base):
    """q quantized per (row, q head) and dequantized, the pool
    dequantized, the current token written exact: write_kv_pages +
    _xla_paged over lens + 1 (JAX functions throughout)."""
    qq, qs = jax_quantize(jnp.asarray(a["q"]))
    qd = qq.astype(jnp.float32) * qs[..., None]
    ps = a["ps"]

    def deq(rows, plane):
        P, n_kv = rows.shape[0], rows.shape[1]
        s = np.transpose(plane.reshape(n_kv, P, ps), (1, 0, 2))
        return jnp.asarray(rows.astype(np.float32) * s[..., None])
    tables = jnp.asarray(a["tables"] + base)
    ck, cv = jax_write(deq(a["kq"], a["ks"]), deq(a["vq"], a["vs"]),
                       jnp.asarray(a["nk"]), jnp.asarray(a["nv"]),
                       jnp.asarray(a["lens"]), tables)
    return np.asarray(_xla_paged(qd, ck, cv, jnp.asarray(a["lens"] + 1),
                                 tables))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_dequantized_reference(g, layer):
    a = _case(g=g, seed=3 + g, lens=(4, 0, 8, 12, 3, 7))
    base = layer * a["P"]
    out, _ = _port(a, base=base)
    np.testing.assert_allclose(out, _dequant_reference(a, base),
                               atol=TOL_REF)


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_jax_kernel_and_writes_bitwise(layer):
    """Outputs within TOL_KERNEL of the JAX kernel; the int8 rows and
    the scale planes after the append bitwise equal to its, the other
    layer's region untouched."""
    a = _case()
    base = layer * a["P"]
    out_t, pools_t = _port(a, base=base)
    out_j, pools_j = _jax(a, base=base)
    err = float(np.abs(out_t - out_j).max())
    assert err <= TOL_KERNEL, err
    for t, j in zip(pools_t, pools_j):
        np.testing.assert_array_equal(t, j)
    P, ps = a["P"], a["ps"]
    other = slice(P, 2 * P) if layer == 0 else slice(0, P)
    np.testing.assert_array_equal(pools_t[0][other], a["kq"][other])
    cols = slice(other.start * ps, other.stop * ps)
    np.testing.assert_array_equal(pools_t[1][:, cols], a["ks"][:, cols])
    assert not np.array_equal(pools_t[0], a["kq"])           # appended


def test_overfull_row_is_a_noop_write():
    """Rows whose tables are full (lens == pp * ps) touch no int8 row
    and no plane column, as the JAX kernel's masked write; the other
    row's append lands (mirrors tests/test_paged_backends.py). The
    shapes are _case's, so the JAX kernel's interpret-mode compile is
    shared with the tests above."""
    a = _case(seed=11)
    a["lens"] = np.array([24, 5, 24, 24], np.int32)
    a["tables"] = np.zeros((4, 6), np.int32)
    a["tables"][0] = np.arange(1, 7)
    a["tables"][1, :2] = [7, 8]
    a["tables"][2] = np.arange(9, 15)
    a["tables"][3] = [15, 1, 2, 3, 4, 5]
    out_t, pools_t = _port(a)
    _, pools_j = _jax(a)
    for t, j in zip(pools_t, pools_j):
        np.testing.assert_array_equal(t, j)
    nkq, nks = jax_quantize(jnp.asarray(a["nk"]))
    exp_kq = a["kq"].copy()
    exp_kq[8, :, 1] = np.asarray(nkq)[1]
    exp_ks = a["ks"].copy()
    exp_ks[:, 8 * 4 + 1] = np.asarray(nks)[1]
    np.testing.assert_array_equal(pools_t[0], exp_kq)
    np.testing.assert_array_equal(pools_t[1], exp_ks)
    assert np.isfinite(out_t).all()


def test_shared_prefix_page_follows_block_tables():
    """Rows 0 and 1 share pages 1 and 2 (tables [1,2,3] and [1,2,4],
    lens 10 and 9, d 128, 2 kv heads, page 4; rows 2 and 3 on pages of
    their own, _case's shapes): the port attends through each row's table
    and matches the dequantized reference. The JAX int8 kernel masks with
    one owner per page: its row 0 is off by more than 0.5 while row 1
    keeps the int8 error — checked so the recorded fault stays
    reproducible."""
    a = _case(seed=0)
    a["lens"] = np.array([10, 9, 6, 3], np.int32)
    a["tables"] = np.zeros((4, 6), np.int32)
    a["tables"][0, :3] = [1, 2, 3]
    a["tables"][1, :3] = [1, 2, 4]
    a["tables"][2, :2] = [5, 6]
    a["tables"][3, :1] = [7]
    ref = _dequant_reference(a, 0)
    out_t, _ = _port(a)
    np.testing.assert_allclose(out_t, ref, atol=TOL_REF)
    out_j, _ = _jax(a)
    err_j = np.abs(out_j - ref).reshape(4, -1).max(axis=1)
    assert err_j[0] > 0.5 and (err_j[1:] < TOL_KERNEL).all(), err_j


@pytest.mark.parametrize("base,pages", [(-1, 10), (0, 33), (20, 13)])
def test_layer_region_outside_the_pool_raises(base, pages):
    a = _case()
    with pytest.raises(ValueError, match="layer region"):
        _port(a, base=base, P=pages)


def test_table_id_outside_the_region_names_no_page():
    """A table id at or past pool_pages (or negative) is neither read
    nor written: row 0 computes what its two in-region pages give, and
    the pool and planes match the call with the truncated table."""
    a = _case(lens=(8, 5), seed=17)
    full = a["tables"][:, :2].copy()
    over = np.concatenate([full, np.zeros((2, 1), np.int32)], axis=1)
    over[0, 2] = a["P"]
    over[1, 2] = -3
    out, pools = _port(a, tables=over, base=a["P"])
    ref, ref_pools = _port(a, tables=full, base=a["P"])
    np.testing.assert_allclose(out[0], ref[0], atol=TOL_REF)
    for t, r in zip(pools, ref_pools):
        np.testing.assert_array_equal(t, r)


@pytest.mark.parametrize("mode", ["fresh", "start_valid"])
def test_write_prefill_int8_matches_jax(mode):
    """A prompt chunk quantized into the int8 pool: rows and planes
    bitwise equal to the JAX package's (padding rows go to the scratch
    page 0, which is left out: duplicate writes there may land in any
    order)."""
    rng = np.random.RandomState(4)
    b, s, n_kv, d, ps, P = 3, 6, 2, 8, 4, 12
    kq, ks = _int8_pool(rng, P, n_kv, ps, d)
    vq, vs = _int8_pool(rng, P, n_kv, ps, d)
    k = rng.randn(b, s, n_kv, d).astype(np.float32)
    v = rng.randn(b, s, n_kv, d).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    kw = {}
    if mode == "start_valid":
        kw = dict(start=np.array([0, 3, 5], np.int32),
                  valid_lens=np.array([6, 2, 4], np.int32))
    cj = jax_write_prefill(
        (jnp.asarray(kq), jnp.asarray(ks)), (jnp.asarray(vq), jnp.asarray(vs)),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        **{n: jnp.asarray(x) for n, x in kw.items()})
    ct = pa.write_prefill_kv_pages(
        (_t(kq), _t(ks)), (_t(vq), _t(vs)), _t(k), _t(v), _t(tables),
        **{n: _t(x) for n, x in kw.items()})
    for side_t, side_j in zip(ct, cj):
        np.testing.assert_array_equal(side_t[0].numpy()[1:],
                                      np.asarray(side_j[0])[1:])
        np.testing.assert_array_equal(side_t[1].numpy()[:, ps:],
                                      np.asarray(side_j[1])[:, ps:])


@pytest.mark.parametrize("quant", [True, False])
def test_gather_kv_pages_matches_jax(quant):
    rng = np.random.RandomState(5)
    P, n_kv, ps, d = 10, 2, 4, 8
    tables = np.array([[3, 1, 0], [2, 9, 4]], np.int32)
    if quant:
        rows, plane = _int8_pool(rng, P, n_kv, ps, d)
        side_j, side_t = (jnp.asarray(rows), jnp.asarray(plane)), \
            (_t(rows), _t(plane))
    else:
        pool = rng.randn(P, n_kv, ps, d).astype(np.float32)
        side_j, side_t = jnp.asarray(pool), _t(pool)
    gj = np.asarray(jax_gather(side_j, jnp.asarray(tables)))
    gt = pa.gather_kv_pages(side_t, _t(tables)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-7, atol=0)


def test_bf16_operands():
    """bf16 q/new_k/new_v: the append quantizes the same values, and the
    output is the f32 call's rounded to bf16 (within one bf16 ulp)."""
    a = _case(g=2, seed=13)
    bf = torch.bfloat16
    for k in ("q", "nk", "nv"):
        a[k] = _t(a[k]).to(bf).float().numpy()
    out32, pools32 = _port(a)
    pools = [_t(a[k]) for k in ("kq", "ks", "vq", "vs")]
    out, *_ = pa.paged_decode_attention_inplace_q(
        _t(a["q"]).to(bf), _t(a["nk"]).to(bf), _t(a["nv"]).to(bf), *pools,
        _t(a["lens"]), _t(a["tables"]), pool_base=0, pool_pages=a["P"])
    assert out.dtype == bf
    np.testing.assert_allclose(out.float().numpy(), out32, atol=2 ** -7)
    for t, r in zip(pools, pools32):
        np.testing.assert_array_equal(t.numpy(), r)


# ---------------------------------------------------------------------
# the tensor-core kernel's split plan, the chip check's control, and the
# card route (library faked)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("b,n_kv,span,sms,want", [
    (64, 16, 17 * 16, 132, (1, 1024)),      # the int8-KV rung: no split
    (4, 16, 64 * 16, 132, (5, 320)),        # long rows: two blocks an SM
    (4, 16, 4 * 16, 132, (1, 64)),          # too few tiles to split
    (1, 1, 400 * 16, 132, (16, 16)),        # at most 16 splits
    (2, 8, 24 * 16, 132, (3, 48)),          # each split >= 8 tiles
])
def test_decode_q_plan_splits_rows_only_when_the_card_is_short(b, n_kv, span,
                                                               sms, want):
    assert pa.decode_q_plan(b, n_kv, span, sms) == want


def test_decode_q_plan_raises_past_the_grid():
    with pytest.raises(ValueError, match="grid's limit of 65535"):
        pa.decode_q_plan(65536, 1, 16, 132)


def test_skip_last_page_control_differs_from_the_plain_result():
    """The chip check's control (each row's last live page left out)
    moves the outputs far past the kernel's limits; without the flag the
    plain version is unchanged."""
    a = _case(g=2, seed=21, lens=(5, 0, 13, 9))
    pools = [_t(a[k]) for k in ("kq", "ks", "vq", "vs")]
    args = (_t(a["q"]), _t(a["nk"]), _t(a["nv"]))

    def run(**kw):
        return pa._paged_decode_q_plain(
            *args, *[p.clone() for p in pools], _t(a["lens"]),
            _t(a["tables"]), 0, a["P"], **kw).numpy()
    ref, ctrl = run(), run(skip_last_page=True)
    np.testing.assert_array_equal(run(skip_last_page=False), ref)
    err = np.abs(ctrl - ref).reshape(len(a["lens"]), -1).max(axis=1)
    assert err[1] == 0.0                     # length 0: nothing to skip
    assert (err[[0, 2, 3]] > 2 ** -7).all(), err


def test_nan_scales_past_the_lengths_are_selected_away():
    """Scale columns nobody wrote (NaN in a pool from torch.empty) past
    each row's length, the append's slot included, leave the output
    bitwise as with finite ones: masked weights are selected, never
    multiplied."""
    a = _case(g=2, seed=23, lens=(5, 0, 13, 9))
    ps = a["ps"]
    nan = {k: a[k].copy() for k in ("ks", "vs")}
    for r, n in enumerate(a["lens"]):
        for j, page in enumerate(a["tables"][r]):
            for slot in range(ps):
                if j * ps + slot >= n and page:
                    for k in nan:
                        nan[k][:, page * ps + slot] = np.nan
    out, pools = _port(a)
    out_nan, pools_nan = _port({**a, **nan})
    assert np.isfinite(out_nan).all()
    np.testing.assert_array_equal(out_nan, out)
    for t, r in zip(pools_nan, pools):          # the rest as written
        np.testing.assert_array_equal(np.where(np.isnan(t), r, t), r)
    for r, n in enumerate(a["lens"]):           # the appends landed
        col = a["tables"][r, n // ps] * ps + n % ps
        assert np.isfinite(pools_nan[1][:, col]).all()
        assert np.isfinite(pools_nan[3][:, col]).all()


class _Lib:
    def __init__(self):
        self.calls = []

    def ptt_paged_decode_attention_q(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,lens,n_kv,pp,n_split", [
    (torch.bfloat16, (17, 200, 5, 0) * 5, 16, 17, 1),   # 320 blocks
    (torch.bfloat16, (1000, 700), 2, 64, 8),
    (torch.float32, (1000, 700), 2, 64, 1),
])
def test_card_tensors_reach_the_kernel_with_their_split(monkeypatch, dtype,
                                                        lens, n_kv, pp,
                                                        n_split):
    """With the card faked, the wrapper hands the library decode_q_plan's
    split (bf16; f32 one block a row and head), a workspace of the
    partials and tickets only when it splits, and counts one launch;
    nothing reaches the plain version."""
    from paddle_tpu_torch import _kernels

    lib = _Lib()

    def refuse(*a, **k):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(pa, "_on_card", lambda t: True)
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "_paged_decode_q_plain", refuse)
    monkeypatch.setattr(_kernels, "lib", lambda name: lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    b, g, d, ps = len(lens), 4, 64, 16
    P = b * pp + 1
    rows = torch.zeros(P, n_kv, ps, d, dtype=torch.int8)
    plane = torch.zeros(n_kv, P * ps)
    q = torch.zeros(b, n_kv * g, d, dtype=dtype)
    nk = torch.zeros(b, n_kv, d, dtype=dtype)
    tables = torch.arange(1, b * pp + 1, dtype=torch.int32).reshape(b, pp)
    before = pa.q_launches
    out = pa.paged_decode_attention_inplace_q(
        q, nk, nk.clone(), rows, plane, rows.clone(), plane.clone(),
        torch.tensor(lens, dtype=torch.int32), tables, pool_base=0,
        pool_pages=P)[0]
    assert pa.q_launches == before + 1 and out.shape == q.shape
    (args,) = lib.calls
    # ws, dtype, b, n_q, n_kv, d, page_size, pp, base, region, plane_cols,
    # n_split
    assert (args[10] is None) == (n_split == 1)
    assert args[11:22] == (int(dtype == torch.bfloat16), b, n_kv * g, n_kv,
                           d, ps, pp, 0, P, P * ps, n_split)
