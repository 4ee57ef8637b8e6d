"""Parity of paddle_tpu_torch's paged prefill attention with paddle_tpu's.

The same numpy inputs go through the JAX ``paged_prefill_attention``
(its tiled XLA walk, ``backend="xla"``, and the Pallas kernel in
interpret mode, ``backend="interpret"``) and through the port's
function on CPU tensors, which runs the kernel's plain version.
Tolerances: float32 — both sides compute fp32 scores, softmax and
weighted sums in another summation order, 1e-5 absolute on outputs of
magnitude ~1; bfloat16 — both round the same fp32 result to bf16, so a
sum-order difference can flip one rounding: one bf16 ulp at the
output's largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.flash_varlen import (
    paged_prefill_attention as jax_paged_prefill)
from paddle_tpu_torch.nn.functional import flash_varlen as fv

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

PS, PP, P, D = 4, 8, 48, 16          # page size, table width, pool, d
SPAN = PS * PP


def _case(seed, starts, c, g=1, n_kv=2, shared=0, dtype="f32"):
    """A pool of random pages, one table per row (distinct pages past
    the scratch page 0; the first ``shared`` pages common to all rows),
    and chunk queries."""
    rng = np.random.RandomState(seed)
    b = len(starts)
    perm = list(rng.permutation(np.arange(1, P)))
    common = [perm.pop() for _ in range(shared)]
    tables = np.asarray([common + [perm.pop() for _ in range(PP - shared)]
                         for _ in range(b)], np.int32)
    return dict(
        q=rng.randn(b, c, n_kv * g, D).astype(np.float32),
        kp=rng.randn(P, n_kv, PS, D).astype(np.float32),
        vp=rng.randn(P, n_kv, PS, D).astype(np.float32),
        tables=tables, start=np.asarray(starts, np.int32), n_kv=n_kv,
        dtype=dtype)


def _jax(a, backend):
    dt = jnp.bfloat16 if a["dtype"] == "bf16" else jnp.float32
    out = jax_paged_prefill(
        jnp.asarray(a["q"]).astype(dt), jnp.asarray(a["kp"]).astype(dt),
        jnp.asarray(a["vp"]).astype(dt), jnp.asarray(a["tables"]),
        jnp.asarray(a["start"]), n_kv=a["n_kv"], backend=backend)
    return np.asarray(out.astype(jnp.float32))


def _port(a, tables=None):
    dt = torch.bfloat16 if a["dtype"] == "bf16" else torch.float32
    out = fv.paged_prefill_attention(
        torch.from_numpy(a["q"]).to(dt), torch.from_numpy(a["kp"]).to(dt),
        torch.from_numpy(a["vp"]).to(dt),
        torch.from_numpy(a["tables"] if tables is None else tables),
        torch.from_numpy(a["start"]), n_kv=a["n_kv"])
    assert out.dtype == dt
    return out.float().numpy()


def _tol(ref, dtype):
    if dtype == "bf16":
        return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return 1e-5


CASES = {
    # name: (starts, c, g, shared pages, rows compared)
    "start0": ((0,), 8, 1, 0, None),
    "page_aligned": ((12,), 8, 1, 0, None),
    "unaligned": ((7,), 8, 1, 0, None),
    # the padded tail chunk of a prompt ending at the table's span:
    # 5 valid rows of 8, the padding reaching past the span
    "padded_tail": ((27,), 8, 1, 0, 5),
    "shared_prefix_b2": ((9, 16), 8, 1, 3, None),
    "gqa_g2_b2": ((5, 20), 8, 2, 0, None),
}


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name, dtype, backend):
    starts, c, g, shared, rows = CASES[name]
    a = _case(3, starts, c, g=g, shared=shared, dtype=dtype)
    ref = _jax(a, backend)[:, :rows]
    out = _port(a)[:, :rows]
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref, dtype))


def test_chunks_compose_into_the_whole_prompt():
    """The causal walk over the pool: one query row of a chunk at start
    s equals row s of a chunk that starts at 0 over the same pages."""
    a = _case(4, (0,), 24)
    whole = _port(a)
    part = dict(a, q=a["q"][:, 10:18], start=np.asarray([10], np.int32))
    np.testing.assert_allclose(_port(part), whole[:, 10:18], atol=1e-6)


def test_table_id_past_the_pool_is_not_attended():
    """An id outside [0, P) names no page: those keys drop out, as if
    the position were masked (the kernel skips it the same way)."""
    a = _case(5, (4,), 8)
    bad = a["tables"].copy()
    bad[0, 1] = P + 3                        # positions 4..7
    out = _port(a, tables=bad)
    # reference: the same walk with those positions' keys made
    # irrelevant — scores of -inf are what "not attended" means
    q = a["q"][0].reshape(8, 2, 1, D) * D ** -0.5
    ids = np.where(bad[0] < P, bad[0], 0)
    k = a["kp"][ids].transpose(1, 0, 2, 3).reshape(2, SPAN, D)
    v = a["vp"][ids].transpose(1, 0, 2, 3).reshape(2, SPAN, D)
    lg = np.einsum("tngd,nsd->ntgs", q, k)
    pos_q = 4 + np.arange(8)
    mask = (np.arange(SPAN)[None, :] <= pos_q[:, None]) \
        & ~((np.arange(SPAN) >= 4) & (np.arange(SPAN) < 8))[None, :]
    lg = np.where(mask[None, :, None, :], lg, -np.inf)
    w = np.exp(lg - lg.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    ref = np.einsum("ntgs,nsd->tngd", w, v).reshape(1, 8, 2, D)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no library is
    requested and the launch count stays put."""
    from paddle_tpu_torch import _kernels

    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel was requested on the CPU")
    monkeypatch.setattr(_kernels, "lib", refuse)
    before = fv.launches
    _port(_case(6, (0,), 8))
    assert fv.launches == before


def _int8_side(rng, pool_shape):
    """(int8 rows, f32 plane [n_kv, P * ps]) from the JAX quantizer, and
    the pool it dequantizes to."""
    from paddle_tpu.nn.functional.paged_attention import quantize_kv_rows
    rows, s = (np.array(t) for t in quantize_kv_rows(
        jnp.asarray(rng.randn(*pool_shape).astype(np.float32))))
    Pn, n_kv, ps, _ = pool_shape
    plane = np.ascontiguousarray(s.transpose(1, 0, 2).reshape(n_kv, Pn * ps))
    return (rows, plane), rows.astype(np.float32) * s[..., None]


@pytest.mark.parametrize("bad_id", [None, P + 3, -1])
def test_int8_pool_is_the_dequantized_pool(bad_id):
    """An int8 pool ``(rows, plane)`` attends as its dequantized pool
    does, the JAX XLA walk over that pool being the reference (1e-5, as
    for f32); a table id outside the pool is masked, not read."""
    rng = np.random.RandomState(8)
    a = _case(8, (4, 13), 8, g=2, shared=2)
    (kq, ks), kd = _int8_side(rng, a["kp"].shape)
    (vq, vs), vd = _int8_side(rng, a["vp"].shape)
    tables = a["tables"].copy()
    if bad_id is not None:
        tables[1, 2] = bad_id
    t = torch.from_numpy
    out = fv.paged_prefill_attention(
        t(a["q"]), (t(kq), t(ks)), (t(vq), t(vs)), t(tables), t(a["start"]),
        n_kv=a["n_kv"]).numpy()
    deq = _port(dict(a, kp=kd, vp=vd), tables=tables)
    np.testing.assert_array_equal(out, deq)
    if bad_id is None:
        ref = _jax(dict(a, kp=kd, vp=vd), "xla")
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------
# The tensor-core kernel's grid: key slices merged by log-sum-exp
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    # (b, c, n_kv, g, span, d, sms): (q_tiles, n_split, blocks)
    ((1, 256, 16, 1, 2048, 128, 132), (4, 4, 256)),   # the serving rung
    ((1, 256, 16, 1, 2048, 256, 132), (4, 4, 256)),   # 32-key tiles
    ((1, 16, 16, 1, 2048, 128, 132), (1, 16, 256)),   # a short chunk
    ((3, 256, 16, 1, 2048, 128, 132), (4, 1, 192)),   # tiles fill it
    ((1, 256, 2, 8, 2048, 128, 132), (32, 4, 256)),   # g 8: 8 rows a tile
    ((1, 256, 16, 1, 128, 64, 132), (4, 1, 64)),      # two key tiles
    ((2, 64, 16, 1, 2048, 96, 132), (1, 8, 256)),
])
def test_prefill_grid_fills_the_card(shape, want):
    """The split count is a function of the shapes and the SM count: two
    blocks an SM, at most 16 slices, each at least two key tiles of the
    widest walk; at the serving rung 256 blocks on 132 SMs."""
    assert fv.prefill_grid(*shape) == want


def _split_render(q, kp, vp, tables, start, n_kv, n_split, kn,
                  qv=fv.PREFILL_Q_VECTORS):
    """The tensor-core kernel's arithmetic in PyTorch, f32: per (row, kv
    head, q tile of ``qv`` vectors) the key range up to the tile's last
    query position, cut into ``n_split`` slices of whole ``kn``-key
    tiles as the kernel cuts it; each slice's partial (m, l, unnormalised
    output) over its keys, merged in split order by log-sum-exp."""
    b, c, n_q, d = q.shape
    P, _, ps, _ = kp.shape
    pp = tables.shape[1]
    g, rows = n_q // n_kv, qv // (n_q // n_kv)
    scale = d ** -0.5
    out = torch.zeros(b, c, n_q, d)
    for bi in range(b):
        st = int(start[bi])
        pos = torch.arange(pp * ps)
        ids = tables[bi].long()[pos // ps]
        ok = (ids >= 0) & (ids < P)
        rows_of = ids.clamp(0, P - 1)
        for kv in range(n_kv):
            keys = kp[rows_of, kv, pos % ps].float()            # [S, d]
            vals = vp[rows_of, kv, pos % ps].float()
            for t0 in range(0, c, rows):
                t1 = min(t0 + rows, c)
                qt = q[bi, t0:t1, kv * g:(kv + 1) * g].float()  # [r, g, d]
                qpos = st + torch.arange(t0, t1)
                key_end = max(0, min(pp * ps, st + t1))
                n_kt = -(-key_end // kn)
                parts = []
                for s in range(n_split):
                    lo = s * n_kt // n_split * kn
                    hi = min((s + 1) * n_kt // n_split * kn, key_end)
                    kpos = torch.arange(lo, max(lo, hi))
                    lg = torch.einsum("rgd,kd->rgk", qt, keys[kpos]) * scale
                    vis = (kpos[None, :] <= qpos[:, None]) & ok[kpos][None]
                    lg = torch.where(vis[:, None], lg, -torch.inf)
                    m = lg.amax(-1).clamp_min(-1e30) if len(kpos) else \
                        torch.full(qt.shape[:2], -1e30)
                    p = torch.exp(lg - m[..., None])
                    parts.append((m, p.sum(-1), p @ vals[kpos]))
                mm = torch.stack([m for m, _, _ in parts]).amax(0)
                ll = torch.zeros_like(mm)
                acc = torch.zeros(*mm.shape, d)
                for m, l, o in parts:
                    f = torch.exp(m - mm)
                    ll = ll + l * f
                    acc = acc + o * f[..., None]
                inv = torch.where(ll > 0, 1 / ll, 0.0)
                out[bi, t0:t1, kv * g:(kv + 1) * g] = acc * inv[..., None]
    return out


@pytest.mark.parametrize("name", ["unaligned", "shared_prefix_b2",
                                  "gqa_g2_b2", "padded_tail"])
@pytest.mark.parametrize("n_split,kn", [(1, 8), (3, 4), (16, 4), (5, 8)])
def test_split_merge_equals_the_plain_version(name, n_split, kn):
    """Key slices of whole key tiles, each with its own softmax partial,
    merged by log-sum-exp in split order, give the plain version's output
    (f32, 1e-6): slices past the tile's walk (n_split above its key
    tiles) and keys on an id outside the pool add nothing."""
    starts, c, g, shared, _ = CASES[name]
    a = _case(9, starts, c, g=g, shared=shared)
    tables = a["tables"].copy()
    tables[0, 3] = P + 1                     # names no page
    t = torch.from_numpy
    want = fv._paged_prefill_plain(t(a["q"]), t(a["kp"]), t(a["vp"]),
                                   t(tables), t(a["start"]), n_kv=a["n_kv"])
    got = _split_render(t(a["q"]), t(a["kp"]), t(a["vp"]), t(tables),
                        t(a["start"]), a["n_kv"], n_split, kn, qv=8)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_wrapper_hands_the_kernel_its_grid_and_workspace(monkeypatch):
    """On the card a bf16 pool at d128 reaches the tensor-core launch
    with ``prefill_grid``'s split and a workspace of the partials and
    counters; an f32 pool the CUDA-core launch with one slice and none.
    One launch each, counted; nothing falls back to the plain version."""
    from paddle_tpu_torch import _kernels

    calls = []

    class Lib:
        def ptt_paged_prefill_attention(self, *args):
            calls.append(args)
            return 0

    def refuse(*a, **k):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(fv, "_on_card", lambda t: True)
    monkeypatch.setattr(fv, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(fv, "_paged_prefill_plain", refuse)
    monkeypatch.setattr(_kernels, "lib", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    b, c, n_kv, d, ps, pp = 1, 256, 16, 128, 16, 128
    tables = torch.arange(1, pp + 1, dtype=torch.int32)[None]
    start = torch.tensor([1792], dtype=torch.int32)
    before = fv.launches
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros(b, c, n_kv, d, dtype=dt)
        pool = torch.zeros(pp + 1, n_kv, ps, d, dtype=dt)
        fv.paged_prefill_attention(q, pool, pool, tables, start, n_kv=n_kv)
    assert fv.launches == before + 2
    bf, f32 = calls
    # ws, dtype, b, c, n_q, n_kv, d, page_size, pp, P, n_split, scale
    assert bf[6] != 0 and bf[7:17] == (1, b, c, n_kv, n_kv, d, ps, pp,
                                       pp + 1, 4)
    assert f32[6] is None and f32[7:17] == (0, b, c, n_kv, n_kv, d, ps, pp,
                                            pp + 1, 1)
