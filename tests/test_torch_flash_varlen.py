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
