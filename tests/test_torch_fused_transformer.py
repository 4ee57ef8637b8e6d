"""Parity of paddle_tpu_torch's FusedMultiTransformer with paddle_tpu's.

A 2-layer float32 stack (d 128, 2 heads of 64, dff 256) built by the
JAX package, its weights carried over with ``load_jax_params``; the
same numpy inputs go through ``prefill_raw`` (dense and paged) and
``decode_raw`` (grouped with prefetch on and off, and ungrouped) of
both packages. Tolerance 2e-5 absolute on hidden states of magnitude
~1-4: fp32 on both sides, sums in another order. Pools are compared
with the same tolerance (written K/V rows come out of a projection).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.incubate.nn.fused_transformer import (
    FusedMultiTransformer as JStack, PagedKV as JPagedKV,
    rope_table as j_rope)
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    FusedMultiTransformer as TStack, PagedKV as TPagedKV,
    rope_table as t_rope)

D, H, DFF, L, PS = 128, 2, 256, 2, 4
TOL = 2e-5


@pytest.fixture(scope="module")
def stacks():
    import paddle_tpu as paddle

    paddle.seed(11)
    js = JStack(D, H, DFF, L, max_position=64)
    # non-trivial biases and LN parameters so every term is exercised
    rng = np.random.RandomState(0)
    params = {}
    for k, v in js.state_dict().items():
        a = np.asarray(v._data)
        if k.endswith(("_bias", "_scale")):
            a = a + rng.randn(*a.shape).astype(np.float32) * 0.1
        params[k] = a
        v._rebind(jnp.asarray(a))
    ts = TStack(D, H, DFF, L, max_position=64, device="cpu")
    load_jax_params(ts, params)
    return js, ts


def _ropes():
    jc, js_ = j_rope(64, D // H)
    tc, ts_ = t_rope(64, D // H)
    return (jc, js_), (tc, ts_)


def test_prefill_dense_matches_jax(stacks):
    js, ts = stacks
    (jc, jsn), (tc, tsn) = _ropes()
    x = np.random.RandomState(1).randn(3, 8, D).astype(np.float32)
    hj, _ = js.prefill_raw(js._stack(), jnp.asarray(x), None, None, jc, jsn)
    ht, cache = ts.prefill_raw(ts._stack(), torch.from_numpy(x), None,
                               None, tc, tsn)
    assert cache is None
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)


def _pool(rng, P, random):
    shape = (L * P, H, PS, D // H)
    if random:
        return rng.randn(*shape).astype(np.float32)
    return np.zeros(shape, np.float32)


def test_prefill_paged_matches_jax(stacks):
    js, ts = stacks
    (jc, jsn), (tc, tsn) = _ropes()
    rng = np.random.RandomState(2)
    b, s, P = 3, 8, 10
    x = rng.randn(b, s, D).astype(np.float32)
    tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    kp, vp = _pool(rng, P, False), _pool(rng, P, False)
    hj, cj = js.prefill_raw(js._stack(), jnp.asarray(x),
                            JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
                            jnp.asarray(tables), jc, jsn)
    ht, ct = ts.prefill_raw(ts._stack(), torch.from_numpy(x),
                            TPagedKV(torch.from_numpy(kp),
                                     torch.from_numpy(vp)),
                            torch.from_numpy(tables), tc, tsn)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), atol=TOL)


@pytest.fixture
def decode_flags(request):
    grouped, prefetch = request.param
    saved = (jflags.get_flags(["decode_grouped", "decode_prefetch"]),
             tflags.get_flags(["decode_grouped", "decode_prefetch"]))
    new = {"decode_grouped": grouped, "decode_prefetch": prefetch}
    jflags.set_flags(new)
    tflags.set_flags(new)
    yield request.param
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


@pytest.mark.parametrize("decode_flags", [("auto", True), ("on", False),
                                          ("off", True)],
                         indirect=True, ids=["grouped_prefetch",
                                             "grouped_no_prefetch",
                                             "ungrouped"])
def test_decode_matches_jax(stacks, decode_flags):
    js, ts = stacks
    (jc, jsn), (tc, tsn) = _ropes()
    rng = np.random.RandomState(3)
    b, P = 4, 12
    x = rng.randn(b, D).astype(np.float32)
    lens = np.array([8, 5, 0, 3], np.int32)          # page edge, idle row
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0], [6, 0, 0]],
                      np.int32)
    kp, vp = _pool(rng, P, True), _pool(rng, P, True)
    hj, cj = js.decode_raw(js._stack(), jnp.asarray(x),
                           JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
                           jnp.asarray(tables), jnp.asarray(lens), jc, jsn)
    ht, ct = ts.decode_raw(ts._stack(), torch.from_numpy(x),
                           TPagedKV(torch.from_numpy(kp.copy()),
                                    torch.from_numpy(vp.copy())),
                           torch.from_numpy(tables),
                           torch.from_numpy(lens), tc, tsn)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), atol=TOL)


def test_rope_and_split_match_jax():
    from paddle_tpu.incubate.nn.fused_transformer import (
        qkv_split_rope_fused as j_fused)
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        qkv_split_rope_fused as t_fused)

    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 32).astype(np.float32)
    w = rng.randn(32, 3 * 32).astype(np.float32) * 0.1
    bias = rng.randn(3 * 32).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1))
    (jc, jsn), (tc, tsn) = (j_rope(16, 16), t_rope(16, 16))
    outs_j = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                     jnp.asarray(pos), 2, 2, 16, jc, jsn)
    outs_t = t_fused(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias), torch.from_numpy(pos), 2, 2,
                     16, tc, tsn)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_later_slices_raise():
    with pytest.raises(NotImplementedError):
        TStack(D, H, DFF, L, moe_num_experts=4, device="cpu")
