"""Parity of paddle_tpu_torch's A8W8 streamed GEMM with paddle_tpu's.

The plain version of kernel B5 (``_stream_linear_a8w8_plain``: exact
int32 product, ``acc * x_scale * w_scale + bias``, activation) against
the JAX kernel ``_stream_linear_a8w8`` in Pallas interpret mode, as
tests/test_stream_linear_a8w8.py runs it: stacked int8 weights with a
layer index, with and without bias, gelu and relu, M in {1, 8, 32};
rtol 1e-5 (the dequant and activation in fp32 on both sides).
``stream_linear(act_quant=True)`` against the JAX public call, and the
documented error bound of the dynamic act quant against an fp32
reference:

    |out - x @ dequant(w) - b| <= 0.5 * act_scale(row) * sum_k |w_deq|
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.stream_linear import (
    _stream_linear_a8w8 as jax_a8w8, stream_linear as jax_stream_linear)
from paddle_tpu.quantization.dynamic import dynamic_act_quant as j_quant
from paddle_tpu_torch.nn.functional import stream_linear as sl
from paddle_tpu_torch.quantization import dynamic_act_quant as t_quant

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

L, K, N = 3, 256, 384


def _weights(seed=0):
    """Weight-only int8 per output channel (the engine's layout): w
    [L, K, N] int8, s [L, N] f32, bias [L, N] f32."""
    rng = np.random.RandomState(seed)
    w = rng.randn(L, K, N).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=1) / np.float32(127.0),
                   np.float32(1e-8)).astype(np.float32)
    wq = np.clip(np.round(w / s[:, None, :]), -127, 127).astype(np.int8)
    b = rng.randn(L, N).astype(np.float32)
    return wq, s, b


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("activation", [None, "gelu", "relu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_jax_interpret_kernel(M, activation, with_bias):
    wq, s, b = _weights()
    x = np.random.RandomState(M).randn(M, K).astype(np.float32) * 2
    xq, xs = j_quant(jnp.asarray(x))
    layer = 2
    ref = jax_a8w8(xq, xs, jnp.asarray(wq), jnp.asarray(s)[:, None, :],
                   jnp.asarray(b)[:, None, :] if with_bias else None,
                   layer, activation, jnp.float32, interpret=True)
    out = sl._stream_linear_a8w8_plain(
        _t(xq), _t(xs), _t(wq), _t(s), layer, _t(b) if with_bias else None,
        activation, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False])
def test_act_quant_stream_linear_matches_jax(dtype, stacked):
    """The public call: act quant + int8 product + dequant + bias + act,
    out in x's dtype (bf16 outputs round the same fp32 values: one ulp
    at most)."""
    wq, s, b = _weights(1)
    x = np.random.RandomState(5).randn(8, K).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jd)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(td)
    if stacked:
        kj = dict(layer=1, bias=jnp.asarray(b), scale=jnp.asarray(s))
        kt = dict(layer=1, bias=_t(b), scale=_t(s))
        wj, wt = jnp.asarray(wq), _t(wq)
    else:
        kj = dict(bias=jnp.asarray(b[1]), scale=jnp.asarray(s[1]))
        kt = dict(bias=_t(b[1]), scale=_t(s[1]))
        wj, wt = jnp.asarray(wq[1]), _t(wq[1])
    ref = jax_stream_linear(xj, wj, activation="gelu", act_quant=True, **kj)
    out = sl.stream_linear(xt, wt, activation="gelu", act_quant=True, **kt)
    assert out.dtype == td
    r = np.asarray(ref.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** (
        np.floor(np.log2(np.abs(r).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), r, rtol=0, atol=tol)


def test_error_bound_against_fp32():
    wq, s, b = _weights(2)
    x = np.random.RandomState(7).randn(32, K).astype(np.float32) * 3
    out = sl.stream_linear(_t(x), _t(wq), layer=0, bias=_t(b), scale=_t(s),
                           act_quant=True, out_dtype=torch.float32).numpy()
    w_deq = wq[0].astype(np.float32) * s[0][None, :]
    ref = x @ w_deq + b[0]
    xs = t_quant(_t(x))[1].numpy()
    bound = 0.5 * xs[:, None] * np.abs(w_deq).sum(0)[None, :] + 1e-4
    assert (np.abs(out - ref) <= bound).all()
    assert np.abs(out - ref).max() > 0              # quantization did act


def test_act_quant_needs_int8_weights_and_scales():
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="int8"):
        sl.stream_linear(x, torch.zeros(16, 16), act_quant=True)
    with pytest.raises(ValueError, match="int8"):
        sl.stream_linear(x, torch.zeros(16, 16, dtype=torch.int8),
                         act_quant=True)


def test_cpu_calls_count_no_launch(monkeypatch):
    from paddle_tpu_torch import _kernels

    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel was requested on the CPU")
    monkeypatch.setattr(_kernels, "lib", refuse)
    wq, s, b = _weights(3)
    before = (sl.a8w8_launches, sl.w8_launches)
    x = torch.randn(4, K)
    sl.stream_linear(x, _t(wq), layer=0, scale=_t(s), act_quant=True)
    sl.stream_linear(x, _t(wq), layer=0, scale=_t(s))
    assert (sl.a8w8_launches, sl.w8_launches) == before
