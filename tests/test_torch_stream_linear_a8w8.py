"""Parity of paddle_tpu_torch's A8W8 streamed GEMM with paddle_tpu's.

The plain version of kernel B5 (``_stream_linear_a8w8_plain``: exact
int32 product, ``acc * x_scale * w_scale + bias``, activation) against
the JAX kernel ``_stream_linear_a8w8`` in Pallas interpret mode, as
tests/test_stream_linear_a8w8.py runs it: stacked int8 weights with a
layer index, with and without bias, gelu and relu, M in {1, 8, 32};
rtol 1e-5 (the dequant and activation in fp32 on both sides).
``stream_linear(act_quant=True)`` against the JAX public call, and the
documented error bound of the dynamic act quant against an fp32
reference; B5's split plan, its split-K arithmetic rendered in PyTorch
(bitwise against the JAX kernel without a bias) and its card route with
the library faked. The bound:

    |out - x @ dequant(w) - b| <= 0.5 * act_scale(row) * sum_k |w_deq|
"""
import functools

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


@functools.lru_cache(maxsize=None)
def _jax_case(M, activation, with_bias):
    """x_q, x_scale and the JAX kernel's output in interpret mode at
    layer 2 (shared by the tests below)."""
    wq, s, b = _weights()
    x = np.random.RandomState(M).randn(M, K).astype(np.float32) * 2
    xq, xs = j_quant(jnp.asarray(x))
    ref = jax_a8w8(xq, xs, jnp.asarray(wq), jnp.asarray(s)[:, None, :],
                   jnp.asarray(b)[:, None, :] if with_bias else None,
                   2, activation, jnp.float32, interpret=True)
    return np.asarray(xq), np.asarray(xs), np.asarray(ref)


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("activation", [None, "gelu", "relu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_jax_interpret_kernel(M, activation, with_bias):
    wq, s, b = _weights()
    xq, xs, ref = _jax_case(M, activation, with_bias)
    out = sl._stream_linear_a8w8_plain(
        _t(xq), _t(xs), _t(wq), _t(s), 2, _t(b) if with_bias else None,
        activation, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


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


# ---------------------------------------------------------------------
# B5 on the card: its split plan, a rendering of its arithmetic, the
# card route (library faked)
# ---------------------------------------------------------------------

#: the A8W8 step's four projections (K, N) and the plan at 132 SMs:
#: (split, steps); blocks are 128-column tiles x split
A8W8_PLANS = {"qkv": ((2048, 6144), (6, 6)), "o_proj": ((2048, 2048), (8, 4)),
              "ffn1": ((2048, 8192), (5, 7)), "ffn2": ((8192, 2048), (8, 16))}


@pytest.mark.parametrize("m", [1, 32, 64])
@pytest.mark.parametrize("name", list(A8W8_PLANS))
def test_a8w8_plan_fills_the_card(name, m):
    """Every K slice holds at least one 64-row k-step and the slices
    cover K once; the blocks number two an SM or more, by at most one
    column tile's worth of slices (the split rounds up), unless the split
    reaches its cap of 8 (each slice also costs the tile's last block a
    read of its partial); the workspace is split * M * N int32
    partials."""
    (K, N), (split, steps) = A8W8_PLANS[name]
    tiles = N // sl.A8W8_BN
    assert sl.a8w8_plan(m, K, N, 132) == (split, steps, tiles * split,
                                          split * m * N)
    ksteps = K // sl.A8W8_BK
    spans = [(s * steps, min(ksteps, (s + 1) * steps)) for s in range(split)]
    assert all(hi > lo for lo, hi in spans)
    assert [k for lo, hi in spans for k in range(lo, hi)] == \
        list(range(ksteps))
    assert 2 * 132 <= tiles * split < 2 * 132 + 2 * tiles or \
        split == sl._A8W8_MAX_SPLIT == 8


def test_a8w8_plan_unsplit_and_row_blocks():
    """One slice when the tiles fill the card (workspace 0); rows past 64
    add row blocks that the split counts."""
    assert sl.a8w8_plan(32, 2048, 6144, 8) == (1, 32, 48, 0)
    assert sl.a8w8_plan(100, 2048, 2048, 132) == (8, 4, 256, 8 * 100 * 2048)


def _b5_render(xq, xs, w, s, bias, activation, split, steps):
    """B5's arithmetic in PyTorch, as the kernel runs it: per K slice of
    ``steps`` 64-row k-steps its exact int32 partial, formed in the
    products' stride-4 column order (product j of a warp's 32 columns
    takes columns j, j + 4, ..., j + 28) and put back in column order;
    the partials summed in split order; then the dequant ``acc *
    x_scale * scale + bias`` and the activation, in f32."""
    M, K = xq.shape
    N = w.shape[1]
    order = torch.tensor([c0 + 4 * n + j for c0 in range(0, N, 32)
                          for j in range(4) for n in range(8)])
    back = torch.argsort(order)
    span = steps * sl.A8W8_BK
    acc = torch.zeros(M, N, dtype=torch.int32)
    for sl_i in range(split):
        ks = slice(sl_i * span, min(K, (sl_i + 1) * span))
        part = xq[:, ks].to(torch.int32) @ w[ks][:, order].to(torch.int32)
        acc += part[:, back]
    out = acc.float() * xs.float()[:, None] * s.float()
    if bias is not None:
        out = out + bias.float()
    return sl._apply_activation(out, activation)


def test_b5_lane_holds_eight_consecutive_columns():
    """The epilogue's store: fragment e of product j at lane 4 g + a is
    n8 column 2 a + e, in the stride-4 order the warp's column 4 (2 a +
    e) + j, so a lane's 8 values are columns 8 a .. 8 a + 7 of its rows."""
    for a in range(4):
        cols = sorted(4 * (2 * a + e) + j for j in range(4) for e in range(2))
        assert cols == list(range(8 * a, 8 * a + 8))


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("split,steps", [(1, 4), (2, 2), (4, 1)])
def test_b5_rendering_matches_jax(M, with_bias, split, steps):
    """The rendering, f32 with no activation, against the JAX kernel in
    interpret mode: bitwise without a bias (XLA's dequant rounds step by
    step as the kernel does), within 1e-5 with one (XLA contracts the
    bias add into an FMA) and there bitwise against the plain version.
    Leaving out one K slice (the chip check's control) moves it."""
    wq, s, b = _weights()
    xq, xs, ref = _jax_case(M, None, with_bias)
    bias = _t(b[2]) if with_bias else None
    got = _b5_render(_t(xq), _t(xs), _t(wq[2]), _t(s[2]), bias, None,
                     split, steps)
    plain = sl._a8w8_split_plain(_t(xq), _t(xs), _t(wq[2]), _t(s[2]), split,
                                 steps, bias)
    assert torch.equal(got, plain)
    assert torch.equal(got, sl._stream_linear_a8w8_plain(
        _t(xq), _t(xs), _t(wq), _t(s), 2, _t(b) if with_bias else None))
    if with_bias:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
    if split > 1:
        ctrl = sl._a8w8_split_plain(_t(xq), _t(xs), _t(wq[2]), _t(s[2]),
                                    split, steps, bias, drop=split // 2)
        assert float((ctrl - got).abs().max()) > 1.0


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_b5_rendering_with_activation_matches_jax(activation):
    wq, s, b = _weights()
    xq, xs, ref = _jax_case(32, activation, True)
    got = _b5_render(_t(xq), _t(xs), _t(wq[2]), _t(s[2]), _t(b[2]),
                     activation, 2, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sms,M", [(132, 32), (132, 100), (8, 32)])
def test_a8w8_launch_arguments(monkeypatch, sms, M):
    """The launch the wrapper makes, the library faked: a8w8_plan's split
    and steps, and with a split the stream's workspace (at least split *
    M * N elements, read as int32 partials) and merge counters (zeros),
    the same buffers B2 uses and kept for the next call; one launch
    counted. Unsplit: no workspace."""
    calls = []

    class Lib:
        def ptt_stream_linear_a8w8(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(sl._kernels, "lib", lambda name: Lib())
    monkeypatch.setattr(sl._kernels, "stream_ptr", lambda dev: 7)
    monkeypatch.setattr(sl, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(sl, "_SPLIT", {})
    Kp, Np = 2048, 2048
    xq = torch.zeros(M, Kp, dtype=torch.int8)
    xs = torch.ones(M)
    w = torch.zeros(Kp, Np, dtype=torch.int8)
    before = sl.a8w8_launches
    for _ in range(2):
        out = sl._stream_linear_a8w8(xq, xs, w, torch.ones(Np),
                                     torch.zeros(Np, dtype=torch.bfloat16),
                                     "gelu", torch.bfloat16)
    assert sl.a8w8_launches == before + 2
    assert out.shape == (M, Np) and out.dtype == torch.bfloat16
    first, second = calls
    split, steps, blocks, n_ws = sl.a8w8_plan(M, Kp, Np, sms)
    # M, K, N, activation, ws, counters, split, steps, stream
    assert first[8:12] == (M, Kp, Np, 1)
    assert first[14:17] == (split, steps, 7) and second[12:17] == first[12:17]
    if split == 1:
        assert first[12:14] == (None, None) and not sl._SPLIT
        return
    buf_ws, buf_t = sl._SPLIT[(torch.device("cpu"), 7)]
    assert (buf_ws.data_ptr(), buf_t.data_ptr()) == first[12:14]
    assert buf_ws.numel() >= split * M * Np
    assert buf_t.numel() >= blocks // split and int(buf_t.abs().sum()) == 0
