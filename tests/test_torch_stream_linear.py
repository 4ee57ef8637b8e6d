"""Parity of paddle_tpu_torch's weight-streaming linears with paddle_tpu's.

``stream_linear``'s plain version against the JAX package's fallback
branch (stream_linear.py:363-375, what it runs off the TPU), and the
grouped tail's plain version against the JAX tail kernel in Pallas
interpret mode (as tests/test_stream_grouped.py runs it). Inputs come
from numpy with a fixed seed.

Tolerances: float32 — the same fp32 products summed in another order,
1e-5 relative and absolute. bfloat16 — the port's plain tail follows
the JAX ``_tail_fallback`` and rounds h2 (and each partial sum of the
residual stream) to bf16, where the JAX kernel keeps h2 in fp32: up to
4 bf16 ulps at the output's largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.stream_linear import (
    stream_layer_tail as jax_tail, stream_linear as jax_stream_linear)
from paddle_tpu_torch.nn.functional import stream_linear as sl

EPS = 1e-5
L, M, D, DFF = 3, 8, 128, 256


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("activation", [None, "gelu", "relu"])
def test_stream_linear_plain_matches_jax_fallback(stacked, activation):
    rng = np.random.RandomState(1)
    x = rng.randn(M, D).astype(np.float32)
    w = (rng.randn(L, D, 384) * 0.05).astype(np.float32)
    b = (rng.randn(L, 384) * 0.1).astype(np.float32)
    if stacked:
        args_j = (_j(x), _j(w)), dict(layer=2, bias=_j(b))
        args_t = (_t(x), _t(w)), dict(layer=2, bias=_t(b))
    else:
        args_j = (_j(x), _j(w[2])), dict(bias=_j(b[2]))
        args_t = (_t(x), _t(w[2])), dict(bias=_t(b[2]))
    ref = jax_stream_linear(*args_j[0], activation=activation,
                            **args_j[1])
    out = sl.stream_linear(*args_t[0], activation=activation, **args_t[1])
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_stream_linear_f32_out(x_dtype):
    """The LM-head form: bf16 (or f32) operands, fp32 logits; bf16
    products are exact in fp32, so only the summation order differs."""
    rng = np.random.RandomState(2)
    x = rng.randn(M, D).astype(np.float32)
    w = (rng.randn(D, 512) * 0.05).astype(np.float32)
    jd = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    ref = jax_stream_linear(_j(x, jd), _j(w, jd), out_dtype=jnp.float32)
    out = sl.stream_linear(_t(x, td), _t(w, td), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5,
                               atol=1e-5)


def test_stream_linear_later_slices_raise():
    """Tensor parallelism (``reduce_axis=``) is a later slice, in every
    weight form."""
    x, w = torch.zeros(2, 8), torch.zeros(8, 8)
    wq, s = torch.zeros(8, 8, dtype=torch.int8), torch.ones(8)
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, wq, scale=s, reduce_axis="mp")
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, wq, scale=s, act_quant=True, reduce_axis="mp")
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, w, reduce_axis="mp")
    with pytest.raises(NotImplementedError):
        sl.stream_layer_tail(x, x, wq, wq, wq, bo=s, b1=s, b2=s,
                             ln2_scale=s, ln2_bias=s, epsilon=EPS, so=s,
                             s1=s, s2=s, reduce_axis="mp")


@pytest.mark.parametrize("knob", ["overlap", "interpret"])
def test_tpu_only_knobs_are_not_accepted(knob):
    """The TPU kernels' scheduling knobs have no meaning for the CUDA
    path; passing one is an error, not a silent no-op."""
    x, w = torch.zeros(2, 8), torch.zeros(8, 8)
    with pytest.raises(TypeError):
        sl.stream_linear(x, w, **{knob: True})
    z = torch.zeros(8)
    with pytest.raises(TypeError):
        sl.stream_layer_tail(x, x, w, w, w, bo=z, b1=z, b2=z,
                             ln2_scale=z, ln2_bias=z, epsilon=EPS,
                             **{knob: True})


def _tail_params(seed=0):
    rng = np.random.RandomState(seed)

    def nrm(*s, scale=0.05):
        return (rng.randn(*s) * scale).astype(np.float32)
    return dict(
        wo=nrm(L, D, D), w1=nrm(L, D, DFF), w2=nrm(L, DFF, D),
        wq=nrm(L, D, 3 * D), bo=nrm(L, D, scale=0.1),
        b1=nrm(L, DFF, scale=0.1), b2=nrm(L, D, scale=0.1),
        bq=nrm(L, 3 * D, scale=0.1),
        l2s=1 + nrm(L, D, scale=0.1), l2b=nrm(L, D, scale=0.1),
        l1s=1 + nrm(L, D, scale=0.1), l1b=nrm(L, D, scale=0.1),
        att=rng.randn(M, D).astype(np.float32),
        h=rng.randn(M, D).astype(np.float32))


def _run_tail(fn, conv, p, layer, with_q, **kw):
    nq = None
    if with_q:
        nq = dict(w=conv(p["wq"]), b=conv(p["bq"]), ln_s=conv(p["l1s"]),
                  ln_b=conv(p["l1b"]), layer=min(layer + 1, L - 1))
    return fn(conv(p["att"]), conv(p["h"]), conv(p["wo"]), conv(p["w1"]),
              conv(p["w2"]), layer=layer, bo=conv(p["bo"]),
              b1=conv(p["b1"]), b2=conv(p["b2"]), ln2_scale=conv(p["l2s"]),
              ln2_bias=conv(p["l2b"]), epsilon=EPS, activation="gelu",
              next_qkv=nq, **kw)


@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_tail_plain_matches_jax_interpret_kernel(with_q, dtype, layer):
    p = _tail_params(layer)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = _run_tail(jax_tail, lambda a: _j(a, jd), p, layer, with_q,
                    interpret=True)
    out = _run_tail(sl.stream_layer_tail, lambda a: _t(a, td), p, layer,
                    with_q)
    refs = ref if with_q else (ref,)
    outs = out if with_q else (out,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == td
        r = _np(r)
        m = float(np.abs(r).max())
        if dtype == "float32":
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5)
        else:
            assert float(np.abs(o.float().numpy() - r).max()) \
                <= 4 * 2 ** -7 * m


def test_tail_unstacked_matches_stacked():
    """2-D weights (one layer's view) compute what the stacked form with
    that layer index computes."""
    p = _tail_params(5)
    conv = _t
    st = _run_tail(sl.stream_layer_tail, conv, p, 1, True)
    nq = dict(w=conv(p["wq"][2]), b=conv(p["bq"][2]),
              ln_s=conv(p["l1s"][2]), ln_b=conv(p["l1b"][2]))
    un = sl.stream_layer_tail(
        conv(p["att"]), conv(p["h"]), conv(p["wo"][1]), conv(p["w1"][1]),
        conv(p["w2"][1]), bo=conv(p["bo"][1]), b1=conv(p["b1"][1]),
        b2=conv(p["b2"][1]), ln2_scale=conv(p["l2s"][1]),
        ln2_bias=conv(p["l2b"][1]), epsilon=EPS, activation="gelu",
        next_qkv=nq)
    for a, b in zip(st, un):
        assert torch.equal(a, b)


def test_ln_and_activation_match_jax():
    """The tail's building blocks: population-variance LN and the tanh
    GELU (jax.nn.gelu's default)."""
    import jax

    from paddle_tpu.nn.functional.stream_linear import _ln_f32

    rng = np.random.RandomState(3)
    x = rng.randn(4, 64).astype(np.float32) * 3
    s, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        sl._ln_f32(_t(x), _t(s), _t(b), EPS).numpy(),
        np.asarray(_ln_f32(_j(x), _j(s), _j(b), EPS)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        sl._apply_activation(_t(x), "gelu").numpy(),
        np.asarray(jax.nn.gelu(_j(x))), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------
# int8 weights (weight-only quantization): scale= and so/s1/s2
# ---------------------------------------------------------------------

def _int8(w):
    """Weight-only int8 of w [.., K, N] per output column: (q, scale)."""
    s = np.maximum(np.abs(w).max(axis=-2) / np.float32(127.0),
                   np.float32(1e-8)).astype(np.float32)
    q = np.clip(np.round(w / s[..., None, :]), -127, 127).astype(np.int8)
    return q, s


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_stream_linear_int8_matches_jax_fallback(stacked, activation,
                                                 x_dtype):
    """``scale=``: int8 weights exact in fp32 on both sides, the scale on
    the fp32 accumulator, then bias and activation (f32: 1e-5; bf16
    outputs round the same fp32 value, one ulp at most)."""
    rng = np.random.RandomState(4)
    x = rng.randn(M, D).astype(np.float32)
    wq, s = _int8((rng.randn(L, D, 384) * 0.05).astype(np.float32))
    b = (rng.randn(L, 384) * 0.1).astype(np.float32)
    jd = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    if stacked:
        aj, at = (wq, s, b), (wq, s, b)
        kj, kt = dict(layer=1), dict(layer=1)
    else:
        aj = at = (wq[1], s[1], b[1])
        kj = kt = {}
    ref = jax_stream_linear(_j(x, jd), jnp.asarray(aj[0]), bias=_j(aj[2]),
                            scale=_j(aj[1]), activation=activation, **kj)
    out = sl.stream_linear(_t(x, td), torch.from_numpy(at[0]),
                           bias=_t(at[2]), scale=_t(at[1]),
                           activation=activation, **kt)
    assert out.dtype == td
    r = _np(ref)
    tol = 1e-5 if x_dtype == "float32" else 2.0 ** (
        np.floor(np.log2(np.abs(r).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), r, rtol=0,
                               atol=max(tol, 1e-5))


def _int8_tail_params(seed):
    p = _tail_params(seed)
    for w, sc in (("wo", "so"), ("w1", "s1"), ("w2", "s2"), ("wq", "sq")):
        p[w], p[sc] = _int8(p[w])
    return p


def _run_tail_int8(fn, conv, wconv, p, layer, with_q, **kw):
    """The tail over int8 stacks: ``conv`` converts the float operands,
    ``wconv`` the int8 weights."""
    nq = None
    if with_q:
        nq = dict(w=wconv(p["wq"]), b=conv(p["bq"]), s=conv(p["sq"]),
                  ln_s=conv(p["l1s"]), ln_b=conv(p["l1b"]),
                  layer=min(layer + 1, L - 1))
    return fn(conv(p["att"]), conv(p["h"]), wconv(p["wo"]), wconv(p["w1"]),
              wconv(p["w2"]), layer=layer, bo=conv(p["bo"]),
              b1=conv(p["b1"]), b2=conv(p["b2"]), ln2_scale=conv(p["l2s"]),
              ln2_bias=conv(p["l2b"]), epsilon=EPS, activation="gelu",
              so=conv(p["so"]), s1=conv(p["s1"]), s2=conv(p["s2"]),
              next_qkv=nq, **kw)


@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_form", ["interpret", "fallback"])
def test_tail_int8_matches_jax(with_q, dtype, jax_form):
    """int8 stacks with so/s1/s2 (and the next QKV's s): the port's
    plain tail against the JAX tail kernel in interpret mode and the
    JAX ``_tail_fallback``. float32: 1e-5 (int8 weights exact, fp32
    sums in another order). bfloat16: the plain tail rounds each int8
    product to bf16 before its bf16-rounded scale, and h2 and each
    partial sum of the residual stream (as ``_tail_fallback`` does);
    the JAX kernel scales the fp32 accumulator by the f32 scale and
    keeps h2 in fp32; the JAX fallback rounds at the plain tail's
    points, its products summed in another order. Both: 4 bf16 ulps at
    the output's largest magnitude, as the float tail (measured at most
    1.04 against the kernel and 1.56 against the fallback, layers
    0-2)."""
    layer = 1
    p = _int8_tail_params(layer + 7)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(interpret=True) if jax_form == "interpret" else {}
    ref = _run_tail_int8(jax_tail, lambda a: _j(a, jd), jnp.asarray, p,
                         layer, with_q, **kw)
    out = _run_tail_int8(sl.stream_layer_tail, lambda a: _t(a, td),
                         torch.from_numpy, p, layer, with_q)
    refs = ref if with_q else (ref,)
    outs = out if with_q else (out,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == td
        r = _np(r)
        m = float(np.abs(r).max())
        if dtype == "float32":
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5)
        else:
            assert float(np.abs(o.float().numpy() - r).max()) \
                <= 4 * 2 ** -7 * m


def test_tail_scales_all_or_none():
    z, w = torch.zeros(8), torch.zeros(8, 8, dtype=torch.int8)
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="so/s1/s2"):
        sl.stream_layer_tail(x, x, w, w, w, bo=z, b1=z, b2=z, ln2_scale=z,
                             ln2_bias=z, epsilon=EPS, so=z)


# ---------------------------------------------------------------------
# The bf16 GEMM's split-K: the planner, its PyTorch rendering, the launch
# ---------------------------------------------------------------------

#: the d2048 decode step's GEMMs (K, N) and the plan at 132 SMs:
#: (split, steps); blocks are 64-column tiles x split
PLAN_SHAPES = {"qkv": ((2048, 6144), (3, 11)),
               "o_proj": ((2048, 2048), (8, 4)),
               "ffn1": ((2048, 8192), (3, 11)),
               "ffn2": ((8192, 2048), (9, 15)),
               "lm_head": ((2048, 51200), (1, 32))}


@pytest.mark.parametrize("m", [1, 32, 64])
@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_stream_plan_fills_the_card(name, m):
    """Two blocks an SM (ceil), at most 16 slices of at least two
    k-steps, none empty; the workspace holds split * M * N floats; the
    LM head's 800 column tiles fill the card unsplit."""
    (K, N), (split, steps) = PLAN_SHAPES[name]
    tiles = N // sl.STREAM_BN
    want = (split, steps, tiles * split, split * m * N if split > 1 else 0)
    assert sl.stream_plan(m, K, N, 132) == want
    ksteps = K // sl.STREAM_BK
    assert (split - 1) * steps < ksteps <= split * steps


@pytest.mark.parametrize("shape,want", [
    ((100, 2048, 2048, 132), (5, 7, 320, 1024000)),  # two row blocks
    ((32, 136, 200, 132), (1, 3, 4, 0)),            # three k-steps
    ((32, 256, 2048, 132), (2, 2, 64, 131072)),     # two-step floor
    ((32, 65536, 64, 132), (16, 64, 16, 32768)),    # 16-slice cap
])
def test_stream_plan_edges(shape, want):
    assert sl.stream_plan(*shape) == want


@pytest.mark.parametrize("K,split,steps", [(2048, 8, 4), (8192, 9, 15),
                                           (136, 2, 2)])
def test_split_k_rendering_matches_plain(K, split, steps):
    """The kernel's split in PyTorch (whole 64-row k-steps a slice, f32
    partials summed in split order) equals the plain product; leaving
    out one slice (the chip check's control) does not."""
    rng = np.random.RandomState(K)
    x = torch.from_numpy(rng.randn(7, K).astype(np.float32))
    w = torch.from_numpy(rng.randn(K, 48).astype(np.float32))
    ref = sl._stream_linear_plain(x, w)
    got = sl._split_k_plain(x, w, split, steps)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)
    bad = sl._split_k_plain(x, w, split, steps, drop=split - 1)
    assert float((bad - ref).abs().max()) > 1.0


def test_gemm_launch_arguments(monkeypatch):
    """The launch the wrapper makes, the library faked: bf16 takes the
    plan's split with the stream's workspace (at least split * M * N
    floats) and merge counters (zeros), kept for the next call; f32
    takes one slice and neither."""
    calls = []

    class Lib:
        def ptt_stream_linear(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(sl._kernels, "lib", lambda name: Lib())
    monkeypatch.setattr(sl._kernels, "stream_ptr", lambda dev: 7)
    monkeypatch.setattr(sl, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sl, "_SPLIT", {})
    for dtype in (torch.bfloat16, torch.bfloat16, torch.float32):
        x = torch.zeros(32, 2048, dtype=dtype)
        w = torch.zeros(2048, 2048, dtype=dtype)
        sl._gemm("stream_linear", x, w)
    (bf, bf2, f32) = calls
    ws, tickets, split, steps, stream = bf[16:21]
    assert (split, steps, stream) == (8, 4, 7) and bf2[16:21] == bf[16:21]
    buf_ws, buf_t = sl._SPLIT[(torch.device("cpu"), 7)]
    assert (buf_ws.data_ptr(), buf_t.data_ptr()) == (ws, tickets)
    assert buf_ws.numel() >= 8 * 32 * 2048 and buf_ws.dtype == torch.float32
    assert buf_t.numel() >= 2048 // sl.STREAM_BN
    assert int(buf_t.abs().sum()) == 0
    assert f32[16:20] == (None, None, 1, 1)
