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
    x, w = torch.zeros(2, 8), torch.zeros(8, 8)
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, w, scale=torch.ones(8))
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, w, act_quant=True)
    with pytest.raises(NotImplementedError):
        sl.stream_linear(x, w, reduce_axis="mp")


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
