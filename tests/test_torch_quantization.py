"""Parity of paddle_tpu_torch's quantization with paddle_tpu's.

Per-token activation quantization, the K/V row quantizer and the
weight-only int8 quantization of a transformer stack give BITWISE equal
int8 values and scales for equal inputs (the JAX functions called as
the JAX package's own tests call them, op by op); the int8 x int8
product has an equal int32 accumulator and a dequantized result within
1e-6 relative. A stack quantized by the JAX package loads into the
port's model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.fused_transformer import (
    FusedMultiTransformer as JStack)
from paddle_tpu.inference import FusedCausalLM as JLM
from paddle_tpu.nn.functional.paged_attention import (
    quantize_kv_rows as j_kv_quant)
from paddle_tpu.quantization.dynamic import (
    dynamic_act_quant as j_act_quant, int8_dot_dequant as j_dot)
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    FusedMultiTransformer as TStack)
from paddle_tpu_torch.inference import FusedCausalLM as TLM
from paddle_tpu_torch.nn.functional.paged_attention import (
    quantize_kv_rows as t_kv_quant)
from paddle_tpu_torch.quantization import (
    absmax_scale, dynamic_act_quant as t_act_quant,
    int8_dot_dequant as t_dot)
from paddle_tpu_torch.quantization.dynamic import _int32_matmul

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape, dtype):
    """Values with a spread of magnitudes, exact ties (x.5 after the
    scale) and an all-zero row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) \
        * rng.choice([1e-3, 0.3, 5.0, 300.0], shape[:-1])[..., None]
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1] = np.clip(rows[1], -1.0, 1.0)
    rows[1, :4] = [127.0, 63.5, -0.5, 1.5]        # scale 1: half-way ties
    jd, td = DTYPES[dtype]
    xj = jnp.asarray(x).astype(jd)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_act_quant_bitwise(dtype):
    xj, xt = _inputs(0, (64, 96), dtype)
    qj, sj = j_act_quant(xj)
    qt, st = t_act_quant(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert int(qt[0].abs().max()) == 0                 # the zero row
    assert st[0].item() == np.float32(1e-8)
    assert qt[1, :4].tolist() == [127, 64, -0, 2]      # halves to even


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bitwise(dtype):
    xj, xt = _inputs(1, (6, 4, 2, 64), dtype)
    qj, sj = j_kv_quant(xj)
    qt, st = t_kv_quant(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_absmax_scale_is_a_true_division():
    a = np.abs(np.random.RandomState(2).randn(4096)).astype(np.float32) * 50
    s = absmax_scale(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(s, np.maximum(a / np.float32(127.0),
                                                np.float32(1e-8)))


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_dot_dequant_matches_jax(with_bias):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 256).astype(np.float32) * 3
    w = rng.randint(-127, 128, (256, 48)).astype(np.int8)
    ws = (np.abs(rng.randn(48)) * 0.01 + 1e-3).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if with_bias else None
    qj, sj = j_act_quant(jnp.asarray(x))
    qt, st = t_act_quant(torch.from_numpy(x))
    acc_j = np.asarray(jax.lax.dot_general(
        qj.reshape(-1, 256), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    acc_t = _int32_matmul(qt.reshape(-1, 256), torch.from_numpy(w))
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    oj = j_dot(qj, sj, jnp.asarray(w), jnp.asarray(ws),
               bias=None if b is None else jnp.asarray(b))
    ot = t_dot(qt, st, torch.from_numpy(w), torch.from_numpy(ws),
               bias=None if b is None else torch.from_numpy(b))
    assert ot.shape == (2, 5, 48) and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6,
                               atol=1e-6)


def test_zero_row_is_finite_and_zero():
    x = torch.zeros(4, 32)
    x[1] = 1.0
    q, s = t_act_quant(x)
    assert torch.isfinite(s).all() and int(q[0].abs().max()) == 0
    out = t_dot(q, s, torch.ones(32, 8, dtype=torch.int8),
                torch.full((8,), 0.01))
    assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0


def test_quantize_weight_only_int8_bitwise():
    """Both packages quantize the same stack to the same int8 weights
    and [L, N] scales; ``_stack()`` then carries ``{kind}_scale``."""
    paddle.seed(5)
    js = JStack(64, 2, 128, 2, max_position=32)
    params = {k: np.asarray(v._data) for k, v in js.state_dict().items()}
    ts = TStack(64, 2, 128, 2, max_position=32, device="cpu")
    load_jax_params(ts, params)
    js.quantize_weight_only_int8()
    ts.quantize_weight_only_int8()
    wj, wt = js._stack(), ts._stack()
    assert set(wt) == set(wj)
    for kind in ("qkv", "out", "ffn1", "ffn2"):
        assert wt[f"{kind}_weight"].dtype == torch.int8
        np.testing.assert_array_equal(wt[f"{kind}_weight"].numpy(),
                                      np.asarray(wj[f"{kind}_weight"]))
        np.testing.assert_array_equal(wt[f"{kind}_scale"].numpy(),
                                      np.asarray(wj[f"{kind}_scale"]))
        assert tuple(wt[f"{kind}_scale"].shape) == (
            2, wt[f"{kind}_weight"].shape[2])


def test_load_jax_params_carries_a_quantized_stack():
    """A quantized JAX model's state_dict (int8 weights plus
    ``stack.*_scale_woq``) loads into a fresh port model, name for
    name; the two then prefill to the same hidden states (f32
    activations, 2e-5)."""
    cfg = dict(vocab_size=64, embed_dim=32, num_heads=4,
               dim_feedforward=64, num_layers=2, max_position=64)
    paddle.seed(9)
    jm = JLM(**cfg)
    jm.stack.quantize_weight_only_int8()
    params = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert "stack.qkv_scale_woq" in params
    tm = TLM(**cfg, device="cpu")
    load_jax_params(tm, params)
    own = dict(tm.named_parameters())
    assert set(own) == set(params)
    for k, a in params.items():
        np.testing.assert_array_equal(own[k].numpy(), a)
    from paddle_tpu.incubate.nn.fused_transformer import rope_table as jr
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        rope_table as tr)
    x = np.random.RandomState(4).randn(2, 6, 32).astype(np.float32)
    hj, _ = jm.stack.prefill_raw(jm.stack._stack(), jnp.asarray(x), None,
                                 None, *jr(64, 8))
    ht, _ = tm.stack.prefill_raw(tm.stack._stack(), torch.from_numpy(x),
                                 None, None, *tr(64, 8))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=2e-5)
