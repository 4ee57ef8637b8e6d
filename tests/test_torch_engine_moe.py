"""Parity of paddle_tpu_torch's MoE serving with paddle_tpu's.

A tiny float32 MoE FusedCausalLM (vocab 64, d 64, 4 heads, dff 128, 2
layers, 4 experts, top-2) built by the JAX package with random weights
(unit-scale embeddings, so the greedy streams vary) and carried into the
port with ``load_jax_params``. Greedy tokens, the serving scheduler's
action log and page accounting are integers and must be IDENTICAL;
hidden states of ``prefill_raw``/``decode_raw`` agree within 1e-5
(fp32 on both sides, sums in another order). The JAX ServingEngine is
slow on the CPU, so its workload runs once, in a module-scoped fixture.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.fused_transformer import PagedKV as JPagedKV
from paddle_tpu.inference import (ContinuousBatchingEngine as JCBE,
                                  FusedCausalLM as JLM,
                                  GenerationEngine as JGE)
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import SLOConfig as JSLO
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    PagedKV as TPagedKV)
from paddle_tpu_torch.inference import (ContinuousBatchingEngine as TCBE,
                                        FusedCausalLM as TLM,
                                        GenerationEngine as TGE)
from paddle_tpu_torch.serving import ServingEngine as TEngine
from paddle_tpu_torch.serving import SLOConfig as TSLO

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

CFG = dict(vocab_size=64, embed_dim=64, num_heads=4, dim_feedforward=128,
           num_layers=2, max_position=128, moe_num_experts=4, moe_top_k=2)
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JLM(**CFG)
    rng = np.random.RandomState(0)
    params = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v._data)
        if k == "embed":
            a = rng.randn(*a.shape).astype(np.float32)
        elif k.endswith("weight") or k.endswith(("moe_w1", "moe_w2")):
            a = rng.randn(*a.shape).astype(np.float32) * 0.2
        elif k.endswith(("_bias", "_scale", "moe_b1", "moe_b2")):
            a = a + rng.randn(*a.shape).astype(np.float32) * 0.1
        params[k] = a
        v._rebind(jnp.asarray(a))
    tm = TLM(**CFG, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


def test_moe_stack_names_and_shapes(models):
    jm, tm = models
    js, ts = jm.stack._stack(), tm.stack._stack()
    assert sorted(js) == sorted(ts)
    assert "ffn1_weight" not in ts
    for n in js:
        assert tuple(ts[n].shape) == tuple(js[n].shape), n


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 64, n) for n in (5, 9, 3, 12)]


@pytest.mark.parametrize("decode_chunk", [None, 3])
def test_generate_tokens_identical(models, decode_chunk):
    jm, tm = models
    kw = dict(page_size=4, max_length=40, decode_chunk=decode_chunk)
    oj = JGE(jm, **kw).generate(_prompts(), max_new_tokens=12)
    ot = TGE(tm, **kw).generate(_prompts(), max_new_tokens=12)
    np.testing.assert_array_equal(ot, oj)
    assert len({tuple(r) for r in ot[:, -12:]}) > 1


def test_continuous_batching_tokens_identical(models):
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, n) for n in (6, 17, 2, 11, 8)]

    def serve(cls, model):
        eng = cls(model, max_batch=2, page_size=4, max_length=48,
                  decode_chunk=3)
        ids = [eng.submit(p, max_new_tokens=n)
               for p, n in zip(prompts, (7, 4, 9, 5, 6))]
        free0 = eng._mgr.free_pages
        by_id = {r.id: r for r in eng.run()}
        return [list(by_id[i].generated) for i in ids], free0, \
            eng._mgr.free_pages
    assert serve(TCBE, tm) == serve(JCBE, jm)


def _pool(rng, P, fill):
    shape = (CFG["num_layers"] * P, CFG["num_heads"], 4,
             CFG["embed_dim"] // CFG["num_heads"])
    return rng.randn(*shape).astype(np.float32) if fill \
        else np.zeros(shape, np.float32)


def test_prefill_and_decode_hidden_match(models):
    jm, tm = models
    js, ts = jm.stack, tm.stack
    from paddle_tpu.incubate.nn.fused_transformer import rope_table as jr
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        rope_table as tr)
    jc, jsn = jr(128, 16)
    tc, tsn = tr(128, 16)
    rng = np.random.RandomState(4)
    # prefill: 3 rows of 8 tokens into pages 1..6
    x = rng.randn(3, 8, 64).astype(np.float32)
    tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    kp, vp = _pool(rng, 10, False), _pool(rng, 10, False)
    hj, cj = js.prefill_raw(js._stack(), jnp.asarray(x),
                            JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
                            jnp.asarray(tables), jc, jsn)
    ht, ct = ts.prefill_raw(ts._stack(), torch.from_numpy(x),
                            TPagedKV(torch.from_numpy(kp),
                                     torch.from_numpy(vp)),
                            torch.from_numpy(tables), tc, tsn)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=TOL)
    # decode: a page edge and an idle row
    xd = rng.randn(4, 64).astype(np.float32)
    lens = np.array([8, 5, 0, 3], np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0], [6, 0, 0]],
                      np.int32)
    kp, vp = _pool(rng, 12, True), _pool(rng, 12, True)
    hj, cj = js.decode_raw(js._stack(), jnp.asarray(xd),
                           JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
                           jnp.asarray(tables), jnp.asarray(lens), jc, jsn)
    ht, ct = ts.decode_raw(ts._stack(), torch.from_numpy(xd),
                           TPagedKV(torch.from_numpy(kp.copy()),
                                    torch.from_numpy(vp.copy())),
                           torch.from_numpy(tables),
                           torch.from_numpy(lens), tc, tsn)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), atol=TOL)


def _serving_run(Engine, SLO, model):
    eng = Engine(model, max_batch=3, page_size=4, max_length=64,
                 decode_chunk=2, slo=SLO(prefill_chunk=8))
    rng = np.random.RandomState(5)
    sys_prompt = rng.randint(0, 64, 12)
    first = np.concatenate([sys_prompt, rng.randint(0, 64, 5)])
    rids = [eng.submit(first, max_new_tokens=6)]
    while not eng.num_active:
        eng.step()
    for p in (np.concatenate([sys_prompt, rng.randint(0, 64, 9)]),
              rng.randint(0, 64, 30), rng.randint(0, 64, 3)):
        rids.append(eng.submit(p, max_new_tokens=6))
    done = {r.id: r for r in eng.run()}
    free_end = eng._mgr.free_pages
    eng.prefix_cache.clear()
    return dict(tokens=[list(done[r].generated) for r in rids],
                states=[done[r].state for r in rids],
                action_log=list(eng.action_log), free_end=free_end,
                free_cleared=eng._mgr.free_pages,
                free_start=eng._mgr.num_pages - 1)


@pytest.fixture(scope="module")
def serving_runs(models):
    jm, tm = models
    return _serving_run(JEngine, JSLO, jm), _serving_run(TEngine, TSLO, tm)


@pytest.mark.parametrize("key", ["tokens", "states", "action_log",
                                 "free_end"])
def test_serving_engine_chunked_prefill_matches_jax(serving_runs, key):
    j, t = serving_runs
    assert t[key] == j[key]


def test_serving_engine_pool_returns(serving_runs):
    _, t = serving_runs
    assert t["free_cleared"] == t["free_start"]
    assert all(s == "ok" for s in t["states"])


def test_int8_quantization_of_the_expert_bank_raises(models):
    jm, tm = models
    with pytest.raises(NotImplementedError, match="MoE expert bank"):
        jm.stack.quantize_weight_only_int8()
    with pytest.raises(NotImplementedError, match="MoE expert bank"):
        tm.stack.quantize_weight_only_int8()
    with pytest.raises(NotImplementedError, match="MoE expert bank"):
        TGE(tm, page_size=4, max_length=16, quant="int8")


def test_moe_with_adapters_raises_in_decode(models):
    jm, tm = models
    rng = np.random.RandomState(6)
    xd = rng.randn(2, 64).astype(np.float32)
    lens = np.array([2, 1], np.int32)
    tables = np.array([[1], [2]], np.int32)
    banks = {"qkv_a": np.zeros((2, 2, 64, 8), np.float32),
             "qkv_b": np.zeros((2, 2, 8, 192), np.float32)}
    for pkg, stack, PK, arr in (
            ("jax", jm.stack, JPagedKV, jnp.asarray),
            ("torch", tm.stack, TPagedKV, torch.from_numpy)):
        kp, vp = _pool(rng, 4, True), _pool(rng, 4, True)
        ad = {k: arr(v) for k, v in banks.items()}
        ad["slots"] = arr(np.array([0, -1], np.int32))
        if pkg == "jax":
            from paddle_tpu.incubate.nn.fused_transformer import (
                rope_table as rt)
        else:
            from paddle_tpu_torch.incubate.nn.fused_transformer import (
                rope_table as rt)
        c, s = rt(128, 16)
        with pytest.raises(NotImplementedError, match="dense stack only"):
            stack.decode_raw(stack._stack(), arr(xd), PK(arr(kp), arr(vp)),
                             arr(tables), arr(lens), c, s, adapters=ad)
