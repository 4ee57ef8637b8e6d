"""Quantized serving of paddle_tpu_torch's engines against paddle_tpu's.

A tiny FusedCausalLM (vocab 64, d 32, 4 heads, 2 layers, unit-scale
embeddings so the greedy streams vary) built by the JAX package and
carried into the port with ``load_jax_params``; its stack quantized to
int8 by both packages (bitwise equal, tests/test_torch_quantization.py).
Modes: ``quant="int8"`` (weight-only), ``quant="a8w8"``,
``kv_dtype="int8"`` (on the float model) and int8 weights with the int8
pool. Quantized stacks compute in bf16, and XLA on the CPU and PyTorch
on the CPU round bf16 products at other points, so:

- teacher-forced logits (both packages fed the same tokens) agree
  within 4% of the largest logit (~21 here): each package's own bf16
  prefill departs from its f32 prefill of the same int8 model by up to
  2.6% of it (0.26 JAX / 0.19 PyTorch with int8 weights, 0.52 / 0.47
  with A8W8, whose act-quant rounds flip under bf16 noise); measured
  cross-package maxima: int8 0.27, a8w8 0.49, int8 + int8 pool 0.33;
- greedy tokens agree on at least 90% of positions (measured: every
  generated token in three modes, 97.5% under A8W8 in generate);
- the ``quant.*`` counters, decode steps and free pages are integers of
  the schedule and agree exactly;
- ``decode_raw`` / ``prefill_chunk_raw`` called directly with f32
  activations and an int8 stack (a float pool) agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.incubate.nn.fused_transformer import PagedKV as JPagedKV
from paddle_tpu.inference import (ContinuousBatchingEngine as JCBE,
                                  FusedCausalLM as JLM,
                                  GenerationEngine as JGE)
from paddle_tpu.profiler import stats as jstats
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    PagedKV as TPagedKV)
from paddle_tpu_torch.inference import (ContinuousBatchingEngine as TCBE,
                                        FusedCausalLM as TLM,
                                        GenerationEngine as TGE)
from paddle_tpu_torch.profiler import stats as tstats

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)
TOL_LOGITS_REL = 0.04
MIN_AGREE = 0.9
#: (quant, kv_dtype, which model)
MODES = {"int8": ("int8", None, "int8"), "a8w8": ("a8w8", None, "int8"),
         "kv_int8": (None, "int8", "float"),
         "int8_kv_int8": ("int8", "int8", "int8")}
COUNTERS = ("quant.act_quant_calls", "quant.a8w8_matmuls",
            "inference.decode_steps", "inference.prefills",
            "serving.decode_steps", "serving.admitted")


def _pair(seed, quantize):
    paddle.seed(seed)
    jm = JLM(**CFG)
    rng = np.random.RandomState(seed)
    params = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v._data)
        if k.endswith("weight") or k == "embed":
            a = rng.randn(*a.shape).astype(np.float32) \
                * (1.0 if k == "embed" else 0.3)
        elif k.endswith(("_bias", "_scale")):
            a = a + rng.randn(*a.shape).astype(np.float32) * 0.1
        params[k] = a
        v._rebind(jnp.asarray(a))
    tm = TLM(**CFG, device="cpu")
    load_jax_params(tm, params)
    if quantize:
        jm.stack.quantize_weight_only_int8()
        tm.stack.quantize_weight_only_int8()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"float": _pair(3, False), "int8": _pair(3, True)}


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 64, n) for n in (5, 9, 3, 12)]


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_matches_jax(models, mode):
    quant, kv, which = MODES[mode]
    jm, tm = models[which]
    kw = dict(page_size=4, max_length=40, decode_chunk=4, quant=quant,
              kv_dtype=kv)
    jstats.reset()
    tstats.reset()
    oj = JGE(jm, **kw).generate(_prompts(), max_new_tokens=10)
    ot = TGE(tm, **kw).generate(_prompts(), max_new_tokens=10)
    assert ot.shape == oj.shape
    assert _agree(ot, oj) >= MIN_AGREE, _agree(ot, oj)
    for name in COUNTERS:
        assert tstats.counter(name).value == jstats.counter(name).value, \
            name
    assert tstats.gauge("inference.kv_pages_in_use").value == \
        jstats.gauge("inference.kv_pages_in_use").value
    if quant == "a8w8":
        # 4 products x 2 layers x (1 prefill + 9 decode steps)
        assert tstats.counter("quant.a8w8_matmuls").value == 4 * 2 * 10


@pytest.mark.parametrize("mode", ["a8w8", "int8_kv_int8"])
def test_continuous_batching_matches_jax(models, mode):
    quant, kv, which = MODES[mode]
    jm, tm = models[which]
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, n) for n in (6, 17, 2, 11, 8)]
    out = []
    for cls, model, st in ((JCBE, jm, jstats), (TCBE, tm, tstats)):
        st.reset()
        eng = cls(model, max_batch=2, page_size=4, max_length=48,
                  decode_chunk=3, quant=quant, kv_dtype=kv)
        ids = [eng.submit(p, max_new_tokens=n)
               for p, n in zip(prompts, (7, 4, 9, 5, 6))]
        free0 = eng._mgr.free_pages
        done = {r.id: r for r in eng.run()}
        out.append(([list(done[i].generated) for i in ids],
                    (free0, eng._mgr.free_pages),
                    {n: st.counter(n).value for n in COUNTERS}))
    (gj, fj, cj), (gt, ft, ct) = out
    assert [len(g) for g in gt] == [len(g) for g in gj]
    flat_j = [t for g in gj for t in g]
    flat_t = [t for g in gt for t in g]
    assert _agree(flat_t, flat_j) >= MIN_AGREE
    assert ft == fj and ft[0] == ft[1]
    assert ct == cj


def _jax_step(jm, a8w8):
    st = jm.stack
    cos, sin = _ropes()[0]

    @jax.jit
    def step(w, x, ck, cv, tables, lens):
        h, c = st.decode_raw(w, x, JPagedKV(ck, cv), tables, lens, cos, sin,
                             a8w8=a8w8)
        return h, c.k, c.v
    return step


def _ropes():
    from paddle_tpu.incubate.nn.fused_transformer import rope_table as jr
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        rope_table as tr)
    return jr(128, 8), tr(128, 8)


@pytest.mark.parametrize("mode", list(MODES))
def test_teacher_forced_logits(models, mode):
    """Both packages prefill the same prompts into their own pools and
    decode 6 steps fed the same tokens (the JAX stream's): logits
    within TOL_LOGITS_REL of the largest at every step."""
    quant, kv, which = MODES[mode]
    jm, tm = models[which]
    kw = dict(page_size=4, max_length=24, quant=quant, kv_dtype=kv)
    je, te = JGE(jm, **kw), TGE(tm, **kw)
    b, s, steps = 3, 6, 6
    ids = np.random.RandomState(1).randint(0, 64, (b, s)).astype(np.int32)
    lens = np.full((b,), s, np.int32)
    tables = np.arange(1, 1 + b * 6, dtype=np.int32).reshape(b, 6)
    from paddle_tpu.inference import BlockKVCacheManager as JMgr
    from paddle_tpu_torch.inference import BlockKVCacheManager as TMgr
    jc = JMgr(2, 4, 8, 4, num_pages=b * 6 + 1, dtype=je._kv_dtype)
    tc = TMgr(2, 4, 8, 4, num_pages=b * 6 + 1, dtype=te._kv_dtype,
              device="cpu")
    jk, jv = jc.fresh_cache()
    tk, tv = tc.fresh_cache()
    wj, wt = je._weights(), te._weights()
    lj, jk, jv = je._prefill(wj, je._embed(), je._head_t, *je._lnf(),
                             jnp.asarray(ids), jnp.asarray(lens), jk, jv,
                             jnp.asarray(tables))
    lt, tk, tv = te._prefill_fn(wt, te._embed(), te._head_t, *te._lnf(),
                                torch.from_numpy(ids),
                                torch.from_numpy(lens), tk, tv,
                                torch.from_numpy(tables))
    errs = [float(np.abs(lt.numpy() - np.asarray(lj)).max())]
    top = float(np.abs(np.asarray(lj)).max())
    step = _jax_step(jm, je._a8w8)
    st = tm.stack
    (_, _), (tcos, tsin) = _ropes()
    tok = np.asarray(je._argmax(lj)).astype(np.int32)
    pos = lens.copy()
    for _ in range(steps):
        xj = je._embed()[jnp.asarray(tok)].astype(je._cdtype)
        hj, jk, jv = step(wj, xj, jk, jv, jnp.asarray(tables),
                          jnp.asarray(pos))
        lj = je._logits(hj, je._head_t, *je._lnf())
        xt = te._embed()[torch.from_numpy(tok).long()].to(te._cdtype)
        ht, c = st.decode_raw(wt, xt, TPagedKV(tk, tv),
                              torch.from_numpy(tables),
                              torch.from_numpy(pos), tcos, tsin,
                              a8w8=te._a8w8)
        tk, tv = c.k, c.v
        lt = te._logits(ht, te._head_t, *te._lnf())
        errs.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        top = max(top, float(np.abs(np.asarray(lj)).max()))
        tok = np.asarray(je._argmax(lj)).astype(np.int32)
        pos = pos + 1
    assert max(errs) <= TOL_LOGITS_REL * top, (errs, top)


@pytest.fixture
def linear_flags(request):
    names = ["decode_grouped", "decode_linear"]
    saved = (jflags.get_flags(names), tflags.get_flags(names))
    new = dict(zip(names, request.param))
    jflags.set_flags(new)
    tflags.set_flags(new)
    yield request.param
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


@pytest.mark.parametrize("linear_flags,a8w8", [
    (("auto", "auto"), False),          # grouped int8 tail
    (("off", "auto"), False),           # ungrouped, int8 streamed GEMM
    (("off", "xla"), False),            # ungrouped, plain int8 products
    (("auto", "auto"), True)],          # A8W8: ungrouped act-quant
    indirect=["linear_flags"], ids=["grouped", "stream", "xla", "a8w8"])
def test_raw_f32_activations_int8_stack(models, linear_flags, a8w8):
    """decode_raw and prefill_chunk_raw with f32 activations over the
    int8 stack and a float pool: the same fp32 math in both packages
    (1e-4 absolute on hidden states of magnitude ~1-10)."""
    jm, tm = models["int8"]
    (jcos, jsin), (tcos, tsin) = _ropes()
    wj, wt = jm.stack._stack(), tm.stack._stack()
    rng = np.random.RandomState(6)
    b, P = 8, 12
    shape = (2 * P, 4, 4, 8)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    x = rng.randn(b, 32).astype(np.float32)
    lens = np.array([8, 5, 0, 3, 1, 2, 6, 7], np.int32)
    tables = np.zeros((b, 3), np.int32)
    tables[:, 0] = np.arange(1, 9)
    tables[0, 1:] = [9, 10]
    tables[1, 1] = 11
    tables[6, 1], tables[7, 1] = 9, 10
    hj, cj = jm.stack.decode_raw(
        wj, jnp.asarray(x), JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(tables), jnp.asarray(lens), jcos, jsin, a8w8=a8w8)
    ht, ct = tm.stack.decode_raw(
        wt, torch.from_numpy(x), TPagedKV(torch.from_numpy(kp.copy()),
                                          torch.from_numpy(vp.copy())),
        torch.from_numpy(tables), torch.from_numpy(lens), tcos, tsin,
        a8w8=a8w8)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=1e-4)
    # a prefill chunk over cached prefixes (the last 2 rows padding)
    xc = rng.randn(2, 6, 32).astype(np.float32)
    start, clens = np.array([8, 5], np.int32), np.array([6, 4], np.int32)
    tab = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    hj, cj = jm.stack.prefill_chunk_raw(
        wj, jnp.asarray(xc), JPagedKV(jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(tab), jnp.asarray(start), jnp.asarray(clens), jcos,
        jsin, a8w8=a8w8)
    ht, ct = tm.stack.prefill_chunk_raw(
        wt, torch.from_numpy(xc), TPagedKV(torch.from_numpy(kp.copy()),
                                           torch.from_numpy(vp.copy())),
        torch.from_numpy(tab), torch.from_numpy(start),
        torch.from_numpy(clens), tcos, tsin, a8w8=a8w8)
    for r in range(2):
        n = clens[r]
        np.testing.assert_allclose(ht.numpy()[r, :n], np.asarray(hj)[r, :n],
                                   atol=1e-4)
    np.testing.assert_allclose(ct.k.numpy()[1:], np.asarray(cj.k)[1:],
                               atol=1e-4)


def test_a8w8_needs_an_int8_stack(models):
    _, tm = models["float"]
    st = tm.stack
    (_, _), (tcos, tsin) = _ropes()
    x = torch.zeros(1, 32)
    cache = TPagedKV(torch.zeros(2, 4, 4, 8), torch.zeros(2, 4, 4, 8))
    zeros = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        st.decode_raw(st._stack(), x, cache, zeros, zeros[0], tcos, tsin,
                      a8w8=True)
    with pytest.raises(ValueError, match="quant="):
        TGE(tm, quant="int4")


def test_int8_pool_layout_and_bytes():
    from paddle_tpu.inference import BlockKVCacheManager as JMgr
    from paddle_tpu_torch.inference import BlockKVCacheManager as TMgr

    jm = JMgr(3, 2, 8, page_size=4, num_pages=6, dtype="int8")
    tmg = TMgr(3, 2, 8, page_size=4, num_pages=6, dtype="int8",
               device="cpu")
    (jk, jks), _ = jm.fresh_cache()
    (tk, tks), (tv, tvs) = tmg.fresh_cache()
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.int8
    assert tuple(tks.shape) == jks.shape == (2, 3 * 6 * 4)
    assert tks.dtype == torch.float32
    assert tmg.page_hbm_bytes() == jm.page_hbm_bytes()
    assert TMgr(3, 2, 8, 4, 6, dtype=torch.bfloat16,
                device="cpu").page_hbm_bytes() == JMgr(
        3, 2, 8, 4, 6, dtype=jnp.bfloat16).page_hbm_bytes()


def test_quantized_cpu_paths_build_and_launch_nothing(monkeypatch):
    """On the CPU every quantized mode runs the plain versions: nothing
    is built and no launch counter moves."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl
    from paddle_tpu_torch.serving import ServingEngine, SLOConfig

    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel was requested on the CPU")
    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)

    def counters():
        return (pa.launches, pa.q_launches, sl.launches, sl.w8_launches,
                sl.tail_launches, sl.tail_w8_launches, sl.a8w8_launches)
    before = counters()
    model = TLM(32, 16, 2, 32, 1, max_position=32, device="cpu")
    out = TGE(model, page_size=4, max_length=16, quant="a8w8").generate(
        [[1, 2, 3]], max_new_tokens=3)
    assert out.shape == (1, 6)
    eng = ServingEngine(model, max_batch=2, page_size=4, max_length=24,
                        slo=SLOConfig(prefill_chunk=4), quant="int8",
                        kv_dtype="int8")
    eng.submit(list(range(10)), max_new_tokens=3)
    assert [len(r.generated) for r in eng.run()] == [3]
    assert counters() == before
