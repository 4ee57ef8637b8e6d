"""Parity of paddle_tpu_torch's serving frontend with paddle_tpu's.

Host modules (prefix cache, SLO monitor, flight recorder, fault
injector, usage ledger) take the same inputs in both packages and must
give the same keys, verdicts, events, firing sequences and records.

The engine: a tiny float32 FusedCausalLM (vocab 64, d 32, 4 heads, 2
layers) built by the JAX package with weights of unit-scale embeddings
(so the greedy streams vary), carried into the port with
``load_jax_params``, served by both packages' ``ServingEngine`` with a
``ManualClock`` in each package's clock seam that advances 1 ms per
streamed token. Tokens, the scheduler's action log, the journal, the
counters and the pool's free pages are integers or clock stamps and
must be IDENTICAL. The JAX engine is slow on the CPU, so it serves two
workloads, once each, in module-scoped fixtures.
"""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import (BlockKVCacheManager as JMgr,
                                  FusedCausalLM as JLM)
from paddle_tpu.profiler import stats as jstats
from paddle_tpu.serving import (FaultInjector as JFaults,
                                ManualClock as JClock,
                                ServingEngine as JEngine,
                                SLOConfig as JSLO, use_clock as j_use)
from paddle_tpu.serving import journal as jjournal
from paddle_tpu.serving import prefix_cache as jprefix
from paddle_tpu.serving.accounting import UsageLedger as JLedger
from paddle_tpu.serving.slo import SLOMonitor as JMonitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import (BlockKVCacheManager as TMgr,
                                        FusedCausalLM as TLM,
                                        GenerationEngine as TGen)
from paddle_tpu_torch.nn.functional import flash_varlen as fv
from paddle_tpu_torch.profiler import stats as tstats
from paddle_tpu_torch.serving import (FaultInjector as TFaults,
                                      ManualClock as TClock,
                                      ServingEngine as TEngine,
                                      SLOConfig as TSLO, use_clock as t_use)
from paddle_tpu_torch.serving import journal as tjournal
from paddle_tpu_torch.serving import prefix_cache as tprefix
from paddle_tpu_torch.serving.accounting import UsageLedger as TLedger
from paddle_tpu_torch.serving.slo import SLOMonitor as TMonitor

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)

J = dict(Engine=JEngine, SLO=JSLO, Clock=JClock, use=j_use,
         Faults=JFaults, stats=jstats)
T = dict(Engine=TEngine, SLO=TSLO, Clock=TClock, use=t_use,
         Faults=TFaults, stats=tstats)

#: counters both workloads compare
COUNTERS = ("serving.prefix_hit", "serving.prefix_miss",
            "serving.prefix_pages_saved", "serve.prefill_chunks",
            "serve.prefill_tokens", "serving.decode_steps",
            "serving.step_retries", "serving.preemptions",
            "serving.chunk_shrinks", "serving.prefill_stalls",
            "serving.prefill_requeues", "serving.admitted")


def _pair():
    paddle.seed(7)
    jm = JLM(**CFG)
    rng = np.random.RandomState(0)
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
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------

def _serve(pkg, model, workload):
    """Run ``workload(eng, clk, submit)`` on a fresh engine of package
    ``pkg`` under a ManualClock; returns what both packages must agree
    on, with request ids replaced by submission order."""
    pkg["stats"].reset()
    with pkg["use"](pkg["Clock"](0.0)) as clk:
        order = []

        def submit(eng, prompt, **kw):
            rid = eng.submit(prompt, on_token=lambda r, t: clk.advance(1e-3),
                             **kw)
            order.append(rid)
            return rid
        eng = workload(pkg, model, submit)
        done = {r.id: r for r in eng.run()}
        free_end = eng._mgr.free_pages
        cleared = eng.prefix_cache.clear() if eng.prefix_cache else 0
        free_cleared = eng._mgr.free_pages
    rank = {rid: i for i, rid in enumerate(order)}
    events = []
    for e in eng.journal.events():
        e = {k: v for k, v in e.items() if k != "usage"}
        if e["rid"] in rank:
            e["rid"] = rank[e["rid"]]
        events.append(e)
    return dict(
        tokens=[list(done[rid].generated) for rid in order],
        states=[done[rid].state for rid in order],
        action_log=list(eng.action_log),
        counters={k: pkg["stats"].counter(k).value for k in COUNTERS},
        free_end=free_end, cleared=cleared, free_cleared=free_cleared,
        free_start=eng._mgr.num_pages - 1, events=events)


SYS = np.random.RandomState(1).randint(0, 64, 12)     # shared prefix


def _eos_of(tm, prompt):
    """An EOS that request's own greedy stream reaches mid-way: its
    first token that differs from every earlier one, past the first."""
    out = TGen(tm, page_size=4, max_length=40).generate(
        [prompt], max_new_tokens=8)[0, len(prompt):]
    for i in range(1, len(out)):
        if out[i] not in out[:i]:
            return int(out[i])
    return int(out[1])


def _plain_workload(eos, **engine_kw):
    rng = np.random.RandomState(2)
    first = np.concatenate([SYS, rng.randint(0, 64, 5)])
    later = [(np.concatenate([SYS, rng.randint(0, 64, 9)]), {}),
             (rng.randint(0, 64, 30), {}),                 # 4 chunks
             (rng.randint(0, 64, 1), dict(max_new_tokens=1)),
             (EOS_PROMPT, dict(eos_token_id=eos))]

    def run(pkg, model, submit):
        eng = pkg["Engine"](model, max_batch=3, page_size=4,
                            max_length=64, decode_chunk=2,
                            slo=pkg["SLO"](prefill_chunk=8), **engine_kw)
        submit(eng, first, max_new_tokens=6)
        while not eng.num_active:          # the prefix is registered
            eng.step()
        for p, kw in later:
            submit(eng, p, **dict(dict(max_new_tokens=6), **kw))
        return eng
    return run


EOS_PROMPT = np.random.RandomState(3).randint(0, 64, 7)


def _fault_workload(pkg, model, submit):
    """One injected prefill.dispatch raise (retried), then a pool of 16
    pages squeezed by 2 on the third decode step: three 16-token
    decoders preempt by recompute, and a later 20-token prompt's
    chunks shrink to fit."""
    inj = (pkg["Faults"](seed=0)
           .add("prefill.dispatch", kind="raise", at=1)
           .add("decode.step", kind="squeeze", pages=2, at=2))
    eng = pkg["Engine"](model, faults=inj, max_batch=3, page_size=4,
                        max_length=64, decode_chunk=2, num_pages=15,
                        slo=pkg["SLO"](prefill_chunk=8))
    rng = np.random.RandomState(31)
    for _ in range(3):
        submit(eng, rng.randint(0, 64, 16), max_new_tokens=16)
    for _ in range(6):
        eng.step()
    submit(eng, rng.randint(0, 64, 20), max_new_tokens=4)
    return eng


@pytest.fixture(scope="module")
def plain_runs(models):
    jm, tm = models
    wl = _plain_workload(_eos_of(tm, EOS_PROMPT))
    return _serve(J, jm, wl), _serve(T, tm, wl)


@pytest.fixture(scope="module")
def fault_runs(models):
    jm, tm = models
    return _serve(J, jm, _fault_workload), _serve(T, tm, _fault_workload)


@pytest.mark.parametrize("what", ["tokens", "states", "action_log",
                                  "counters", "free_end", "cleared",
                                  "free_cleared", "events"])
def test_engine_matches_jax(plain_runs, what):
    j, t = plain_runs
    assert t[what] == j[what]


def test_engine_workload_exercises_the_paths(plain_runs):
    """The workload does what it is for: a prefix hit, a multi-chunk
    prompt, a one-token request, an EOS stop, interleaved actions, and
    a clean pool once the cache lets go."""
    _, t = plain_runs
    c = t["counters"]
    assert c["serving.prefix_hit"] >= 1
    assert c["serving.prefix_pages_saved"] >= 3
    assert c["serve.prefill_chunks"] > 5
    assert len(t["tokens"][3]) == 1
    assert 1 < len(t["tokens"][4]) < 6                 # stopped at EOS
    assert "prefill" in t["action_log"] and "decode" in t["action_log"]
    assert t["free_cleared"] == t["free_start"]
    assert set(t["states"]) == {"ok"}


@pytest.mark.parametrize("what", ["tokens", "states", "action_log",
                                  "counters", "free_end", "events"])
def test_faults_and_pool_pressure_match_jax(fault_runs, what):
    j, t = fault_runs
    assert t[what] == j[what]


def test_fault_workload_retries_preempts_and_shrinks(fault_runs):
    _, t = fault_runs
    c = t["counters"]
    assert c["serving.step_retries"] >= 1
    assert c["serving.preemptions"] >= 1
    assert c["serving.chunk_shrinks"] >= 1
    assert set(t["states"]) == {"ok"}


def test_chunked_serving_matches_one_shot_generation(models, plain_runs):
    """Every stream of the plain workload equals what the one-shot
    GenerationEngine of the port decodes from the same prompt."""
    _, tm = models
    _, t = plain_runs
    eng = TGen(tm, page_size=4, max_length=64)
    out = eng.generate([EOS_PROMPT], max_new_tokens=6)[0, 7:]
    stream = t["tokens"][4]
    np.testing.assert_array_equal(out[:len(stream)], stream)


def test_cpu_serving_builds_and_launches_nothing(models, monkeypatch):
    from paddle_tpu_torch import _kernels

    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel was requested on the CPU")
    monkeypatch.setattr(_kernels, "lib", refuse)
    _, tm = models
    before = fv.launches
    eng = TEngine(tm, max_batch=2, page_size=4, max_length=32,
                  slo=TSLO(prefill_chunk=8))
    eng.submit(np.arange(20) % 64, max_new_tokens=3)
    assert [len(r.generated) for r in eng.run()] == [3]
    assert fv.launches == before


# ---------------------------------------------------------------------
# quantized serving: A8W8 on the plain workload (prefix hits included),
# int8 weights + the int8 KV pool on a workload without shared prefixes
# (the JAX int8 decode kernel masks one owner per page, which is wrong
# for a page two decoding rows share). Quantized engines compute in
# bf16, which XLA and PyTorch round at other points on the CPU: tokens
# agree on at least 90% (measured 96% under A8W8, 24 of 25, and 100%
# with the int8 pool); everything that is a function
# of the schedule — the action log, journal, counters, free pages — is
# identical, since no request stops at an EOS.
# ---------------------------------------------------------------------

def _noshare_workload(pkg, model, submit):
    eng = pkg["Engine"](model, max_batch=3, page_size=4, max_length=64,
                        decode_chunk=2, slo=pkg["SLO"](prefill_chunk=8),
                        quant="int8", kv_dtype="int8")
    rng = np.random.RandomState(12)
    submit(eng, rng.randint(0, 64, 11), max_new_tokens=6)
    while not eng.num_active:
        eng.step()
    for n, new in ((30, 5), (1, 1), (7, 6), (18, 4)):
        submit(eng, rng.randint(0, 64, n), max_new_tokens=new)
    return eng


@pytest.fixture(scope="module")
def quant_runs():
    """One JAX and one port run of each quantized workload, on a fresh
    pair of models (the engines quantize the stacks in place)."""
    jm, tm = _pair()
    a8w8 = _plain_workload(None, quant="a8w8")
    return {"a8w8": (_serve(J, jm, a8w8), _serve(T, tm, a8w8)),
            "int8_kv_int8": (_serve(J, jm, _noshare_workload),
                             _serve(T, tm, _noshare_workload))}


def _token_agreement(j, t):
    pairs = [(a, b) for gj, gt in zip(j["tokens"], t["tokens"])
             for a, b in zip(gj, gt)]
    return sum(a == b for a, b in pairs) / len(pairs)


@pytest.mark.parametrize("mode", ["a8w8", "int8_kv_int8"])
@pytest.mark.parametrize("what", ["states", "action_log", "counters",
                                  "free_end", "cleared", "free_cleared",
                                  "events"])
def test_quantized_serving_matches_jax(quant_runs, mode, what):
    j, t = quant_runs[mode]
    assert t[what] == j[what]


@pytest.mark.parametrize("mode", ["a8w8", "int8_kv_int8"])
def test_quantized_serving_tokens(quant_runs, mode):
    j, t = quant_runs[mode]
    assert [len(g) for g in t["tokens"]] == [len(g) for g in j["tokens"]]
    assert _token_agreement(j, t) >= 0.9
    c = t["counters"]
    assert c["serve.prefill_chunks"] > 4 and set(t["states"]) == {"ok"}
    if mode == "a8w8":
        assert c["serving.prefix_hit"] >= 1
    else:
        assert c["serving.prefix_hit"] == 0


def test_later_slices_raise(models):
    _, tm = models
    # multi-LoRA serving is served now (tests/test_torch_lora_serving.py)
    # and so is speculation (tests/test_torch_speculative.py); the
    # tensor-parallel bank layouts and speculation, and KV migration, are
    # not yet
    from paddle_tpu_torch.serving import AdapterBank

    bank = AdapterBank.from_stack(tm.stack._stack(), slots=1)
    with pytest.raises(NotImplementedError, match="TP serving"):
        bank.operands(tp=object())
    eng = TEngine(tm, max_batch=1, page_size=4, max_length=32,
                  adapters=bank)
    with pytest.raises(NotImplementedError, match="fleet"):
        eng.export_slot(0)
    with pytest.raises(ValueError, match="expected True, 'self'"):
        TEngine(tm, speculative=object())
    with pytest.raises(NotImplementedError, match="TP serving"):
        TEngine(tm, mp_degree=2, speculative="self")


# ---------------------------------------------------------------------
# host modules
# ---------------------------------------------------------------------

def test_prefix_cache_keys_and_matches_match_jax():
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, 64, 23)
    other = np.concatenate([prompt[:8], rng.randint(0, 64, 9)])
    caches = []
    for mgr_cls, mod in ((JMgr, jprefix), (TMgr, tprefix)):
        kw = {} if mod is jprefix else dict(device="cpu")
        mgr = mgr_cls(1, 2, 8, 4, 16, reserve_scratch=True, **kw)
        mgr.allocate("a", len(prompt))
        cache = mod.PrefixCache(mgr, 4, capacity_pages=4)
        cache.insert(prompt, mgr._owned["a"])
        caches.append((cache, mgr, mod))
    (jc, jmgr, _), (tc, tmgr, _) = caches
    assert list(tc._entries) == list(jc._entries)       # bytes, in order
    assert tprefix._page_key(b"", prompt[:4]) \
        == jprefix._page_key(b"", prompt[:4])
    for p in (prompt, other, prompt[:5]):
        assert tc.match(p) == jc.match(p)
    assert tc.evict(2) == jc.evict(2)
    assert list(tc._entries) == list(jc._entries)
    tmgr.free("a")
    jmgr.free("a")
    assert tc.clear() == jc.clear()
    assert tmgr.free_pages == jmgr.free_pages == 15


def _finished(ttft, tpot, tenant=None):
    return SimpleNamespace(ttft_s=ttft, tpot_s=tpot, tenant=tenant)


def test_slo_monitor_verdicts_match_jax():
    reqs = [(0.2, 0.05, "a"), (1.5, 0.05, "a"), (0.1, None, None),
            (None, 0.3, "b"), (0.9, 0.099, "b"), (None, None, "c")]
    out = []
    for cls in (JMonitor, TMonitor):
        mon = cls(ttft_target_ms=1000.0, tpot_target_ms=100.0,
                  objective=0.9, window=4, tenant_windows_max=2)
        verdicts = [mon.observe_finish(_finished(*r)) for r in reqs]
        mon.observe_error(_finished(None, None, "a"))
        out.append((verdicts, mon.goodput, mon.burn_rate,
                    mon.tenant_goodputs(), mon.tenant_min_goodput))
    assert out[1] == out[0]


def test_flight_recorder_and_chrome_trace_match_jax():
    script = [("submit", 0, -1, {"prompt_len": 5}), ("queued", 0, -1, None),
              ("admitted", 0, 1, {"prefix_pages": 1}),
              ("prefill_chunk", 0, 1, {"c": 8, "pos": 5, "n": 5}),
              ("submit", 1, -1, None), ("decode", 0, 1, None),
              ("evict_trigger", -1, -1, {"pages": 2}),
              ("preempt", 0, 1, {"n_generated": 3}), ("queued", 0, -1, None),
              ("admitted", 0, 2, None), ("decode", 0, 2, None),
              ("finish", 0, 2, {"n_tokens": 6}), ("shed", 1, -1, None)]
    res = []
    for mod, clock_cls, use in ((jjournal, JClock, j_use),
                                (tjournal, TClock, t_use)):
        with use(clock_cls(5.0)) as clk:
            jr = mod.FlightRecorder(8)            # wraps: 5 dropped
            for ev, rid, slot, extra in script:
                clk.advance(0.0015)
                jr.record(ev, rid, slot, extra)
        trace = mod.chrome_trace(jr.events(), process_index=1)
        trace["metadata"].pop("source")
        res.append((jr.events(), jr.events(0), jr.dropped,
                    json.dumps(trace, sort_keys=True)))
    assert res[1] == res[0]


def test_fault_injector_fires_the_same_sequence():
    fired = []
    for cls in (JFaults, TFaults):
        inj = (cls(seed=11)
               .add("decode.step", kind="raise", p=0.3, times=-1)
               .add("prefill.dispatch", kind="corrupt", every=3, times=2)
               .add("kv.grow", kind="delay", at=[1, 4], delay_ms=0)
               .add("prefix.insert", kind="raise", at=2))
        seq = []
        for i in range(24):
            site = ("decode.step", "prefill.dispatch", "kv.grow",
                    "prefix.insert")[i % 4]
            try:
                inj.fire(site)
                seq.append(inj.corrupt(site, 7))
            except Exception as e:            # an injected raise
                seq.append(type(e).__name__)
        fired.append((inj.fired, seq, inj.plan()))
    assert fired[1] == fired[0]


def test_usage_ledger_conserves_like_jax():
    res = []
    for cls, clock_cls, use in ((JLedger, JClock, j_use),
                                (TLedger, TClock, t_use)):
        reqs = [SimpleNamespace(id=i, tenant=t, adapter_id=None)
                for i, t in enumerate(("a", "b", None, "a"))]
        with use(clock_cls(0.0)) as clk:
            led = cls()
            for step in range(7):
                clk.advance(0.004)
                live = reqs[step % 3: step % 3 + 2]
                led.charge_phase("decode_chunk", 1.37 * (step + 1), live)
                led.charge_phase("prefill_chunk", 0.71, reqs[3:])
                led.set_pages(reqs[step % 4], step + 1)
                led.add_tokens(reqs[step % 4], prefill=3, decode=step)
            led.charge_phase("admit", 0.5, [])
            for r in reqs:
                led.finish(r, "ok")
        recs = led.records()
        # conservation: every phase's ns is partitioned exactly over
        # the requests (and the system bucket for target-less charges)
        ns = led.phase_ns_totals()
        for phase, total in ns.items():
            assert sum(r["phase_ns"].get(phase, 0) for r in recs) \
                + led.system_ns_totals().get(phase, 0) == total
        res.append((recs, ns, led.attributed_ms(), led.tenant_totals()))
    assert res[1] == res[0]
