"""Speculative decoding: the port's ``inference/speculative.py`` and its
engine wiring against paddle_tpu's.

A tiny float32 FusedCausalLM (vocab 64, d 32, 4 heads, 2 layers) and a
tinier draft model (d 16, 2 heads, 1 layer) are built by the JAX package
with unit-scale embeddings (so the greedy streams vary) and carried into
the port with ``load_jax_params``. The self-drafting heads' projections
are JAX's, carried across too (the two packages draw other numbers from
one seed). Each workload runs once a package (results cached for the
module: the JAX engines compile on the CPU); the speculating ones run
in both packages, the plain baselines and a few schedule variants in the
port alone. Tokens, accept lengths (the ``serve.accept_len``
observations in order), the speculation counters, journal events and
the pool's free pages are integers and must be IDENTICAL, and every
speculative stream must equal the plain greedy stream (the port's,
which test_plain_engines_agree holds to JAX's). Hidden states of the verify pass: f32 in
another order, within 1e-4 of values of magnitude up to about 10. The
reference's tensor-parallel and roofline-site classes wait for the
port's TP serving and profiler slices.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import (BlockKVCacheManager as JMgr,
                                  ContinuousBatchingEngine as JCBE,
                                  DraftModelDrafter as JDraft,
                                  FusedCausalLM as JLM,
                                  ScheduledDrafter as JSched)
from paddle_tpu.profiler import stats as jstats
from paddle_tpu.serving import (FaultInjector as JFaults,
                                ManualClock as JClock,
                                ServingEngine as JServe,
                                SLOConfig as JSLO, use_clock as j_use)
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    PagedKV as TPagedKV)
from paddle_tpu_torch.inference import (BlockKVCacheManager as TMgr,
                                        ContinuousBatchingEngine as TCBE,
                                        DraftModelDrafter as TDraft,
                                        FusedCausalLM as TLM,
                                        ScheduledDrafter as TSched)
from paddle_tpu_torch.profiler import stats as tstats
from paddle_tpu_torch.serving import (FaultInjector as TFaults,
                                      ManualClock as TClock,
                                      ServingEngine as TServe,
                                      SLOConfig as TSLO, use_clock as t_use)

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)
DRAFT_CFG = dict(vocab_size=64, embed_dim=16, num_heads=2,
                 dim_feedforward=32, num_layers=1, max_position=128)

J = dict(CBE=JCBE, Draft=JDraft, Sched=JSched, Serve=JServe, SLO=JSLO,
         Faults=JFaults, Clock=JClock, use=j_use, stats=jstats)
T = dict(CBE=TCBE, Draft=TDraft, Sched=TSched, Serve=TServe, SLO=TSLO,
         Faults=TFaults, Clock=TClock, use=t_use, stats=tstats)

#: the counters every engine workload compares
COUNTERS = ("serving.spec_rounds", "serving.spec_drafted_tokens",
            "serving.spec_accepted_tokens", "serving.spec_rejected_tokens",
            "serving.wasted_decode_tokens", "serving.decode_steps",
            "serving.admitted", "serving.step_retries",
            "serving.preemptions")


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JLM(**cfg)
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
    tm = TLM(**cfg, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _models():
    jm, tm = _pair(CFG, 7)
    jd, td = _pair(DRAFT_CFG, 99)
    return dict(jax=(jm, jd), torch=(tm, td))


def _prompts(n=3, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (L,)) for L in (3, 6, 9)[:n]]


def _key(prompt):
    return np.asarray(prompt, np.int32).tobytes()


@functools.lru_cache(maxsize=None)
def _heads_w(k: int):
    """The JAX self-drafting heads' projections (seed 0, scale 0.02)."""
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (k, CFG["embed_dim"], CFG["embed_dim"]),
        jnp.float32) * 0.02)


def _speculative(pkg, name, k):
    """Each package's ``speculative=`` argument for drafter ``name``."""
    p = J if pkg == "jax" else T
    _, draft = _models()[pkg]
    if name is None or name == "self":
        return name
    if name == "draft":
        return p["Draft"](draft)
    if name == "draft_model":
        return draft
    kind, n_new = name                    # ("accept" | "reject", n_new)
    base = {_key(pr): g for pr, g in zip(_prompts(), _plain(n_new))}
    if kind == "reject":
        base = {kk: [(t + 1) % 64 for t in g] for kk, g in base.items()}
    return p["Sched"](lambda r: base[_key(r.prompt)])


def _carry_heads(pkg, eng):
    """The port's heads take JAX's projections."""
    spec = getattr(eng, "_spec", None)
    if pkg == "torch" and spec is not None \
            and hasattr(spec.drafter, "_w"):
        spec.drafter._w = torch.from_numpy(_heads_w(spec.k).copy())


def _outcome(pkg, eng, rids, free0):
    st = J["stats"] if pkg == "jax" else T["stats"]
    by = {r.id: r for r in eng.finished}
    return dict(
        tokens=[list(by[r].generated) for r in rids],
        counters={c: st.counter(c).value for c in COUNTERS},
        accept_lens=list(st.histogram("serve.accept_len")._samples),
        free=(free0, eng._mgr.free_pages), refs=dict(eng._mgr._refs))


@functools.lru_cache(maxsize=None)
def _run(pkg, spec=None, n_prompts=3, n_new=8, eos=None, k=None,
         max_batch=4):
    """One ContinuousBatchingEngine workload in package ``pkg``."""
    p = J if pkg == "jax" else T
    speculative = _speculative(pkg, spec, k)      # may run the plain base
    p["stats"].reset()
    model, _ = _models()[pkg]
    kw = {} if k is None else {"spec_k": k}
    eng = p["CBE"](model, max_batch=max_batch, page_size=4, max_length=64,
                   decode_chunk=2, speculative=speculative, **kw)
    _carry_heads(pkg, eng)
    free0 = eng._mgr.free_pages
    rids = [eng.submit(pr, max_new_tokens=n_new, eos_token_id=eos)
            for pr in _prompts(n_prompts)]
    eng.run()
    return _outcome(pkg, eng, rids, free0)


def _plain(n_new=8):
    """The plain greedy streams (the port's; test_plain_engines_agree
    holds them to JAX's)."""
    return _run("torch", n_new=n_new)["tokens"]


def _both(*args, **kw):
    """The JAX and the port outcome of one workload; they must agree.
    JAX's engines compile on the CPU, so only workloads that speculate
    (and the plain one base) run in both packages."""
    j, t = _run("jax", *args, **kw), _run("torch", *args, **kw)
    assert t["tokens"] == j["tokens"]
    assert t["accept_lens"] == j["accept_lens"]
    assert t["counters"] == j["counters"]
    assert t["free"] == j["free"] and t["refs"] == j["refs"]
    return t


# =====================================================================
# the verify pass's numerics
# =====================================================================

class TestVerifyProgramNumerics:
    def test_chunk_verify_matches_sequential_decode(self):
        """The verify pass scores a window with prefill_chunk_raw, the
        plain engine token by token with decode_raw: over a random cache
        state and a random window the two agree on every hidden state
        (the reference's 2e-4)."""
        from paddle_tpu_torch.incubate.nn.fused_transformer import \
            rope_table

        tm, _ = _models()["torch"]
        st = tm.stack
        b, L, win_len, ps, pp = 2, 6, 4, 4, 8
        rng = np.random.RandomState(5)
        x = torch.from_numpy(rng.randn(b, L, 32).astype(np.float32))
        win = torch.from_numpy(rng.randn(b, win_len, 32).astype(np.float32))
        mgr = TMgr(st.num_layers, st.num_kv_heads, st.head_dim, ps,
                   num_pages=32, reserve_scratch=True, device="cpu")
        for i in range(b):
            mgr.allocate(i, L + win_len)
        tables = mgr.block_tables(range(b), pp)
        cos, sin = rope_table(64, st.head_dim)
        w = st._stack()
        _h, cache = st.prefill_raw(w, x, mgr.fresh_cache(), tables, cos,
                                   sin)
        ck, cv = cache.k.clone(), cache.v.clone()
        h_chunk, _ = st.prefill_chunk_raw(
            w, win, cache, tables, torch.full((b,), L, dtype=torch.int32),
            torch.full((b,), win_len, dtype=torch.int32), cos, sin)
        seq = []
        for j in range(win_len):
            hj, c2 = st.decode_raw(
                w, win[:, j].contiguous(), TPagedKV(ck, cv), tables,
                torch.full((b,), L + j, dtype=torch.int32), cos, sin)
            ck, cv = c2.k, c2.v
            seq.append(hj.numpy())
        np.testing.assert_allclose(h_chunk.numpy(), np.stack(seq, axis=1),
                                   atol=2e-4, rtol=2e-4)

    def test_verify_fn_matches_jax(self):
        """The verify pass itself on one batch of windows — a full
        match, a reject at the first draft, a clamped window of 3, an
        idle row — against JAX's: greedy picks and accept lengths
        equal, the accept-boundary hidden states within 1e-4."""
        k = 3
        outs = {}
        for pkg in ("jax", "torch"):
            p = J if pkg == "jax" else T
            model, _ = _models()[pkg]
            eng = p["CBE"](model, max_batch=4, page_size=4, max_length=64,
                           speculative=p["Sched"](lambda r: []), spec_k=k)
            for pr in _prompts(3):
                eng.submit(pr, max_new_tokens=20)
            eng._admit()                 # three prefilled slots, one idle
            g = eng._gen
            lens = eng._lens.copy()
            ids = np.zeros((4, k + 1), np.int32)
            ids[:3, 0] = eng._last_tok[:3]
            ids[:3, 1:] = [[5, 6, 7], [8, 9, 10], [11, 12, 13]]
            start = np.where(lens > 0, lens - 1, 0).astype(np.int32)
            clen = np.array([4, 4, 3, 0], np.int32)
            for i in range(3):
                eng._mgr.grow(("slot", i), 2)
            tables = eng._mgr.block_tables(
                [("slot", i) for i in range(4)], eng._pages_per_seq,
                allow_missing=True)
            lnf_s, lnf_b = g._lnf()
            spec = eng._spec
            if pkg == "jax":
                # drafts equal to the model's picks in row 0 (pick j
                # depends on drafts before j: k passes settle them), a
                # wrong first draft in row 1
                args = (g._weights(), g._embed(), g._head_t, lnf_s, lnf_b)
                verify = jax.jit(functools.partial(spec._verify_fn, k=k))
                for _ in range(k):
                    cand, *_ = verify(
                        *args, jnp.asarray(ids), jnp.asarray(start),
                        jnp.asarray(clen), jnp.asarray(ids[:, 1:]),
                        eng._ck, eng._cv, tables)
                    ids[0, 1:] = np.asarray(cand)[0, :k]
                ids[1, 1] = (int(np.asarray(cand)[1, 0]) + 1) % 64
                outs["ids"] = ids.copy()
                res = verify(
                    *args, jnp.asarray(ids), jnp.asarray(start),
                    jnp.asarray(clen), jnp.asarray(ids[:, 1:]),
                    eng._ck, eng._cv, tables)
            else:
                ids = outs["ids"]
                res = spec._verify_fn(
                    g._weights(), g._embed(), g._head_t, lnf_s, lnf_b,
                    torch.from_numpy(ids), torch.from_numpy(start),
                    torch.from_numpy(clen), torch.from_numpy(ids[:, 1:]),
                    eng._ck, eng._cv, tables, k=k)
            outs[pkg] = [np.asarray(r) for r in res[:3]]
        (jc, ja, jh), (tc, ta, th) = outs["jax"], outs["torch"]
        np.testing.assert_array_equal(tc[:3], jc[:3])
        np.testing.assert_array_equal(ta[:3], ja[:3])
        assert list(ta[:3]) == [3, 0, ta[2]] and ta[2] <= 2
        np.testing.assert_allclose(th[:3], jh[:3], atol=1e-4, rtol=0)


    def test_verify_never_reaches_the_dense_route(self, monkeypatch):
        """C2: the verify pass is a cross-length causal caller (k+1
        queries against a longer cached span). It must never take
        ``nn/functional/attention.py``'s dense route, whose causal mask
        the reference aligns two ways; it reaches only
        ``paged_prefill_attention``, whose mask is by absolute position
        (key position <= ``start + t``). Every dense-route entry is made
        to raise, and the paged calls are recorded: one a layer a round,
        each at the window's start."""
        from paddle_tpu_torch.incubate.nn import fused_transformer as ft
        from paddle_tpu_torch.nn.functional import attention as at

        def refuse(*a, **k):
            raise AssertionError("the verify pass took the dense route")
        for name in ("_causal_keep", "_logits", "_dense_attention",
                     "_attention_raw", "flash_attention_fwd",
                     "flash_attention_fwd_plain",
                     "scaled_dot_product_attention", "flash_attention"):
            monkeypatch.setattr(at, name, refuse)
        calls = []
        paged = ft.paged_prefill_attention

        def record(q, ck, cv, tables, start, **kw):
            calls.append((tuple(q.shape), start.tolist()))
            return paged(q, ck, cv, tables, start, **kw)
        monkeypatch.setattr(ft, "paged_prefill_attention", record)
        tm, _ = _models()["torch"]
        eng = TCBE(tm, max_batch=2, page_size=4, max_length=64,
                   speculative=TSched(lambda r: []), spec_k=3)
        eng.submit(_prompts(1)[0], max_new_tokens=3)
        eng._admit()
        calls.clear()                       # the admission's prefill
        starts = [int(eng._lens[0]) - 1, 0]
        eng.step()
        L = tm.stack.num_layers
        assert calls == [((2, 4, 4, 8), starts)] * L


# =====================================================================
# greedy-token parity: every drafter, forced schedules
# =====================================================================

class TestGreedyParity:
    def test_plain_engines_agree(self):
        assert _both()["tokens"] == _plain()

    def test_self_draft_heads_parity(self):
        assert _both("self", k=3)["tokens"] == _plain()

    def test_draft_model_parity(self):
        assert _both("draft", k=3)["tokens"] == _plain()

    def test_draft_model_instance_shorthand(self):
        # a bare FusedCausalLM wraps into a DraftModelDrafter (the port's
        # run alone: the drafter is test_draft_model_parity's)
        tm, td = _models()["torch"]
        eng = TCBE(tm, max_batch=2, page_size=4, max_length=64,
                   speculative=td, spec_k=2)
        assert isinstance(eng._spec.drafter, TDraft)
        assert eng._spec.drafter.model is td
        assert _run("torch", "draft_model", k=2)["tokens"] == _plain()

    @pytest.mark.parametrize("k", [1, 3, 5])
    def test_forced_full_accept_schedule(self, k):
        """Oracle drafts (the greedy stream): every draft accepts but
        for the request tails' clamped windows (k 3 in both packages,
        k 1 and 5 the port's alone)."""
        t = _both(("accept", 8), k=k) if k == 3 \
            else _run("torch", ("accept", 8), k=k)
        assert t["tokens"] == _plain()
        c = t["counters"]
        assert c["serving.spec_drafted_tokens"] > 0
        assert c["serving.spec_accepted_tokens"] >= \
            c["serving.spec_drafted_tokens"] - len(_prompts()) * k

    def test_forced_full_reject_schedule(self):
        """Drafts guaranteed wrong: every round emits only the bonus
        token, per-token decode through the verify pass."""
        t = _both(("reject", 8), k=3)
        assert t["tokens"] == _plain()
        assert t["counters"]["serving.spec_accepted_tokens"] == 0
        assert t["counters"]["serving.spec_rejected_tokens"] > 0

    def test_eos_mid_window_parity(self):
        eos = _plain()[0][3]      # a token the stream actually emits
        base = _run("torch", eos=eos)["tokens"]
        assert _both("self", eos=eos, k=3)["tokens"] == base

    def test_single_token_requests(self):
        # max_new_tokens=1 finishes at admission; spec must not break
        assert _both("self", n_new=1, k=3)["tokens"] == \
            _run("torch", n_new=1)["tokens"]


# =====================================================================
# rollback and telemetry accounting
# =====================================================================

class TestAccountingAndRollback:
    def test_counters_and_accept_len_histogram(self):
        t = _both("self", k=3)
        c = t["counters"]
        rounds = c["serving.spec_rounds"]
        drafted = c["serving.spec_drafted_tokens"]
        assert rounds > 0 and drafted % 3 == 0 and drafted >= rounds * 3
        assert c["serving.spec_accepted_tokens"] + \
            c["serving.spec_rejected_tokens"] == drafted
        # one observation a slot a round
        assert len(t["accept_lens"]) == drafted // 3
        assert sum(t["accept_lens"]) == c["serving.spec_accepted_tokens"]
        assert c["serving.decode_steps"] == 0
        _run("torch", n_prompts=1, spec="self", k=3)
        assert tstats.gauge("spec.k").value == 3

    def test_no_page_leak_and_exact_pool_drain(self):
        """Grows for rejected windows are handed back by truncate: the
        pool drains to its starting free count, no reference left."""
        t = _both("self", n_prompts=2, n_new=10, k=4, max_batch=2)
        assert t["free"][0] == t["free"][1] and t["refs"] == {}

    def test_amortization_bound(self):
        """With oracle drafts the round count is exactly ceil((n_new -
        1) / (k + 1)): one verify pass per accepted window."""
        n_new, k = 16, 3
        t = _both(("accept", n_new), n_prompts=1, n_new=n_new, k=k)
        assert t["tokens"][0] == _plain(n_new)[0]
        c = t["counters"]
        rounds = c["serving.spec_rounds"]
        assert rounds == -(-(n_new - 1) // (k + 1))
        assert rounds <= (n_new - 1) / (
            c["serving.spec_accepted_tokens"] / rounds)

    @pytest.mark.parametrize("kw,match", [
        (dict(speculative="self", spec_k=0), "spec_k"),
        (dict(speculative="draft"), "draft model"),
        (dict(speculative=object()), "expected True"),
        (dict(speculative="medusa"), "expected 'self'")])
    def test_bad_arguments_raise_as_jax(self, kw, match):
        msgs = []
        for p, pkg in ((J, "jax"), (T, "torch")):
            model, _ = _models()[pkg]
            with pytest.raises(ValueError, match=match) as e:
                p["CBE"](model, max_batch=2, page_size=4, max_length=64,
                         **kw)
            msgs.append(str(e.value).replace("paddle_tpu_torch",
                                             "paddle_tpu"))
        if "speculative" in kw and isinstance(kw["speculative"], str):
            assert msgs[0] == msgs[1]

    def test_draft_model_checks(self):
        """The draft model's vocabulary and max_position are checked as
        the reference checks them."""
        _, td = _models()["torch"]
        tm, _ = _models()["torch"]
        small = TLM(**dict(DRAFT_CFG, max_position=32), device="cpu")
        with pytest.raises(ValueError, match="max_position"):
            TCBE(tm, max_batch=2, page_size=4, max_length=64,
                 speculative=TDraft(small))
        other = TLM(**dict(DRAFT_CFG, vocab_size=32), device="cpu")
        with pytest.raises(ValueError, match="vocab"):
            TCBE(tm, max_batch=2, page_size=4, max_length=64,
                 speculative=other)
        assert td.vocab_size == tm.vocab_size


# =====================================================================
# serving-scheduler composition
# =====================================================================

def _serve_events(p, eng, order):
    rank = {rid: i for i, rid in enumerate(order)}
    out = []
    for e in eng.journal.events():
        # the round's duration is a host time; a message names raw ids
        e = {kk: v for kk, v in e.items()
             if kk not in ("usage", "dur_ms", "msg")}
        if isinstance(e.get("args"), dict):
            e["args"] = {kk: v for kk, v in e["args"].items()
                         if kk != "dur_ms"}
        if e.get("rid") in rank:
            e["rid"] = rank[e["rid"]]
        out.append(e)
    return out


@functools.lru_cache(maxsize=None)
def _serve(pkg, spec="self", n_prompts=3, n_new=8, max_batch=4,
           scenario=None):
    """A ServingEngine workload under a ManualClock: ``scenario`` None,
    "preempt" (slot 0 preempted by recompute mid-stream), "fault" (a
    decode.step raise inside a round) or "deadline" (the second
    request's 50 ms deadline lapses mid-speculation)."""
    p = J if pkg == "jax" else T
    p["stats"].reset()
    model, _ = _models()[pkg]
    with p["use"](p["Clock"](0.0)) as clk:
        kw = {}
        if scenario == "fault":
            kw["faults"] = p["Faults"](seed=0).add("decode.step",
                                                   kind="raise", at=2)
        eng = p["Serve"](model, max_batch=max_batch, page_size=4,
                         max_length=64, decode_chunk=2,
                         slo=p["SLO"](prefill_chunk=4), speculative=spec,
                         spec_k=3, **kw)
        _carry_heads(pkg, eng)
        free0 = eng._mgr.free_pages
        order = []
        for i, pr in enumerate(_prompts(n_prompts)):
            extra = {"deadline_ms": 50.0} \
                if scenario == "deadline" and i == 1 else {}
            order.append(eng.submit(pr, max_new_tokens=n_new, **extra))
        if scenario == "preempt":
            for _ in range(30):
                eng.step()
                if all(r is not None for r in eng._slots) and \
                        len(eng._slots[0].generated) >= 3:
                    break
            assert eng._slots[0] is not None
            eng._preempt_slot(0)
        if scenario == "deadline":
            for _ in range(6):
                eng.step()
            clk.advance(1.0)
        eng.run()
        by = {r.id: r for r in eng.finished}
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        res = _outcome(pkg, eng, order, free0)
        res.update(states=[by[r].state for r in order],
                   action_log=list(eng.action_log),
                   events=_serve_events(p, eng, order),
                   phases=sorted(p["stats"].snapshot(
                       "serve.step.")["histograms"]))
    return res


def _serve_both(*args, **kw):
    j, t = _serve("jax", *args, **kw), _serve("torch", *args, **kw)
    for key in ("tokens", "states", "accept_lens", "counters", "free",
                "action_log", "events"):
        assert t[key] == j[key], key
    return t


class TestServingComposition:
    def test_serving_engine_spec_parity_with_chunked_prefill(self):
        base = _serve("torch", spec=None)
        t = _serve_both()
        assert t["tokens"] == base["tokens"] == _plain()
        assert t["states"] == ["ok"] * 3
        assert t["free"][0] == t["free"][1]

    def test_spec_verify_journal_events_and_chrome_span(self):
        from paddle_tpu_torch.serving.journal import (LIFECYCLE_EVENTS,
                                                      chrome_trace)

        assert "spec_verify" in LIFECYCLE_EVENTS
        t = _serve_both()
        sv = [e for e in t["events"] if e["ev"] == "spec_verify"]
        assert sv and all(e["k"] == 3 and 0 <= e["accepted"] <= 3
                          for e in sv)
        assert [e["accepted"] for e in sv] == t["accept_lens"]
        # spans need the round's duration, which the comparison dropped
        eng = T["Serve"](_models()["torch"][0], max_batch=2, page_size=4,
                         max_length=64, decode_chunk=2,
                         slo=T["SLO"](prefill_chunk=4), speculative="self",
                         spec_k=3)
        eng.submit(_prompts(1)[0], max_new_tokens=6)
        eng.run()
        spans = [s for s in chrome_trace(eng.journal.events())["traceEvents"]
                 if s.get("name") == "spec_verify"]
        assert spans and all(s["ph"] == "X" for s in spans)
        assert "serve.step.spec_verify_ms" in t["phases"]
        assert "serve.step.decode_chunk_ms" not in t["phases"]

    def test_preemption_resume_redrafts_parity(self):
        base = _serve_both(n_prompts=2, n_new=16, max_batch=2)
        t = _serve_both(n_prompts=2, n_new=16, max_batch=2,
                        scenario="preempt")
        assert t["tokens"] == base["tokens"]
        assert t["counters"]["serving.preemptions"] == 1

    def test_mid_verify_fault_retries_cleanly(self):
        base = _serve_both(n_prompts=2, n_new=16, max_batch=2)
        t = _serve_both(n_prompts=2, n_new=16, max_batch=2,
                        scenario="fault")
        assert t["tokens"] == base["tokens"]
        assert t["counters"]["serving.step_retries"] > 0

    def test_deadline_expiry_mid_speculation(self):
        base = _serve_both(n_prompts=2, n_new=16, max_batch=2)
        t = _serve_both(n_prompts=2, n_new=16, max_batch=2,
                        scenario="deadline")
        assert t["states"] == ["ok", "deadline_exceeded"]
        assert t["tokens"][0] == base["tokens"][0]
        assert t["free"][0] == t["free"][1]

    def test_adaptered_requests_raise_under_speculation(self):
        from paddle_tpu_torch.serving import AdapterBank

        tm, _ = _models()["torch"]
        bank = AdapterBank.from_stack(tm.stack._stack(), slots=1)
        eng = T["Serve"](tm, max_batch=2, page_size=4, max_length=64,
                         speculative="self", spec_k=2, adapters=bank)
        with pytest.raises(ValueError, match="speculative"):
            eng.submit(_prompts(1)[0], max_new_tokens=4, adapter_id="a")
