"""Parity of paddle_tpu_torch's multi-LoRA serving with paddle_tpu's.

The engine: the tiny float32 FusedCausalLM of ``test_torch_serving.py``
(vocab 64, d 32, 4 heads, 2 layers) built by the JAX package and carried
into the port with ``load_jax_params``. Each package gets its own
``AdapterBank`` holding the SAME adapters: they are made once from a
seeded numpy generator as JAX ``LoRAAdapter``s (init scale 0.3, so they
steer greedy tokens) and carried into the port's bank with
``load_jax_adapter`` — never regenerated by each package's
``random_adapter`` (the JAX one seeds from Python's per-process
``hash``). Both ``ServingEngine``s run each workload under a
``ManualClock`` advancing 1 ms per streamed token; tokens, states, the
scheduler's action log, the journal (request ids mapped to submission
order), the counters — ``lora.grouped_launches`` included — and the
pool's free pages are integers or clock stamps and must be IDENTICAL.
The JAX engine is slow on the CPU, so each workload runs once per
package, in module-scoped fixtures. No workload shares a prompt prefix
between two adapters: the port keys its prefix cache by adapter, the
JAX package does not (``test_prefix_pages_are_not_shared_across_
adapters`` covers the port's side).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import FusedCausalLM as JLM
from paddle_tpu.profiler import stats as jstats
from paddle_tpu.serving import AdapterBank as JBank
from paddle_tpu.serving import FaultInjector as JFaults
from paddle_tpu.serving import ManualClock as JClock
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import SLOConfig as JSLO
from paddle_tpu.serving import use_clock as j_use
from paddle_tpu.serving.adapters import LoRAAdapter as JAdapter
from paddle_tpu_torch.convert import load_jax_adapter, load_jax_params
from paddle_tpu_torch.inference import FusedCausalLM as TLM
from paddle_tpu_torch.profiler import stats as tstats
from paddle_tpu_torch.serving import AdapterBank as TBank
from paddle_tpu_torch.serving import FaultInjector as TFaults
from paddle_tpu_torch.serving import ManualClock as TClock
from paddle_tpu_torch.serving import ServingEngine as TEngine
from paddle_tpu_torch.serving import SLOConfig as TSLO
from paddle_tpu_torch.serving import use_clock as t_use

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)
NAMES = ("t0", "t1", "t2", "t3", "t4")

#: counters every workload compares
COUNTERS = ("lora.grouped_launches", "lora.swaps", "serving.prefix_hit",
            "serving.prefix_miss", "serve.prefill_chunks",
            "serving.decode_steps", "serving.preemptions",
            "serving.admitted", "serving.chunk_shrinks",
            "serving.prefill_requeues")


def _adapters(dims, L):
    """JAX LoRAAdapters of rank 4 from a seeded numpy generator."""
    out = {}
    for i, name in enumerate(NAMES):
        rng = np.random.RandomState(100 + i)
        w = {p: ((rng.randn(L, k, 4) * 0.3).astype(np.float32),
                 (rng.randn(L, 4, n) * 0.3).astype(np.float32))
             for p, (k, n) in dims.items()}
        out[name] = JAdapter(name, 4, w)
    return out


@pytest.fixture(scope="module")
def world():
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
    probe = JBank.from_stack(jm.stack._stack(), slots=1, rank=4)
    ads = _adapters(probe.dims, CFG["num_layers"])

    def jbank(names, slots):
        b = JBank.from_stack(jm.stack._stack(), slots=slots, rank=4)
        for n in names:
            b.load(ads[n])
        return b

    def tbank(names, slots):
        b = TBank.from_stack(tm.stack._stack(), slots=slots, rank=4)
        for n in names:
            b.load(load_jax_adapter(ads[n]))
        return b
    J = dict(model=jm, Engine=JEngine, SLO=JSLO, Clock=JClock, use=j_use,
             Faults=JFaults, stats=jstats, bank=jbank,
             adapter=lambda n: ads[n])
    T = dict(model=tm, Engine=TEngine, SLO=TSLO, Clock=TClock, use=t_use,
             Faults=TFaults, stats=tstats, bank=tbank,
             adapter=lambda n: load_jax_adapter(ads[n]))
    return J, T


def _serve(pkg, workload):
    """Run ``workload(pkg, submit)`` under a ManualClock; returns what
    both packages must agree on, request ids replaced by submission
    order."""
    pkg["stats"].reset()
    with pkg["use"](pkg["Clock"](0.0)) as clk:
        order = []

        def submit(eng, prompt, **kw):
            rid = eng.submit(prompt,
                             on_token=lambda r, t: clk.advance(1e-3), **kw)
            order.append(rid)
            return rid
        eng, extra = workload(pkg, submit)
        done = {r.id: r for r in eng.run()}
    rank = {rid: i for i, rid in enumerate(order)}
    events = []
    for e in eng.journal.events():
        e = {k: v for k, v in e.items() if k != "usage"}
        if e["rid"] in rank:
            e["rid"] = rank[e["rid"]]
        events.append(e)
    bank = eng.adapters
    return dict(
        tokens=[list(done[rid].generated) for rid in order],
        outputs=[done[rid].output.tolist() for rid in order],
        states=[done[rid].state for rid in order],
        action_log=list(eng.action_log), events=events,
        counters={k: pkg["stats"].counter(k).value for k in COUNTERS},
        active=pkg["stats"].gauge("lora.active_adapters").value,
        free_end=eng._mgr.free_pages,
        loaded=sorted(bank.loaded()) if bank is not None else None,
        refs={n: bank.refcount(n) for n in bank.loaded()}
        if bank is not None else None, extra=extra)


def _engine(pkg, bank, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_length", 128)
    kw.setdefault("decode_chunk", 2)
    kw.setdefault("slo", pkg["SLO"](prefill_chunk=16))
    return pkg["Engine"](pkg["model"], adapters=bank, **kw)


def _requests(K, n_req, seed=5, lens=(12, 9, 17, 6)):
    """Mixed base + adapter requests: every 4th is a base-model request,
    the rest round-robin K adapters; independent prompts."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (lens[i % len(lens)],)),
             None if i % 4 == 3 else NAMES[i % K]) for i in range(n_req)]


def _mixed(pkg, submit):
    eng = _engine(pkg, pkg["bank"](NAMES[:4], 4))
    for p, a in _requests(4, 7):
        submit(eng, p, max_new_tokens=8, adapter_id=a)
    return eng, None


def _solo_runs(pkg, reqs):
    outs = []
    for p, a in reqs:
        eng = _engine(pkg, pkg["bank"](NAMES[:4], 4))
        rid = eng.submit(p, max_new_tokens=8, adapter_id=a)
        outs.append({r.id: r for r in eng.run()}[rid].output.tolist())
    return outs


def _swap(pkg, submit):
    """load/unload under live traffic: t0 drains while its request
    decodes, t1 loads into the free slot and serves a new request."""
    bank = pkg["bank"](["t0"], 3)
    eng = _engine(pkg, bank)
    rng = np.random.RandomState(5)
    submit(eng, rng.randint(0, 64, (12,)), max_new_tokens=12,
           adapter_id="t0")
    submit(eng, rng.randint(0, 64, (9,)), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    bank.load(pkg["adapter"]("t1"))
    submit(eng, rng.randint(0, 64, (7,)), max_new_tokens=8,
           adapter_id="t1")
    drained_now = bank.unload("t0")
    draining = bank.is_draining("t0")
    return eng, (drained_now, draining)


def _squeeze(pkg, submit):
    """A pool of 16 pages squeezed by 2 on the third decode step: three
    16-token decoders (two adaptered) preempt by recompute."""
    inj = pkg["Faults"]().add("decode.step", kind="squeeze", pages=2, at=2)
    eng = _engine(pkg, pkg["bank"](["t0", "t1"], 2), faults=inj,
                  max_batch=3, max_length=64, num_pages=15,
                  slo=pkg["SLO"](prefill_chunk=8))
    rng = np.random.RandomState(31)
    for a in ("t0", "t1", None):
        submit(eng, rng.randint(0, 64, (16,)), max_new_tokens=16,
               adapter_id=a)
    return eng, None


def _dwrr(pkg, submit):
    """Deficit-weighted round-robin over two tenants whose requests mix
    adapters: the admission order follows the tenants' weights and
    groups each adapter's requests."""
    slo = pkg["SLO"](prefill_chunk=16, tenant_fair=True,
                     tenant_weights={"heavy": 3.0, "light": 1.0},
                     fair_quantum=16)
    eng = _engine(pkg, pkg["bank"](NAMES[:3], 3), slo=slo, max_batch=2)
    rng = np.random.RandomState(8)
    for i in range(8):
        submit(eng, rng.randint(0, 64, (8,)), max_new_tokens=4,
               tenant="light" if i < 4 else "heavy",
               adapter_id=(None, "t0", "t1", "t2")[i % 4])
    return eng, None


WORKLOADS = {"mixed": _mixed, "swap": _swap, "squeeze": _squeeze,
             "dwrr": _dwrr}


@pytest.fixture(scope="module")
def runs(world):
    J, T = world
    return {name: (_serve(J, wl), _serve(T, wl))
            for name, wl in WORKLOADS.items()}


@pytest.mark.parametrize("key", ["tokens", "states", "action_log", "events",
                                 "counters", "active", "free_end", "loaded",
                                 "refs", "extra"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_serving_with_adapters_matches_jax(runs, workload, key):
    j, t = runs[workload]
    assert t[key] == j[key]


def test_batched_equals_sequential(world, runs):
    _, T = world
    _, t = runs["mixed"]
    assert t["outputs"] == _solo_runs(T, _requests(4, 7))
    assert all(s == "ok" for s in t["states"])
    assert all(v == 0 for v in t["refs"].values())
    # 4 deltas per layer per adaptered chunk and decode step
    assert t["counters"]["lora.grouped_launches"] > 0
    assert t["counters"]["lora.grouped_launches"] % (4 * 2) == 0


def test_adapter_steers_tokens(world):
    _, T = world
    eng = _engine(T, T["bank"](["t0"], 1))
    p = np.random.RandomState(5).randint(0, 64, (12,))
    rb = eng.submit(p, max_new_tokens=8)
    ra = eng.submit(p + 0, max_new_tokens=8, adapter_id="t0")
    done = {r.id: r for r in eng.run()}
    assert done[rb].generated != done[ra].generated


def test_swap_drains_and_frees(runs):
    _, t = runs["swap"]
    assert t["extra"] == (False, True)       # t0 was live: it drained
    assert t["loaded"] == ["t1"]             # ...and freed at release
    assert all(s == "ok" for s in t["states"])
    # load t0, load t1, and t0's slot freed at its last release
    assert t["counters"]["lora.swaps"] == 3


def test_squeeze_preempts_adaptered_with_parity(world, runs):
    _, T = world
    _, t = runs["squeeze"]
    assert t["counters"]["serving.preemptions"] > 0
    rng = np.random.RandomState(31)
    for (a, out) in zip(("t0", "t1", None), t["outputs"]):
        eng = _engine(T, T["bank"](["t0", "t1"], 2), max_batch=3,
                      max_length=64, slo=T["SLO"](prefill_chunk=8))
        rid = eng.submit(rng.randint(0, 64, (16,)), max_new_tokens=16,
                         adapter_id=a)
        assert {r.id: r for r in eng.run()}[rid].output.tolist() == out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unknown_and_bankless_adapters_rejected(world, pkg):
    P = world[0] if pkg == "jax" else world[1]
    eng = _engine(P, P["bank"](["t0"], 1))
    with pytest.raises(KeyError):
        eng.submit(np.arange(4), max_new_tokens=2, adapter_id="nope")
    bankless = _engine(P, None)
    with pytest.raises(ValueError, match="no adapter bank"):
        bankless.submit(np.arange(4), max_new_tokens=2, adapter_id="t0")


def test_prefix_pages_are_not_shared_across_adapters(world):
    """Two requests with one 24-token prompt under two adapters: their
    KV differs, so the second must not map the first's pages; a third
    under the first's adapter does, and every stream equals its solo
    run."""
    _, T = world
    p = np.random.RandomState(9).randint(0, 64, (24,))
    solo = {}
    for a in ("t0", "t1"):
        eng = _engine(T, T["bank"](["t0", "t1"], 2))
        rid = eng.submit(p, max_new_tokens=6, adapter_id=a)
        solo[a] = {r.id: r for r in eng.run()}[rid].generated
    T["stats"].reset()
    eng = _engine(T, T["bank"](["t0", "t1"], 2))
    r0 = eng.submit(p, max_new_tokens=6, adapter_id="t0")
    while not eng.num_active:
        eng.step()
    r1 = eng.submit(p, max_new_tokens=6, adapter_id="t1")
    r2 = eng.submit(p, max_new_tokens=6, adapter_id="t0")
    done = {r.id: r for r in eng.run()}
    assert done[r0].generated == solo["t0"] == done[r2].generated
    assert done[r1].generated == solo["t1"]
    assert T["stats"].counter("serving.prefix_hit").value == 1
