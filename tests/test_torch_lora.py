"""Parity of paddle_tpu_torch's LoRA delta and AdapterBank with paddle_tpu's.

The same seeded numpy inputs go to both packages. The adapter sort
(order, offsets, counts, inverse) is pinned as integers, base-model
slots (< 0 and >= S) included. The port's plain ``lora_delta`` (its CPU
path) is held to the JAX function in interpret mode and through its XLA
walk, float32 within 1e-5 of the largest value (fp32 sums in another
order); base rows are exactly 0, and zero padded rank columns change
nothing. The bank's lifecycle — load, acquire, release, draining, a
full bank, alpha folded into B, version-keyed operands and the
``lora.*`` telemetry — runs the same script on both banks, which must
agree step for step.

``random_adapter`` of the JAX package seeds from Python's ``hash``,
which differs between processes, so the two packages' random adapters
are never compared; the port's seeds from a CRC32 and is checked to
give the same weights in two processes.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import lora as jl
from paddle_tpu.profiler import stats as jstats
from paddle_tpu.serving.adapters import AdapterBank as JBank
from paddle_tpu.serving.adapters import LoRAAdapter as JAdapter
from paddle_tpu_torch.convert import load_jax_adapter
from paddle_tpu_torch.nn.functional import lora as tl
from paddle_tpu_torch.profiler import stats as tstats
from paddle_tpu_torch.serving.adapters import AdapterBank as TBank

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype,want", [(torch.float32, (8, 8, 24)),
                                        (torch.bfloat16, (16, 16, 32)),
                                        (torch.int8, (32, 32, 64))])
def test_pad_rank_table(dtype, want):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int8: jnp.int8}[dtype]
    for rank, w in zip((4, 8, 17 if dtype != torch.int8 else 33), want):
        assert tl.pad_rank(rank, dtype) == w == jl.pad_rank(rank, jd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_by_adapter_and_inverse_equal_jax(seed):
    rng = np.random.RandomState(seed)
    S = 4
    slots = rng.randint(-2, S + 2, 37).astype(np.int32)   # base: <0, >=S
    want = jl.sort_by_adapter(jnp.asarray(slots), S)
    got = tl.sort_by_adapter(torch.from_numpy(slots), S)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tl.inverse_order(got[0]).numpy(),
        np.asarray(jl.inverse_order(want[0])))


def _delta_inputs(T=96, K=256, N=384, S=3, R=8, seed=0, base_frac=0.3):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, K).astype(np.float32)
    a = (rng.randn(S, K, R) * 0.05).astype(np.float32)
    b = (rng.randn(S, R, N) * 0.05).astype(np.float32)
    slots = rng.randint(0, S, T).astype(np.int32)
    slots[rng.rand(T) < base_frac] = -1
    order, offsets, _ = jl.sort_by_adapter(jnp.asarray(slots), S)
    xs = np.array(jnp.asarray(x)[order])
    return xs, a, b, np.array(offsets)


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("seed,base_frac", [(0, 0.3), (1, 0.0), (2, 1.0)])
def test_lora_delta_plain_matches_jax(backend, seed, base_frac):
    xs, a, b, off = _delta_inputs(seed=seed, base_frac=base_frac)
    want = jl.lora_delta(jnp.asarray(xs), jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(off), backend=backend)
    got = tl.lora_delta(torch.from_numpy(xs), torch.from_numpy(a),
                        torch.from_numpy(b), torch.from_numpy(off))
    assert got.dtype == torch.float32
    _close(got, want)
    assert (got[int(off[-1]):] == 0).all()          # base rows exact 0


def test_lora_delta_bf16_bank_matches_jax():
    xs, a, b, off = _delta_inputs(seed=4)
    want = jl.lora_delta(jnp.asarray(xs).astype(jnp.bfloat16),
                         jnp.asarray(a).astype(jnp.bfloat16),
                         jnp.asarray(b).astype(jnp.bfloat16),
                         jnp.asarray(off), backend="xla")
    got = tl.lora_delta(torch.from_numpy(xs).to(torch.bfloat16),
                        torch.from_numpy(a).to(torch.bfloat16),
                        torch.from_numpy(b).to(torch.bfloat16),
                        torch.from_numpy(off))
    _close(got, want)
    assert (got[int(off[-1]):] == 0).all()


#: blocks a cluster of the card's kernel (kLoraC, csrc/grouped_gemm.cu)
LORA_CLUSTER = 8


def _k_slices(K):
    """The card kernel's K slices ``[(k_lo, k_hi)]``, one per block of a
    cluster, in rank order: block ``c`` takes 16-wide k-steps ``c *
    steps // 8`` up to ``(c + 1) * steps // 8`` of ``steps = cdiv(K,
    16)``; every block adds the slices' sums in rank order."""
    steps = -(-K // 16)
    return [(min(K, c * steps // LORA_CLUSTER * 16),
             min(K, (c + 1) * steps // LORA_CLUSTER * 16))
            for c in range(LORA_CLUSTER)]


@pytest.mark.parametrize("K", [8, 16, 200, 264, 2048, 8192])
def test_lora_k_slices_cover_k_once_in_rank_order(K):
    """The card kernel's K slices, one a block of a cluster in rank
    order: whole 16-wide k-steps that cover [0, K) exactly once."""
    slices = _k_slices(K)
    assert len(slices) == LORA_CLUSTER
    assert [k for lo, hi in slices for k in range(lo, hi)] == list(range(K))
    assert all(lo % 16 == 0 and hi >= lo for lo, hi in slices)


def _cluster_delta(x, a, b, off):
    """The card kernel's order rendered in PyTorch: per slot, x_seg @
    A[s] (A rounded to x's dtype) summed in fp32 on each block's K slice
    (``_k_slices``), the slices added in rank order, then h @ B[s]
    in fp32 (h not rounded); rows past offsets[S] stay +0.0."""
    T, K = x.shape
    S, _, R = a.shape
    out = torch.zeros(T, b.shape[-1])
    for s in range(S):
        lo, hi = int(off[s]), min(int(off[s + 1]), T)
        if hi <= lo:
            continue
        xs, As = x[lo:hi].float(), a[s].to(x.dtype).float()
        h = torch.zeros(hi - lo, R)
        for k0, k1 in _k_slices(K):
            h = h + xs[:, k0:k1] @ As[k0:k1]
        out[lo:hi] = h @ b[s].float()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [8, 33])
def test_cluster_reduction_order_matches_jax(T, dtype):
    """B16's reduction order (x A summed in 8 rank-ordered K slices of
    whole k-steps, then times B in fp32) against the JAX ``lora_delta``
    on its XLA walk (bitwise the interpret-mode kernel's, which
    ``test_lora_delta_plain_matches_jax`` runs) within 2e-5 (fp32 sums
    in another order; deltas of
    magnitude ~0.2), at T 8 and 33 with slot 2 empty; base rows are
    bitwise +0.0 in the rendering and in the port's plain version."""
    rng = np.random.RandomState(40 + T)
    S, K, N, R = 4, 264, 256, 16
    slots = np.resize(np.array([0, 1, -1, 3, 0, 1, 3, -1], np.int32), T)
    order, off, _ = jl.sort_by_adapter(jnp.asarray(rng.permutation(slots)),
                                       S)
    off = np.array(off)
    xs = rng.randn(T, K).astype(np.float32)[np.array(order)]
    a = (rng.randn(S, K, R) * 0.05).astype(np.float32)
    b = (rng.randn(S, R, N) * 0.05).astype(np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jl.lora_delta(*(jnp.asarray(v).astype(jd) for v in (xs, a, b)),
                         jnp.asarray(off), backend="xla")
    t = [torch.from_numpy(v).to(dtype) for v in (xs, a, b)]
    got = _cluster_delta(*t, off)
    assert off[3] == off[2]                       # slot 2 holds no row
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    plain = tl.lora_delta(*t, torch.from_numpy(off))
    for out in (got, plain):
        base = out[int(off[-1]):]
        assert base.shape[0] == int((slots < 0).sum())
        assert (base == 0).all() and not torch.signbit(base).any()


def test_padded_rank_columns_give_zero_delta():
    xs, a, b, off = _delta_inputs(R=5, seed=6)
    ap = np.zeros(a.shape[:2] + (8,), np.float32)
    bp = np.zeros((b.shape[0], 8, b.shape[2]), np.float32)
    ap[..., :5], bp[:, :5] = a, b
    t = [torch.from_numpy(v) for v in (xs, a, b, ap, bp, off)]
    np.testing.assert_array_equal(
        tl.lora_delta(t[0], t[3], t[4], t[5]).numpy(),
        tl.lora_delta(t[0], t[1], t[2], t[5]).numpy())


def test_shape_validation():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="need S\\+1"):
        tl.lora_delta(x, torch.zeros(2, 8, 4), torch.zeros(2, 4, 6),
                      torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bank mismatch"):
        tl.lora_delta(x, torch.zeros(2, 8, 4), torch.zeros(2, 3, 6),
                      torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------
# AdapterBank
# ---------------------------------------------------------------------

DIMS = {"qkv": (16, 48), "out": (16, 16), "ffn1": (16, 32),
        "ffn2": (32, 16)}


def _adapter(name, rank, seed, alpha=None, projections=None):
    rng = np.random.RandomState(seed)
    w = {p: (rng.randn(2, k, rank).astype(np.float32) * 0.1,
             rng.randn(2, rank, n).astype(np.float32) * 0.1)
         for p, (k, n) in DIMS.items()
         if projections is None or p in projections}
    return JAdapter(name, rank, w, alpha=alpha)


def _script(bank, Adapter, stats):
    """One lifecycle over a 3-slot bank; returns what both packages must
    agree on, step by step."""
    stats.reset()
    log = []

    def note(what, fn):
        try:
            out = fn()
        except (KeyError, ValueError, RuntimeError) as e:
            out = type(e).__name__
        log.append((what, out, bank.version, dict(bank.loaded()),
                    stats.counter("lora.swaps").value,
                    stats.gauge("lora.active_adapters").value))
        return out

    ads = [Adapter(_adapter("t0", 4, 0)), Adapter(_adapter("t1", 8, 1)),
           Adapter(_adapter("t2", 2, 2, alpha=4.0,
                            projections=("qkv", "ffn2"))),
           Adapter(_adapter("t3", 4, 3))]
    for a in ads[:3]:
        note(f"load {a.name}", lambda a=a: bank.load(a))
    note("full", lambda: bank.load(ads[3]))
    note("double", lambda: bank.load(ads[0]))
    note("acquire r1 t0", lambda: bank.acquire("t0", 1))
    note("acquire r2 t0", lambda: bank.acquire("t0", 2))
    note("acquire r1 t0 again", lambda: bank.acquire("t0", 1))
    note("refcount", lambda: bank.refcount("t0"))
    note("unknown", lambda: bank.acquire("nope", 3))
    note("unload t0 live", lambda: bank.unload("t0"))
    note("draining", lambda: bank.is_draining("t0"))
    note("acquire draining", lambda: bank.acquire("t0", 4))
    note("release r1", lambda: bank.release(1))
    note("release r1 again", lambda: bank.release(1))
    note("release r2", lambda: bank.release(2))
    note("load t3", lambda: bank.load(ads[3]))
    note("move r5", lambda: (bank.acquire("t1", 5), bank.acquire("t2", 5)))
    note("refcounts", lambda: (bank.refcount("t1"), bank.refcount("t2")))
    note("unload t1 free", lambda: bank.unload("t1"))
    note("unload unknown", lambda: bank.unload("t1"))
    return log, {k: _f32(v) for k, v in bank.operands().items()}


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bank_lifecycle_equals_jax(dtype):
    jb = JBank(2, DIMS, slots=3, rank=8, dtype=getattr(jnp, dtype))
    tb = TBank(2, DIMS, slots=3, rank=8, dtype=getattr(torch, dtype),
               device="cpu")
    assert tb.rank_pad == jb.rank_pad
    jlog, jops = _script(jb, lambda a: a, jstats)
    tlog, tops = _script(tb, load_jax_adapter, tstats)
    assert tlog == jlog
    assert sorted(tops) == sorted(jops)
    for k in jops:                 # alpha folded, ranks zero-padded
        np.testing.assert_array_equal(tops[k], jops[k])


def test_operands_are_version_keyed_and_updated_in_place():
    tb = TBank(2, DIMS, slots=2, rank=4, device="cpu")
    tb.load(load_jax_adapter(_adapter("t0", 4, 0)))
    ops = tb.operands()
    ptrs = {k: v.data_ptr() for k, v in ops.items()}
    assert tb.operands() is ops and tb.uploads == 1    # same version
    tb.load(load_jax_adapter(_adapter("t1", 4, 1)))
    ops2 = tb.operands()
    assert tb.uploads == 2
    # a hot swap changes values only: the same tensors, refreshed
    assert {k: v.data_ptr() for k, v in ops2.items()} == ptrs
    assert float(ops2["qkv_a"][:, 1].abs().sum()) > 0


def test_from_stack_takes_the_stack_dtype_and_skips_moe_ffn():
    w = {"qkv_weight": torch.zeros(2, 16, 48, dtype=torch.bfloat16),
         "out_weight": torch.zeros(2, 16, 16, dtype=torch.bfloat16),
         "moe_w1": torch.zeros(2, 4, 16, 32, dtype=torch.bfloat16)}
    tb = TBank.from_stack(w, slots=2, rank=8)
    assert tb.dtype == torch.bfloat16 and tb.rank_pad == 16
    assert sorted(tb.dims) == ["out", "qkv"]
    assert tb.device.type == "cpu"
    w8 = dict(w, qkv_weight=torch.zeros(2, 16, 48, dtype=torch.int8))
    assert TBank.from_stack(w8, rank=8).dtype == torch.float32


def test_tp_operands_wait_for_their_slice():
    tb = TBank(1, {"qkv": (8, 24)}, slots=1, device="cpu")
    with pytest.raises(NotImplementedError, match="TP serving"):
        tb.operands(tp=object())


def test_random_adapter_is_the_same_in_every_process():
    code = ("import hashlib, numpy as np\n"
            "from paddle_tpu_torch.serving.adapters import AdapterBank\n"
            "b = AdapterBank(2, {'qkv': (8, 24), 'ffn2': (16, 8)}, "
            "rank=4, device='cpu')\n"
            "a = b.random_adapter('lora0', seed=3)\n"
            "h = hashlib.sha256()\n"
            "for p in sorted(a.weights):\n"
            "    for t in a.weights[p]:\n"
            "        h.update(np.ascontiguousarray(t).tobytes())\n"
            "print(h.hexdigest())\n")
    outs = []
    for hashseed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs.append(res.stdout.strip())
    assert outs[0] == outs[1]
    b = TBank(2, {"qkv": (8, 24)}, rank=4, device="cpu")
    x, y = b.random_adapter("lora0", seed=3), b.random_adapter("lora0",
                                                              seed=4)
    assert not np.array_equal(x.weights["qkv"][0], y.weights["qkv"][0])
