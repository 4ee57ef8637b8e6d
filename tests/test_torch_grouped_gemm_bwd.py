"""Parity of the backward of paddle_tpu_torch's grouped GEMM with
paddle_tpu's custom VJP, and of kernel B15's plain version.

The same seeded numpy inputs and cotangent go to both packages: the
port's ``grouped_gemm`` through ``torch.autograd`` (its CPU path, the
plain versions) and the JAX ``grouped_gemm`` through ``jax.grad``, run as
the JAX package's own tests run it: the XLA tile walk and the Pallas
kernels in interpret mode. dx, dw and db are held to JAX's within 1e-5
of each one's largest value in float32 (fp32 sums in another order) and
1e-2 in bfloat16 (bf16 inputs and outputs; the products are exact in
fp32, the sums and the final rounding differ by a few ulps). The
layouts: ragged counts off the 128/64-row tiles, every row on one
expert, empty experts, and ``offsets[E] < T`` (rows that belong to no
expert, whose dx is exactly 0 and which add nothing to dw and db).

On the card the backward launches B14 (the pre-activation recompute and
dx, in B14's backward mode) and B15 (dw) or raises; the guards here
check, without a card, that a CUDA tensor never reaches a plain version
and that the kernel route reads nothing back to the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import grouped_gemm as jgg
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import grouped_gemm as tgg

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

K, N = 128, 256
#: (T, per-expert counts): uniform and ragged counts off the 128/64-row
#: tiles, one expert owning every row, two empty experts,
#: offsets[E] = 150 < T = 200, and counts 1-15 rows past a multiple of 16
#: (B15's k16 steps) with a one-row expert and the last ending at T
COUNTS = {
    "uniform": (192, [48, 48, 48, 48]),
    "ragged": (200, [37, 61, 50, 52]),
    "skewed": (200, [0, 200, 0, 0]),
    "empty": (150, [70, 0, 0, 80]),
    "short": (200, [40, 30, 60, 20]),
    "unaligned": (216, [35, 1, 77, 103]),
}


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _inputs(case, seed=0):
    T, counts = COUNTS[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(T, K).astype(np.float32)
    w = (rng.randn(len(counts), K, N) * 0.05).astype(np.float32)
    b = (rng.randn(len(counts), N) * 0.1).astype(np.float32)
    g = rng.randn(T, N).astype(np.float32)
    return x, w, b, g, _offsets(counts)


def _jax_grads(case, dtype, activation, bias, backend, out_f32=False):
    x, w, b, g, off = _inputs(case)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out_dtype = jnp.float32 if out_f32 else None

    def f(xa, wa, ba):
        y = jgg.grouped_gemm(xa, wa, jnp.asarray(off),
                             bias=ba if bias else None,
                             activation=activation, backend=backend,
                             out_dtype=out_dtype)
        return jnp.sum(y.astype(jnp.float32) * g)

    grads = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
        jnp.asarray(b))
    return [np.asarray(t.astype(jnp.float32)) for t in grads]


def _port_grads(case, dtype, activation, bias, out_f32=False):
    x, w, b, g, off = _inputs(case)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).to(td).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = tgg.grouped_gemm(tx, tw, torch.from_numpy(off),
                         bias=tb if bias else None, activation=activation,
                         out_dtype=torch.float32 if out_f32 else None)
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == td and tw.grad.dtype == td
    return [tx.grad, tw.grad, tb.grad if bias else None]


def _close(got, want, dtype, what):
    got = got.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    tol = 1e-5 if dtype == "float32" else 1e-2
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


#: (backend, activation, layout, bias): the XLA walk over every layout
#: (gelu) and every activation; the interpret-mode kernels over every
#: layout and every activation; no bias on three
GRAD_CASES = (
    [("xla", "gelu", case, True) for case in COUNTS]
    + [("xla", None, case, True) for case in ("empty", "short")]
    + [("xla", "relu", case, True) for case in ("ragged", "empty")]
    + [("xla", act, "short", False) for act in (None, "gelu")]
    + [("interpret", "gelu", case, True) for case in COUNTS
       if case != "ragged"]
    + [("interpret", act, "ragged", True) for act in (None, "relu")]
    + [("interpret", "relu", "empty", False)])


@pytest.mark.parametrize("backend,activation,case,bias", GRAD_CASES)
def test_gradients_match_jax_f32(backend, activation, case, bias):
    want = _jax_grads(case, "float32", activation, bias, backend)
    got = _port_grads(case, "float32", activation, bias)
    for name, g, w in zip(("dx", "dw", "db"), got, want):
        if g is not None:
            _close(g, w, "float32", f"{name} {backend} {activation} {case}")
    total = int(_offsets(COUNTS[case][1])[-1])
    # rows that belong to no expert get no gradient
    assert (got[0][total:] == 0).all()


@pytest.mark.parametrize("case,activation,out_f32", [
    ("short", "gelu", False), ("skewed", "gelu", False),
    ("empty", None, True)])
def test_gradients_match_jax_bf16(case, activation, out_f32):
    """FFN1's form (bf16 out, GELU) and FFN2's (f32 out, no activation)
    with bf16 x and bank, as the O2 MoE step runs them."""
    want = _jax_grads(case, "bfloat16", activation, True, "xla", out_f32)
    got = _port_grads(case, "bfloat16", activation, True, out_f32)
    for name, g, w in zip(("dx", "dw", "db"), got, want):
        _close(g, w, "bfloat16", f"{name} bf16 {activation} {case}")


def _padded(a, t_pad):
    return jnp.asarray(np.pad(a, ((0, t_pad - a.shape[0]), (0, 0))))


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_grouped_dw_plain_matches_jax(case):
    """B15's plain version against the JAX ``_grouped_dw``, the Pallas
    kernel in interpret mode (and the XLA walk on one layout), over the
    JAX map at its 128-row tile."""
    x, _, _, g, off = _inputs(case)
    E, bm = len(off) - 1, 128
    t_pad = -(-x.shape[0] // bm) * bm
    gids, tids, lo, hi = jgg.grouped_work_map(jnp.asarray(off), t_pad, bm)
    got = tgg.grouped_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(off), E)
    assert got.dtype == torch.float32 and got.shape == (E, K, N)
    backends = ("interpret", "xla") if case == "short" else ("interpret",)
    for backend in backends:
        want = np.asarray(jgg._grouped_dw(
            _padded(x, t_pad), _padded(g, t_pad), E, gids, tids, lo, hi,
            bm, 128, backend))
        _close(got, want, "float32", f"dw {backend} {case}")
    for e in np.flatnonzero(np.diff(off) == 0):
        assert (got[e].view(torch.int32) == 0).all()   # exact +0.0


def test_grouped_dw_ignores_rows_past_offsets_and_casts():
    x, _, _, g, off = _inputs("short")
    tx, tg, toff = (torch.from_numpy(a) for a in (x, g, off))
    total = int(off[-1])
    junk = tx.clone()
    junk[total:] = 1e6
    want = tgg.grouped_dw_plain(tx[:total], tg[:total], toff, 4)
    assert torch.equal(tgg.grouped_dw_plain(junk, tg, toff, 4), want)
    out = tgg._dw(tx.to(torch.bfloat16), tg, toff, 4, torch.bfloat16,
                  "plain")
    assert out.dtype == torch.bfloat16 and out.shape == (4, K, N)


@pytest.mark.parametrize("counts,K,N", [
    ([35, 1, 77, 103], 128, 256),      # one tile an expert
    ([0, 200, 0, 0], 1024, 4096),      # the FFN1 bank, three empty
    ([70, 0, 0, 80], 4096, 1024),      # the FFN2 bank
    ([3, 3, 0, 9, 3], 136, 200),       # ragged K and N, ties
])
def test_dw_tile_order_visits_every_tile_heaviest_expert_first(counts, K,
                                                              N):
    """B15's bf16 walk: every (expert, 128 x 256 tile) exactly once, empty
    experts included (they write zeros), an expert's tiles consecutive,
    the experts by row count with the heaviest first (ties by index)."""
    off = torch.from_numpy(_offsets(counts))
    tiles = tgg.dw_tile_order(off, K, N)
    E, per = len(counts), -(-K // 128) * -(-N // 256)
    assert tiles.dtype == torch.int32 and tiles.shape == (E * per,)
    ids = tiles.tolist()
    assert sorted(ids) == list(range(E * per))
    experts = [i // per for i in ids]
    walk = experts[::per]
    assert experts == [e for e in walk for _ in range(per)]
    assert walk == sorted(range(E), key=lambda e: (-counts[e], e))


# ---------------------------------------------------------------------
# guards: no plain version for a CUDA tensor, no host read on the card
# ---------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA device: what the wrappers see
    on the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _card(t, grad=False):
    return torch.Tensor._make_subclass(_OnCard, t, grad)


def _refuse_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(tgg, "grouped_gemm_plain", plain)
    monkeypatch.setattr(tgg, "grouped_dw_plain", plain)


def _fake_kernels(monkeypatch, log):
    """Stand-ins for the two CUDA wrappers that record each launch and
    return zeros of the kernel's shape without reading anything."""
    def gemm(x, w, offsets, bias, activation, out_dtype, trans_w=False):
        log.append("dx" if trans_w else "gemm")
        n = w.shape[1] if trans_w else w.shape[2]
        return torch.zeros((x.shape[0], n), dtype=out_dtype)

    def dw(x, dz, offsets, E, out_dtype):
        assert dz.dtype == x.dtype      # dz rounded to x's dtype
        log.append("dw")
        return torch.zeros((E, x.shape[1], dz.shape[1]), dtype=out_dtype)
    monkeypatch.setattr(tgg, "_grouped_gemm_cuda", gemm)
    monkeypatch.setattr(tgg, "_grouped_dw_cuda", dw)


def test_backward_on_a_cuda_tensor_never_takes_a_plain_version(
        monkeypatch):
    _refuse_plain(monkeypatch)
    log = []
    _fake_kernels(monkeypatch, log)
    x = _card(torch.randn(16, 32, dtype=torch.bfloat16), grad=True)
    w = _card(torch.randn(2, 32, 64, dtype=torch.bfloat16), grad=True)
    off = _card(torch.tensor([0, 9, 16], dtype=torch.int32))
    y = tgg.grouped_gemm(x, w, off, activation="gelu")
    y.float().sum().backward()
    # forward, the pre-activation's recompute, dx, dw
    assert log == ["gemm", "gemm", "dx", "dw"]


def test_backward_kernels_raise_without_their_library(monkeypatch):
    _refuse_plain(monkeypatch)

    def no_lib(name):
        raise RuntimeError("kernel library unavailable")
    monkeypatch.setattr(_kernels, "lib", no_lib)
    x = _card(torch.randn(16, 32, dtype=torch.bfloat16))
    dz = _card(torch.randn(16, 64, dtype=torch.bfloat16))
    w = _card(torch.randn(2, 32, 64, dtype=torch.bfloat16))
    off = _card(torch.tensor([0, 9, 16], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tgg._dx(dz, w, off, torch.bfloat16, "kernel")
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tgg._dw(x, dz, off, 2, torch.bfloat16, "kernel")


def test_backward_kernel_route_reads_nothing_back(monkeypatch):
    """The kernel route's backward (recompute, act', dz rounding, dx, dw
    and the db segment sum) runs with every host read refused."""
    log = []
    _fake_kernels(monkeypatch, log)
    rng = np.random.RandomState(4)
    x = _card(torch.from_numpy(rng.randn(24, 32).astype(np.float32))
              .to(torch.bfloat16), grad=True)
    w = _card(torch.from_numpy(rng.randn(3, 32, 64).astype(np.float32))
              .to(torch.bfloat16), grad=True)
    b = torch.zeros(3, 1, 64, requires_grad=True)
    off = _card(torch.tensor([0, 10, 10, 20], dtype=torch.int32))
    y = tgg.grouped_gemm(x, w, off, bias=b, activation="gelu",
                         out_dtype=torch.bfloat16)

    def refuse(*a, **k):
        raise AssertionError("a host read on the device path")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "bincount", refuse)
    y.float().sum().backward()
    monkeypatch.undo()
    assert log == ["gemm", "gemm", "dx", "dw"]
    assert b.grad.shape == b.shape and x.grad.dtype == torch.bfloat16


class _FakeLib:
    """Stands in for the built library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_dw_launch_arguments(monkeypatch, dtype):
    """B15's wrapper with the library faked: one launch with the shapes,
    counted; no rows (T 0) gives zeros without a launch; the bf16 kernel
    refuses more experts than it ranks in shared memory."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "lib", lambda name: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    x = torch.randn(24, 256).to(dtype)
    dz = torch.randn(24, 512).to(dtype)
    off = torch.tensor([0, 10, 10, 24], dtype=torch.int32)
    before = tgg.dw_launches
    out = tgg._grouped_dw_cuda(x, dz, off, 3, torch.bfloat16)
    assert out.shape == (3, 256, 512) and out.dtype == torch.bfloat16
    assert tgg.dw_launches == before + 1
    (name, args), = fake.calls
    assert name == "ptt_grouped_dw"
    assert args[5:10] == (_kernels.dtype_code(x, ""), 24, 256, 512, 3)
    empty = tgg._grouped_dw_cuda(x[:0], dz[:0], off * 0, 3, torch.float32)
    assert len(fake.calls) == 1 and tgg.dw_launches == before + 1
    assert (empty == 0).all() and empty.shape == (3, 256, 512)
    many = torch.zeros(tgg.DW_MAX_EXPERTS + 2, dtype=torch.int32)
    many[-1] = 24
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="at most 1024 experts"):
            tgg._grouped_dw_cuda(x, dz, many, tgg.DW_MAX_EXPERTS + 1,
                                 torch.bfloat16)


def test_segment_sum_is_the_live_rows_per_expert():
    rng = np.random.RandomState(6)
    dz = torch.from_numpy(rng.randn(30, 8).astype(np.float32))
    off = torch.tensor([0, 7, 7, 25], dtype=torch.int32)
    db = tgg._segment_sum(dz, off, 3)
    want = torch.stack([dz[0:7].sum(0), torch.zeros(8), dz[7:25].sum(0)])
    torch.testing.assert_close(db, want)


def test_serving_moe_ffn_is_forward_only_and_unchanged():
    """The serving stack's MoE FFN (parameters without gradient) builds
    no graph and equals the plain composition of its two grouped GEMMs
    bit for bit."""
    from paddle_tpu_torch.inference import FusedCausalLM

    torch.manual_seed(0)
    model = FusedCausalLM(64, 32, 2, 64, 2, max_position=16,
                          moe_num_experts=4, moe_top_k=2, device="cpu")
    stack = model.stack
    w = {n: getattr(stack, n)[0] for n in
         ("gate_weight", "moe_w1", "moe_b1", "moe_w2", "moe_b2")}
    assert not any(t.requires_grad for t in w.values())
    hn = torch.randn(3, 5, 32)
    y = stack._moe_ffn(w, hn)
    assert y.grad_fn is None
    _, topk_val, topk_idx = tgg.moe_route(hn.reshape(-1, 32),
                                          w["gate_weight"], 2)
    order, off, _ = tgg._sort_by_expert(topk_idx, 4)
    rows = hn.reshape(-1, 32)[torch.div(order.long(), 2,
                                        rounding_mode="floor")]
    h = tgg.grouped_gemm_plain(rows, w["moe_w1"], off, bias=w["moe_b1"],
                               activation=stack.activation)
    yr = tgg.grouped_gemm_plain(h, w["moe_w2"], off, bias=w["moe_b2"],
                                out_dtype=torch.float32)
    flat = torch.zeros(15 * 2, 32)
    flat[order.long()] = yr
    want = (flat.reshape(15, 2, 32) * topk_val[..., None]).sum(1)
    assert torch.equal(y.reshape(15, 32), want)
