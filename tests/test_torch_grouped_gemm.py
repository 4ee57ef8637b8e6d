"""Parity of paddle_tpu_torch's grouped GEMM and MoE FFN with paddle_tpu's.

The same seeded numpy inputs go to both packages. Integers are pinned
exactly: the work-unit map (at the TPU's row tile 128 and the card's
64), the router's top-k experts (ties included), the expert sort's
order, offsets and counts. Float outputs of the port's plain version
(the CPU path of ``grouped_gemm``) are held to the JAX function run as
its own tests run it (the Pallas kernel in interpret mode, and the XLA
walk): float32 within 1e-5 of the largest value (fp32 sums in another
order), bf16 inputs within 1e-2 (the products are exact in fp32; the
sums and the bf16 output rounding differ by a few ulps), and rows past
``offsets[E]`` exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import grouped_gemm as jgg
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.nn.functional import grouped_gemm as tgg


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


#: per-expert row counts: random, one expert owning every row, two empty
#: experts, rows past offsets[E] (a short tail of pad rows)
COUNTS = {
    "random": (200, [37, 61, 50, 52]),
    "skewed": (200, [0, 200, 0, 0]),
    "empty": (150, [70, 0, 0, 80]),
    "short": (200, [40, 30, 60, 20]),
    "tiny": (7, [3, 0, 2, 0]),
}


@pytest.mark.parametrize("bm", [128, tgg.DEFAULT_BLOCK_ROWS])
@pytest.mark.parametrize("case", sorted(COUNTS))
def test_work_map_equals_jax(case, bm):
    T, counts = COUNTS[case]
    off = _offsets(counts)
    t_pad = -(-T // bm) * bm
    want = jgg.grouped_work_map(jnp.asarray(off), t_pad, bm)
    got = tgg.grouped_work_map(torch.from_numpy(off), t_pad, bm)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_work_map_random_offsets_equal_jax():
    """40 random offset vectors at bm 128 and 64. The JAX map runs jitted
    (t_pad and bm static): an eager call compiles each of its ops for
    every new shape, a jitted one compiles once a shape (42 distinct
    shapes among the 80 calls)."""
    jax_map = jax.jit(jgg.grouped_work_map, static_argnums=(1, 2))
    rng = np.random.RandomState(3)
    for _ in range(40):
        E = int(rng.randint(1, 9))
        T = int(rng.randint(1, 300))
        counts = rng.multinomial(int(rng.randint(0, T + 1)),
                                 np.ones(E) / E)
        off = _offsets(counts)
        for bm in (128, 64):
            t_pad = -(-T // bm) * bm
            want = jax_map(jnp.asarray(off), t_pad, bm)
            got = tgg.grouped_work_map(torch.from_numpy(off), t_pad, bm)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _route_inputs(ties: bool):
    rng = np.random.RandomState(5)
    x = rng.randn(24, 32).astype(np.float32)
    g = rng.randn(32, 6).astype(np.float32)
    if ties:
        g[:, 4] = g[:, 1]          # experts 1 and 4 tie on every token
        x[7] = x[3]                # equal rows route alike
        x[12] = x[3]
    return x, g


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_and_sort_equal_jax(ties, top_k):
    x, g = _route_inputs(ties)
    jp, jv, ji = jgg.moe_route(jnp.asarray(x), jnp.asarray(g), top_k)
    tp, tv, ti = tgg.moe_route(torch.from_numpy(x), torch.from_numpy(g),
                               top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    if ties:
        # the tie goes to the lower index, as jax.lax.top_k
        for row in ti.numpy().tolist():
            if 4 in row:
                assert 1 in row and row.index(1) < row.index(4)
    want = jgg._sort_by_expert(ji, 6)
    got = tgg._sort_by_expert(ti, 6)
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def _gemm_inputs(case, dtype, K=256, N=384, seed=0):
    T, counts = COUNTS[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(T, K).astype(np.float32)
    w = (rng.randn(len(counts), K, N) * 0.05).astype(np.float32)
    b = (rng.randn(len(counts), N) * 0.1).astype(np.float32)
    off = _offsets(counts)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if dtype == "bfloat16":
        jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
        tx, tw = tx.to(torch.bfloat16), tw.to(torch.bfloat16)
    return (jx, jw, jnp.asarray(b), jnp.asarray(off)), \
        (tx, tw, torch.from_numpy(b), torch.from_numpy(off))


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-6)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("case", ["random", "skewed", "empty", "short"])
def test_grouped_gemm_plain_matches_jax_f32(case, backend):
    (jx, jw, jb, joff), (tx, tw, tb, toff) = _gemm_inputs(case, "float32")
    want = jgg.grouped_gemm(jx, jw, joff, bias=jb, activation="gelu",
                            backend=backend)
    got = tgg.grouped_gemm(tx, tw, toff, bias=tb, activation="gelu")
    assert got.dtype == torch.float32
    _close(got, want, "float32")
    total = int(toff[-1])
    assert (got[total:] == 0).all()


@pytest.mark.parametrize("activation", [None, "gelu", "relu"])
def test_grouped_gemm_plain_matches_jax_bf16(activation):
    (jx, jw, jb, joff), (tx, tw, tb, toff) = _gemm_inputs("short",
                                                          "bfloat16")
    for out in (None, "f32"):
        want = jgg.grouped_gemm(jx, jw, joff, bias=jb,
                                activation=activation, backend="xla",
                                out_dtype=jnp.float32 if out else None)
        got = tgg.grouped_gemm(tx, tw, toff, bias=tb, activation=activation,
                               out_dtype=torch.float32 if out else None)
        assert got.dtype == (torch.float32 if out else torch.bfloat16)
        _close(got, want, "bfloat16")
        assert (got[int(toff[-1]):] == 0).all()


def test_untileable_shapes_and_no_bias_match_jax():
    """K and N that do not tile by 128 (the JAX package falls back to
    its XLA walk there; the port's kernel takes any multiple of 8)."""
    rng = np.random.RandomState(1)
    x = rng.randn(50, 136).astype(np.float32)
    w = (rng.randn(3, 136, 200) * 0.05).astype(np.float32)
    off = _offsets([20, 0, 25])
    want = jgg.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(off), backend="interpret")
    got = tgg.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(off))
    _close(got, want, "float32")
    assert (got[45:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_nodrop_matches_jax(dtype):
    rng = np.random.RandomState(2)
    T, d, dff, E, k = 40, 64, 128, 4, 2
    x = rng.randn(T, d).astype(np.float32)
    gate = rng.randn(d, E).astype(np.float32)
    w1 = (rng.randn(E, d, dff) * 0.1).astype(np.float32)
    b1 = (rng.randn(E, dff) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, dff, d) * 0.1).astype(np.float32)
    b2 = (rng.randn(E, d) * 0.1).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    jy, jp, ji, jc = jgg.moe_ffn_nodrop(
        jnp.asarray(x).astype(jd), jnp.asarray(gate),
        jnp.asarray(w1).astype(jd), jnp.asarray(b1),
        jnp.asarray(w2).astype(jd), jnp.asarray(b2), top_k=k,
        backend="xla")
    ty, tp, ti, tc = tgg.moe_ffn_nodrop(
        torch.from_numpy(x).to(td), torch.from_numpy(gate),
        torch.from_numpy(w1).to(td), torch.from_numpy(b1),
        torch.from_numpy(w2).to(td), torch.from_numpy(b2), top_k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ty.dtype == td
    _close(ty, jy, dtype)


def test_offsets_shape_validated():
    x = torch.zeros(4, 8)
    w = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="need E\\+1"):
        tgg.grouped_gemm(x, w, torch.tensor([0, 4], dtype=torch.int32))


def test_moe_ffn_ep_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        tgg.moe_ffn_ep()


# ---------------------------------------------------------------------
# no plain fallback for a CUDA tensor
# ---------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA device: what the wrappers see
    on the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def no_plain_no_kernel(monkeypatch):
    """The plain versions fail the test if called; the kernel library is
    unavailable (no nvcc), as on a broken install."""
    from paddle_tpu_torch.nn.functional import lora as tl

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    def no_lib(name):
        raise RuntimeError("kernel library unavailable")
    monkeypatch.setattr(tgg, "grouped_gemm_plain", plain)
    monkeypatch.setattr(tl, "lora_delta_plain", plain)
    monkeypatch.setattr(_kernels, "lib", no_lib)


@pytest.mark.parametrize("flag", ["auto", "pallas", "interpret", "xla"])
def test_cuda_tensor_never_takes_the_plain_version(no_plain_no_kernel,
                                                   flag):
    from paddle_tpu_torch.nn.functional import lora as tl

    x = _card(torch.randn(16, 32))
    w = _card(torch.randn(2, 32, 64))
    off = _card(torch.tensor([0, 9, 16], dtype=torch.int32))
    a = _card(torch.randn(2, 32, 8))
    b = _card(torch.randn(2, 8, 64))
    set_flags({"moe_grouped_backend": flag, "lora_delta_backend": flag})
    try:
        err = (ValueError, "plain walk") if flag == "xla" else \
            (RuntimeError, "kernel library unavailable")
        with pytest.raises(err[0], match=err[1]):
            tgg.grouped_gemm(x, w, off, backend=flag)
        with pytest.raises(err[0], match=err[1]):
            tl.lora_delta(x, a, b, off, backend=flag)
    finally:
        set_flags({"moe_grouped_backend": "auto",
                   "lora_delta_backend": "auto"})


def test_unknown_backend_raises():
    x = torch.zeros(4, 8)
    w = torch.zeros(2, 8, 8)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="expected 'auto'"):
        tgg.grouped_gemm(x, w, off, backend="mosaic")
    # on the CPU every JAX value runs the plain version
    for backend in ("auto", "pallas", "interpret", "xla"):
        assert tgg.grouped_gemm(x, w, off, backend=backend).shape == (4, 8)


def test_device_side_of_routing_and_sorting_reads_nothing_back(monkeypatch):
    """moe_route, _sort_by_expert, sort_by_adapter and inverse_order
    build the kernels' operands on the device with no host read (no
    ``item``, ``tolist`` or ``torch.bincount``, which reads its maximum
    back on the card): a decode step must not sync once per layer."""
    from paddle_tpu_torch.nn.functional import lora as tl

    def refuse(*a, **k):
        raise AssertionError("a host read on the device path")
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
    g = torch.from_numpy(rng.randn(32, 6).astype(np.float32))
    slots = torch.from_numpy(rng.randint(-1, 5, 16).astype(np.int32))
    for name in ("item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "bincount", refuse)
    _, _, idx = tgg.moe_route(x, g, 2)
    order, offsets, counts = tgg._sort_by_expert(idx, 6)
    s_order, s_off, _ = tl.sort_by_adapter(slots, 4)
    tl.inverse_order(s_order)
    monkeypatch.undo()
    assert int(offsets[-1]) == 32 and int(counts.sum()) == 32
    assert int(s_off[-1]) == int(((slots >= 0) & (slots < 4)).sum())


@pytest.mark.parametrize("K,N,dtype,refused", [
    (1024, 4096, torch.bfloat16, False),   # the MoE rung's FFN1 bank
    (136, 200, torch.bfloat16, False),     # ragged, 16-byte rows
    (132, 200, torch.bfloat16, True),      # K off a multiple of 8
    (136, 204, torch.bfloat16, True),      # N off a multiple of 8
    (132, 204, torch.float32, False),      # f32: multiples of 4
    (130, 204, torch.float32, True),
])
def test_card_shape_gate(K, N, dtype, refused):
    """B14 on the card takes K and N whose rows are whole 16-byte pieces
    (the bf16 kernel's TMA strides); the wrapper raises on the rest."""
    msg = tgg.card_shape_error(K, N, dtype)
    assert (msg is not None) == refused
    if refused:
        assert "multiples of" in msg
        x = _card(torch.zeros(4, K, dtype=dtype))
        w = _card(torch.zeros(2, K, N, dtype=dtype))
        off = _card(torch.tensor([0, 2, 4], dtype=torch.int32))
        with pytest.raises(ValueError, match="multiples of"):
            tgg._grouped_gemm_cuda(x, w, off, None, None, dtype)
