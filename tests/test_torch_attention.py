"""Parity of paddle_tpu_torch's attention with paddle_tpu's.

The JAX side runs as its own tests run it on the CPU: ``_use_pallas`` is
false there, so ``_attention_raw`` takes ``_xla_attention``
(``jax.nn.dot_product_attention``); gradients come from ``jax.vjp``.
The port's flash route on the CPU runs kernel B10's plain versions
through ``FlashAttentionFunction``. The same seeded numpy inputs go to
both. Tolerances, against the largest value of the reference: float32
1e-5 (f32 sums in another order); bf16 1e-2 (the XLA path casts the
probabilities to bf16 before the value product and its backward runs in
bf16, where the plain version keeps f32: differences of one or two bf16
ulps, 0.4-0.8% of the largest value).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.nn.functional import flash_varlen as tfv

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(shape_q, shape_k, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_k).astype(np.float32)
    v = rng.standard_normal(shape_k).astype(np.float32)
    do = rng.standard_normal(shape_q).astype(np.float32)
    return q, k, v, do


def _jax(arrs, dtype, causal):
    jd = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(a).astype(jd) for a in arrs)
    out, vjp = jax.vjp(
        lambda q, k, v: jattn._attention_raw(q, k, v, causal=causal),
        q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(do))]


def _port(arrs, dtype, causal):
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrs)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tattn.scaled_dot_product_attention(q, k, v, is_causal=causal)
    backend = tattn.last_attention_backend()
    out.backward(do)
    return backend, [t.detach().float().numpy()
                     for t in (out, q.grad, k.grad, v.grad)]


def _close(got, want, tol, what):
    limit = tol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max error {err} > {limit}"


def test_flash_route_f32_case_is_bitwise_repeatable():
    """Both sides of ``test_flash_route_matches_jax[shape0-True-float32]``
    are bitwise repeatable in one process: the port's plain f32 flash
    route (out and the three gradients) under one torch thread and under
    one a core (at least two), twice each, and the JAX reference twice.
    A reduction order that followed the thread count, or any state that
    moved one side between calls, would show here."""
    def bits(ts):
        return [np.ascontiguousarray(t).view(np.int32).copy() for t in ts]

    arrs = _inputs((2, 128, 2, 16), (2, 128, 2, 16))
    threads, many = torch.get_num_threads(), max(2, os.cpu_count() or 2)
    runs = []
    try:
        for n in (1, many, 1, many):
            torch.set_num_threads(n)
            runs.append(bits(_port([a.copy() for a in arrs], "float32",
                                   True)[1]))
    finally:
        torch.set_num_threads(threads)
    for run in runs[1:]:
        for got, first in zip(run, runs[0]):
            assert np.array_equal(got, first)
    want = [bits(_jax([a.copy() for a in arrs], "float32", True))
            for _ in range(2)]
    for got, first in zip(want[1], want[0]):
        assert np.array_equal(got, first)
    # and the case itself, well inside its limit
    for name, g, w in zip(("out", "dq", "dk", "dv"), runs[0], want[0]):
        g, w = g.view(np.float32), w.view(np.float32)
        _close(g, w, TOL["float32"] / 5, f"{name} f32 causal")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 2, 16), (1, 256, 3, 8)])
def test_flash_route_matches_jax(shape, causal, dtype):
    arrs = _inputs(shape, shape)
    backend, got = _port(arrs, dtype, causal)
    assert backend == "flash"
    for name, g, w in zip(("out", "dq", "dk", "dv"), got,
                          _jax(arrs, dtype, causal)):
        _close(g, w, TOL[dtype], f"{name} {dtype} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_route_cross_lengths_match_jax(causal):
    """sq != sk: causal counts from the top left on both sides."""
    arrs = _inputs((1, 128, 2, 16), (1, 256, 2, 16), seed=4)
    backend, got = _port(arrs, "float32", causal)
    assert backend == "flash"
    for g, w in zip(got, _jax(arrs, "float32", causal)):
        _close(g, w, TOL["float32"], f"causal={causal}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_route_matches_jax(causal, dtype):
    """A length off the 128 grid takes the dense route on both sides."""
    arrs = _inputs((2, 96, 2, 16), (2, 96, 2, 16), seed=1)
    backend, got = _port(arrs, dtype, causal)
    assert backend == "dense"
    for g, w in zip(got, _jax(arrs, dtype, causal)):
        _close(g, w, TOL[dtype], f"dense {dtype} causal={causal}")


def test_bool_mask_takes_dense_route_and_matches_jax():
    q, k, v, _ = _inputs((2, 128, 2, 16), (2, 128, 2, 16), seed=2)
    mask = np.random.RandomState(5).rand(2, 1, 128, 128) > 0.3
    mask[..., 0] = True
    want = jattn._attention_raw(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask))
    got = tattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    assert tattn.last_attention_backend() == "dense"
    _close(got.numpy(), np.asarray(want), TOL["float32"], "masked")


ROUTES = [(hd, sq, sk, bias) for hd in (8, 12, 16, 64, 128, 96)
          for sq in (64, 128, 200, 256) for sk in (128, 384, 100)
          for bias in (False, True)]


def test_route_is_use_pallas_without_on_tpu(monkeypatch):
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    for hd, sq, sk, bias in ROUTES:
        assert tattn._use_flash(hd, sq, sk, bias) == \
            jattn._use_pallas(hd, sq, sk, bias), (hd, sq, sk, bias)
    assert sum(tattn._use_flash(*r) for r in ROUTES) > 0


@pytest.mark.parametrize("causal", [True, False])
def test_lse_is_logsumexp_of_jax_logits(causal):
    q, k, v, _ = _inputs((2, 128, 3, 16), (2, 128, 3, 16), seed=3)
    scale = 16 ** -0.5
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q),
                        jnp.asarray(k)) * scale
    if causal:
        keep = jnp.tril(jnp.ones((128, 128), bool))
        logits = jnp.where(keep, logits, tattn.MASK_VALUE)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    _, lse = tattn.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 128)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_flash_attention_returns_out_and_none():
    q, k, v, _ = _inputs((1, 128, 2, 8), (1, 128, 2, 8))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, soft = tattn.flash_attention(*t, causal=True)
    assert soft is None
    ref = tattn.scaled_dot_product_attention(*t, is_causal=True)
    assert torch.equal(out, ref)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(*t, return_softmax=True)


def test_dropout_path_draws_from_its_generator():
    q, k, v, _ = _inputs((1, 128, 2, 8), (1, 128, 2, 8))
    t = [torch.from_numpy(a) for a in (q, k, v)]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tattn.scaled_dot_product_attention(
            *t, dropout_p=0.5, is_causal=True, generator=g)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert tattn.last_attention_backend() == "dense"
    # not training: no dropout, the flash route
    out = tattn.scaled_dot_product_attention(*t, dropout_p=0.5,
                                             is_causal=True, training=False)
    assert tattn.last_attention_backend() == "flash"
    assert torch.equal(out, tattn.scaled_dot_product_attention(
        *t, is_causal=True))


@pytest.mark.parametrize("causal", [True, False])
def test_dropout_path_without_drops_matches_jax(causal):
    # keep probability 1 - 1e-9: every draw keeps, so the dropout path's
    # logits, bias, bottom-right causal mask and softmax meet JAX's
    q, k, v, _ = _inputs((2, 64, 3, 16), (2, 96, 3, 16), seed=5)
    bias = np.random.RandomState(6).standard_normal(
        (2, 3, 64, 96)).astype(np.float32)
    want = np.asarray(jattn._attention_raw(
        *(jnp.asarray(a) for a in (q, k, v, bias)), causal=causal,
        dropout_p=1e-9, dropout_key=jax.random.PRNGKey(0)))
    got = tattn._attention_raw(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), causal=causal,
        dropout_p=1e-9, generator=torch.Generator().manual_seed(0))
    assert tattn.last_attention_backend() == "dense"
    _close(got.numpy(), want, TOL["float32"], "dropout path")


def test_plain_versions_leave_out_dropped_pairs():
    # drop keys 32-63 from rows 64 on: those rows see the other 96 keys
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs((1, 128, 2, 16), (1, 128, 2, 16), seed=7))
    scale = 16 ** -0.5
    drop = torch.zeros((128, 128), dtype=torch.bool)
    drop[64:, 32:64] = True
    out, lse = tattn.flash_attention_fwd_plain(q, k, v, False, scale,
                                               drop=drop)
    dq = tattn.flash_attention_bwd_plain(q, k, v, out, lse, do, False,
                                         scale, drop=drop)[0]
    keys = torch.cat([torch.arange(32), torch.arange(64, 128)])
    kr, vr, late = k[:, keys], v[:, keys], slice(64, None)
    out_r, lse_r = tattn.flash_attention_fwd_plain(q[:, late], kr, vr,
                                                   False, scale)
    dq_r = tattn.flash_attention_bwd_plain(q[:, late], kr, vr, out_r, lse_r,
                                           do[:, late], False, scale)[0]
    torch.testing.assert_close(out[:, late], out_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse[..., late], lse_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(dq[:, late], dq_r, rtol=0, atol=1e-6)
    whole = tattn.flash_attention_fwd_plain(q, k, v, False, scale)[0]
    assert torch.equal(out[:, :64], whole[:, :64])


def test_unported_entry_points_name_their_slices():
    with pytest.raises(NotImplementedError, match="tile"):
        tattn.set_flash_block_sizes(256, 256)


# ---------------------------------------------------------------------
# no plain fallback for a CUDA tensor
# ---------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def no_plain_no_kernel(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    def no_lib(name):
        raise RuntimeError("kernel library unavailable")
    monkeypatch.setattr(tattn, "flash_attention_fwd_plain", plain)
    monkeypatch.setattr(tattn, "flash_attention_bwd_plain", plain)
    monkeypatch.setattr(_kernels, "lib", no_lib)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensor_never_takes_the_plain_version(no_plain_no_kernel,
                                                   dtype):
    q, k, v = (_card(torch.randn(1, 128, 2, 64).to(dtype))
               for _ in range(3))
    before = (tattn.fwd_launches, tattn.dq_launches, tattn.dkv_launches)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tattn.flash_attention_fwd(q, k, v, True, 0.125)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tattn.flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 128), q,
                                  True, 0.125)
    assert (tattn.fwd_launches, tattn.dq_launches,
            tattn.dkv_launches) == before


@pytest.mark.parametrize("head_dim", [8, 32, 80, 136, 256, 264])
def test_head_dim_without_a_kernel_raises_on_the_card(no_plain_no_kernel,
                                                      head_dim):
    """The route admits head_dim % 8 == 0; the kernel has 64, 96, 128 and
    256. On the card another multiple of 8 up to 256 goes to the kernel
    zero-padded (the library is missing here, so that raises), a wider
    head raises NotImplementedError naming its reason; neither takes the
    dense path."""
    assert tattn._use_flash(head_dim, 128, 128, False)
    q = _card(torch.randn(1, 128, 2, head_dim))
    err = (RuntimeError, "kernel library unavailable") if head_dim <= 256 \
        else (NotImplementedError, "head_dim 264.*no model")
    with pytest.raises(err[0], match=err[1]):
        tattn.scaled_dot_product_attention(q, q, q, is_causal=True)


@pytest.mark.parametrize("head_dim,width", [(80, 96), (40, 64), (104, 128),
                                            (136, 256), (200, 256)])
def test_padded_head_dim_reaches_the_kernel_at_its_built_width(monkeypatch,
                                                               head_dim,
                                                               width):
    """A head_dim without a kernel reaches B10's three launches
    zero-padded to the next built width with the true scale (recorded by
    stand-ins for the launch functions), and comes back at its own
    width."""
    calls = []

    def fwd(q, k, v, causal, scale):
        calls.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1], scale))
        b, s, h, _ = q.shape
        return torch.zeros(q.shape), torch.zeros(b, h, s)

    def dq(q, k, v, dout, lse, di, causal, scale):
        calls.append(("dq", q.shape[-1], dout.shape[-1], scale))
        return torch.zeros(q.shape)

    def dkv(q, k, v, dout, lse, di, causal, scale):
        calls.append(("dkv", k.shape[-1], dout.shape[-1], scale))
        return torch.zeros(k.shape), torch.zeros(v.shape)
    monkeypatch.setattr(tattn, "_flash_fwd_cuda", fwd)
    monkeypatch.setattr(tattn, "_flash_bwd_dq_cuda", dq)
    monkeypatch.setattr(tattn, "_flash_bwd_dkv_cuda", dkv)
    q = _card(torch.randn(1, 128, 2, head_dim)).requires_grad_(True)
    out = tattn.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert out.shape == (1, 128, 2, head_dim)
    out.backward(torch.ones_like(out))
    assert q.grad.shape == q.shape
    scale = head_dim ** -0.5
    assert calls == [("fwd", width, width, width, scale),
                     ("dq", width, width, scale),
                     ("dkv", width, width, scale)]


@pytest.mark.parametrize("head_dim", [80, 136])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_pad_route_equals_the_plain_version(causal, head_dim):
    """The card's route for head_dim 80 (pad to 96) or 136 (pad to 256):
    the plain flash versions at the built width with the true scale,
    sliced, equal the plain versions at the true width: forward, lse and
    backward, f32, within 1e-6."""
    shape = (2, 128, 2, head_dim)
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(shape, shape, seed=8))
    scale = head_dim ** -0.5
    args = (tattn.FLASH_HEAD_DIMS, "flash_attention")
    out, lse = tfv.padded_fwd(tattn.flash_attention_fwd_plain, *args, q, k,
                              v, causal, scale)
    out_r, lse_r = tattn.flash_attention_fwd_plain(q, k, v, causal, scale)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-6)
    got = tfv.padded_bwd(tattn.flash_attention_bwd_plain, *args, q, k, v,
                         out, lse, do, causal, scale)
    want = tattn.flash_attention_bwd_plain(q, k, v, out_r, lse_r, do,
                                           causal, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------
# head_dim 96 (the gpt-760m rung: d1536, 16 heads)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_route_head_dim_96_matches_jax(causal, dtype):
    arrs = _inputs((1, 128, 2, 96), (1, 128, 2, 96), seed=6)
    backend, got = _port(arrs, dtype, causal)
    assert backend == "flash"
    want = _jax(arrs, dtype, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, TOL[dtype], f"d96 {dtype} causal={causal} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_96_takes_the_kernel_on_the_card(no_plain_no_kernel,
                                                  dtype):
    """96 is one of the kernels' head dims: a d96 CUDA tensor goes to
    the kernel library, never to a plain version."""
    assert tattn.FLASH_HEAD_DIMS == (64, 96, 128, 256)
    q = _card(torch.randn(1, 128, 2, 96).to(dtype))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tattn.scaled_dot_product_attention(q, q, q, is_causal=True)


def test_attn_varlen_bench_runs_on_the_cpu(capsys):
    """The port's --attn-varlen rung at its CPU geometry (4 x 512 tokens,
    2 heads of 64, f32) and its command line."""
    import json

    from paddle_tpu_torch import bench

    tps, peak, total, backend = bench.run_attn_varlen_bench(device="cpu")
    assert tps > 0 and peak is None and total == 2048 and backend == "plain"
    bench.main(["--attn-varlen", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["attn_varlen_total_tokens"] == 2048
    assert line["attn_varlen_backend"] == "plain" and line["device"] == "cpu"
    with pytest.raises(SystemExit):
        bench.main([])
