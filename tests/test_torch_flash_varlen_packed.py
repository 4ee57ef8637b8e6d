"""Parity of the port's packed varlen flash attention with paddle_tpu's.

The same seeded numpy inputs go to both packages. The block map is pinned
exactly: every field of ``varlen_block_map`` (``n_active`` included)
equals the JAX map's, at the TPU's tiles (128, 128), which the card's
bf16 kernels share up to head_dim 128, and the card's head_dim-256 tiles
(64, 64) and (32, 64). The port's plain versions (the CPU path of
``flash_varlen_packed``) are held to the JAX tile walks
``_packed_fwd_xla`` / ``_packed_bwd_xla`` and to the JAX
``flash_attn_unpadded`` under ``jax.vjp``, run as the JAX tests run them
(``backend="xla"``, and the Pallas kernel in interpret mode for one small
case). Tolerances, of the reference's largest value: float32 1e-5 (f32
sums in another order); bf16 1e-2 (the JAX walk rounds the bf16 output
and gradients at other places: a few bf16 ulps); the ``dense`` flag's
bf16 gradients add the JAX dense path's own bf16 rounding (its deviation
from its f32 run), since that path cancels in bf16. Rows that see no
key are exactly 0.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.flags import set_flags as jset_flags
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.nn.functional import flash_varlen as jfv
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.nn.functional import flash_varlen as tfv

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}

#: segment lengths of q and (when they differ) k: tile-aligned, ragged
#: with a 1-token segment, one segment, totals under one tile, and cross
#: lengths with an empty k segment
PACKS = {
    "aligned": ([128, 256, 128], None),
    "ragged": ([100, 260, 60, 1, 33], None),
    "single": ([200], None),
    "subtile": ([5, 17, 9], None),
    "cross_empty": ([70, 40, 90], [50, 0, 130]),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _pack(name):
    lq, lk = PACKS[name]
    return _cu(lq), _cu(lk if lk is not None else lq)


def _inputs(tq, tk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((tq, h, d)).astype(np.float32),
            rng.standard_normal((tk, h, d)).astype(np.float32),
            rng.standard_normal((tk, h, d)).astype(np.float32),
            rng.standard_normal((tq, h, d)).astype(np.float32))


def _close(got, want, tol, what, extra=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    limit = tol * float(np.abs(want).max()) + extra
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max error {err} > {limit}"


# ---------------------------------------------------------------------
# the block map
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_map(pack, tqp, tkp, bq, bk, causal):
    """The JAX ``varlen_block_map`` of ``pack``, shared by the tests that
    hold a map to it and compiled as one program (its fields are
    integers, the same as op by op, without a compile per primitive and
    shape): a namespace of numpy arrays, ``names`` its fields in order."""
    cq, ck = _pack(pack)
    names = []

    def fields(a, b):
        m = jfv.varlen_block_map(a, b, tqp, tkp, bq, bk, causal)
        names[:] = [f.name for f in dataclasses.fields(m)]
        return tuple(getattr(m, n) for n in names)
    arrays = jax.jit(fields)(jnp.asarray(cq), jnp.asarray(ck))
    return types.SimpleNamespace(names=tuple(names), **{
        n: np.asarray(a) for n, a in zip(names, arrays)})


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (32, 64)])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_block_map_equals_jax(pack, blocks, causal):
    cq, ck = _pack(pack)
    bq, bk = blocks
    tqp = -(-int(cq[-1]) // bq) * bq
    tkp = -(-int(ck[-1]) // bk) * bk
    want = _jax_map(pack, tqp, tkp, bq, bk, causal)
    got = tfv.varlen_block_map(torch.from_numpy(cq), torch.from_numpy(ck),
                               tqp, tkp, bq, bk, causal)
    names = list(want.names)
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), getattr(want, name),
                                      err_msg=name)


def test_block_map_reads_nothing_back(monkeypatch):
    """The map is built on the offsets' device with no host read (no
    ``item``, ``tolist``, ``int``, ``bool`` or ``cpu``): on the card the
    kernels launch without a sync."""
    def refuse(*a, **k):
        raise AssertionError("a host read on the device path")
    cq, ck = (torch.from_numpy(c) for c in _pack("cross_empty"))
    for name in ("item", "tolist", "__int__", "__bool__", "__float__",
                 "__index__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    bm = tfv.varlen_block_map(cq, ck, 256, 192, 64, 64, True)
    monkeypatch.undo()
    want = jfv.varlen_block_map(jnp.asarray(cq.numpy()),
                                jnp.asarray(ck.numpy()), 256, 192, 64, 64,
                                True)
    assert int(bm.n_active) == int(want.n_active)


# ---------------------------------------------------------------------
# the plain versions against the JAX tile walks
# ---------------------------------------------------------------------

def _walk_inputs(pack, causal, bq, bk, h=2, d=16, seed=0):
    cq, ck = _pack(pack)
    q, k, v, _ = _inputs(int(cq[-1]), int(ck[-1]), h, d, seed)
    jq = jfv._packed_prepare(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(cq), jnp.asarray(ck), causal, None,
                             bq, bk)
    tq = tfv._packed_prepare(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(cq),
                             torch.from_numpy(ck), causal, bq, bk)
    return jq, tq


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_plain_walks_match_xla(pack, causal):
    """``_packed_fwd_plain`` / ``_packed_bwd_plain`` against
    ``_packed_fwd_xla`` / ``_packed_bwd_xla`` on the same padded
    operands and map: out and lse (pad rows included), dq, dk, dv."""
    bq, bk, scale = 64, 64, 0.3
    (qt, kt, vt, bm), (qt2, kt2, vt2, bm2) = _walk_inputs(pack, causal, bq,
                                                          bk)
    out, lse = jfv._packed_fwd_xla(qt, kt, vt, bm, scale, causal, bq, bk)
    out2, lse2 = tfv._packed_fwd_plain(qt2, kt2, vt2, bm2, scale, causal, bq,
                                       bk)
    _close(out2.numpy(), out, 1e-5, "out")
    _close(lse2.numpy(), lse, 1e-5, "lse")
    rng = np.random.RandomState(9)
    do = rng.standard_normal(qt.shape).astype(np.float32)
    delta = rng.standard_normal(lse.shape).astype(np.float32)
    want = jfv._packed_bwd_xla(qt, kt, vt, jnp.asarray(do), lse,
                               jnp.asarray(delta), bm, scale, causal, bq, bk)
    got = tfv._packed_bwd_plain(qt2, kt2, vt2, torch.from_numpy(do),
                                torch.from_numpy(np.array(lse)),
                                torch.from_numpy(delta), bm2, scale, causal,
                                bq, bk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, 1e-5, name)


def test_empty_rows_are_exactly_zero():
    """A q segment whose k segment is empty sees no key: out 0 and lse
    -1e30 exactly (the reference multiplies p by the mask), and its dq
    rows 0; the dense path would average every key instead."""
    cq, ck = _pack("cross_empty")
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(int(cq[-1]), int(ck[-1]), 2, 16))
    cq, ck = torch.from_numpy(cq), torch.from_numpy(ck)
    for causal in (True, False):
        out, lse = tfv.packed_fwd_plain(q, k, v, cq, ck, scale=0.25,
                                        causal=causal)
        rows = slice(70, 110)                     # segment 1: 40 queries
        assert torch.equal(out[rows], torch.zeros_like(out[rows]))
        assert bool((lse[:, rows] == -1e30).all())
        assert bool((out[:70].abs().sum(-1) > 0).all())
        dq, dk, dv = tfv.packed_bwd_plain(q, k, v, out, lse, do, cq, ck,
                                          scale=0.25, causal=causal)
        assert torch.equal(dq[rows], torch.zeros_like(dq[rows]))


def test_plain_walk_memory_is_linear_in_tokens(monkeypatch):
    """No [T, T] tensor: the largest intermediate of the walk is
    h * T * block_k floats."""
    sizes = []
    real = torch.einsum

    def spy(eq, *ops):
        r = real(eq, *ops)
        sizes.append(r.numel())
        return r
    monkeypatch.setattr(torch, "einsum", spy)
    T, h, d = 1024, 2, 16
    cu = torch.tensor([0, 300, 700, 1024], dtype=torch.int32)
    q = torch.randn(T, h, d)
    tfv.packed_fwd_plain(q, q, q, cu, cu, scale=0.25, causal=True)
    assert max(sizes) <= h * T * tfv.DEFAULT_BLOCK_K < T * T


# ---------------------------------------------------------------------
# flash_attn_unpadded against the JAX function and its vjp
# ---------------------------------------------------------------------

def _jax_unpadded(arrs, cq, ck, dtype, causal, scale, backend):
    jd = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(a).astype(jd) for a in arrs)
    jset_flags({"attn_varlen_backend": backend})
    try:
        out, vjp = jax.vjp(lambda q, k, v: jattn._unpadded_varlen_raw(
            q, k, v, jnp.asarray(cq), jnp.asarray(ck), scale=scale,
            causal=causal), q, k, v)
        grads = vjp(do)
    finally:
        jset_flags({"attn_varlen_backend": "auto"})
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port_unpadded(arrs, cq, ck, dtype, causal, scale, backend):
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrs)
    for t in (q, k, v):
        t.requires_grad_(True)
    set_flags({"attn_varlen_backend": backend})
    try:
        out, none = tattn.flash_attn_unpadded(
            q, k, v, torch.from_numpy(cq), torch.from_numpy(ck),
            int(np.diff(cq).max()), int(np.diff(ck).max()), scale,
            causal=causal)
        out.backward(do)
    finally:
        set_flags({"attn_varlen_backend": "auto"})
    assert none is None
    assert out.dtype == td and q.grad.dtype == td
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad,
                                                 v.grad)]


@functools.lru_cache(maxsize=None)
def _jax_reference(pack, causal, dtype, ref):
    """The JAX function's out and gradients on ``pack`` (computed once for
    the flag values that share it), and the extra limit of each: 0, but
    for the dense path in bf16, whose backward runs in bf16 end to end
    and cancels in dS = P (dP - delta): its own rounding moves its
    gradients by up to 1.6% of their largest value against its f32 run
    on the same inputs, and that deviation joins the limit."""
    cq, ck = _pack(pack)
    arrs = _inputs(int(cq[-1]), int(ck[-1]), 2, 16, seed=3)
    want = _jax_unpadded(arrs, cq, ck, dtype, causal, 0.3, ref)
    noise = [0.0] * 4
    if ref == "dense" and dtype == "bfloat16":
        exact = _jax_unpadded([np.asarray(jnp.asarray(a).astype(
            jnp.bfloat16).astype(jnp.float32)) for a in arrs], cq, ck,
            "float32", causal, 0.3, ref)
        noise = [float(np.abs(w - e).max()) for w, e in zip(want, exact)]
    return want, noise


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["auto", "pallas", "xla", "dense"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pack", ["ragged", "cross_empty"])
def test_flash_attn_unpadded_matches_jax(pack, causal, backend, dtype):
    """Out and the gradients of q, k, v under every flag value that runs
    on the CPU, against the JAX function on the XLA walk (``dense``
    against the JAX dense path, whose empty rows average every key)."""
    cq, ck = _pack(pack)
    arrs = _inputs(int(cq[-1]), int(ck[-1]), 2, 16, seed=3)
    ref = "dense" if backend == "dense" else "xla"
    want, noise = _jax_reference(pack, causal, dtype, ref)
    got = _port_unpadded(arrs, cq, ck, dtype, causal, 0.3, backend)
    for name, g, w, n in zip(("out", "dq", "dk", "dv"), got, want, noise):
        _close(g, w, TOL[dtype], f"{pack} {backend} {dtype} {name}",
               extra=n)


def test_interpret_flag_matches_the_jax_pallas_kernel():
    """``interpret`` on the CPU (the plain walk) against the JAX Pallas
    kernels run through the interpreter."""
    cq, ck = _pack("subtile")
    arrs = _inputs(int(cq[-1]), int(ck[-1]), 2, 16, seed=4)
    want = _jax_unpadded(arrs, cq, ck, "float32", True, 0.25, "interpret")
    got = _port_unpadded(arrs, cq, ck, "float32", True, 0.25, "interpret")
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, 1e-5, f"interpret {name}")


def test_dropout_and_max_seqlen_are_ignored_as_in_the_reference():
    cq, _ = _pack("ragged")
    q = torch.from_numpy(_inputs(int(cq[-1]), int(cq[-1]), 2, 16)[0])
    cu = torch.from_numpy(cq)
    base, _ = tattn.flash_attn_unpadded(q, q, q, cu, cu, 260, 260, 0.25,
                                        causal=True)
    other, soft = tattn.flash_attn_unpadded(
        q, q, q, cu, cu, 1, 7, 0.25, dropout=0.5, causal=True,
        return_softmax=True, training=True)
    assert soft is None and torch.equal(base, other)


def test_unknown_backend_raises():
    q = torch.zeros(8, 1, 16)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="expected 'auto'"):
        tfv.flash_varlen_packed(q, q, q, cu, cu, backend="mosaic")


# ---------------------------------------------------------------------
# no plain fallback for a CUDA tensor; no host read on the kernel path
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
        raise AssertionError("a CUDA tensor reached a plain version")

    def no_lib(name):
        raise RuntimeError("kernel library unavailable")
    for name in ("packed_fwd_plain", "packed_bwd_plain", "_packed_fwd_plain",
                 "_packed_bwd_plain"):
        monkeypatch.setattr(tfv, name, plain)
    monkeypatch.setattr(tattn, "_unpadded_dense_raw", plain)
    monkeypatch.setattr(_kernels, "lib", no_lib)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flag", ["auto", "pallas", "interpret", "xla",
                                  "dense"])
def test_cuda_tensor_never_takes_the_plain_version(no_plain_no_kernel,
                                                   flag, dtype):
    q, k, v = (_card(torch.randn(100, 2, 64).to(dtype)) for _ in range(3))
    cu = _card(torch.tensor([0, 60, 100], dtype=torch.int32))
    before = (tfv.fwd_varlen_launches, tfv.dq_varlen_launches,
              tfv.dkv_varlen_launches)
    err = (RuntimeError, "kernel library unavailable") \
        if flag in ("auto", "pallas") else (ValueError, "CPU only")
    set_flags({"attn_varlen_backend": flag})
    try:
        with pytest.raises(err[0], match=err[1]):
            tattn.flash_attn_unpadded(q, k, v, cu, cu, 60, 60, 0.125,
                                      causal=True)
    finally:
        set_flags({"attn_varlen_backend": "auto"})
    if flag in ("auto", "pallas"):
        lse = _card(torch.zeros(2, 128))
        with pytest.raises(RuntimeError, match="kernel library unavailable"):
            tfv.packed_bwd(q, k, v, q, lse, q, cu, cu, scale=0.125,
                           causal=True, backend=flag)
    assert (tfv.fwd_varlen_launches, tfv.dq_varlen_launches,
            tfv.dkv_varlen_launches) == before


@pytest.mark.parametrize("head_dim", [16, 80, 136, 256, 264, 100])
def test_head_dim_without_a_kernel_raises_on_the_card(no_plain_no_kernel,
                                                      head_dim):
    """A multiple of 8 up to 256 goes to the kernels zero-padded (the
    library is missing here, so that raises); a wider head, or one off a
    multiple of 8, raises NotImplementedError naming its reason; neither
    reaches a plain version."""
    q = _card(torch.randn(100, 2, head_dim))
    cu = _card(torch.tensor([0, 100], dtype=torch.int32))
    err = (RuntimeError, "kernel library unavailable") \
        if head_dim <= 256 and head_dim % 8 == 0 \
        else (NotImplementedError, "head_dim 264.*no model"
              if head_dim == 264 else "head_dim 100 is not a multiple of 8")
    with pytest.raises(err[0], match=err[1]):
        tfv.flash_varlen_packed(q, q, q, cu, cu, causal=True)


@pytest.mark.parametrize("head_dim", [40, 136])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_pad_route_equals_the_plain_version(causal, head_dim):
    """The card's route for head_dim 40 (pad to 64) or 136 (pad to 256):
    the plain walks at the built width with the true scale, sliced,
    equal the plain walks at the true width on the ragged pack: out, lse,
    dq, dk, dv (each backward kernel padded on its own, as the ops pad
    them), f32, within 1e-6."""
    cq, ck = (torch.from_numpy(c) for c in _pack("ragged"))
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(int(cq[-1]), int(ck[-1]), 2, head_dim, seed=4))
    scale = head_dim ** -0.5

    def fwd(q, k, v, cq, ck, causal, scale):
        return tfv.packed_fwd_plain(q, k, v, cq, ck, scale=scale,
                                    causal=causal)

    def grads(plain):
        def kernel(q, k, v, do, lse, delta, cq, ck, causal, scale):
            return plain(q, k, v, do, lse, delta, cq, ck, scale=scale,
                         causal=causal)
        return kernel
    args = (tfv.VARLEN_HEAD_DIMS, "flash_varlen_packed")
    out, lse = tfv.padded_fwd(fwd, *args, q, k, v, cq, ck, causal, scale)
    out_r, lse_r = fwd(q, k, v, cq, ck, causal, scale)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-6)
    delta = tfv.packed_delta(out, do, lse.shape[1])
    rest = (lse, delta, cq, ck, causal, scale)
    got = (tfv.padded_grads(grads(tfv.packed_dq_plain), *args, q, k, v, do,
                            *rest),
           *tfv.padded_grads(grads(tfv.packed_dkv_plain), *args, q, k, v,
                             do, *rest))
    want = tfv.packed_bwd_plain(q, k, v, out_r, lse_r, do, cq, ck,
                                scale=scale, causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_padded_head_dim_reaches_the_kernels_at_their_built_width(
        monkeypatch):
    """head_dim 40 reaches B11-B13 zero-padded to 64 with the true scale,
    one launch each, and comes back at 40."""
    fake = _FakeLib()
    monkeypatch.setattr(tfv, "_on_card", lambda t: True)
    monkeypatch.setattr(_kernels, "lib", lambda name: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    q = torch.randn(100, 2, 40, requires_grad=True)
    cu = torch.tensor([0, 60, 100], dtype=torch.int32)
    out = tfv.flash_varlen_packed(q, q, q, cu, cu, causal=True)
    assert out.shape == (100, 2, 40)
    out.backward(torch.zeros_like(out))
    assert q.grad.shape == q.shape
    assert [c[0] for c in fake.calls] == [
        "ptt_flash_varlen_fwd", "ptt_flash_varlen_bwd_dq",
        "ptt_flash_varlen_bwd_dkv"]
    fwd = fake.calls[0][1]     # 16 pointers, dtype, tq, tk, tq_pad, tk_pad,
    assert fwd[21:23] == (2, 64)                      # h, d, ...
    assert fwd[-2] == pytest.approx(40 ** -0.5)


class _FakeLib:
    """Stands in for the built library: each entry point records its call
    and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_reads_nothing_back_and_counts_launches(monkeypatch,
                                                            dtype):
    """Forward and backward through the kernel path (CPU tensors, the
    library faked): from cu_seqlens to the last launch nothing is read
    back to the host; one launch each of B11, B12, B13, whose map
    arguments are the JAX map's at the kernel's tile, and whose grid
    order lists the longest walks first."""
    fake = _FakeLib()
    monkeypatch.setattr(tfv, "_on_card", lambda t: True)
    monkeypatch.setattr(_kernels, "lib", lambda name: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    cq, ck = _pack("cross_empty")
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in
                   _inputs(int(cq[-1]), int(ck[-1]), 2, 64))
    for t in (q, k, v):
        t.requires_grad_(True)
    cu_q, cu_k = torch.from_numpy(cq), torch.from_numpy(ck)
    before = (tfv.fwd_varlen_launches, tfv.dq_varlen_launches,
              tfv.dkv_varlen_launches)

    def refuse(*a, **k):
        raise AssertionError("a host read on the kernel path")
    for name in ("item", "tolist", "__int__", "__bool__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out, _ = tattn.flash_attn_unpadded(q, k, v, cu_q, cu_k, 90, 130, 0.125,
                                       causal=True)
    out.backward(do)
    monkeypatch.undo()
    after = (tfv.fwd_varlen_launches, tfv.dq_varlen_launches,
             tfv.dkv_varlen_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert [c[0] for c in fake.calls] == [
        "ptt_flash_varlen_fwd", "ptt_flash_varlen_bwd_dq",
        "ptt_flash_varlen_bwd_dkv"]
    # the launches' shape arguments: dtype, tq, tk, tq_pad, tk_pad, h, d
    fwd_args = fake.calls[0][1]
    assert fwd_args[16:23] == (_kernels.dtype_code(q, ""), 200, 180, 256,
                               256, 2, 64)
    assert q.grad is not None and k.grad is not None


def test_kernel_map_arrays_follow_the_jax_map():
    """``CardMap`` hands each kernel the JAX map at its own tile (bf16 at
    head_dim <= 128: all three at 128 x 128; at 256 the forward and dq 64
    x 64, dk/dv 32 x 64; f32 32 x 32) and the order of the longest walks
    first."""
    cq, ck = _pack("ragged")
    for dtype, kernel, d, want_tile in (
            (torch.bfloat16, "fwd", 128, (128, 128)),
            (torch.bfloat16, "fwd", 256, (64, 64)),
            (torch.bfloat16, "dq", 128, (128, 128)),
            (torch.bfloat16, "dkv", 128, (128, 128)),
            (torch.bfloat16, "dq", 256, (64, 64)),
            (torch.bfloat16, "dkv", 256, (32, 64)),
            (torch.float32, "fwd", 64, (32, 32))):
        tile = tfv.card_tile(kernel, dtype, d)
        assert tile == want_tile
        transposed = kernel == "dkv"
        cm = tfv.CardMap(torch.from_numpy(cq), torch.from_numpy(ck), 454,
                         454, tile, True)
        tqp, tkp, arrays = cm.tq_pad, cm.tk_pad, cm.arrays(transposed)
        assert (tqp, tkp) == (512, 512)
        want = _jax_map("ragged", 512, 512, *tile, True)
        start, length = ((want.qstart2, want.qlen2) if transposed
                         else (want.kstart, want.klen))
        order, *fields = [a.numpy() for a in arrays]
        for got, w in zip(fields, (start, length, want.qslo, want.qshi,
                                   want.qpos0, want.kslo, want.kshi,
                                   want.kmax, want.qmeta, want.kmeta)):
            np.testing.assert_array_equal(got, np.asarray(w))
        lens = np.asarray(length)[order]
        assert sorted(order.tolist()) == list(range(len(order)))
        assert (np.diff(lens) <= 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [64, 96, 128, 256])
def test_lse_padding_is_whole_tiles_of_every_kernel(dtype, head_dim):
    """B11 writes the ``[h, tq_pad]`` lse that B12 and B13 read: the pad
    (and so tq_pad and tk_pad) is a whole number of every kernel's q and
    key tile, so each kernel's map covers the padded axes exactly."""
    for kernel in ("fwd", "dq", "dkv"):
        bq, bk = tfv.card_tile(kernel, dtype, head_dim)
        assert tfv._CARD_PAD % bq == 0 and tfv._CARD_PAD % bk == 0
    for t in (1, 63, 64, 127, 128, 129, 454):
        tp = tfv._card_pad(t)
        assert tp >= t and tp - t < tfv._CARD_PAD
        assert all(tp % b == 0 for kernel in ("fwd", "dq", "dkv")
                   for b in tfv.card_tile(kernel, dtype, head_dim))


def test_head_dim_past_256_names_its_roadmap_item(no_plain_no_kernel):
    """A head_dim of 264 raises NotImplementedError pointing at ROADMAP.md
    A13, before any kernel or plain version is reached."""
    q = _card(torch.randn(100, 2, 264))
    cu = _card(torch.tensor([0, 100], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A13\)"):
        tfv.flash_varlen_packed(q, q, q, cu, cu, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_and_backward_share_one_block_map(monkeypatch, dtype):
    """One ``flash_attn_unpadded`` forward + backward on the kernel path
    (the library faked, as above) builds its block map once: one
    ``varlen_block_map`` call; the three launches get the same pointers
    for the eight fields both walks share, B11 and B12 the same walk
    (order, start, len), B13 the transposed walk of that map; nothing is
    read back to the host."""
    fake = _FakeLib()
    monkeypatch.setattr(tfv, "_on_card", lambda t: True)
    monkeypatch.setattr(_kernels, "lib", lambda name: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    tiles = []
    build = tfv.varlen_block_map

    def counted(cu_q, cu_k, tqp, tkp, bq, bk, causal):
        tiles.append((bq, bk))
        return build(cu_q, cu_k, tqp, tkp, bq, bk, causal)
    monkeypatch.setattr(tfv, "varlen_block_map", counted)
    cq, ck = _pack("ragged")
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in
                   _inputs(int(cq[-1]), int(ck[-1]), 2, 64))
    for t in (q, k, v):
        t.requires_grad_(True)

    def refuse(*a, **kw):
        raise AssertionError("a host read on the kernel path")
    for name in ("item", "tolist", "__int__", "__bool__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out, _ = tattn.flash_attn_unpadded(q, k, v, torch.from_numpy(cq),
                                       torch.from_numpy(ck), 260, 260, 0.125,
                                       causal=True)
    out.backward(do)
    monkeypatch.undo()
    assert tiles == [tfv.card_tile("fwd", dtype, 64)]
    assert [c[0] for c in fake.calls] == [
        "ptt_flash_varlen_fwd", "ptt_flash_varlen_bwd_dq",
        "ptt_flash_varlen_bwd_dkv"]
    # the 11 map pointers follow 5, 7 and 8 operand pointers
    fwd, dq, dkv = (args[n:n + 11] for (_, args), n in
                    zip(fake.calls, (5, 7, 8)))
    assert fwd == dq
    assert fwd[3:] == dkv[3:]
    assert not set(fwd[:3]) & set(dkv[:3])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pack", ["ragged", "cross_empty"])
def test_plain_backward_on_the_card_map_matches_jax_packed_core(pack,
                                                                causal):
    """The card's kernels walk one 128 x 128 map at bf16 head_dim <= 128
    (``card_tile`` of B11, B12, B13). The plain forward and backward
    walking that map (``packed_fwd_plain``/``packed_bwd_plain`` at those
    tiles) against ``jax.vjp`` of the JAX ``_packed_core`` (its XLA route
    at the same tiles): out, dq, dk, dv in f32 within 1e-5 of the largest
    value (sums in another order); rows that see no key exactly 0."""
    tile = tfv.card_tile("dq", torch.bfloat16, 128)
    assert tile == (128, 128) == tfv.card_tile("dkv", torch.bfloat16, 128) \
        == tfv.card_tile("fwd", torch.bfloat16, 128)
    cq, ck = _pack(pack)
    arrs = _inputs(int(cq[-1]), int(ck[-1]), 2, 64, seed=5)
    scale = 0.125
    out_j, vjp = jax.vjp(lambda q, k, v: jfv._packed_core(
        q, k, v, jnp.asarray(cq), jnp.asarray(ck), causal, scale, *tile,
        "xla"), *(jnp.asarray(a) for a in arrs[:3]))
    want = [np.asarray(out_j), *(np.asarray(g) for g in
                                 vjp(jnp.asarray(arrs[3])))]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    cu_q, cu_k = torch.from_numpy(cq), torch.from_numpy(ck)
    kw = dict(scale=scale, causal=causal, block_q=tile[0], block_k=tile[1])
    out, lse = tfv.packed_fwd_plain(q, k, v, cu_q, cu_k, **kw)
    got = [out, *tfv.packed_bwd_plain(q, k, v, out, lse, do, cu_q, cu_k,
                                      **kw)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, 1e-5, f"{pack} {name}")
    if pack == "cross_empty":                  # segment 1 sees no key
        assert torch.equal(got[1][70:110], torch.zeros_like(got[1][70:110]))


def test_card_grid_follows_the_dispatch_and_bounds_the_call():
    """``card_grid`` renders the C dispatch's grids: the wgmma kernels
    (bf16, head_dim <= 128) one block per (128-row tile, head), heads
    slowest; bf16 at 256 (head, 64-row tile), dk/dv with two column halves
    a head; f32 (head, 32-row tile). ``_check_packed`` refuses a call only
    where a grid's second axis passes 65535: 4.2 M packed rows in one head
    fit the wgmma grids, not the 32-row f32 or 64-row d256 ones."""
    bf, f32 = torch.bfloat16, torch.float32
    for kernel in ("fwd", "dq", "dkv"):
        assert tfv.card_grid(kernel, bf, 128, 512, 384, 16) == (
            (3 if kernel == "dkv" else 4), 16)
        assert tfv.card_grid(kernel, f32, 64, 512, 384, 4) == (
            4, (12 if kernel == "dkv" else 16))
    assert tfv.card_grid("fwd", bf, 256, 512, 384, 8) == (8, 8)
    assert tfv.card_grid("dq", bf, 256, 512, 384, 8) == (8, 8)
    assert tfv.card_grid("dkv", bf, 256, 512, 384, 8) == (16, 6)
    rows = 4_200_000
    for dtype, d, ok in ((bf, 128, True), (bf, 64, True), (f32, 64, False),
                         (bf, 256, False)):
        q = torch.zeros(1, 1, d, dtype=dtype).expand(rows, 1, d)
        if ok:
            tfv._check_packed("grid", q, q, q)
        else:
            with pytest.raises(ValueError, match="more than 65535 blocks"):
                tfv._check_packed("grid", q, q, q)
