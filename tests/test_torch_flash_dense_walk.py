"""B10's dense walk (the Hopper kernels of ``csrc/flash_attention.cu``)
against the JAX package's varlen block map, and the flash route against
the JAX varlen function on the uniform packing.

Dense causal attention over ``[b, s, h, d]`` is packed varlen attention
over ``cu_seqlens = arange(b + 1) * s`` (top-left causal in each
segment). The card's bf16 kernels at head_dim <= 128 walk that packing
without a map: ``attention.dense_walk`` renders what ``DenseWalk`` works
out from ``(sq, sk, causal)``, and is pinned here, integer for integer,
to the JAX ``varlen_block_map`` at 128 x 128 tiles: each tile's interval
of tiles on the other axis and each visited pair's interior flag. The
port's flash route on the CPU (the plain versions) is held to the JAX
``flash_attn_unpadded`` (its raw function ``_unpadded_varlen_raw``, the
default backend) under ``jax.vjp`` on the same packing: out and
gradients in f32 within 1e-5 of the largest value (f32 sums in another
order). With the library faked, the bf16 d128 route hands the kernels
the ``[b, s, 3, h, d]`` views uncopied; the grids and their limits are
pinned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.nn.functional import flash_varlen as jfv
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import attention as tattn

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

TOL = 1e-5
TILE = 128
#: (sq, sk): equal lengths, and cross lengths both ways
LENGTHS = [(512, 512), (384, 768), (768, 384)]


def _jax_map(b, sq, sk, causal):
    cq = np.arange(b + 1, dtype=np.int32) * sq
    ck = np.arange(b + 1, dtype=np.int32) * sk
    bm = jfv.varlen_block_map(jnp.asarray(cq), jnp.asarray(ck), b * sq,
                              b * sk, TILE, TILE, causal)
    return {f: np.asarray(getattr(bm, f)) for f in (
        "kstart", "klen", "qslo", "qshi", "qpos0", "kslo", "kshi", "kmax",
        "qstart2", "qlen2")}


def _interior(m, i, j, causal):
    """The JAX kernels' test of tile pair (q tile i, k tile j)."""
    return bool(m["qslo"][i] == m["qshi"][i] and m["kslo"][j] == m["kshi"][j]
                and m["qslo"][i] == m["kslo"][j]
                and (not causal or m["kmax"][j] <= m["qpos0"][i]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", LENGTHS)
def test_dense_walk_follows_the_jax_block_map(sq, sk, causal):
    """Each q tile's k-tile interval (forward: 128-key steps; dq: 64-key
    steps, two a tile), each k tile's q-tile interval (dk/dv: 64-row
    steps) and every visited pair's interior flag equal the JAX map's on
    the uniform packing, in every batch (global tile = batch * tiles +
    tile; an empty interval's start clamped as the JAX map clamps it)."""
    b = 3
    nq, nk = sq // TILE, sk // TILE
    m = _jax_map(b, sq, sk, causal)
    walks = {k: tattn.dense_walk(k, sq, sk, causal)
             for k in ("fwd", "dq", "dkv")}
    # the forward and dq by fold units: tiles nt - 1 - f and f, whose
    # causal walks add up to the same length in every unit; dk/dv the
    # lowest k tiles (the longest causal walks) first
    def units(nt):
        return [TILE * i for f in range((nt + 1) // 2)
                for i in sorted({nt - 1 - f, f}, reverse=True)]
    assert [t["r0"] for t in walks["fwd"]] == units(nq)
    assert [t["r0"] for t in walks["dq"]] == units(nq)
    assert [t["r0"] for t in walks["dkv"]] == [TILE * j for j in range(nk)]
    if causal and sq == sk:
        for kernel in ("fwd", "dq"):
            lens = [len(t["steps"]) for t in walks[kernel]]
            assert len({a + b for a, b in zip(lens[::2], lens[1::2])}) == 1
    for bi in range(b):
        for kernel, step in (("fwd", TILE), ("dq", 64)):
            for tile in walks[kernel]:
                i = tile["r0"] // TILE
                gi = bi * nq + i
                tiles = sorted({f // TILE for f in tile["steps"]})
                assert tile["steps"] == list(range(0, len(tiles) * TILE,
                                                   step))
                assert (bi * nk + tiles[0], len(tiles)) == \
                    (m["kstart"][gi], m["klen"][gi])
                for f, flag in zip(tile["steps"], tile["interior"]):
                    assert flag == _interior(m, gi, bi * nk + f // TILE,
                                             causal), (kernel, i, f)
        for tile in walks["dkv"]:
            j = tile["r0"] // TILE
            gj = bi * nk + j
            tiles = sorted({f // TILE for f in tile["steps"]})
            first = tiles[0] if tiles else min(j if causal else 0, nq)
            assert (min(bi * nq + first, b * nq - 1), len(tiles)) == \
                (m["qstart2"][gj], m["qlen2"][gj])
            assert tile["steps"] == [TILE * first + 64 * s for s in
                                     range(2 * len(tiles))]
            for f, flag in zip(tile["steps"], tile["interior"]):
                assert flag == _interior(m, bi * nq + f // TILE, gj,
                                         causal), ("dkv", j, f)


def test_dense_walk_tail_tiles_stop_at_the_lengths():
    """Lengths that are multiples of 64 but not of 128 (bf16 admits
    them): dq and dk/dv steps stop at sk and sq, and the forward's last
    key tile, half past sk, is never interior, so its keys past sk are
    masked; a causal k tile past sq walks nothing."""
    fwd = tattn.dense_walk("fwd", 320, 320, False)
    assert [t["r0"] for t in fwd] == [256, 0, 128]  # units (2, 0), (1)
    assert [t["steps"] for t in fwd] == [[0, 128, 256]] * 3
    assert [t["interior"] for t in fwd] == [[True, True, False]] * 3
    dq = tattn.dense_walk("dq", 320, 320, True)
    assert dq[0]["r0"] == 256 and dq[0]["steps"] == [0, 64, 128, 192, 256]
    dkv = tattn.dense_walk("dkv", 192, 448, True)
    assert [t["steps"] for t in dkv] == [[0, 64, 128], [128], [], []]


def _uniform_inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))]


@pytest.mark.parametrize("sq,sk,causal", [
    (256, 256, True), (256, 256, False), (256, 128, False)])
def test_flash_route_matches_jax_varlen_on_uniform_packing(sq, sk, causal):
    """The port's flash route (CPU: the plain versions through
    ``FlashAttentionFunction``) against the JAX ``flash_attn_unpadded``
    over the packed batch with ``cu_seqlens = arange(b + 1) * s``: out,
    dq, dk and dv in f32. Few shapes, as each compiles the JAX walk anew
    (seconds apiece); cross lengths under causal are held to the JAX
    dense path in ``test_torch_attention.py``."""
    b, h, d, scale = 2, 2, 16, 0.25
    q, k, v, do = _uniform_inputs(b, sq, sk, h, d, seed=sq + sk)
    cq = jnp.arange(b + 1, dtype=jnp.int32) * sq
    ck = jnp.arange(b + 1, dtype=jnp.int32) * sk
    out, vjp = jax.vjp(lambda q, k, v: jattn._unpadded_varlen_raw(
        q, k, v, cq, ck, scale=scale, causal=causal),
        *(jnp.asarray(a.reshape(-1, h, d)) for a in (q, k, v)))
    want = [np.asarray(t) for t in (out, *vjp(jnp.asarray(
        do.reshape(-1, h, d))))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k,
                                                                      v))
    got = tattn.FlashAttentionFunction.apply(tq, tk, tv, causal, scale)
    got.backward(torch.from_numpy(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (got, tq.grad, tk.grad, tv.grad), want):
        g = g.detach().numpy().reshape(w.shape)
        limit = TOL * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= limit, f"{name} causal={causal}: {err} > {limit}"


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


def test_bf16_d128_route_hands_the_kernels_the_views_uncopied(monkeypatch):
    """q, k and v as strided views of one ``[b, s, 3, h, d]`` tensor (the
    GPT block's layout) reach all three launches as they are: their own
    data pointers and strides, no copy; one launch each."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "lib", lambda name: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    b, s, h, d = 2, 256, 4, 128
    qkv = torch.randn(b, s, 3, h, d).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    before = (tattn.fwd_launches, tattn.dq_launches, tattn.dkv_launches)
    out, lse = tattn._flash_fwd_cuda(q, k, v, True, d ** -0.5)
    tattn._flash_bwd_cuda(q, k, v, out, lse, torch.randn(b, s, h, d).to(
        torch.bfloat16), True, d ** -0.5)
    assert (tattn.fwd_launches, tattn.dq_launches, tattn.dkv_launches) == \
        tuple(n + 1 for n in before)
    assert [c[0] for c in fake.calls] == [
        "ptt_flash_fwd", "ptt_flash_bwd_dq", "ptt_flash_bwd_dkv"]
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    assert strides == [3 * s * h * d, 3 * h * d, d] * 3
    for name, args in fake.calls:
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr()), name
        assert list(args).count(3 * h * d) == 3, name  # the row strides


def test_grids_and_their_limits():
    """``flash_grid`` renders the C dispatch's grids: the wgmma forward and
    dq at most one block an SM on one axis, each taking ceil(units / SMs)
    fold units, dk/dv a block a (tile, batch, head); the others (tiles, h,
    b). ``_check_operands`` refuses a call
    whose wgmma fold units pass int32 or whose grid passes an axis's limit
    (65535 on y and z)."""
    bf, f32 = torch.bfloat16, torch.float32
    # 256 fold units at the 1.3b rung, 2 a block; 512 at the 760m rung;
    # dk/dv a block a tile
    for kernel in ("fwd", "dq"):
        assert tattn.flash_grid(kernel, bf, 128, 4, 1024, 1024, 16) == \
            (128, 1)
        assert tattn.flash_grid(kernel, bf, 96, 8, 1024, 1024, 16) == \
            (128, 1)
    assert tattn.flash_grid("dkv", bf, 128, 4, 1024, 1024, 16) == (512, 1)
    assert tattn.flash_grid("fwd", bf, 128, 2, 320, 320, 4, sms=8) == (8, 1)
    assert tattn.flash_grid("dkv", bf, 64, 2, 384, 320, 8) == (48, 1)
    assert tattn.flash_grid("dkv", bf, 256, 2, 512, 512, 8) == (16, 8, 2)
    assert tattn.flash_grid("dq", f32, 64, 2, 256, 256, 4) == (8, 4, 2)

    def call(b, h, dtype):
        t = torch.zeros(1, 1, 1, 128, dtype=dtype).expand(b, 128, h, 128)
        tattn._check_operands("grid", t, t, t)
    call(65536, 1, bf)
    call(1, 65536, bf)
    with pytest.raises(ValueError, match="2147483648 fold units pass the "
                       "int32 limit"):
        call(65536, 32768, bf)
    with pytest.raises(ValueError, match="axis y, past its limit of 65535"):
        call(1, 65536, f32)
    with pytest.raises(ValueError, match="axis z, past its limit of 65535"):
        call(65536, 1, f32)
