"""Parity of the port's decode backends with paddle_tpu's.

``FLAGS_paged_attention_backend`` routes the public ``paged_attention``
and ``decode_raw``'s attention. The same seeded numpy inputs go to both
packages. The JAX pool-streaming kernel ``_stream_paged`` runs in
Pallas interpret mode, as its own tests run it; its per-sequence and
stock kernels (``_fused_paged``, ``_pallas_paged``) run on a TPU only, so
the port's plain versions of B8 and B9 are held to the function they
compute, the XLA gather ``_xla_paged``, on rows with a length, and to 0
on empty rows (both kernels return 0 there; ``_xla_paged`` averages the
table's V rows). Tolerances: f32 scores, softmax and sums on both sides
in another order: 1e-5 absolute on outputs of magnitude ~1 (hidden
states of the decode step too). Integer maps are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.inference import FusedCausalLM as JLM
from paddle_tpu.inference import GenerationEngine as JGE
from paddle_tpu.incubate.nn.fused_transformer import (
    FusedMultiTransformer as JStack, PagedKV as JPagedKV,
    rope_table as j_rope)
from paddle_tpu.nn.functional import paged_attention as jpa
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    FusedMultiTransformer as TStack, PagedKV as TPagedKV,
    rope_table as t_rope)
from paddle_tpu_torch.inference import FusedCausalLM as TLM
from paddle_tpu_torch.inference import GenerationEngine as TGE
from paddle_tpu_torch.nn.functional import paged_attention as tpa

TOL = 1e-5


@pytest.fixture
def backend():
    """Sets FLAGS_paged_attention_backend in both packages; restores."""
    saved = (jflags.get_flags("paged_attention_backend"),
             tflags.get_flags("paged_attention_backend"))

    def set_(value):
        new = {"paged_attention_backend": value}
        jflags.set_flags(new)
        tflags.set_flags(new)
    yield set_
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _tables(rng, lens, pp, ps, P, share=None):
    """Distinct random pages (never the scratch page 0) covering each
    row's tokens, zero-padded; ``share=(r, s)`` gives row s row r's first
    page."""
    b = len(lens)
    tables = np.zeros((b, pp), np.int32)
    perm = list(rng.permutation(np.arange(1, P)))
    for r, n in enumerate(lens):
        need = -(-int(n) // ps)
        tables[r, :need] = [perm.pop() for _ in range(need)]
    if share is not None:
        tables[share[1], 0] = tables[share[0], 0]
    return tables


def _case(g, d, lens=(0, 5, 17, 32, 9, 1), seed=0, share=None):
    """q, a 2-layer folded pool of 2 kv heads with pages of 8, lengths
    with an empty row 0 and page edges, layer-local tables."""
    rng = np.random.RandomState(seed)
    b, n_kv, ps, pp, P = len(lens), 2, 8, 4, 16
    return dict(
        q=rng.randn(b, n_kv * g, d).astype(np.float32),
        kp=rng.randn(2 * P, n_kv, ps, d).astype(np.float32),
        vp=rng.randn(2 * P, n_kv, ps, d).astype(np.float32),
        lens=np.asarray(lens, np.int32),
        tables=_tables(rng, lens, pp, ps, P, share), P=P, ps=ps)


def _jax(c, *names):
    return [jnp.asarray(c[n]) for n in names]


def _torch(c, *names):
    return [torch.from_numpy(np.array(c[n])) for n in names]


def _xla(c, base):
    q, kp, vp, lens = _jax(c, "q", "kp", "vp", "lens")
    return np.asarray(jpa._xla_paged(q, kp, vp, lens,
                                     jnp.asarray(c["tables"] + base)))


# ---------------------------------------------------------------------
# the public op and its flag
# ---------------------------------------------------------------------

def test_invalid_flag_value_raises_in_both(backend):
    c = _case(1, 128)
    backend("mosaic")
    with pytest.raises(ValueError, match="valid values"):
        jpa.paged_attention(*_jax(c, "q", "kp", "vp", "lens", "tables"))
    with pytest.raises(ValueError, match="valid values"):
        tpa.paged_attention(*_torch(c, "q", "kp", "vp", "lens", "tables"))


@pytest.mark.parametrize("base", [None, 16])
def test_auto_on_the_cpu_equals_jax(backend, base):
    """``auto`` off the card is the plain gather in both packages, over a
    layer region or the whole pool (empty row included)."""
    c = _case(2, 128, seed=1)
    backend("auto")
    kw = {} if base is None else dict(pool_base=base, pool_pages=c["P"])
    want = jpa.paged_attention(*_jax(c, "q", "kp", "vp", "lens", "tables"),
                               **kw)
    got = tpa.paged_attention(*_torch(c, "q", "kp", "vp", "lens", "tables"),
                              **kw)
    assert tpa.last_paged_attention_backend() == "xla"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("value", ["stream", "fused", "pallas"])
def test_each_value_takes_its_plain_version_on_the_cpu(backend, value):
    c = _case(1, 128, seed=2)
    backend(value)
    got = tpa.paged_attention(*_torch(c, "q", "kp", "vp", "lens", "tables"),
                              pool_base=16, pool_pages=16)
    assert tpa.last_paged_attention_backend() == value
    np.testing.assert_allclose(got[1:].numpy(), _xla(c, 16)[1:], atol=TOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_stream_needs_a_lane_multiple_head_dim(backend):
    c = _case(1, 64)
    backend("stream")
    for fn, arrs in ((jpa.paged_attention, _jax), (tpa.paged_attention,
                                                   _torch)):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(*arrs(c, "q", "kp", "vp", "lens", "tables"), pool_base=0,
               pool_pages=16)


# ---------------------------------------------------------------------
# B7: the pool-streaming kernel's plain version
# ---------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_stream_plain_equals_jax_stream_kernel(g, layer):
    """On tables with no shared page, ``_stream_paged_plain`` equals the
    JAX ``_stream_paged`` (interpret mode), the empty row (0) included."""
    c = _case(g, 128, seed=3 + g)
    base = layer * c["P"]
    want = jpa._stream_paged(*_jax(c, "q", "kp", "vp", "lens", "tables"),
                             pool_base=base, pool_pages=c["P"])
    q, kp, vp, lens, tables = _torch(c, "q", "kp", "vp", "lens", "tables")
    got = tpa._stream_paged_plain(q, kp, vp, lens, tables, base, c["P"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_stream_follows_the_block_tables_on_a_shared_page():
    """Rows 2 and 3 share a full page. The port's B7 plain version equals
    the block tables' attention (``_xla_paged``) on every row; the JAX
    kernel, which masks with one owner a page, moves the other row by
    more than 0.1 (the reference's fault, asserted and not carried)."""
    c = _case(1, 128, seed=7, share=(2, 3))
    want = _xla(c, 0)
    jax_out = np.asarray(jpa._stream_paged(
        *_jax(c, "q", "kp", "vp", "lens", "tables"), pool_base=0,
        pool_pages=c["P"]))
    q, kp, vp, lens, tables = _torch(c, "q", "kp", "vp", "lens", "tables")
    got = tpa._stream_paged_plain(q, kp, vp, lens, tables, 0, c["P"])
    np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=TOL)
    jax_err = np.abs(jax_out[2:4] - want[2:4]).max(axis=(1, 2))
    assert jax_err.max() > 0.1, jax_err
    # the port's one-owner map reproduces the reference's mask
    own = tpa.build_pool_ownership(tables, lens, c["P"], c["ps"])
    faulty = tpa._stream_paged_plain(q, kp, vp, lens, tables, 0, c["P"],
                                     ownership=own)
    np.testing.assert_allclose(faulty.numpy(), jax_out, atol=TOL)


def test_stream_drops_ids_outside_the_region():
    """B7's mask drops a table id >= pool_pages, as the reference's
    scatter with mode="drop": the row attends its other pages only."""
    c = _case(1, 128, seed=8, lens=(0, 20, 9))
    tables = c["tables"].copy()
    tables[1, 2] = c["P"]                     # row 1's last page, tokens 16-19
    q, kp, vp, lens = _torch(c, "q", "kp", "vp", "lens")
    got = tpa._stream_paged_plain(q, kp, vp, lens, torch.from_numpy(tables),
                                  0, c["P"])
    short = dict(c, lens=np.asarray([0, 16, 9], np.int32))
    np.testing.assert_allclose(got[1:].numpy(), _xla(short, 0)[1:],
                               atol=TOL)


# ---------------------------------------------------------------------
# B8, B9: plain versions against the function they compute
# ---------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_fused_and_pallas_plain_equal_xla_paged(g, d):
    c = _case(g, d, seed=10 + g)
    want = _xla(c, 16)
    q, kp, vp, lens = _torch(c, "q", "kp", "vp", "lens")
    for fn in (tpa._fused_paged_plain, tpa._pallas_paged_plain):
        got = fn(q, kp, vp, lens, torch.from_numpy(c["tables"] + 16))
        np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=TOL,
                                   err_msg=fn.__name__)
        assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_pallas_ppcb_is_the_jax_expression(monkeypatch):
    """``_pallas_ppcb`` against the pages_per_compute_block that the JAX
    ``_pallas_paged`` hands the stock kernel (stubbed to record it), over
    a grid of table widths and page sizes."""
    from jax.experimental.pallas.ops.tpu import paged_attention as stock

    seen = []

    def kernel(q, k, v, lens, tables, *, pages_per_compute_block):
        seen.append(pages_per_compute_block)
        return jnp.zeros_like(q)
    monkeypatch.setattr(stock, "paged_attention", kernel)
    for pp in (1, 2, 3, 7, 12, 17, 33, 64, 96):
        for ps in (1, 8, 16, 32, 128, 1024):
            q = jnp.zeros((1, 1, 8), jnp.float32)
            pool = jnp.zeros((2, 1, ps, 8), jnp.float32)
            jpa._pallas_paged(q, pool, pool, jnp.ones((1,), jnp.int32),
                              jnp.zeros((1, pp), jnp.int32))
            assert tpa._pallas_ppcb(pp, ps) == seen[-1], (pp, ps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ownership_map_is_integer_equal_to_jax(seed):
    """``build_pool_ownership`` against the JAX map (no shared page; an
    id past the region, which both drop), and ``pool_membership``
    against the tables it inverts."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, 33, 6).astype(np.int32)
    tables = _tables(rng, lens, 4, 8, 24)
    tables[int(np.argmax(lens)), 0] = 24
    want = jpa.build_pool_ownership(jnp.asarray(tables), jnp.asarray(lens),
                                    24, 8)
    got = tpa.build_pool_ownership(torch.from_numpy(tables),
                                   torch.from_numpy(lens), 24, 8)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    mem = tpa.pool_membership(torch.from_numpy(tables),
                              torch.from_numpy(lens), 24, 8).numpy()
    expect = np.full((6, 24), -1, np.int32)
    for r in range(6):
        for j in range(4):
            if j * 8 < lens[r] and tables[r, j] < 24:
                expect[r, tables[r, j]] = j
    np.testing.assert_array_equal(mem, expect)


# ---------------------------------------------------------------------
# B7's bf16 walk: its plan, the pages it reads, its fold, the card route
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((32, 1, 16, 545, 16, 132), (16, 9, 37, 1)),      # the decode rung
    ((32, 4, 16, 545, 16, 132), (16, 9, 37, 2)),      # 128 rows: 2 passes
    ((32, 1, 16, 100000, 16, 132), (807, 31, 125, 1)),  # runs capped
    ((2, 1, 1, 3, 1, 132), (1, 1, 65, 1)),            # one chunk
])
def test_stream_walk_plan(shape, want):
    assert tpa.stream_walk(*shape) == want


@pytest.mark.parametrize("seed", range(4))
def test_stream_walk_runs_cover_the_region_once(seed):
    """Runs of whole 64-token chunks, every chunk in one run, no empty
    block, a run's pages within run_pages (at most 128), about two blocks
    an SM where the region has the chunks for it."""
    rng = np.random.RandomState(seed)
    b, g, n_kv = rng.randint(1, 80), rng.randint(1, 9), rng.randint(1, 33)
    P, ps = rng.randint(1, 5000), int(rng.choice([1, 8, 16, 64, 128]))
    blocks, cpb, run_pages, passes = tpa.stream_walk(b, g, n_kv, P, ps, 132)
    nch = -(-P * ps // 64)
    assert (blocks - 1) * cpb < nch <= blocks * cpb
    assert run_pages <= 128
    assert cpb * 64 <= (run_pages - 1) * ps         # the kernel's own check
    assert passes == -(-b * g // 64)
    if nch >= -(-264 // n_kv) and cpb * 64 <= 127 * ps:
        assert blocks * n_kv >= 264


def test_stream_walk_raises_past_the_grid():
    with pytest.raises(ValueError, match="grid's limit of 65535"):
        tpa.stream_walk(1, 1, 65536, 16, 16, 132)


def test_stream_live_pages_are_the_tables_pages(monkeypatch):
    """The pages B7's walk reads, by pass of 64 query rows, against the
    block tables: a page some row of the pass holds below its length;
    built from pool_membership on the device with no host read."""
    rng = np.random.RandomState(5)
    b, g, ps, pp, P = 30, 3, 4, 6, 50
    lens = rng.randint(0, pp * ps + 1, b).astype(np.int32)
    tables = rng.randint(0, P + 3, (b, pp)).astype(np.int32)  # ids past P
    mem = tpa.pool_membership(torch.from_numpy(tables),
                              torch.from_numpy(lens), P, ps)

    def refuse(*a, **k):
        raise AssertionError("a host read on the device path")
    for name in ("item", "tolist", "__bool__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    live = tpa.stream_live_pages(mem, g)
    monkeypatch.undo()
    want = np.zeros((2, P), bool)
    for row in range(b * g):
        r = row // g
        for j in range(pp):
            if j * ps < lens[r] and 0 <= tables[r, j] < P:
                want[row // 64, tables[r, j]] = True
    np.testing.assert_array_equal(live.numpy(), want)


def _walk_render(q, kp, vp, lens, tables, base, P, cpb):
    """B7's bf16 walk rendered in PyTorch on f32 pools: per chunk the
    plain version's (m, l, p V); a block folds its run's chunks in order
    as the kernel does (a new max rescales the state; else the chunk
    enters at e^(m_c - M), dropped below 2^-40); the blocks' states are
    merged by log-sum-exp over those with l > 0."""
    b, n_q, d = q.shape
    _, n_kv, ps, _ = kp.shape
    g, C = n_q // n_kv, tpa.STREAM_KERNEL_CHUNK
    T = P * ps
    nch = -(-T // C)
    k = torch.nn.functional.pad(tpa._region_tokens(kp, base, P),
                                (0, 0, 0, nch * C - T))
    v = torch.nn.functional.pad(tpa._region_tokens(vp, base, P),
                                (0, 0, 0, nch * C - T))
    mem = tpa.pool_membership(tables, lens, P, ps).long()
    tok = torch.arange(nch * C)
    tc = torch.clamp(tok, max=T - 1)
    j = mem[:, tc // ps]
    valid = ((j >= 0) & (j * ps + tc % ps < lens.long()[:, None])
             & (tok < T)).reshape(b, 1, 1, nch, C)
    s = torch.einsum("bngd,ntd->bngt", q.reshape(b, n_kv, g, d), k) \
        .reshape(b, n_kv, g, nch, C) * d ** -0.5
    m = torch.where(valid, s, tpa._NEG).amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bngck,nckd->bngcd", p, v.reshape(n_kv, nch, C, d))
    states = []
    for c0 in range(0, nch, cpb):
        M = torch.full(m.shape[:-1], tpa._NEG)
        L = torch.zeros(m.shape[:-1])
        O = torch.zeros(acc.shape[:3] + (d,))
        for c in range(c0, min(nch, c0 + cpb)):
            mc, lc, oc = m[..., c], l[..., c], acc[..., c, :]
            new = mc > M
            alpha = torch.where(new, torch.exp(M - mc), 1.0)
            beta = torch.where(new, 1.0, torch.exp(mc - M))
            keep = new | (beta >= 2.0 ** -40)
            O = torch.where((new | ~keep)[..., None], O * alpha[..., None]
                            + torch.where(keep, 1.0, 0.0)[..., None] * oc,
                            (O / beta[..., None] + oc) * beta[..., None])
            L = L * alpha + lc * beta
            M = torch.maximum(M, mc)
        states.append((M, L, O))
    Ms = torch.stack([st[0] for st in states])
    Ls = torch.stack([st[1] for st in states])
    Os = torch.stack([st[2] for st in states])
    mx = torch.where(Ls > 0, Ms, tpa._NEG).amax(0)
    w = torch.where(Ls > 0, torch.exp(Ms - mx), 0.0)
    out = (w[..., None] * Os).sum(0) \
        / torch.clamp((w * Ls).sum(0), min=1e-30)[..., None]
    return out.reshape(b, n_q, d)


@pytest.mark.parametrize("g", [1, 2])
def test_stream_walk_fold_equals_the_plain_version(g):
    """The walk's fold (chunks in runs of stream_walk's length, a state
    per run, merged) against _stream_paged_plain on a five-chunk region
    cut into two runs: equal to f32 order (1e-6)."""
    rng = np.random.RandomState(11 + g)
    b, n_kv, ps, P, d = 5, 2, 8, 40, 128
    lens = np.array([0, 37, 120, 9, 64], np.int32)
    tables = _tables(rng, lens, 16, ps, P, share=(1, 2))
    blocks, cpb, _, _ = tpa.stream_walk(b, g, n_kv, P, ps, 2)
    assert (blocks, cpb) == (2, 3)
    q = torch.from_numpy(rng.randn(b, n_kv * g, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(2 * P, n_kv, ps, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(2 * P, n_kv, ps, d).astype(np.float32))
    lens_t, tables_t = torch.from_numpy(lens), torch.from_numpy(tables)
    want = tpa._stream_paged_plain(q, kp, vp, lens_t, tables_t, P, P)
    got = _walk_render(q, kp, vp, lens_t, tables_t, P, P, cpb)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


class _BackendsLib:
    def __init__(self):
        self.calls = []

    def ptt_paged_stream(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_tensors_reach_the_stream_kernel(monkeypatch, dtype):
    """With the card faked, stream_paged hands the library stream_walk's
    runs (bf16; f32 one block a chunk) and a workspace of one partial a
    block and row, and counts its two launches; nothing reaches the plain
    version."""
    from paddle_tpu_torch import _kernels

    lib = _BackendsLib()

    def refuse(*a, **k):
        raise AssertionError("a card tensor reached the plain version")
    monkeypatch.setattr(tpa, "_on_card", lambda t: True)
    monkeypatch.setattr(tpa, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tpa, "_stream_paged_plain", refuse)
    monkeypatch.setattr(_kernels, "lib", lambda name: lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    c = _case(2, 128)
    q, kp, vp, lens, tables = _torch(c, "q", "kp", "vp", "lens", "tables")
    before = tpa.stream_launches
    out = tpa.stream_paged(q.to(dtype), kp.to(dtype), vp.to(dtype), lens,
                           tables, pool_base=c["P"], pool_pages=c["P"])
    assert tpa.stream_launches == before + 2 and out.dtype == dtype
    (args,) = lib.calls
    b, n_q, n_kv = q.shape[0], q.shape[1], kp.shape[1]
    runs = (tpa.stream_walk(b, 2, n_kv, c["P"], c["ps"], 132)[:3]
            if dtype == torch.bfloat16 else (2, 1, 1))
    # ws_ml, ws_acc: (m, l) pairs, then the outputs, of one buffer
    assert args[6] - args[5] == n_kv * runs[0] * b * 2 * 2 * 4
    # dtype, b, n_q, n_kv, d, page_size, pool_base, pool_pages, blocks,
    # chunks_per_block, run_pages
    assert args[8:19] == (int(dtype == torch.bfloat16), b, n_q, n_kv, 128,
                          c["ps"], c["P"], c["P"]) + runs


# ---------------------------------------------------------------------
# decode_raw's routes
# ---------------------------------------------------------------------

CFG = dict(vocab_size=64, embed_dim=256, num_heads=2, dim_feedforward=512,
           num_layers=2, max_position=64)


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle

    paddle.seed(5)
    jm = JLM(**CFG)
    params = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = TLM(**CFG, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


def _decode_inputs(head_dim, seed=3):
    rng = np.random.RandomState(seed)
    b, P = 4, 12
    x = rng.randn(b, 2 * head_dim).astype(np.float32)
    lens = np.array([8, 5, 0, 3], np.int32)          # page edge, idle row
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0], [6, 0, 0]],
                      np.int32)
    shape = (2 * P, 2, 4, head_dim)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    return x, lens, tables, kp, vp


def _decode(stack, jax_side, x, lens, tables, kp, vp, head_dim):
    if jax_side:
        cos, sin = j_rope(64, head_dim)
        h, cache = stack.decode_raw(
            stack._stack(), jnp.asarray(x),
            JPagedKV(jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(tables),
            jnp.asarray(lens), cos, sin)
        return np.asarray(h), np.asarray(cache.k)
    cos, sin = t_rope(64, head_dim)
    h, cache = stack.decode_raw(
        stack._stack(), torch.from_numpy(x),
        TPagedKV(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())),
        torch.from_numpy(tables), torch.from_numpy(lens), cos, sin)
    return h.numpy(), cache.k.numpy()


@pytest.fixture(scope="module")
def jax_decode(models):
    """The JAX decode step under ``xla`` and under ``stream``, once."""
    jm, _ = models
    saved = jflags.get_flags("paged_attention_backend")
    out = {}
    try:
        for value in ("xla", "stream"):
            jflags.set_flags({"paged_attention_backend": value})
            out[value] = _decode(jm.stack, True, *_decode_inputs(128), 128)
    finally:
        jflags.set_flags(saved)
    return out


@pytest.mark.parametrize("value", ["fused", "pallas", "xla", "stream",
                                   "auto"])
def test_decode_raw_routes_match_jax(models, jax_decode, backend, value):
    """Every route of the port's decode step against the JAX step: the
    write-then-attend routes against JAX under ``xla``, ``stream`` (the
    in-place kernel's plain version in the port) against JAX under
    ``stream`` (write then ``_stream_paged`` in interpret mode); hidden
    states and the written pool."""
    _, tm = models
    backend(value)
    h, k = _decode(tm.stack, False, *_decode_inputs(128), 128)
    hj, kj = jax_decode["stream" if value == "stream" else "xla"]
    np.testing.assert_allclose(h, hj, atol=TOL)
    np.testing.assert_allclose(k, kj, atol=TOL)


@pytest.fixture(scope="module")
def jax_tokens(models):
    jm, _ = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, n) for n in (5, 9, 3)]
    saved = jflags.get_flags("paged_attention_backend")
    try:
        jflags.set_flags({"paged_attention_backend": "xla"})
        toks = JGE(jm, page_size=4, max_length=24).generate(
            prompts, max_new_tokens=6)
    finally:
        jflags.set_flags(saved)
    return prompts, toks


@pytest.mark.parametrize("value", ["fused", "pallas", "xla"])
def test_generate_tokens_equal_jax(models, jax_tokens, backend, value):
    _, tm = models
    prompts, want = jax_tokens
    backend(value)
    got = TGE(tm, page_size=4, max_length=24).generate(prompts,
                                                       max_new_tokens=6)
    np.testing.assert_array_equal(got, want)


def test_stream_at_head_dim_64_raises_in_both(backend):
    """``stream`` needs head_dim % 128 == 0 in decode_raw too."""
    import paddle_tpu as paddle

    paddle.seed(2)
    js = JStack(128, 2, 256, 1, max_position=64)
    params = {k: np.asarray(v._data) for k, v in js.state_dict().items()}
    ts = TStack(128, 2, 256, 1, max_position=64, device="cpu")
    load_jax_params(ts, params)
    x, lens, tables, kp, vp = _decode_inputs(64)
    kp, vp = kp[:12], vp[:12]
    backend("stream")
    for stack, jax_side in ((js, True), (ts, False)):
        with pytest.raises(ValueError, match="multiple of 128"):
            _decode(stack, jax_side, x, lens, tables, kp, vp, 64)
