"""Sampled decoding: the port's ``GenerationEngine._pick_token`` and
sampled ``_decode_k_fn`` against paddle_tpu's.

``jax.random.categorical(key, l)`` is ``argmax(gumbel(key, l.shape) +
l)``; the port draws ``argmax(noise + l)`` with Gumbel noise from an
explicit ``torch.Generator``. The tests hand the port JAX's own
``jax.random.gumbel`` noise, so the two must pick the same tokens
exactly. The top-p cut compares an f32 cumulative sum with ``top_p``,
and the two packages sum in another order: every case with ``top_p <
1`` asserts that no row's preceding mass lies within 1e-4 of ``top_p``
(the inputs are chosen so), so rounding cannot move a token across the
cut; at ``top_p = 1`` only tokens of probability below 2^-24 can fall
to it. The tiny
f32 model (vocab 64, d 32, 4 heads, 2 layers, its stack weights scaled
by 30 so the streams vary) is built by the JAX package and carried
across with ``load_jax_params``; its logits agree within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import BlockKVCacheManager as JMgr
from paddle_tpu.inference import FusedCausalLM as JLM
from paddle_tpu.inference import GenerationEngine as JGE
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import BlockKVCacheManager as TMgr
from paddle_tpu_torch.inference import FusedCausalLM as TLM
from paddle_tpu_torch.inference import GenerationEngine as TGE
from paddle_tpu_torch.inference.engine import gumbel_noise

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)
#: (temperature, top_k, top_p)
CONFIGS = [(1.0, 0, 1.0), (0.8, 10, 0.9), (0.5, 0, 0.7), (1.3, 5, 1.0),
           (0.7, 64, 0.95), (2.0, 20, 0.5)]


def _scaled_params(jm, scale=30.0):
    params = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k, v in params.items():
        if k.startswith("stack.") and k.endswith("_weight"):
            params[k] = (v * scale).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLM(**CFG)
    params = _scaled_params(jm)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    tm = TLM(**CFG, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


def _filtered(logits, cfg):
    """f64 rendering of the filter: (kept mask, the filtered softmax, the
    smallest distance of each row's preceding mass from top_p)."""
    t, top_k, top_p = cfg
    lg = np.asarray(logits, np.float64) / max(t, 1e-6)
    V = lg.shape[-1]
    if top_k and 0 < top_k < V:
        kth = np.sort(lg, -1)[..., V - top_k][..., None]
        lg = np.where(lg < kth, -np.inf, lg)
    srt = -np.sort(-lg, -1)
    p = np.exp(srt - srt[..., :1])
    p /= p.sum(-1, keepdims=True)
    before = np.cumsum(p, -1) - p
    live = np.isfinite(srt)
    # at top_p >= 1 the cut can only drop tokens whose preceding mass
    # rounds to 1 in f32 (each of probability < 2^-24): no boundary
    margin = np.where(live, np.abs(before - top_p), np.inf).min(-1) \
        if top_p < 1 else np.full(lg.shape[:-1], np.inf)
    keep_sorted = (before < top_p) & live
    thresh = np.where(keep_sorted, srt, np.inf).min(-1, keepdims=True)
    kept = lg >= thresh
    q = np.where(kept, np.exp(lg - lg.max(-1, keepdims=True)), 0.0)
    return kept, q / q.sum(-1, keepdims=True), margin


@pytest.mark.parametrize("cfg", CONFIGS)
def test_pick_token_equals_jax_under_its_noise(cfg):
    """The port's filter and draw against the JAX ``_pick_token`` on 64
    rows of 256 logits, JAX's key and its gumbel noise: every token
    equal, each inside the f64 rendering's kept set. The rows are the
    first 64 of a seeded draw whose top-p boundary lies at least 1e-4
    from ``top_p``."""
    rng = np.random.RandomState(11)
    pool = (rng.randn(512, 256) * 3).astype(np.float32)
    logits = pool[_filtered(pool, cfg)[2] >= 1e-4][:64]
    assert logits.shape == (64, 256)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JGE._pick_token(jnp.asarray(logits), key, cfg))
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = TGE._pick_token(torch.from_numpy(logits),
                          torch.from_numpy(noise), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    kept, _, _ = _filtered(logits, cfg)
    assert kept[np.arange(64), got.numpy()].all()


def test_pick_token_greedy_needs_no_noise():
    logits = np.random.RandomState(2).randn(8, 64).astype(np.float32)
    got = TGE._pick_token(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def _prefilled(pkg, model, prompts, k):
    """A prefilled batch, as generate() makes it: (engine, args of
    _decode_k_fn up to the tables, the first token)."""
    eng = (JGE if pkg == "jax" else TGE)(model, page_size=4, max_length=40)
    ids, lens = eng._pad_prompts(prompts)
    b = ids.shape[0]
    st = model.stack
    pp = -(-40 // 4)
    Mgr = JMgr if pkg == "jax" else TMgr
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mgr = Mgr(st.num_layers, st.num_kv_heads, st.head_dim, 4,
              num_pages=b * pp + 1, reserve_scratch=True, **kw)
    for i in range(b):
        mgr.allocate(i, int(lens[i]) + k)
    tables = mgr.block_tables(range(b), pp)
    cache = mgr.fresh_cache()
    lnf_s, lnf_b = eng._lnf()
    if pkg == "jax":
        w, emb = eng._weights(), eng._embed()
        logits, ck, cv = eng._prefill(w, emb, eng._head_t, lnf_s, lnf_b,
                                      jnp.asarray(ids), jnp.asarray(lens),
                                      cache.k, cache.v, tables)
        tok = np.asarray(eng._argmax(logits))
        return eng, (w, emb, eng._head_t, lnf_s, lnf_b, jnp.asarray(tok),
                     jnp.asarray(lens), ck, cv, tables), tok
    w, emb = eng._weights(), eng._embed()
    logits, ck, cv = eng._prefill_fn(w, emb, eng._head_t, lnf_s, lnf_b,
                                     torch.from_numpy(ids),
                                     torch.from_numpy(lens), cache.k,
                                     cache.v, tables)
    tok = eng._argmax(logits).numpy()
    return eng, (w, emb, eng._head_t, lnf_s, lnf_b, torch.from_numpy(tok),
                 torch.from_numpy(lens), ck, cv, tables), tok


@pytest.mark.parametrize("cfg", [(0.8, 10, 1.0), (1.0, 0, 0.9)])
def test_sampled_decode_chunk_equals_jax(models, cfg):
    """``_decode_k_fn`` with sampling, k 6 steps, each step's noise the
    one JAX's scan draws (``gumbel(fold_in(key, i))``) handed to the
    port: the [b, k] token matrices are equal. The port's logits of
    every step are recorded and their top-p margins asserted."""
    jm, tm = models
    prompts = [np.random.RandomState(s).randint(0, 64, n)
               for s, n in ((0, 5), (1, 9), (2, 3), (3, 12))]
    k = 6
    je, jargs, jtok = _prefilled("jax", jm, prompts, k + 1)
    te, targs, ttok = _prefilled("torch", tm, prompts, k + 1)
    np.testing.assert_array_equal(ttok, jtok)
    t, top_k, top_p = cfg
    key = jax.random.PRNGKey(9)
    jt, _, _ = je._decode_k_fn(
        *jargs, key, (jnp.float32(t), jnp.float32(top_p)), k=k,
        sample_cfg=(top_k,))
    b = len(prompts)
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, i), (b, 64), jnp.float32))
        for i in range(k)])
    seen = []
    pick = TGE._pick_token

    def record(logits, noise=None, sample_cfg=None):
        seen.append(logits.numpy().copy())
        return pick(logits, noise, sample_cfg)
    te._pick_token = record
    tt, _, _ = te._decode_k_fn(*targs, k=k, sample_cfg=cfg,
                               noise=torch.from_numpy(noise))
    assert len(seen) == k
    assert min(_filtered(lg, cfg)[2].min() for lg in seen) >= 1e-4
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_top_k_one_is_greedy(models):
    """``do_sample=True, top_k=1`` is the greedy stream bit for bit (the
    one kept token wins whatever the noise), JAX's greedy stream too."""
    jm, tm = models
    prompts = [np.random.RandomState(s).randint(0, 64, n)
               for s, n in ((4, 6), (5, 2), (6, 10))]
    eng = TGE(tm, page_size=4, max_length=40, decode_chunk=4)
    greedy = eng.generate(prompts, max_new_tokens=12)
    gen = torch.Generator().manual_seed(3)
    sampled = eng.generate(prompts, max_new_tokens=12, do_sample=True,
                           temperature=0.7, top_k=1, top_p=0.9,
                           generator=gen)
    np.testing.assert_array_equal(sampled, greedy)
    want = JGE(jm, page_size=4, max_length=40).generate(prompts,
                                                        max_new_tokens=12)
    np.testing.assert_array_equal(greedy, want)


def test_generate_samples_from_its_generator(models):
    """generate(do_sample=True) returns tokens in the vocabulary after
    each prompt; the same generator seed gives the same tokens, another
    seed others, and greedy decoding draws nothing from the default
    generator."""
    from paddle_tpu_torch.core.generator import default_generator

    _, tm = models
    prompts = [np.random.RandomState(7).randint(0, 64, 8)] * 4
    eng = TGE(tm, page_size=4, max_length=40, decode_chunk=5)

    def run(seed):
        return eng.generate(prompts, max_new_tokens=16, do_sample=True,
                            temperature=1.5, top_k=0, top_p=1.0,
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (4, 24) and ((a >= 0) & (a < 64)).all()
    np.testing.assert_array_equal(a[:, :8], np.stack(prompts))
    state = default_generator("cpu").get_state()
    eng.generate(prompts, max_new_tokens=4)
    assert torch.equal(default_generator("cpu").get_state(), state)


@pytest.mark.parametrize("cfg", [(0.8, 50, 0.9), (1.0, 0, 1.0)])
def test_draws_follow_the_filtered_softmax(cfg):
    """10^5 draws on one fixed row of 256 logits with the port's own
    generator: no token outside the kept set, and the total-variation
    distance between their frequencies and the filtered softmax below
    0.02 (its expectation at this count is under 0.01)."""
    rng = np.random.RandomState(21)
    row = (rng.randn(256) * 2).astype(np.float32)
    kept, q, _ = _filtered(row[None], cfg)
    n = 100_000
    logits = torch.from_numpy(row).expand(n, 256)
    gen = torch.Generator().manual_seed(0)
    toks = TGE._pick_token(logits, gumbel_noise((n, 256), gen), cfg)
    freq = np.bincount(toks.numpy(), minlength=256) / n
    assert kept[0][freq > 0].all()
    assert 0.5 * np.abs(freq - q[0]).sum() < 0.02
