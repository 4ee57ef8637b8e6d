"""Parity of paddle_tpu_torch's serving engines with paddle_tpu's.

A tiny float32 FusedCausalLM (vocab 64, d 32, 4 heads, 2 layers) built
by the JAX package and carried into the port with ``load_jax_params``.
Greedy tokens, page accounting and block tables are integers and must
be IDENTICAL between the packages; logits are compared at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import (BlockKVCacheManager as JMgr,
                                  ContinuousBatchingEngine as JCBE,
                                  FusedCausalLM as JLM,
                                  GenerationEngine as JGE)
from paddle_tpu.profiler import stats as jstats
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import (BlockKVCacheManager as TMgr,
                                        ContinuousBatchingEngine as TCBE,
                                        FusedCausalLM as TLM,
                                        GenerationEngine as TGE)
from paddle_tpu_torch.profiler import stats as tstats

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, dim_feedforward=64,
           num_layers=2, max_position=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLM(**CFG)
    params = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = TLM(**CFG, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 64, n) for n in (5, 9, 3, 12)]


def test_forward_logits_match(models):
    jm, tm = models
    ids = np.random.RandomState(1).randint(0, 64, (2, 7))
    lj = np.asarray(jm(paddle.to_tensor(ids))._data)
    lt = tm(ids).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-5)


@pytest.mark.parametrize("decode_chunk", [None, 3])
def test_generate_tokens_identical(models, decode_chunk):
    jm, tm = models
    kw = dict(page_size=4, max_length=40, decode_chunk=decode_chunk)
    oj = JGE(jm, **kw).generate(_prompts(), max_new_tokens=12)
    ot = TGE(tm, **kw).generate(_prompts(), max_new_tokens=12)
    np.testing.assert_array_equal(ot, oj)


def test_generate_eos_identical(models):
    """An EOS taken from the greedy stream itself, so some rows stop
    early and pad with it."""
    jm, tm = models
    base = JGE(jm, page_size=4, max_length=40).generate(
        _prompts(), max_new_tokens=10)
    eos = int(base[0, 5 + 3])                  # row 0's 4th new token
    kw = dict(page_size=4, max_length=40, decode_chunk=4)
    oj = JGE(jm, **kw).generate(_prompts(), max_new_tokens=10,
                                eos_token_id=eos)
    ot = TGE(tm, **kw).generate(_prompts(), max_new_tokens=10,
                                eos_token_id=eos)
    np.testing.assert_array_equal(ot, oj)


def test_generate_pool_gauges_match(models):
    jm, tm = models
    jstats.reset()
    tstats.reset()
    JGE(jm, page_size=4, max_length=40).generate(_prompts(),
                                                 max_new_tokens=4)
    TGE(tm, page_size=4, max_length=40).generate(_prompts(),
                                                 max_new_tokens=4)
    for name in ("inference.pool_pages", "inference.pool_pages_requested",
                 "inference.kv_pages_in_use"):
        assert tstats.gauge(name).value == jstats.gauge(name).value, name
    assert tstats.counter("inference.decode_steps").value == \
        jstats.counter("inference.decode_steps").value


def _serve(cls, model, prompts, **kw):
    eng = cls(model, max_batch=2, page_size=4, max_length=48,
              decode_chunk=3, **kw)
    ids = [eng.submit(p, max_new_tokens=n)
           for p, n in zip(prompts, (7, 4, 9, 5, 6))]
    free0 = eng._mgr.free_pages
    done = eng.run()
    by_id = {r.id: r for r in done}
    return [list(by_id[i].generated) for i in ids], free0, \
        eng._mgr.free_pages


def test_continuous_batching_tokens_identical(models):
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, n) for n in (6, 17, 2, 11, 8)]
    gj, fj0, fj1 = _serve(JCBE, jm, prompts)
    gt, ft0, ft1 = _serve(TCBE, tm, prompts)
    assert gt == gj
    assert (ft0, ft1) == (fj0, fj1)
    assert ft1 == ft0                      # every page came back


def _script(mgr):
    """Allocate / grow / share / truncate / free, recording tables,
    refcounts and free counts after each step."""
    out = []

    def snap():
        ids = [s for s in ("a", "b", "c") if s in mgr._owned]
        tbl = np.asarray(mgr.block_tables(ids, 6)) if ids else None
        out.append((ids, None if tbl is None else tbl.tolist(),
                    {p: mgr.refcount(p) for p in range(mgr.num_pages)},
                    mgr.free_pages))
    mgr.allocate("a", 9)
    snap()
    mgr.allocate("b", 3)
    mgr.grow("b", 2)
    snap()
    mgr.share("c", mgr._owned["a"][:2])
    mgr.grow("c", 1)
    snap()
    mgr.truncate("a", 4)
    snap()
    mgr.free("a")
    snap()
    mgr.rekey("c", "a")
    mgr.release_pages([])
    snap()
    mgr.free("b")
    mgr.free("a")
    snap()
    out.append(mgr.pages_needed(17))
    return out


def test_block_manager_accounting_identical():
    jm = JMgr(2, 2, 8, page_size=4, num_pages=16, reserve_scratch=True)
    tm = TMgr(2, 2, 8, page_size=4, num_pages=16, reserve_scratch=True,
              device="cpu")
    assert _script(tm) == _script(jm)
    np.testing.assert_array_equal(tm.phys_rows([3, 5]),
                                  jm.phys_rows([3, 5]))
    k, v = tm.fresh_cache()
    assert k.shape == (2 * 16, 2, 4, 8) and k.device.type == "cpu"
    assert int(k.abs().sum()) == 0


@pytest.mark.parametrize("page_size", [1, 4, 16, 64])
def test_round_pool_pages_identical(page_size):
    from paddle_tpu.inference.engine import _round_pool_pages as jr
    from paddle_tpu_torch.inference.engine import _round_pool_pages as tr

    for n in (1, 2, 3, 25, 129, 545, 1000, 4097):
        assert tr(n, page_size) == jr(n, page_size)


def test_argmax_min_index_and_nan():
    from paddle_tpu.inference.engine import GenerationEngine as J

    logits = np.array([[1.0, 3.0, 3.0, 0.0],
                       [np.nan] * 4,
                       [-1.0, -1.0, -2.0, -1.0]], np.float32)
    tj = np.asarray(J._argmax(jnp.asarray(logits)))
    tt = TGE._argmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(tt, [1, 0, 0])


def test_later_slices_raise(models):
    _, tm = models
    with pytest.raises(NotImplementedError):          # quantized TP
        TGE(tm, quant="a8w8", mp_degree=2)
    assert tm.stack.qkv_weight.dtype == torch.float32  # not quantized
    with pytest.raises(NotImplementedError):
        TCBE(tm, quant="int8", kv_dtype="int8", mp_degree=2)
    with pytest.raises(NotImplementedError):
        TGE(tm, page_size=4, max_length=40).generate(
            _prompts(), max_new_tokens=2, do_sample=True)
    with pytest.raises(NotImplementedError):
        TCBE(tm, speculative=True)
