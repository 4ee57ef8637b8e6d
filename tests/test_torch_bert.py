"""The port's BERT (``paddle_tpu_torch/text/models.py``) against the JAX
package's, and the three repairs of this slice.

``bert_tiny`` is built in both packages and the JAX ``state_dict``
carried across by ``load_jax_params``, in eval mode (no dropout): the
sequence output, the pooled output, the masked-LM and next-sentence
logits, the pretraining criterion and every parameter's gradient, with
and without an attention mask, and at 128 tokens, where the port takes
the flash route (B10's plain versions on the CPU). f32 outputs within
1e-5 of the largest value, gradients within 1e-4 of the largest
gradient. Three f32 ``TrainStep`` steps (AdamW, dropout 0) give losses
within 1e-5 of the JAX ``TrainStep``'s.

The repairs: ``Embedding(sparse=True)`` trains with the JAX layer's
dense gradient; ``set_flash_block_sizes`` takes the JAX function's
arguments and checks and records its override; ``TrainStep(donate=
False)`` leaves the old parameter storage as it was and reaches the
parameters of an in-place step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu.text import models as jm
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core.place import device_guard
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.text import models as tm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(
        t.numpy())


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _pair(seq=64, dropout=0.1):
    """The JAX ``BertForPretraining(bert_tiny())`` from ``seed(0)`` and the
    port's with its weights."""
    kw = dict(max_position_embeddings=seq, hidden_dropout_prob=dropout)
    jp.seed(0)
    j = jm.BertForPretraining(jm.bert_tiny(**kw))
    t = tm.BertForPretraining(tm.bert_tiny(**kw))
    load_jax_params(t, {k: np.array(v.numpy())
                        for k, v in j.state_dict().items()})
    return j, t


def _batch(b=3, s=16, seed=0, masked=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s))
    types = rng.randint(0, 2, (b, s))
    mask = np.ones((b, s), np.int64)
    if masked:
        mask[1:, s // 2:] = 0
    mlm = np.where(rng.rand(b, s) < 0.3, rng.randint(0, 128, (b, s)), -100)
    nsp = rng.randint(0, 2, (b,))
    return [ids, types] + ([mask] if masked else []), [mlm, nsp]


def _forward(P, model, crit, inputs, labels):
    ins = [P.to_tensor(a) for a in inputs]
    seq, pooled = model.bert(*ins)
    mlm, nsp = model(*ins)
    loss = crit(mlm, nsp, *[P.to_tensor(a) for a in labels])
    return seq, pooled, mlm, nsp, loss


@pytest.mark.parametrize("case", ["unmasked", "masked", "flash128"])
def test_bert_tiny_forward_loss_and_gradients_match_jax(case):
    seq = 128 if case == "flash128" else 64
    j, t = _pair(seq)
    j.eval()
    t.eval()
    inputs, labels = _batch(s=seq if case == "flash128" else 16,
                            masked=case == "masked")
    outs_j = _forward(jp, j, jm.BertPretrainingCriterion(), inputs, labels)
    outs_t = _forward(tp, t, tm.BertPretrainingCriterion(), inputs, labels)
    if case == "flash128":
        assert tattn.last_attention_backend() == "flash"
    for name, g, w in zip(("seq", "pooled", "mlm", "nsp", "loss"), outs_t,
                          outs_j):
        _close(g, w, 1e-5, name)
    outs_j[-1].backward()
    outs_t[-1].backward()
    jg = {k: p.grad for k, p in j.named_parameters()}
    tg = dict(t.named_parameters())
    assert set(jg) == set(tg)
    gmax = max(float(np.abs(_np(g)).max()) for g in jg.values())
    for k, g in jg.items():
        got = tg[k].grad
        assert got is not None, k
        # the key projections' biases have a zero gradient in exact
        # arithmetic: each gradient within 1e-4 of the largest one
        assert float(np.abs(_np(got) - _np(g)).max()) <= 1e-4 * gmax, k


def test_bert_tiny_train_steps_match_jax():
    j, t = _pair(dropout=0.0)
    inputs, labels = _batch(b=4, seed=3)
    jstep = jp.jit.TrainStep(j, jm.BertPretrainingCriterion(),
                             jp.optimizer.AdamW(1e-3,
                                                parameters=j.parameters()))
    tstep = tp.jit.TrainStep(t, tm.BertPretrainingCriterion(),
                             tp.optimizer.AdamW(1e-3,
                                                parameters=t.parameters()))
    ja = ([jp.to_tensor(a) for a in inputs], [jp.to_tensor(a)
                                              for a in labels])
    ta = ([tp.to_tensor(a) for a in inputs], [tp.to_tensor(a)
                                              for a in labels])
    lj = [float(jstep(*ja).numpy()) for _ in range(3)]
    lt = [float(tstep(*ta)) for _ in range(3)]
    assert lj[2] < lj[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_bert_structure_and_unported_text_names():
    t = tm.BertForPretraining(tm.bert_tiny())
    assert isinstance(t.decoder_bias, torch.nn.Parameter)
    assert t.decoder_bias.shape == (128,) and not t.decoder_bias.any()
    with device_guard("cpu"):
        base = tm.bert_base(max_position_embeddings=8)
    assert sum(p.numel() for p in base.parameters()) == 30522 * 768 \
        + 8 * 768 + 2 * 768 + 2 * 768 + 12 * (4 * 768 * 769 + 2 * 768 * 3072
                                              + 3072 + 768 + 4 * 768) \
        + 768 * 769
    for name in ("Imdb", "WMT16", "viterbi_decode", "ViterbiDecoder"):
        with pytest.raises(NotImplementedError, match="A12"):
            getattr(tp.text, name)


def test_run_bert_bench_on_the_cpu():
    from paddle_tpu_torch import bench

    tps, mfu, stats = bench.run_bert_bench(1, 128, 1, device="cpu",
                                           warmup=1)
    assert tps > 0 and mfu is None
    assert stats["n_params"] == 30522 * 768 + 128 * 768 + 2 * 768 \
        + 2 * 768 + 12 * (4 * 768 * 769 + 2 * 768 * 3072 + 3072 + 768
                          + 4 * 768) + 768 * 769 + 768 * 769 + 2 * 768 \
        + 30522 + 768 * 2 + 2
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2
    assert tattn.last_attention_backend() == "flash"


# ---------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------

def test_sparse_embedding_trains_with_the_dense_gradient():
    jp.seed(0)
    j = jnn.Embedding(10, 4, padding_idx=2, sparse=True)
    t = tnn.Embedding(10, 4, padding_idx=2, sparse=True)
    load_jax_params(t, {k: np.array(v.numpy())
                        for k, v in j.state_dict().items()})
    ids = np.array([[1, 2, 2, 7], [7, 0, 9, 1]])
    w = np.random.RandomState(0).randn(2, 4, 4).astype(np.float32)
    oj, ot = j(jp.to_tensor(ids)), t(tp.to_tensor(ids))
    _close(ot, oj, 0, "embedding")
    (oj * jp.to_tensor(w)).sum().backward()
    (ot * tp.to_tensor(w)).sum().backward()
    assert not t.weight.grad.is_sparse
    _close(t.weight.grad, j.weight.grad, 1e-6, "embedding grad")


def test_set_flash_block_sizes_takes_the_jax_arguments():
    from paddle_tpu.nn.functional import attention as jattn

    for mod in (jattn, tattn):
        with pytest.raises(ValueError, match="block_q is required"):
            mod.set_flash_block_sizes(block_k=128)
    try:
        for args, want in (((128,), ((128, 128), "wgmma")),
                           ((64, 64), ((64, 64), "mma")),
                           ((32, 32), ((32, 32), "f32")),
                           ((256, 512), ((256, 512), None))):
            jattn.set_flash_block_sizes(*args)
            tattn.set_flash_block_sizes(*args)
            assert tattn.flash_block_sizes() == want
            assert jattn._FA_BLOCKS == want[0]
        tattn.set_flash_block_sizes(None)
        assert tattn.flash_block_sizes() == (None, None)
    finally:
        jattn.set_flash_block_sizes(None)
        tattn.set_flash_block_sizes(None)


def _tiny_step(donate):
    tp.seed(0)
    model = tm.BertForPretraining(tm.bert_tiny(hidden_dropout_prob=0.0))
    opt = tp.optimizer.AdamW(1e-2, parameters=model.parameters())
    return model, tp.jit.TrainStep(model, tm.BertPretrainingCriterion(),
                                   opt, donate=donate)


def test_train_step_without_donation_keeps_the_old_parameters():
    inputs, labels = _batch(b=2, seed=5)
    ins = [tp.to_tensor(a) for a in inputs]
    labs = [tp.to_tensor(a) for a in labels]
    kept, step = _tiny_step(donate=False)
    held = {k: p.detach() for k, p in kept.named_parameters()}
    before = {k: v.clone() for k, v in held.items()}
    for _ in range(2):
        step(ins, labs)
    moved, step = _tiny_step(donate=True)
    for _ in range(2):
        step(ins, labs)
    new = dict(kept.named_parameters())
    for k, p in moved.named_parameters():
        assert torch.equal(held[k], before[k]), k
        assert torch.equal(new[k].detach(), p.detach()), k
    assert not torch.equal(new["nsp.weight"].detach(), before["nsp.weight"])
