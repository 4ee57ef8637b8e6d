"""The port's sequence losses against the JAX package's:
``ctc_loss`` (the alpha recursion over time) and ``rnnt_loss`` (the
(t, u) lattice, walked by anti-diagonals in the port, row by row in
JAX), in ``paddle_tpu_torch/nn/functional/loss.py``.

The same seeded logits, labels and lengths go through both: f32 values
within 1e-5 and the logits' gradients within 1e-4 of the largest value,
for every reduction, ``norm_by_times``, a nonzero ``blank``, rows whose
input is shorter than the batch's and a zero-length label. ``ctc_loss``
is also held to ``torch.nn.functional.ctc_loss`` (reduction ``none``,
1e-5), an independent implementation; ``rnnt_loss`` raises for
``fastemit_lambda``, as in JAX.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

# CTC: frames, batch, classes, max label length
T, B, C, L = 12, 4, 7, 4
# RNN-T: batch, frames, max label length, vocabulary
RB, RT, RU, RV = 3, 6, 4, 5


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.array(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _labels(rng, n, u, vocab, blank, lens):
    """Padded label ids that avoid ``blank``, a repeat in row 0."""
    ids = np.array([c for c in range(vocab) if c != blank])
    lab = ids[rng.randint(0, len(ids), (n, u))]
    lab[0, 1] = lab[0, 0]
    for i, n_i in enumerate(lens):
        lab[i, n_i:] = ids[0]
    return lab.astype(np.int32)


def _both(fj, ft, arrays, kw, reduction):
    """Values and the first array's gradients of ``fj`` (JAX) and ``ft``
    (port); a 'none' loss is weighted by a seeded vector first."""
    jx = [paddle.to_tensor(a) for a in arrays]
    jx[0].stop_gradient = False
    tx = [torch.from_numpy(a) for a in arrays]
    tx[0].requires_grad_()
    jl = fj(*jx, reduction=reduction, **kw)
    tl = ft(*tx, reduction=reduction, **kw)
    w = np.random.RandomState(7).rand(*tl.shape, 1)[..., 0] \
        .astype(np.float32)
    (jl * paddle.to_tensor(w)).sum().backward()
    (tl * torch.from_numpy(w)).sum().backward()
    return (jl, jx[0].grad), (tl, tx[0].grad)


def _ctc_inputs(blank):
    rng = np.random.RandomState(1)
    logits = (rng.randn(T, B, C) * 2).astype(np.float32)
    lab_len = np.array([4, 2, 0, 3], np.int64)
    in_len = np.array([12, 9, 5, 11], np.int64)
    return logits, _labels(rng, B, L, C, blank, lab_len), in_len, lab_len


@pytest.mark.parametrize("reduction,blank,norm", [
    ("none", 0, False), ("mean", 0, False), ("sum", 0, False),
    ("mean", 3, False), ("none", 0, True), ("sum", 6, True)])
def test_ctc_loss_and_gradient_match_jax(reduction, blank, norm):
    (jl, jg), (tl, tg) = _both(JF.ctc_loss, TF.ctc_loss, _ctc_inputs(blank),
                               {"blank": blank, "norm_by_times": norm},
                               reduction)
    assert torch.isfinite(tl).all()
    _close(tl, jl, 1e-5, "ctc loss")
    _close(tg, jg, 1e-4, "ctc d logits")


def test_ctc_loss_matches_torch_ctc():
    logits, lab, in_len, lab_len = _ctc_inputs(0)
    got = TF.ctc_loss(torch.from_numpy(logits), torch.from_numpy(lab),
                      torch.from_numpy(in_len), torch.from_numpy(lab_len),
                      reduction="none")
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(lab).long(), torch.from_numpy(in_len),
        torch.from_numpy(lab_len), blank=0, reduction="none")
    _close(got, want.numpy(), 1e-5, "ctc vs torch")


def _rnnt_inputs(blank):
    rng = np.random.RandomState(2)
    logits = rng.randn(RB, RT, RU + 1, RV).astype(np.float32)
    lab_len = np.array([4, 0, 2], np.int64)
    in_len = np.array([6, 4, 5], np.int64)
    return logits, _labels(rng, RB, RU, RV, blank, lab_len), in_len, lab_len


@pytest.mark.parametrize("reduction,blank", [
    ("none", 0), ("mean", 0), ("sum", 0), ("mean", 4)])
def test_rnnt_loss_and_gradient_match_jax(reduction, blank):
    (jl, jg), (tl, tg) = _both(JF.rnnt_loss, TF.rnnt_loss,
                               _rnnt_inputs(blank), {"blank": blank},
                               reduction)
    assert torch.isfinite(tl).all()
    _close(tl, jl, 1e-5, "rnnt loss")
    _close(tg, jg, 1e-4, "rnnt d logits")


def test_rnnt_loss_fastemit_raises():
    x = torch.zeros(1, 2, 2, 3)
    lab = torch.zeros(1, 1, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="fastemit"):
        TF.rnnt_loss(x, lab, n, n, fastemit_lambda=0.01)
