"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy`` on index labels, the training path's loss.

The JAX package's closed-form big-vocab path (``_fused_index_ce``) is
``FusedIndexCE``, an autograd function: per row ``log(sum exp(x - m)) +
m - x[label]`` with the sums in f32, and its backward ``(softmax -
onehot) * g`` in f32, cast to the logits' dtype. bf16 logits are never
copied to f32 whole: both passes walk row chunks of at most
``CE_CHUNK_ELEMENTS`` elements, so the f32 temporaries are a chunk's.
``cross_entropy`` passes its operands through the AMP hook first: under
``auto_cast`` (O1 or O2) the op is in the black list, so bf16 logits are
cast to f32 whole before the chunks, as the JAX package casts them.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import _amp_cast

__all__ = ["cross_entropy", "CE_CHUNK_ELEMENTS"]

#: elements of logits per f32 chunk (256 MB of f32 temporaries)
CE_CHUNK_ELEMENTS = 1 << 26


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, CE_CHUNK_ELEMENTS // max(n_cols, 1))
    for lo in range(0, n_rows, step):
        yield slice(lo, min(lo + step, n_rows))


class FusedIndexCE(torch.autograd.Function):
    """Per-row softmax cross entropy over the last axis of 2-d
    ``logits`` for pre-clamped ``ids``; rows where ``valid`` is false
    give exactly 0 loss and 0 gradient. The max and the logits'
    difference from it stay in the logits' dtype (as the JAX package
    computes ``logits - m`` before its f32 cast); exp, sums and logs run
    in f32."""

    @staticmethod
    def forward(ctx, logits, ids, valid):
        n = logits.shape[0]
        m = torch.empty(n, dtype=logits.dtype, device=logits.device)
        sumexp = torch.empty(n, dtype=torch.float32, device=logits.device)
        for rows in _row_chunks(n, logits.shape[1]):
            x = logits[rows]
            m[rows] = x.amax(dim=-1)
            sumexp[rows] = (x - m[rows, None]).float().exp_().sum(-1)
        picked = logits.gather(-1, ids[:, None]).squeeze(-1).float()
        per = torch.log(sumexp) + m.float() - picked
        ctx.save_for_backward(logits, ids, valid, m, sumexp)
        return torch.where(valid, per, torch.zeros_like(per))

    @staticmethod
    def backward(ctx, g):
        logits, ids, valid, m, sumexp = ctx.saved_tensors
        gv = torch.where(valid, g.float(), 0.0)
        log_sumexp = torch.log(sumexp)
        d = torch.empty_like(logits)
        for rows in _row_chunks(logits.shape[0], logits.shape[1]):
            p = ((logits[rows] - m[rows, None]).float()
                 - log_sumexp[rows, None]).exp_()
            idx = torch.arange(rows.stop - rows.start, device=p.device)
            p[idx, ids[rows]] -= 1.0
            d[rows] = (p * gv[rows, None]).to(logits.dtype)
        return d, None, None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy on index labels (the JAX package's fast
    path; f32 and bf16 logits alike).

    Label contract: entries equal to ``ignore_index`` give zero loss and
    zero gradient and leave the ``'mean'`` denominator; any other
    out-of-range entry is clamped into ``[0, num_classes)``."""
    if weight is not None or soft_label or not use_softmax \
            or label_smoothing != 0.0:
        raise NotImplementedError(
            "cross_entropy with weight, soft labels, use_softmax=False or "
            "label smoothing comes with the losses slice of the port")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', "
                         f"not {reduction!r}")
    logits, label = _amp_cast("cross_entropy", input, label)
    ids = label.long()
    if ids.ndim == logits.ndim:
        ids = ids.squeeze(axis)
    if axis not in (-1, logits.ndim - 1):
        logits = logits.movedim(axis, -1)
    batch_shape = logits.shape[:-1]
    n_class = logits.shape[-1]
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids)) \
        .clamp(0, n_class - 1)
    per = FusedIndexCE.apply(logits.reshape(-1, n_class),
                             safe.reshape(-1), valid.reshape(-1))
    if reduction == "mean":
        return per.sum() / valid.sum().float().clamp_min(1.0)
    if reduction == "sum":
        return per.sum()
    return per.reshape(batch_shape)
