"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy`` and every other loss of the JAX file, each its
formula in torch ops with Paddle's reductions (``'none'``, ``'mean'``,
``'sum'``; ``kl_div`` also ``'batchmean'``). The losses on the O1
black list (``cross_entropy``, ``nll_loss``, ``mse_loss``, ``l1_loss``,
``kl_div``, ``binary_cross_entropy``, ``bce_with_logits``,
``sigmoid_focal_loss``) pass their operands through the AMP hook under
the JAX op name. ``margin_cross_entropy`` with a ``group`` raises
(tensor parallelism, A10).

``ctc_loss`` is the log-domain alpha recursion over time and
``rnnt_loss`` the forward recursion over the (t, u) lattice, both in
PyTorch ops vectorised over the batch: CTC a step per frame, RNN-T a
step per anti-diagonal of the lattice (T + U steps, every cell of a
diagonal at once; each cell's sum is the JAX package's, in the same
order). Autograd differentiates both.

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

import math

import torch
import torch.nn.functional as F

from ...amp.auto_cast import _amp_cast

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "square_error_cost",
    "log_loss", "sigmoid_focal_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
    "ctc_loss", "margin_cross_entropy", "huber_loss", "rnnt_loss",
    "CE_CHUNK_ELEMENTS",
]

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


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy. Plain index labels (no ``weight``, soft
    labels, ``use_softmax=False`` or smoothing) take the JAX package's
    fast path, ``FusedIndexCE``; the rest the general form: log-softmax
    (or the log of ``input`` clipped at 1e-10 with ``use_softmax=False``),
    soft labels (smoothed toward uniform), or picked index labels mixed
    with the mean log-probability by ``label_smoothing`` and scaled by
    ``weight[label]``.

    Label contract: entries equal to ``ignore_index`` give zero loss and
    zero gradient and leave the ``'mean'`` denominator (with ``weight``
    the denominator is the sum of the valid entries' weights); any other
    out-of-range entry is clamped into ``[0, num_classes)`` on the fast
    path."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', "
                         f"not {reduction!r}")
    logits, label, weight = _amp_cast("cross_entropy", input, label, weight)
    if use_softmax and not soft_label and label_smoothing == 0.0 \
            and weight is None:
        return _index_ce(logits, label, ignore_index, reduction, axis)
    logp = torch.log_softmax(logits, axis) if use_softmax else \
        torch.log(torch.clamp(logits, min=1e-10))
    nclass = logits.shape[axis]
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        return _reduce(-(soft * logp).sum(axis), reduction)
    ids = label.long()
    if ids.ndim == logp.ndim:
        ids = ids.squeeze(axis)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    per = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        per = (1 - label_smoothing) * per - \
            label_smoothing * logp.mean(axis)
    zero = torch.zeros_like(per)
    if weight is not None:
        w = weight[safe]
        per = torch.where(valid, per * w, zero)
        if reduction == "mean":
            return per.sum() / torch.clamp(
                torch.where(valid, w, torch.zeros_like(w)).sum(), min=1e-12)
        return _reduce(per, reduction)
    per = torch.where(valid, per, zero)
    if reduction == "mean":
        return per.sum() / torch.clamp(valid.sum().to(per.dtype), min=1.0)
    return _reduce(per, reduction)


def _index_ce(logits, label, ignore_index, reduction, axis):
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-sample loss with the class axis kept as size 1, and the
    softmax with ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = _amp_cast("mse_loss", input, label)
    return _reduce((input - label).square(), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def l1_loss(input, label, reduction="mean", name=None):
    input, label = _amp_cast("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n]]`` over log-probabilities ``[N, C, ...]``, the
    same label contract and weighting as ``cross_entropy``."""
    logp, label, weight = _amp_cast("nll_loss", input, label, weight)
    ids = label.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    per = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros_like(per)
    if weight is not None:
        w = weight[safe]
        per = torch.where(valid, per * w, zero)
        if reduction == "mean":
            return per.sum() / torch.clamp(
                torch.where(valid, w, torch.zeros_like(w)).sum(), min=1e-12)
        return _reduce(per, reduction)
    per = torch.where(valid, per, zero)
    if reduction == "mean":
        return per.sum() / torch.clamp(valid.sum().to(per.dtype), min=1.0)
    return _reduce(per, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p, y, weight = _amp_cast("binary_cross_entropy", input, label, weight)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    per = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


def _log1p_exp_neg_abs(z):
    """``log(1 + exp(-|z|))``, as the JAX package's
    ``logaddexp(0, -|z|)``."""
    return torch.logaddexp(torch.zeros_like(z), -z.abs())


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(z, 0) - z y + log(1 + exp(-|z|))``, with
    ``pos_weight`` folded in as the JAX package folds it."""
    z, y, weight, pos_weight = _amp_cast("bce_with_logits", logit, label,
                                         weight, pos_weight)
    if pos_weight is not None:
        log_weight = (pos_weight - 1) * y + 1
        per = (1 - y) * z + log_weight * (
            _log1p_exp_neg_abs(z) + torch.clamp(-z, min=0.0))
    else:
        per = torch.clamp(z, min=0) - z * y + _log1p_exp_neg_abs(z)
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    logp, y = _amp_cast("kl_div", input, label)
    if log_target:
        per = torch.exp(y) * (y - logp)
    else:
        per = torch.where(y > 0, y * (torch.log(torch.clamp(y, min=1e-12))
                                      - logp), torch.zeros_like(logp))
    if reduction == "batchmean":
        return per.sum() / logp.shape[0]
    return _reduce(per, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    diff = (input - label).abs()
    per = torch.where(diff < delta, 0.5 * diff * diff / delta,
                      diff - 0.5 * delta)
    return _reduce(per, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, normalizer = _amp_cast("sigmoid_focal_loss", logit, label,
                                 normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + _log1p_exp_neg_abs(z)
    p_t = p * y + (1 - p) * (1 - y)
    per = (alpha * y + (1 - alpha) * (1 - y)) * torch.pow(1 - p_t, gamma) \
        * ce
    if normalizer is not None:
        per = per / normalizer
    return _reduce(per, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    per = torch.where(label == 1, input, torch.clamp(margin - input,
                                                     min=0.0))
    return _reduce(per, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2, dim=-1),
        min=1e-12)
    per = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                       min=0.0))
    return _reduce(per, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return torch.pow(torch.pow((u - v).abs() + epsilon, p).sum(-1),
                         1.0 / p)

    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce(torch.clamp(d_ap - d_an + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = torch.minimum(d_an, distance_function(positive, negative))
    return _reduce(torch.clamp(d_ap - d_an + margin, min=0.0), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    per = -(label * F.logsigmoid(input)
            + (1 - label) * F.logsigmoid(-input)).mean(-1)
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    if log_input:
        per = torch.exp(input) - label * input
    else:
        per = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label + 0.5 * \
            torch.log(2 * math.pi * (label + epsilon))
        per = per + torch.where(label > 1, stirling,
                                torch.zeros_like(stirling))
    return _reduce(per, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    per = 0.5 * (torch.log(var) + (label - input).square() / var)
    if full:
        per = per + 0.5 * math.log(2 * math.pi)
    return _reduce(per, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = input - label
    ad = d.abs()
    per = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(per, reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family margin softmax on one device: the target class's
    ``cos(theta)`` becomes ``cos(m1 theta + m2) - m3`` (the cosine
    clamped inside (-1, 1)), every logit times ``scale``. ``group``
    (logits sharded over a model-parallel group) raises."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy over a model-parallel group comes with "
            "the port's tensor-parallel slice (ROADMAP A10)")
    ids = label.long().reshape(-1)
    onehot = F.one_hot(ids, logits.shape[1]).to(logits.dtype)
    eps = 1e-6
    cos = torch.clamp(logits, -1.0 + eps, 1.0 - eps)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    adj = torch.where(onehot > 0, target, cos) * scale
    loss = torch.logsumexp(adj, -1) - (adj * onehot).sum(-1)
    if return_softmax:
        return _reduce(loss, reduction), torch.softmax(adj, -1)
    return _reduce(loss, reduction)


#: the log-domain "minus infinity" of the CTC and RNN-T recursions (the
#: JAX package's: finite, so that sums of it stay finite)
_NEG_INF = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC loss. ``log_probs``: ``[max_time, batch, num_classes]`` raw
    logits (log-softmaxed here, as warpctc takes them); ``labels``:
    ``[batch, max_label_len]`` padded ids; ``input_lengths``,
    ``label_lengths``: ``[batch]``. Frames past a row's input length
    leave its alpha as it is; a zero-length label has the all-blank
    path alone. ``norm_by_times`` divides each loss by its input length
    before the reduction."""
    T, B, _ = log_probs.shape
    lp = torch.log_softmax(log_probs, dim=-1)
    dev = lp.device
    L = labels.shape[1]
    S = 2 * L + 1
    neg_inf = torch.tensor(_NEG_INF, dtype=lp.dtype, device=dev)
    # the extended label sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    lab_len = label_lengths.long().to(dev)
    in_len = input_lengths.long().to(dev)
    s_len = 2 * lab_len + 1
    # a skip from s - 2 to s: ext[s] is no blank and differs from ext[s-2]
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                        dim=1)
    probs_ext = torch.gather(lp.transpose(0, 1), 2,
                             ext[:, None, :].expand(B, T, S))  # [B, T, S]
    pad1 = neg_inf.expand(B, 1)
    pad2 = neg_inf.expand(B, 2)
    alpha = torch.cat([probs_ext[:, 0, :1],
                       torch.where(lab_len > 0, probs_ext[:, 0, 1],
                                   neg_inf)[:, None],
                       neg_inf.expand(B, S - 2)], dim=1)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], 1),
                             neg_inf)
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) \
            + probs_ext[:, t, :]
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    a_last = alpha.gather(1, (s_len - 1).clamp(0, S - 1)[:, None])[:, 0]
    a_prev = alpha.gather(1, (s_len - 2).clamp(0, S - 1)[:, None])[:, 0]
    # a zero-length label has one terminal state: count alpha[:, 0] once
    a_prev = torch.where(s_len >= 2, a_prev, neg_inf)
    loss = -torch.logaddexp(a_last, a_prev)
    if norm_by_times:
        loss = loss / in_len.to(loss.dtype).clamp(min=1.0)
    return _reduce(loss, reduction)


def rnnt_loss(logits, labels, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss. ``logits``: ``[B, T, U + 1, V]`` joint
    outputs (log-softmaxed here); ``labels``: ``[B, U]`` padded ids.
    ``alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t,
    u-1] + emit[t, u-1])``, walked by anti-diagonals ``t + u = d``;
    cells past a row's label length hold minus infinity, and the loss
    reads ``alpha[T_b - 1, U_b] + blank[T_b - 1, U_b]``.
    ``fastemit_lambda != 0`` raises, as in the JAX package."""
    if fastemit_lambda:
        raise NotImplementedError(
            "rnnt_loss: fastemit_lambda != 0 (FastEmit regularization) "
            "is not implemented; pass 0.0")
    B, T, U1, _ = logits.shape
    U = U1 - 1
    lp = torch.log_softmax(logits, dim=-1)
    dev = lp.device
    neg_inf = torch.tensor(_NEG_INF, dtype=lp.dtype, device=dev)
    blank_lp = lp[..., blank]                                   # [B, T, U1]
    emit_lp = torch.gather(lp[:, :, :U, :], 3, labels.long().to(dev)[
        :, None, :, None].expand(B, T, U, 1))[..., 0]           # [B, T, U]
    in_len = input_lengths.long().to(dev)
    lab_len = label_lengths.long().to(dev)
    u = torch.arange(U1, device=dev)
    in_label = u[None, :] <= lab_len[:, None]                  # [B, U1]
    # skewed operands: on diagonal d, cell u is (t, u) = (d - u, u); it
    # takes blank[t - 1, u] from (t - 1, u) and emit[t, u - 1] from
    # (t, u - 1), both on diagonal d - 1
    D = T + U
    t_of = torch.arange(D, device=dev)[:, None] - u[None, :]    # [D, U1]
    on_grid = (t_of >= 0) & (t_of < T)
    from_above = on_grid & (t_of >= 1)
    from_left = on_grid & (u[None, :] >= 1)
    blank_skew = torch.gather(blank_lp, 1, (t_of - 1).clamp(0, T - 1)[
        None].expand(B, D, U1))                                  # [B, D, U1]
    emit_cols = torch.cat([emit_lp[:, :, :1], emit_lp], dim=2)  # u-1 at u
    emit_skew = torch.gather(emit_cols, 1, t_of.clamp(0, T - 1)[
        None].expand(B, D, U1))
    diag = torch.where((u == 0)[None, :], torch.zeros((), dtype=lp.dtype,
                                                      device=dev), neg_inf)
    diag = diag.expand(B, U1)
    diags = [diag]
    pad = neg_inf.expand(B, 1)
    for d in range(1, D):
        above = torch.where(from_above[d], diag + blank_skew[:, d], neg_inf)
        left = torch.where(from_left[d], torch.cat([pad, diag[:, :-1]], 1)
                           + emit_skew[:, d], neg_inf)
        diag = torch.where(in_label & on_grid[d],
                           torch.logaddexp(above, left), neg_inf)
        diags.append(diag)
    alpha = torch.stack(diags, dim=1)                           # [B, D, U1]
    u_fin = lab_len.clamp(0, U)
    t_fin = (in_len - 1).clamp(0, T - 1)
    rows = torch.arange(B, device=dev)
    loss = -(alpha[rows, t_fin + u_fin, u_fin]
             + blank_lp[rows, t_fin, u_fin])
    return _reduce(loss, reduction)
