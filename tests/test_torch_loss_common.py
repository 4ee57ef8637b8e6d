"""Parity of the port's losses and common functionals
(``paddle_tpu_torch.nn.functional.loss`` / ``common``) with the JAX
package's, on the same numpy inputs from a seed, in f32.

- Every loss of the JAX file at its defaults and at other arguments
  (``cross_entropy`` with ``weight``, soft labels with smoothing,
  ``use_softmax=False``, index-label smoothing and ``ignore_index``,
  each reduction; ``nll_loss``, the BCEs with ``weight`` and
  ``pos_weight``, ``kl_div`` with ``log_target`` and ``batchmean``, the
  margin, embedding, triplet, Poisson, Gaussian and Huber losses,
  ``margin_cross_entropy`` with its softmax): 1e-5 absolute and
  relative (f32 reductions in another order); the gradient of the
  general ``cross_entropy`` path within 1e-6. ``ctc_loss`` and
  ``rnnt_loss`` compute (``test_torch_seq_losses.py`` holds them to
  JAX), ``margin_cross_entropy(group=)`` raises naming A10.
- ``pad`` in every mode and form, ``interpolate`` (nearest, area,
  bilinear, bicubic and trilinear as ``jax.image.resize`` gives them,
  antialiased when shrinking, and corner-aligned linear), the shuffles,
  ``unfold``/``fold``, ``cosine_similarity``, ``bilinear``,
  ``label_smooth``, ``affine_grid`` and ``grid_sample`` (both modes,
  every padding mode, both corner alignments): 1e-5 (1e-4 for the
  resizes, whose weights are summed in another order).
- The dropouts draw from an explicit generator: ``dropout2d`` drops whole
  channels and scales the rest by ``1 / (1 - p)``; ``alpha_dropout``
  gives a standard-normal input mean 0 and the variance of the JAX
  package's affine map; both are the identity in eval. ``class_center_sample`` raises naming A10.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.array(t.numpy())


def _cmp(name, args, tol=1e-5, **kw):
    j = getattr(JF, name)(*[paddle.to_tensor(a) if isinstance(a, np.ndarray)
                            else a for a in args], **kw)
    t = getattr(TF, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args], **kw)
    js = j if isinstance(j, tuple) else (j,)
    ts = t if isinstance(t, tuple) else (t,)
    for a, b in zip(js, ts):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (name, kw, a.shape, b.shape)
        np.testing.assert_allclose(b, a, atol=tol, rtol=tol,
                                   err_msg=f"{name} {kw}")


def test_cross_entropy_every_option():
    r = np.random.RandomState(0)
    logits = r.randn(6, 5).astype(np.float32)
    ids = np.array([0, 3, 4, -100, 2, 1], np.int64)
    w = r.rand(5).astype(np.float32) + 0.1
    soft = r.rand(6, 5).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for red in ("mean", "sum", "none"):
        _cmp("cross_entropy", (logits, ids), reduction=red)
        _cmp("cross_entropy", (logits, ids, w), reduction=red)
        _cmp("cross_entropy", (logits, ids), reduction=red,
             label_smoothing=0.1)
        _cmp("cross_entropy", (logits, soft), reduction=red,
             soft_label=True)
        _cmp("cross_entropy", (logits, soft), reduction=red,
             soft_label=True, label_smoothing=0.2)
        _cmp("cross_entropy", (probs, ids), reduction=red,
             use_softmax=False)
    _cmp("cross_entropy", (logits.T.copy(), ids[None].copy()), axis=0)
    _cmp("softmax_with_cross_entropy", (logits, ids[:, None].copy()))
    _cmp("softmax_with_cross_entropy", (logits, ids[:, None].copy()),
         return_softmax=True)
    jl = paddle.to_tensor(logits, stop_gradient=False)
    JF.cross_entropy(jl, paddle.to_tensor(ids), paddle.to_tensor(w),
                     label_smoothing=0.1).backward()
    tl = torch.from_numpy(logits).requires_grad_()
    TF.cross_entropy(tl, torch.from_numpy(ids), torch.from_numpy(w),
                     label_smoothing=0.1).backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.array(jl.grad.numpy()),
                               atol=1e-6, rtol=0)


def test_every_other_loss():
    r = np.random.RandomState(1)
    a, b = r.randn(4, 6).astype(np.float32), r.randn(4, 6).astype(np.float32)
    p = 1 / (1 + np.exp(-a))
    y01 = (r.rand(4, 6) > 0.5).astype(np.float32)
    w6 = r.rand(6).astype(np.float32)
    logp = a - np.log(np.exp(a).sum(-1, keepdims=True))
    ids = np.array([1, 5, -100, 0], np.int64)
    pm1 = np.where(r.rand(4) > 0.5, 1.0, -1.0).astype(np.float32)
    for red in ("mean", "sum", "none"):
        _cmp("mse_loss", (a, b), reduction=red)
        _cmp("l1_loss", (a, b), reduction=red)
        _cmp("nll_loss", (logp, ids), reduction=red)
        _cmp("nll_loss", (logp, ids, w6), reduction=red)
        _cmp("binary_cross_entropy", (p, y01), reduction=red)
        _cmp("binary_cross_entropy", (p, y01, w6), reduction=red)
        _cmp("binary_cross_entropy_with_logits", (a, y01), reduction=red)
        _cmp("kl_div", (logp, np.abs(b)), reduction=red)
        _cmp("smooth_l1_loss", (a, b), reduction=red, delta=0.7)
        _cmp("margin_ranking_loss", (a[:, 0].copy(), b[:, 0].copy(), pm1),
             reduction=red, margin=0.3)
        _cmp("sigmoid_focal_loss", (a, y01), reduction=red)
        _cmp("hinge_embedding_loss", (a, np.where(y01 > 0, 1.0, -1.0)
                                      .astype(np.float32)), reduction=red)
        _cmp("cosine_embedding_loss", (a, b, pm1), reduction=red,
             margin=0.1)
        _cmp("triplet_margin_loss", (a, b, b[::-1].copy()), reduction=red)
        _cmp("triplet_margin_loss", (a, b, b[::-1].copy()), reduction=red,
             swap=True, p=1.0)
        _cmp("multi_label_soft_margin_loss", (a, y01), reduction=red)
        _cmp("soft_margin_loss", (a, np.where(y01 > 0, 1.0, -1.0)
                                  .astype(np.float32)), reduction=red)
        _cmp("poisson_nll_loss", (a, np.abs(b)), reduction=red)
        _cmp("poisson_nll_loss", (np.abs(a) + 0.1, np.abs(b) * 3),
             reduction=red, log_input=False, full=True)
        _cmp("gaussian_nll_loss", (a, b, np.abs(b) + 0.1), reduction=red)
        _cmp("gaussian_nll_loss", (a, b, np.abs(b) + 0.1), reduction=red,
             full=True)
        _cmp("huber_loss", (a, b), reduction=red, delta=0.5)
    _cmp("binary_cross_entropy_with_logits", (a, y01, w6), pos_weight=None)
    j = JF.binary_cross_entropy_with_logits(
        paddle.to_tensor(a), paddle.to_tensor(y01), paddle.to_tensor(w6),
        pos_weight=paddle.to_tensor(w6 + 1))
    t = TF.binary_cross_entropy_with_logits(
        torch.from_numpy(a), torch.from_numpy(y01), torch.from_numpy(w6),
        pos_weight=torch.from_numpy(w6 + 1))
    np.testing.assert_allclose(t.numpy(), np.array(j.numpy()), rtol=1e-5)
    _cmp("kl_div", (logp, logp[::-1].copy()), log_target=True)
    _cmp("kl_div", (logp, np.abs(b)), reduction="batchmean")
    _cmp("sigmoid_focal_loss", (a, y01, np.float32(3.0) * np.ones(1, np.float32)))
    _cmp("square_error_cost", (a, b))
    _cmp("log_loss", (p, y01))
    _cmp("triplet_margin_with_distance_loss", (a, b, b[::-1].copy()))
    cos = np.tanh(a)
    _cmp("margin_cross_entropy", (cos, np.array([1, 5, 0, 3], np.int64)))
    _cmp("margin_cross_entropy", (cos, np.array([1, 5, 0, 3], np.int64)),
         return_softmax=True, reduction="none", margin2=0.3, scale=16.0)


def test_unported_losses_name_their_slice():
    x = torch.zeros(2, 3)
    # the sequence losses are ported: finite on uniform logits
    lens = torch.ones(2, dtype=torch.long)
    assert torch.isfinite(TF.ctc_loss(torch.zeros(3, 2, 3), lens[:, None],
                                      3 * lens, lens))
    assert torch.isfinite(TF.rnnt_loss(torch.zeros(2, 2, 2, 3),
                                       lens[:, None], lens, lens))
    with pytest.raises(NotImplementedError, match="A10"):
        TF.margin_cross_entropy(x, torch.zeros(2, dtype=torch.long),
                                group=object())
    with pytest.raises(NotImplementedError, match="A10"):
        TF.class_center_sample(x, 10, 4)


def test_pad_and_resizes():
    r = np.random.RandomState(2)
    x = r.randn(2, 3, 6, 7).astype(np.float32)
    for mode in ("constant", "reflect", "replicate", "circular"):
        _cmp("pad", (x, [1, 2, 0, 1]), mode=mode)
        _cmp("pad", (x, [1, 2, 2, 1]), mode=mode, value=0.5)
    _cmp("pad", (x, [0, 0, 1, 1, 2, 0, 1, 3]), value=2.0)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _cmp("pad", (xl, [1, 2, 0, 1]), data_format="NHWC")
    _cmp("zeropad2d", (x, [1, 0, 2, 1]))
    for size in ((12, 14), (3, 4), (5, 9), (8, 5)):
        for mode in ("nearest", "area", "bilinear", "bicubic"):
            _cmp("interpolate", (x,), 1e-4, size=size, mode=mode)
        _cmp("interpolate", (x,), 1e-4, size=size, mode="bilinear",
             align_corners=True)
    _cmp("interpolate", (x,), 1e-4, scale_factor=1.5, mode="bilinear")
    _cmp("interpolate", (x,), 1e-4, scale_factor=[2, 0.5], mode="nearest")
    x3 = r.randn(1, 2, 4, 5, 6).astype(np.float32)
    _cmp("interpolate", (x3,), 1e-4, size=(6, 3, 9), mode="trilinear")
    x1 = r.randn(2, 3, 7).astype(np.float32)
    _cmp("upsample", (x1,), 1e-4, size=11, mode="linear")


def test_shuffles_folds_and_the_rest():
    r = np.random.RandomState(3)
    x = r.randn(2, 8, 6, 4).astype(np.float32)
    _cmp("pixel_shuffle", (x,), upscale_factor=2)
    _cmp("pixel_unshuffle", (x,), downscale_factor=2)
    _cmp("channel_shuffle", (x,), groups=4)
    _cmp("unfold", (x, [3, 2]), strides=[1, 2], paddings=1, dilations=1)
    cols = r.randn(2, 8 * 6, 12).astype(np.float32)
    _cmp("fold", (cols, [7, 6], [3, 2]), strides=[2, 2], paddings=[1, 0])
    a, b = r.randn(4, 5).astype(np.float32), r.randn(4, 5).astype(np.float32)
    _cmp("cosine_similarity", (a, b))
    _cmp("cosine_similarity", (x, x[::-1].copy()), axis=2)
    w = r.randn(3, 5, 5).astype(np.float32)
    _cmp("bilinear", (a, b, w, r.randn(3).astype(np.float32)))
    onehot = np.eye(5, dtype=np.float32)[[0, 2, 4, 1]]
    _cmp("label_smooth", (onehot,), epsilon=0.2)
    _cmp("label_smooth", (onehot,),
         prior_dist=np.full((1, 5), 0.2, np.float32))
    _cmp("one_hot", (np.array([0, 3, 1], np.int64),), num_classes=4)
    theta = r.randn(2, 2, 3).astype(np.float32)
    for align in (True, False):
        _cmp("affine_grid", (theta, [2, 3, 5, 6]), align_corners=align)
    img = r.randn(2, 3, 5, 6).astype(np.float32)
    grid = (r.rand(2, 4, 7, 2) * 2.6 - 1.3).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        for pm in ("zeros", "border", "reflection"):
            for align in (True, False):
                _cmp("grid_sample", (img, grid), mode=mode,
                     padding_mode=pm, align_corners=align)


def test_dropouts_from_an_explicit_generator():
    x = torch.ones(64, 16, 3, 3)
    g = torch.Generator().manual_seed(0)
    y = TF.dropout2d(x, p=0.25, generator=g)
    per_channel = y.reshape(64, 16, 9)
    assert bool(((per_channel == 0).all(-1)
                 | (per_channel == 1 / 0.75).all(-1)).all())
    kept = float((per_channel[..., 0] != 0).float().mean())
    assert abs(kept - 0.75) < 0.05
    y2 = TF.dropout2d(x, p=0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert torch.equal(TF.dropout2d(x, p=0.25, training=False), x)
    assert TF.dropout3d(torch.ones(4, 8, 2, 2, 2), p=0.5,
                        generator=g).reshape(4, 8, 8).std(-1).max() == 0
    z = torch.randn(200000, generator=torch.Generator().manual_seed(1))
    a = TF.alpha_dropout(z, p=0.2, generator=g)
    # the JAX package's affine map: mean 0, variance 1 - p^2 alpha'^2 /
    # (1 - p + p alpha'^2) for a standard-normal input
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    var = 1 - 0.04 * alpha_p ** 2 / (0.8 + 0.2 * alpha_p ** 2)
    assert abs(float(a.mean())) < 0.01
    assert abs(float(a.std()) - var ** 0.5) < 0.01
    assert torch.equal(TF.alpha_dropout(z, p=0.2, training=False), z)
