"""Parity of the port's convolution and pooling functionals
(``paddle_tpu_torch.nn.functional.conv`` / ``pooling``) with the JAX
package's, on the same numpy inputs from a seed.

- Convolutions in f32: every padding form of ``_padding`` (int, per-dim
  ints, flat and nested pairs, ``"SAME"`` and ``"VALID"``) at strides 1
  and 2 (``"SAME"`` at stride 2 pads unevenly, the extra row high), with
  dilation, groups and channel-last layouts, 1-3 d; transposes with
  pairs, ``output_padding``, groups, dilation and channel-last; the
  gradients of x and w. Within 1e-4 absolute (f32 sums in another
  order). A transpose's ``"SAME"`` raises in both packages.
- Under O1 the census of one conv2d and one conv2d_transpose is the
  JAX package's, exactly.
- Pooling: avg and max in 1-3 d with ``ceil_mode``, ``exclusive`` and
  channel-last (1e-5; a window wholly in the padding is NaN in both);
  ``return_mask`` indices equal exactly, ties included; adaptive bins
  even and uneven; ``max_unpool`` of the indices; padding with
  ``return_mask`` and channel-last adaptive pooling raise in both.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

CONV_TOL = 1e-4
POOL_TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _both(jf, tf, arrays, **kw):
    j = jf(*[None if a is None else paddle.to_tensor(a) for a in arrays],
           **kw)
    t = tf(*[None if a is None else torch.from_numpy(a) for a in arrays],
           **kw)
    return j, t


def _close(j, t, tol, what):
    a = np.asarray(j.numpy())
    b = t.detach().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=tol, rtol=0, equal_nan=True,
                               err_msg=str(what))


def _check(jf, tf, arrays, tol, **kw):
    j, t = _both(jf, tf, arrays, **kw)
    _close(j, t, tol, kw)


def test_conv2d_every_padding_form():
    r = _rng()
    x = r.randn(2, 4, 9, 10).astype(np.float32)
    w = r.randn(6, 4, 3, 3).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    for pad in (0, 1, [1, 2], [1, 0, 2, 1], [(1, 0), (2, 1)], "SAME",
                "same", "VALID"):
        for stride in (1, 2):
            _check(JF.conv2d, TF.conv2d, (x, w, b), CONV_TOL, stride=stride,
                   padding=pad)


def test_conv_same_dilation_groups_and_channel_last():
    r = _rng(1)
    x = r.randn(2, 4, 9, 10).astype(np.float32)
    w = r.randn(6, 4, 3, 3).astype(np.float32)
    _check(JF.conv2d, TF.conv2d, (x, w, None), CONV_TOL, stride=2,
           padding="SAME", dilation=2)
    _check(JF.conv2d, TF.conv2d, (x, r.randn(6, 2, 3, 3).astype(np.float32),
                                  None), CONV_TOL, padding=1, groups=2)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _check(JF.conv2d, TF.conv2d, (xl, w, None), CONV_TOL, stride=2,
           padding="SAME", data_format="NHWC")
    x1 = r.randn(2, 4, 11).astype(np.float32)
    w1 = r.randn(5, 4, 3).astype(np.float32)
    _check(JF.conv1d, TF.conv1d, (x1, w1, None), CONV_TOL, stride=2,
           padding="SAME")
    _check(JF.conv1d, TF.conv1d,
           (np.ascontiguousarray(x1.transpose(0, 2, 1)), w1, None), CONV_TOL,
           stride=2, padding=1, data_format="NLC")
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    w3 = r.randn(3, 2, 3, 3, 3).astype(np.float32)
    _check(JF.conv3d, TF.conv3d, (x3, w3, None), CONV_TOL, stride=2,
           padding="SAME")
    _check(JF.conv3d, TF.conv3d,
           (np.ascontiguousarray(x3.transpose(0, 2, 3, 4, 1)), w3, None),
           CONV_TOL, padding=1, data_format="NDHWC")


def test_conv_transpose_forms():
    r = _rng(2)
    x = r.randn(2, 4, 9, 10).astype(np.float32)
    w = r.randn(4, 6, 3, 3).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    for pad in (0, 1, [1, 2], [(1, 0), (2, 1)], "VALID"):
        for stride, out_pad in ((1, 0), (2, 0), (2, 1)):
            _check(JF.conv2d_transpose, TF.conv2d_transpose, (x, w, b),
                   CONV_TOL, stride=stride, padding=pad,
                   output_padding=out_pad)
    _check(JF.conv2d_transpose, TF.conv2d_transpose,
           (x, r.randn(4, 3, 3, 3).astype(np.float32), b), CONV_TOL,
           stride=2, padding=1, groups=2)
    _check(JF.conv2d_transpose, TF.conv2d_transpose, (x, w, b), CONV_TOL,
           stride=2, padding=[(2, 1), (0, 3)], dilation=2, output_padding=1)
    _check(JF.conv2d_transpose, TF.conv2d_transpose,
           (np.ascontiguousarray(x.transpose(0, 2, 3, 1)), w, b), CONV_TOL,
           stride=2, padding=1, data_format="NHWC")
    x1 = r.randn(2, 4, 11).astype(np.float32)
    _check(JF.conv1d_transpose, TF.conv1d_transpose,
           (x1, r.randn(4, 5, 3).astype(np.float32), None), CONV_TOL,
           stride=2, padding=1)
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    _check(JF.conv3d_transpose, TF.conv3d_transpose,
           (x3, r.randn(2, 3, 3, 3, 3).astype(np.float32), None), CONV_TOL,
           stride=2, padding=1)


def test_conv_transpose_same_raises_in_both():
    r = _rng(3)
    x = r.randn(1, 2, 5, 5).astype(np.float32)
    w = r.randn(2, 3, 3, 3).astype(np.float32)
    with pytest.raises(ValueError, match="String padding"):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            stride=2, padding="SAME")
    with pytest.raises(ValueError, match="String padding"):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, padding="SAME")


def test_conv_gradients():
    r = _rng(4)
    x = r.randn(2, 3, 8, 9).astype(np.float32)
    w = r.randn(5, 3, 3, 3).astype(np.float32)
    wt = r.randn(3, 5, 3, 3).astype(np.float32)
    for fj, ft, ww, kw in ((JF.conv2d, TF.conv2d, w,
                            dict(stride=2, padding="SAME")),
                           (JF.conv2d_transpose, TF.conv2d_transpose, wt,
                            dict(stride=2, padding=1, output_padding=1))):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jw = paddle.to_tensor(ww, stop_gradient=False)
        (fj(jx, jw, **kw) ** 2).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(ww).requires_grad_()
        (ft(tx, tw, **kw) ** 2).sum().backward()
        # gradients of a squared sum: larger values, f32 sums of 27-45
        # terms in another order
        _close(jx.grad, tx.grad, 1e-3, "dx")
        _close(jw.grad, tw.grad, 1e-3, "dw")


def test_conv_o1_census_matches_jax():
    r = _rng(5)
    x = r.randn(1, 3, 6, 6).astype(np.float32)
    w = r.randn(4, 3, 3, 3).astype(np.float32)
    wt = r.randn(4, 2, 3, 3).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    hooked = ("conv2d", "conv2d_transpose")
    jdbg.enable_operator_stats_collection()
    try:
        with paddle.amp.auto_cast(level="O1"):
            y = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                          paddle.to_tensor(b), padding=1)
            JF.conv2d_transpose(y, paddle.to_tensor(wt))
        jc = {k: v for k, v in jdbg._op_stats["counts"].items()
              if k.split("<")[0] in hooked}
    finally:
        jdbg.disable_operator_stats_collection()
    tdbg.enable_operator_stats_collection()
    try:
        with tamp.auto_cast(level="O1"):
            y = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), padding=1)
            assert y.dtype == torch.bfloat16
            TF.conv2d_transpose(y, torch.from_numpy(wt))
        tc = dict(tdbg._op_stats["counts"])
    finally:
        tdbg.disable_operator_stats_collection()
    assert tc == jc == {"conv2d<bfloat16>": 3,
                        "conv2d_transpose<bfloat16>": 2}


def test_avg_and_max_pooling():
    r = _rng(6)
    x = r.randn(2, 3, 9, 10).astype(np.float32)
    cases = ((3, 2, 1, False), (3, 2, 1, True), (2, None, 0, False),
             (3, 2, 0, True), (3, 1, [1, 0], False),
             (2, 2, [(1, 0), (0, 1)], True))
    for k, s, p, c in cases:
        kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=c)
        for ex in (True, False):
            _check(JF.avg_pool2d, TF.avg_pool2d, (x,), POOL_TOL,
                   exclusive=ex, **kw)
        _check(JF.max_pool2d, TF.max_pool2d, (x,), POOL_TOL, **kw)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for jf, tf in ((JF.max_pool2d, TF.max_pool2d),
                   (JF.avg_pool2d, TF.avg_pool2d)):
        _check(jf, tf, (xl,), POOL_TOL, kernel_size=3, stride=2, padding=1,
               data_format="NHWC")
    x1 = r.randn(2, 3, 11).astype(np.float32)
    _check(JF.avg_pool1d, TF.avg_pool1d, (x1,), POOL_TOL, kernel_size=3,
           stride=2, padding=1, ceil_mode=True)
    _check(JF.max_pool1d, TF.max_pool1d, (x1,), POOL_TOL, kernel_size=3,
           stride=2, padding=1)
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    _check(JF.avg_pool3d, TF.avg_pool3d, (x3,), POOL_TOL, kernel_size=2,
           stride=2, padding=1, exclusive=False)
    _check(JF.max_pool3d, TF.max_pool3d, (x3,), POOL_TOL, kernel_size=3,
           stride=2, padding=1, ceil_mode=True)


def test_return_mask_indices_and_unpool_exact():
    r = _rng(7)
    ties = r.randint(0, 4, (2, 3, 8, 9)).astype(np.float32)
    for k, s in ((2, 2), (3, 2), (3, 1)):
        (jo, ji), (to, ti) = _both(JF.max_pool2d, TF.max_pool2d, (ties,),
                                   kernel_size=k, stride=s, return_mask=True)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo.numpy()))
        assert ti.dtype == torch.int64
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
        ju, tu = _both(JF.max_unpool2d, TF.max_unpool2d,
                       (np.array(jo.numpy()), np.array(ji.numpy())),
                       kernel_size=k, stride=s)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju.numpy()))
    x1 = r.randn(2, 3, 11).astype(np.float32)
    (jo, ji), (to, ti) = _both(JF.max_pool1d, TF.max_pool1d, (x1,),
                               kernel_size=2, return_mask=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
    ju, tu = _both(JF.max_unpool1d, TF.max_unpool1d,
                   (np.array(jo.numpy()), np.array(ji.numpy())),
                   kernel_size=2)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju.numpy()))
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    (jo, ji), (to, ti) = _both(JF.max_pool3d, TF.max_pool3d, (x3,),
                               kernel_size=2, return_mask=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
    ju, tu = _both(JF.max_unpool3d, TF.max_unpool3d,
                   (np.array(jo.numpy()), np.array(ji.numpy())),
                   kernel_size=2, output_size=[5, 6, 7])
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju.numpy()))


def test_return_mask_with_padding_raises_in_both():
    x = _rng(8).randn(1, 1, 4, 4).astype(np.float32)
    with pytest.raises(NotImplementedError, match="padding=0"):
        JF.max_pool2d(paddle.to_tensor(x), 2, padding=1, return_mask=True)
    with pytest.raises(NotImplementedError, match="padding=0"):
        TF.max_pool2d(torch.from_numpy(x), 2, padding=1, return_mask=True)


def test_adaptive_pooling_bins():
    r = _rng(9)
    x = r.randn(2, 3, 9, 10).astype(np.float32)
    for size in (1, (3, 5), (4, 3), (5, 7), (9, 10)):
        _check(JF.adaptive_avg_pool2d, TF.adaptive_avg_pool2d, (x,),
               POOL_TOL, output_size=size)
        _check(JF.adaptive_max_pool2d, TF.adaptive_max_pool2d, (x,),
               POOL_TOL, output_size=size)
    _check(JF.adaptive_avg_pool1d, TF.adaptive_avg_pool1d,
           (r.randn(2, 3, 11).astype(np.float32),), POOL_TOL, output_size=4)
    _check(JF.adaptive_max_pool3d, TF.adaptive_max_pool3d,
           (r.randn(1, 2, 5, 6, 7).astype(np.float32),), POOL_TOL,
           output_size=(2, 3, 4))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    with pytest.raises(NotImplementedError, match="NCHW"):
        JF.adaptive_avg_pool2d(paddle.to_tensor(xl), 2, data_format="NHWC")
    with pytest.raises(NotImplementedError, match="NCHW"):
        TF.adaptive_avg_pool2d(torch.from_numpy(xl), 2, data_format="NHWC")
