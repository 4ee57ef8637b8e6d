"""Parity of the port's normalization and activation functionals
(``paddle_tpu_torch.nn.functional.norm`` / ``activation``) with the JAX
package's, on the same numpy inputs from a seed, in f32.

- ``batch_norm`` in training: the output and its gradients through the
  batch mean and variance, and the running statistics after 3 steps
  (``m * old + (1 - m) * batch``, the unbiased variance), NCHW and NHWC;
  in eval and with ``use_global_stats`` the running statistics
  normalize and stay. 1e-5 on outputs and statistics, 1e-4 on
  gradients (f32 sums in another order).
- ``layer_norm``, ``group_norm``, ``instance_norm``, ``rms_norm``,
  ``local_response_norm``, ``normalize``: 1e-5.
- Every activation of the JAX file at its defaults and at other
  arguments: 1e-6 absolute and relative (the same formulas; an f32 ulp
  of the larger values); ``rrelu`` in eval takes the mean
  slope as the JAX package does, in training the port draws its slopes
  from an explicit generator (in range, reproducible).
"""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)


def _np(t):
    return np.array(t.numpy()) if not torch.is_tensor(t) else \
        t.detach().numpy()


def _close(a, b, tol, what="", rtol=0.0):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=tol, rtol=rtol, err_msg=str(what))


def test_batch_norm_training_three_steps_and_gradients():
    r = np.random.RandomState(0)
    for fmt, shape in (("NCHW", (4, 3, 5, 6)), ("NHWC", (4, 5, 6, 3))):
        w = r.rand(3).astype(np.float32) + 0.5
        b = r.randn(3).astype(np.float32)
        jm, jv = paddle.to_tensor(np.zeros(3, np.float32)), \
            paddle.to_tensor(np.ones(3, np.float32))
        tm, tv = torch.zeros(3), torch.ones(3)
        for step in range(3):
            x = (r.randn(*shape) * (step + 1) + step).astype(np.float32)
            jx = paddle.to_tensor(x, stop_gradient=False)
            jw = paddle.to_tensor(w, stop_gradient=False)
            jy = JF.batch_norm(jx, jm, jv, jw, paddle.to_tensor(b),
                               training=True, momentum=0.8,
                               data_format=fmt)
            (jy ** 3).sum().backward()
            tx = torch.from_numpy(x).requires_grad_()
            tw = torch.from_numpy(w.copy()).requires_grad_()
            ty = TF.batch_norm(tx, tm, tv, tw, torch.from_numpy(b),
                               training=True, momentum=0.8, data_format=fmt)
            (ty ** 3).sum().backward()
            _close(jy, ty, 1e-5, (fmt, step, "out"))
            _close(jx.grad, tx.grad, 1e-4, (fmt, step, "dx"))
            _close(jw.grad, tw.grad, 1e-3, (fmt, step, "dw"))
            _close(jm, tm, 1e-5, (fmt, step, "mean"))
            _close(jv, tv, 1e-5, (fmt, step, "var"))
        x = r.randn(*shape).astype(np.float32)
        for kw in (dict(training=False), dict(training=True,
                                              use_global_stats=True)):
            jy = JF.batch_norm(paddle.to_tensor(x), jm, jv,
                               paddle.to_tensor(w), paddle.to_tensor(b),
                               data_format=fmt, **kw)
            before = tm.clone()
            ty = TF.batch_norm(torch.from_numpy(x), tm, tv,
                               torch.from_numpy(w), torch.from_numpy(b),
                               data_format=fmt, **kw)
            _close(jy, ty, 1e-5, (fmt, kw))
            assert torch.equal(tm, before)


def test_other_norms():
    r = np.random.RandomState(1)
    x = r.randn(2, 6, 4, 5).astype(np.float32)
    w = r.randn(6).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    J, T = paddle.to_tensor, torch.from_numpy
    _close(JF.group_norm(J(x), 3, 1e-5, J(w), J(b)),
           TF.group_norm(T(x), 3, 1e-5, T(w), T(b)), 1e-5, "group")
    _close(JF.instance_norm(J(x), weight=J(w), bias=J(b)),
           TF.instance_norm(T(x), weight=T(w), bias=T(b)), 1e-5, "inst")
    _close(JF.instance_norm(J(x)), TF.instance_norm(T(x)), 1e-5, "inst2")
    x2 = r.randn(3, 7, 8).astype(np.float32)
    w8 = r.randn(8).astype(np.float32)
    _close(JF.rms_norm(J(x2), J(w8)), TF.rms_norm(T(x2), T(w8)), 1e-5,
           "rms")
    _close(JF.rms_norm(J(x2)), TF.rms_norm(T(x2)), 1e-5, "rms2")
    _close(JF.layer_norm(J(x2), 8, J(w8), J(w8)),
           TF.layer_norm(T(x2), 8, T(w8), T(w8)), 1e-5, "ln")
    _close(JF.local_response_norm(J(x), 3), TF.local_response_norm(T(x), 3),
           1e-5, "lrn")
    _close(JF.local_response_norm(J(x), 4, 1e-2, 0.5, 2.0),
           TF.local_response_norm(T(x), 4, 1e-2, 0.5, 2.0), 1e-5, "lrn4")
    for p, axis in ((2, 1), (1, -1), (3, 2)):
        _close(JF.normalize(J(x), p=p, axis=axis),
               TF.normalize(T(x), p=p, axis=axis), 1e-5, ("norm", p))


#: (name, kwargs) of the activations compared elementwise
ACTIVATIONS = (
    ("relu", {}), ("relu6", {}), ("gelu", {}), ("gelu", {"approximate":
                                                          True}),
    ("sigmoid", {}), ("log_sigmoid", {}), ("silu", {}), ("swish", {}),
    ("mish", {}), ("softmax", {}), ("softmax", {"axis": 1}),
    ("log_softmax", {}), ("softplus", {}),
    ("softplus", {"beta": 2.0, "threshold": 3.0}), ("softshrink", {}),
    ("hardshrink", {"threshold": 0.3}), ("tanhshrink", {}),
    ("hardsigmoid", {}), ("hardswish", {}), ("hardtanh", {}),
    ("hardtanh", {"min": -0.5, "max": 2.0}), ("leaky_relu", {}),
    ("leaky_relu", {"negative_slope": 0.2}), ("elu", {}),
    ("elu", {"alpha": 0.5}), ("celu", {"alpha": 2.0}), ("selu", {}),
    ("tanh", {}), ("softsign", {}), ("thresholded_relu", {}),
    ("thresholded_relu", {"threshold": 0.5, "value": -1.0}),
    ("glu", {}), ("glu", {"axis": 1}), ("swiglu", {}),
    ("maxout", {"groups": 2}), ("maxout", {"groups": 3, "axis": -1}),
    ("rrelu", {"training": False}),
)


def test_activations():
    r = np.random.RandomState(2)
    x = (r.randn(3, 6, 4, 6) * 3).astype(np.float32)
    for name, kw in ACTIVATIONS:
        _close(getattr(JF, name)(paddle.to_tensor(x), **kw),
               getattr(TF, name)(torch.from_numpy(x), **kw), 1e-6,
               (name, kw), rtol=1e-6)
    y = r.randn(3, 6, 4, 6).astype(np.float32)
    _close(JF.swiglu(paddle.to_tensor(x), paddle.to_tensor(y)),
           TF.swiglu(torch.from_numpy(x), torch.from_numpy(y)), 1e-6)
    for w in (np.array([0.25], np.float32),
              r.rand(6).astype(np.float32)):
        _close(JF.prelu(paddle.to_tensor(x), paddle.to_tensor(w)),
               TF.prelu(torch.from_numpy(x), torch.from_numpy(w)), 1e-6)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = r.rand(6).astype(np.float32)
    _close(JF.prelu(paddle.to_tensor(xl), paddle.to_tensor(w),
                    data_format="NHWC"),
           TF.prelu(torch.from_numpy(xl), torch.from_numpy(w),
                    data_format="NHWC"), 1e-6)


def test_inplace_activations_and_rrelu_draws():
    x = torch.randn(4, 5)
    for name in ("relu_", "tanh_", "elu_", "softmax_"):
        ref = getattr(TF, name[:-1])(x.clone())
        y = x.clone()
        out = getattr(TF, name)(y)
        assert out is y and torch.allclose(y, ref)
    x = -torch.rand(1000) - 0.1
    g = torch.Generator().manual_seed(3)
    a = TF.rrelu(x, 0.1, 0.3, training=True, generator=g)
    slope = a / x
    assert bool((slope >= 0.1).all() and (slope <= 0.3).all())
    assert float(slope.std()) > 0.03
    b = TF.rrelu(x, 0.1, 0.3, training=True,
                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
