"""The port's indexing and autograd API against the JAX package's.

Indexing is torch's (the port has no ``ops/indexing.py``): basic
slices, integer-tensor and list indexing, boolean-mask reads and writes,
each held to the JAX package's ``__getitem__``/``__setitem__`` on the
same numpy input (values exact, gradients within 1e-6). ``grad`` keeps
Paddle's rules (``create_graph`` double gradients, ``retain_graph``,
``allow_unused``, ``no_grad_vars``, no ``.grad`` touched) and ``PyLayer``
takes Paddle's context, each held to the JAX package within 1e-5 of the
largest value. The in-place ops that torch refuses on a leaf that
requires a gradient, where the JAX package rebinds the tensor, are
pinned."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core.place import device_guard

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(
        t.numpy())


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max(initial=0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0)) <= tol * scale


_X = np.random.RandomState(0).randn(4, 5).astype(np.float32)
_MASK = np.random.RandomState(1).rand(4, 5) > 0.5


def _wrap(P, a):
    return a if P is np else P.to_tensor(a)


#: name -> the index, built with the package P
_INDEX = {
    "basic": lambda P: (1, slice(None), None),
    "slices": lambda P: (slice(1, 3), slice(None, None, 2)),
    "negative": lambda P: -1,
    "ellipsis": lambda P: (Ellipsis, 2),
    "int_tensor": lambda P: P.to_tensor(np.array([3, 0, 0])),
    "int_tensor_cols": lambda P: (slice(None),
                                  P.to_tensor(np.array([4, 1]))),
    "list": lambda P: [0, 2],
    "pair": lambda P: (P.to_tensor(np.array([0, 3])),
                       P.to_tensor(np.array([4, 2]))),
    "bool_rows": lambda P: _wrap(P, np.array([True, False, True, True])),
    "bool_mask": lambda P: _wrap(P, _MASK),
}


def _getitem_case(kind):
    xj = jp.to_tensor(_X, stop_gradient=False)
    xt = tp.to_tensor(_X, stop_gradient=False)
    oj, ot = xj[_INDEX[kind](jp)], xt[_INDEX[kind](tp)]
    np.testing.assert_array_equal(_np(ot), _np(oj))
    w = np.random.RandomState(2).randn(*_np(oj).shape).astype(np.float32)
    (oj * jp.to_tensor(w)).sum().backward()
    (ot * tp.to_tensor(w)).sum().backward()
    if kind.startswith("bool"):
        # the JAX package reads a boolean mask on the host, outside its
        # tape: the port's gradient is held to the scatter of w instead
        assert xj.grad is None
        want = np.zeros_like(_X)
        want[np.asarray(_INDEX[kind](np))] = w
        np.testing.assert_array_equal(_np(xt.grad), want)
        return
    _close(xt.grad, xj.grad, 1e-6)


@pytest.mark.parametrize("kinds", [
    ("basic", "slices", "negative", "ellipsis"),
    ("int_tensor", "int_tensor_cols", "list", "pair"),
    ("bool_rows", "bool_mask")], ids=["basic", "integer", "bool"])
def test_getitem_matches_jax(kinds):
    for kind in kinds:
        _getitem_case(kind)


def test_setitem_matches_jax():
    """A write into a non-leaf: the written values and the gradient that
    reaches the input (zero where overwritten)."""
    for kind in ("slices", "int_tensor", "bool_rows", "bool_mask", "pair"):
        _setitem_case(kind)


def _setitem_case(kind):
    out = {}
    for P in (jp, tp):
        x = P.to_tensor(_X, stop_gradient=False)
        y = x * 2.0
        y[_INDEX[kind](P)] = 0.5
        w = P.to_tensor(np.random.RandomState(3).randn(4, 5)
                        .astype(np.float32))
        (y * w).sum().backward()
        out[P] = (_np(y), _np(x.grad))
    np.testing.assert_array_equal(out[tp][0], out[jp][0])
    np.testing.assert_allclose(out[tp][1], out[jp][1], rtol=0, atol=1e-6)


def test_grad_matches_jax():
    a0 = np.array([0.5, -1.5, 2.0], np.float32)
    res = {}
    for P in (jp, tp):
        a = P.to_tensor(a0, stop_gradient=False)
        b = P.to_tensor(a0[::-1].copy(), stop_gradient=False)
        y = P.sum(a ** 3 * b)
        (ga, gb) = P.grad(y, [a, b], create_graph=True)
        (gaa,) = P.grad(P.sum(ga), a)
        assert a.grad is None and b.grad is None
        res[P] = (ga, gb, gaa)
    for g, w in zip(res[tp], res[jp]):
        _close(g, w)


def test_grad_rules():
    a = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    b = tp.to_tensor([3.0, 4.0], stop_gradient=False)
    y = (a * a).sum()
    with pytest.raises(RuntimeError, match="allow_unused=True"):
        tp.grad(y, [a, b], retain_graph=True)
    ga, gb = tp.grad(y, [a, b], allow_unused=True)
    assert gb is None and torch.equal(ga, 2 * a.detach())
    # retain_graph defaults to create_graph: the graph is freed
    with pytest.raises(RuntimeError):
        tp.grad(y, [a])
    # no gradient flows back through no_grad_vars: held to the JAX
    # package's gradient with that tensor cut out of the tape
    a0 = np.array([0.5, 2.0], np.float32)
    res = {}
    for P in (jp, tp):
        x = P.to_tensor(a0, stop_gradient=False)
        h = x * 3.0
        if P is jp:
            h = h.detach()
            h.stop_gradient = False
            res[P] = P.grad(P.sum(h * x), [x])[0]
        else:
            res[P] = P.grad(P.sum(h * x), [x], no_grad_vars=[h])[0]
    _close(res[tp], res[jp])


def test_grad_mode_switches():
    x = tp.to_tensor([1.0], stop_gradient=False)
    with tp.no_grad():
        assert not tp.is_grad_enabled()
        assert not (x * 2).requires_grad
        with tp.enable_grad():
            assert (x * 2).requires_grad
    with tp.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    assert tp.is_grad_enabled()

    @tp.no_grad()
    def f(v):
        return v * 2
    assert not f(x).requires_grad
    y = tp.to_tensor([2.0], stop_gradient=False)
    tp.autograd.backward([(x * y).sum()], [tp.to_tensor(3.0)])
    assert float(x.grad) == 6.0 and float(y.grad) == 3.0


def _cube_layer(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, scale=1.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale + k * 0.0

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3.0 * x * x * ctx.scale, None
    return Cube


def test_pylayer_matches_jax():
    x0 = np.array([0.5, -1.0, 2.0], np.float32)
    res = {}
    for P in (jp, tp):
        x = P.to_tensor(x0, stop_gradient=False)
        k = P.to_tensor(x0, stop_gradient=False)
        y = _cube_layer(P).apply(x, k, scale=2.0)
        P.sum(y * P.to_tensor(x0)).backward()
        res[P] = (y, x.grad)
        assert k.grad is None or float(P.sum(k.grad * k.grad)) == 0.0
    for g, w in zip(res[tp], res[jp]):
        _close(g, w)
    assert issubclass(_cube_layer(tp), torch.autograd.Function)


def test_inplace_ops_on_leaves():
    """torch refuses an in-place op on a leaf that requires a gradient,
    where the JAX package rebinds the tensor; on a tensor that stops the
    gradient, each matches the JAX result."""
    leaf = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    for op in (lambda t: tp.increment(t), lambda t: tp.reshape_(t, [2, 1]),
               lambda t: tp.uniform_(t), lambda t: tp.normal_(t),
               lambda t: tp.exponential_(t), lambda t: tp.assign(
                   tp.to_tensor([5.0, 6.0]), output=t)):
        with pytest.raises(RuntimeError, match="leaf Variable"):
            op(leaf)
    for P in (jp, tp):
        t = P.to_tensor(np.array([1.0, 2.0], np.float32))
        P.increment(t, 0.5)
        P.assign(P.to_tensor(np.array([7.0, 8.0], np.float32)), output=t)
        P.reshape_(t, [2, 1])
        res = _np(t)
        if P is jp:
            want = res
    np.testing.assert_array_equal(res, want)
    with tp.no_grad():
        tp.uniform_(leaf, 0.0, 1.0)
    assert leaf.requires_grad and 0.0 <= float(leaf.detach().min())
