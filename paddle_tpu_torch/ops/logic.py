"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/ops/logic.py``). ``where(condition)`` with one argument is
``nonzero(condition, as_tuple=True)``, as in the JAX package; with three
it selects (and is differentiable in ``x`` and ``y``)."""
from __future__ import annotations

import torch

from ..core.tensor import to_tensor
from .registry import register_op

__all__: list = []


def _export(name, fn, methods=(), differentiable=False, amp=False,
            tags=("logic",)):
    op = register_op(name, fn, methods=methods,
                     differentiable=differentiable, tags=tags, amp=amp)
    globals()[name] = op
    __all__.append(name)
    return op


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def _pair(x, y):
    """Two operands with at least one tensor: a scalar on the left
    becomes a 0-d tensor on the other's device."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, device=y.device) if torch.is_tensor(y) \
            else to_tensor(x)
    if not torch.is_tensor(y) and y is not None:
        y = torch.as_tensor(y, device=x.device)
    return x, y


def _make_binary(name, tfn, methods):
    def op(x, y=None, name=None):
        if y is None:
            return tfn(_t(x))
        return tfn(*_pair(x, y))

    op.__name__ = name
    return _export(name, op, methods)


_make_binary("equal", torch.eq, ["equal", "__eq__"])
_make_binary("not_equal", torch.ne, ["not_equal", "__ne__"])
_make_binary("less_than", torch.lt, ["less_than", "__lt__"])
_make_binary("less_equal", torch.le, ["less_equal", "__le__"])
_make_binary("greater_than", torch.gt, ["greater_than", "__gt__"])
_make_binary("greater_equal", torch.ge, ["greater_equal", "__ge__"])
_make_binary("logical_and", torch.logical_and, ["logical_and", "__and__"])
_make_binary("logical_or", torch.logical_or, ["logical_or", "__or__"])
_make_binary("logical_xor", torch.logical_xor, ["logical_xor", "__xor__"])


def logical_not(x, out=None, name=None):
    return torch.logical_not(_t(x))


_export("logical_not", logical_not, ["logical_not", "__invert__"])


def _make_unary(name, tfn):
    def op(x, name=None):
        return tfn(_t(x))

    op.__name__ = name
    return _export(name, op, [name])


for _n, _f in (("isnan", torch.isnan), ("isinf", torch.isinf),
               ("isfinite", torch.isfinite), ("isneginf", torch.isneginf),
               ("isposinf", torch.isposinf), ("isreal", torch.isreal)):
    _make_unary(_n, _f)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _t(x), _t(y)
    return torch.isclose(x, y, float(rtol), float(atol),
                         bool(equal_nan)).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(_t(x), _t(y), float(rtol), float(atol),
                         bool(equal_nan))


def equal_all(x, y, name=None):
    x, y = _t(x), _t(y)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.eq(x, y).all()


def is_empty(x, name=None):
    x = _t(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return torch.is_tensor(x)


for _n in ("allclose", "isclose", "equal_all", "is_empty"):
    _export(_n, globals()[_n], [_n])
_export("is_tensor", is_tensor)


def _make_bitwise(name, tfn):
    def op(x, y=None, out=None, name=None):
        if y is None:
            return tfn(_t(x))
        return tfn(*_pair(x, y))

    op.__name__ = name
    return _export(name, op, [name])


_make_bitwise("bitwise_and", torch.bitwise_and)
_make_bitwise("bitwise_or", torch.bitwise_or)
_make_bitwise("bitwise_xor", torch.bitwise_xor)
_make_bitwise("bitwise_not", torch.bitwise_not)
_make_bitwise("bitwise_left_shift", torch.bitwise_left_shift)
_make_bitwise("bitwise_right_shift", torch.bitwise_right_shift)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .manipulation import nonzero

        return nonzero(condition, as_tuple=True)
    cond = _t(condition).bool()
    if not (torch.is_tensor(x) or torch.is_tensor(y)):
        x = torch.as_tensor(x, device=cond.device)
    return torch.where(cond, x, y)


_export("where", where, ["where"], differentiable=True, amp=True,
        tags=("search",))
