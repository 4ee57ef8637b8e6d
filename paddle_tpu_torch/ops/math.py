"""Elementwise math and reductions (counterpart of
``paddle_tpu/ops/math.py``): thin functions over torch with Paddle's
signatures (``axis=``, ``keepdim=``, ``dtype=``).

Where Paddle's meaning is not torch's, the function holds to the JAX
package's: ``std``/``var`` with ``unbiased``; integer ``divide`` in the
default float dtype, ``floor_divide`` rounding down and ``remainder``
taking the divisor's sign; ``median`` averaging the two middle values;
``cummax``/``cummin`` keeping the earlier index of a tie; ``argmax``
with an index ``dtype``. Integer operands of the transcendental
functions give torch's float32 where the JAX package, running with
64-bit types, gives float64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.tensor import to_tensor
from .registry import register_op

__all__: list = []


def _export(name, fn, methods=(), differentiable=True, amp=True):
    op = register_op(name, fn, methods=methods,
                     differentiable=differentiable, tags=("math",), amp=amp)
    globals()[name] = op
    __all__.append(name)
    return op


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def _item(v):
    return v.item() if torch.is_tensor(v) else v


def _axis(axis):
    """``None`` (every axis), an int or a tuple of ints."""
    if axis is None:
        return None
    if torch.is_tensor(axis):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """Reduction dims for torch: every axis for ``None``."""
    ax = _axis(axis)
    if ax is None:
        return tuple(range(x.ndim))
    return ax if isinstance(ax, tuple) else (ax,)


# ---------------------------------------------------------------- unary
_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "sigmoid": torch.sigmoid, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "trunc": torch.trunc, "sign": torch.sign,
    "reciprocal": lambda a: 1.0 / a, "square": torch.square,
    "erf": torch.erf, "erfinv": torch.erfinv, "digamma": torch.digamma,
    "lgamma": torch.lgamma, "neg": torch.neg, "conj": torch.conj_physical,
    "angle": torch.angle, "frac": lambda a: a - torch.trunc(a),
    "i0": torch.i0, "i1": torch.special.i1,
}


def _make_unary(name, tfn):
    def op(x, name=None):
        return tfn(_t(x))

    op.__name__ = name
    return op


for _n, _f in _UNARY.items():
    _export(_n, _make_unary(_n, _f), methods=[_n])


# --------------------------------------------------------------- binary
def _make_binary(name, tfn, int_to_float=False, tensor_y=False):
    """``tfn(x, y)`` with a scalar on either side: on the left it becomes
    a 0-d tensor on the other's device (it promotes as a Python scalar
    does), and on the right too where ``tfn`` takes only tensors."""
    def op(x, y, name=None):
        if not torch.is_tensor(x):
            x = torch.as_tensor(x, device=y.device) if torch.is_tensor(y) \
                else to_tensor(x)
        if tensor_y and not torch.is_tensor(y):
            y = torch.as_tensor(y, device=x.device)
        if int_to_float and torch.is_tensor(y) and not (
                x.is_floating_point() or x.is_complex()) and not (
                y.is_floating_point() or y.is_complex()):
            d = to_torch_dtype(get_default_dtype())
            return tfn(x.to(d), y.to(d))
        return tfn(x, y)

    op.__name__ = name
    return op


def _heaviside(x, y):
    # by where, so that the gradient reaches y where x is 0
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.where(x < 0, 0, torch.where(x > 0, 1, y)).to(x.dtype)


def _floor_divide(x, y):
    # torch.floor_divide has no derivative; the floor-rounded division's
    # is 0, as the JAX package's
    return torch.div(x, y, rounding_mode="floor")


#: name -> (torch function, methods, whether y must be a tensor)
_BINARY = {
    "add": (torch.add, ["add", "__add__", "__radd__"], False),
    "subtract": (torch.subtract, ["subtract", "__sub__"], False),
    "multiply": (torch.multiply, ["multiply", "__mul__", "__rmul__"],
                 False),
    "divide": (torch.true_divide, ["divide", "__truediv__"], False),
    "floor_divide": (_floor_divide, ["floor_divide", "__floordiv__"],
                     False),
    "mod": (torch.remainder, ["mod", "__mod__"], False),
    "remainder": (torch.remainder, ["remainder"], False),
    "pow": (torch.pow, ["pow", "__pow__"], False),
    "maximum": (torch.maximum, ["maximum"], True),
    "minimum": (torch.minimum, ["minimum"], True),
    "fmax": (torch.fmax, ["fmax"], True),
    "fmin": (torch.fmin, ["fmin"], True),
    "atan2": (torch.atan2, ["atan2"], True),
    "logaddexp": (torch.logaddexp, ["logaddexp"], True),
    "hypot": (torch.hypot, ["hypot"], True),
    "copysign": (torch.copysign, ["copysign"], True),
    "heaviside": (_heaviside, ["heaviside"], False),
    "gcd": (torch.gcd, ["gcd"], True),
    "lcm": (torch.lcm, ["lcm"], True),
}

for _n, (_f, _methods, _ty) in _BINARY.items():
    _export(_n, _make_binary(_n, _f, int_to_float=_n == "divide",
                             tensor_y=_ty), methods=_methods)


# ---------------------------------------------------- scalar-attr ops
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = _t(x)
    s = _item(scale)
    out = x * s + bias if bias_after_scale else (x + bias) * s
    out = out.to(x.dtype)
    if act is not None:
        out = globals()[act](out)
    return out


_export("scale", scale, methods=["scale"])


def clip(x, min=None, max=None, name=None):
    return torch.clamp(_t(x), _item(min), _item(max))


_export("clip", clip, methods=["clip"])


def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


_export("lerp", lerp, methods=["lerp"])


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * _t(x))


_export("stanh", stanh)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


_export("addmm", addmm)


def multiplex(inputs, index, name=None):
    st = torch.stack(list(inputs), 0)
    rows = torch.arange(st.shape[1], device=st.device)
    return st[index.reshape(-1), rows]


_export("multiplex", multiplex)


# ------------------------------------------------------------ reductions
def _make_reduce(name, tfn, int_promote=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = _t(x)
        if dtype is not None:
            x = x.to(to_torch_dtype(dtype))
        elif int_promote and not (x.is_floating_point() or x.is_complex()
                                  or x.dtype == torch.bool):
            x = x.to(torch.int64)
        return tfn(x, _dims(x, axis), bool(keepdim))

    op.__name__ = name
    return op


def _all(x, dims, keepdim):
    return torch.all(x, dim=dims, keepdim=keepdim) if dims else x.bool()


def _any(x, dims, keepdim):
    return torch.any(x, dim=dims, keepdim=keepdim) if dims else x.bool()


def _prod(x, dims, keepdim):
    for d in sorted((d % builtins.max(x.ndim, 1) for d in dims),
                    reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


_REDUCE = {
    "sum": (lambda x, d, k: torch.sum(x, d, keepdim=k), True),
    "mean": (lambda x, d, k: torch.mean(x, d, keepdim=k), False),
    "prod": (_prod, True),
    "max": (lambda x, d, k: torch.amax(x, d, keepdim=k), False),
    "min": (lambda x, d, k: torch.amin(x, d, keepdim=k), False),
    "amax": (lambda x, d, k: torch.amax(x, d, keepdim=k), False),
    "amin": (lambda x, d, k: torch.amin(x, d, keepdim=k), False),
    "nansum": (lambda x, d, k: torch.nansum(x, d, keepdim=k), True),
    "nanmean": (lambda x, d, k: torch.nanmean(x, d, keepdim=k), False),
    "logsumexp": (lambda x, d, k: torch.logsumexp(x, d, keepdim=k), False),
    "all": (_all, False),
    "any": (_any, False),
}

for _n, (_f, _p) in _REDUCE.items():
    _export(_n, _make_reduce(_n, _f, _p), methods=[_n],
            differentiable=_n not in ("all", "any"))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return (x != 0).sum(_dims(x, axis), keepdim=keepdim).to(torch.int64)


_export("count_nonzero", count_nonzero, differentiable=False, amp=False)


def _arg(tfn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = _t(x)
        if axis is None:
            out = tfn(x.reshape(-1), 0)
        else:
            out = tfn(x, int(axis), keepdim=bool(keepdim))
        return out.to(to_torch_dtype(dtype))
    return op


argmax = _export("argmax", _arg(torch.argmax), methods=["argmax"],
                 differentiable=False, amp=False)
argmin = _export("argmin", _arg(torch.argmin), methods=["argmin"],
                 differentiable=False, amp=False)


def cumsum(x, axis=None, dtype=None, name=None):
    x = _t(x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    # an integer input keeps its dtype
    keep = None if x.dtype == torch.bool else x.dtype
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=keep)
    return torch.cumsum(x, int(axis), dtype=keep)


def cumprod(x, dim=None, dtype=None, name=None):
    x = _t(x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    keep = None if x.dtype == torch.bool else x.dtype
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=keep)
    return torch.cumprod(x, int(dim), dtype=keep)


def _running_arg(tfn, strict):
    """``(values, indices)`` of a running max or min along ``axis`` that
    keeps the earlier index of a tie (torch's keeps the later one)."""
    def op(x, axis=None, dtype="int64", name=None):
        x = _t(x)
        a = x if axis is not None else x.reshape(-1)
        ax = 0 if axis is None else int(axis) % a.ndim
        vals = tfn(a, ax).values
        prev = torch.cat([vals.narrow(ax, 0, 1), vals.narrow(
            ax, 0, a.shape[ax] - 1)], ax)
        pos = torch.arange(a.shape[ax], device=a.device).reshape(
            [-1] + [1] * (a.ndim - ax - 1))
        new = strict(a, prev)
        new.narrow(ax, 0, 1).fill_(True)
        idx = torch.cummax(torch.where(new, pos, 0), ax).values
        return vals, idx.to(to_torch_dtype(dtype))
    return op


_export("cumsum", cumsum, methods=["cumsum"])
_export("cumprod", cumprod, methods=["cumprod"])
_export("cummax", _running_arg(torch.cummax, torch.gt))
_export("cummin", _running_arg(torch.cummin, torch.lt))


def _flat_axes(x, axis):
    """``x`` with the reduced axes moved last and merged, and the axis
    to reduce (``None`` for all); ``keep_shape`` for ``keepdim``."""
    ax = _axis(axis)
    if ax is None or isinstance(ax, int):
        return x, ax
    dims = [a % x.ndim for a in ax]
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(rest + dims)
    return moved.reshape([x.shape[d] for d in rest] + [-1]), -1


def _keep(out, x, axis, keepdim):
    ax = _axis(axis)
    if not keepdim or isinstance(ax, int):
        return out
    dims = range(x.ndim) if ax is None else [a % x.ndim for a in ax]
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    return out.reshape(shape)


def _quantile_op(x, q, axis, keepdim, method, nan=False):
    x = _t(x)
    fn = torch.nanquantile if nan else torch.quantile
    flat, ax = _flat_axes(x, axis)
    qq = torch.as_tensor(q, dtype=x.dtype, device=x.device) \
        if isinstance(q, (list, tuple)) else float(q)
    if ax is None:
        out = fn(flat.reshape(-1), qq, 0, interpolation=method)
    else:
        out = fn(flat, qq, ax, keepdim=bool(keepdim) and isinstance(
            _axis(axis), int), interpolation=method)
    if isinstance(qq, float):
        return _keep(out, x, axis, keepdim)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile_op(x, 0.5, axis, keepdim, "linear")


def quantile(x, q, axis=None, keepdim=False, name=None,
             interpolation="linear"):
    return _quantile_op(x, q, axis, keepdim, interpolation)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


_export("median", median, methods=["median"])
_export("quantile", quantile)
_export("std", std, methods=["std"])
_export("var", var, methods=["var"])


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    v, i = torch.kthvalue(_t(x), int(k), int(axis), keepdim=keepdim)
    return v, i


_export("kthvalue", kthvalue)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, int(axis1), int(axis2)).sum(-1)


_export("trace", trace, methods=["trace"])


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(_t(x), nan=nan, posinf=posinf, neginf=neginf)


_export("nan_to_num", nan_to_num, methods=["nan_to_num"])


def increment(x, value=1.0, name=None):
    """``x += value`` in place (torch refuses it for a leaf that requires
    a gradient, where the JAX package rebinds the tensor)."""
    return x.add_(value)


_export("increment", increment)
increment_ = register_op("increment_", increment, inplace_of="increment",
                         tags=("math", "inplace"))


def outer(x, y, name=None):
    return torch.outer(_t(x).reshape(-1), _t(y).reshape(-1))


def inner(x, y, name=None):
    return torch.inner(_t(x), _t(y))


_export("outer", outer, methods=["outer"])
_export("inner", inner, methods=["inner"])


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


_export("broadcast_shape", broadcast_shape, differentiable=False, amp=False)
