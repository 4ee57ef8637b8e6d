"""The case table of the port's tensor API (``paddle_tpu_torch/ops``),
without JAX: each case is one function of a package ``P`` and its
input arrays (seeded numpy), so the same Paddle code runs on either
package and on either device.

``tests/torch_op_cases.py`` runs every case in the JAX package and in
the port on the CPU and compares them; ``chip_smoke.py``'s
``tensor_api`` check runs every case in the port on the CPU and on the
card. ``compare`` holds one output to another: equal dtypes and shapes,
integers and booleans equal, floats within ``tol`` of the reference's
largest magnitude, NaNs and infinities in the same places. ``post``
maps a case's numpy outputs to what is compared, where a decomposition
is defined only up to signs or order. ``RANDOM_CASES`` holds each random
op to its support and moments.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["CASES", "RANDOM_CASES", "RANDOM_OPS", "RANDOM_N", "Case",
           "compare", "to_numpy", "flat", "check_moments"]

_R = np.random.RandomState(0)



def f(*shape, lo=None):
    a = _R.randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def u(*shape, lo=-0.9, hi=0.9):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def i(*shape, lo=-5, hi=6):
    return _R.randint(lo, hi, shape).astype(np.int64)


def b(*shape):
    return _R.rand(*shape) > 0.5


def spd(n):
    a = _R.randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


class Case:
    def __init__(self, name, fn, *arrays, grad=True, post=None, tol=None):
        self.name = name
        self.op = name.split(":")[0]
        self.fn = fn
        self.arrays = arrays
        self.grad = grad
        self.post = post
        self.tol = tol


CASES: list = []


def C(name, fn, *arrays, **kw):
    CASES.append(Case(name, fn, *arrays, **kw))


def _sorted_complex(outs):
    w = outs[0]
    return [w[np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))]] \
        + list(outs[1:])


def _canon_cols(q, r=None):
    """Columns of ``q`` (rows of ``r``) with the sign that makes each
    column's largest entry positive."""
    s = np.sign(q[np.abs(q).argmax(0), np.arange(q.shape[1])])
    s[s == 0] = 1
    return (q * s, None if r is None else r * s[:, None])


# ------------------------------------------------------------ creation
C("zeros", lambda P: P.zeros([2, 3]))
C("zeros:int", lambda P: P.zeros([2], dtype="int32"))
C("ones", lambda P: P.ones([3, 1], dtype="float64"))
C("full", lambda P: P.full([2, 2], 1.5))
C("full:int", lambda P: P.full([2, 2], 7))
C("empty", lambda P: P.empty([2, 3]) * 0)
C("zeros_like", lambda P, x: P.zeros_like(x), i(2, 3))
C("ones_like", lambda P, x: P.ones_like(x, dtype="float32"), i(2, 3))
C("full_like", lambda P, x: P.full_like(x, 3.0), f(2, 3))
C("empty_like", lambda P, x: P.empty_like(x) * 0, f(2, 3))
C("arange", lambda P: P.arange(7))
C("arange:float", lambda P: P.arange(0.5, 3.0, 0.25))
C("arange:dtype", lambda P: P.arange(1, 9, 2, dtype="int32"))
C("linspace", lambda P: P.linspace(-1, 2, 7))
C("logspace", lambda P: P.logspace(0, 2, 5, base=2.0))
C("eye", lambda P: P.eye(3, 4))
C("tril", lambda P, x: P.tril(x, -1), f(4, 4))
C("triu", lambda P, x: P.triu(x, 1), f(3, 5))
C("diag", lambda P, x: P.diag(x, 1, padding_value=2.0), f(3))
C("diag:matrix", lambda P, x: P.diag(x, -1), f(4, 4))
C("diagflat", lambda P, x: P.diagflat(x, 1), f(2, 2))
# the JAX meshgrid builds its outputs outside its tape (no gradient)
C("meshgrid", lambda P, x, y: P.meshgrid(x, y), f(3), f(2), grad=False)
C("assign", lambda P, x: P.assign(x), f(2, 3))
C("assign:list", lambda P: P.assign([[1.5, 2.5]]))
C("clone", lambda P, x: P.clone(x) * 2, f(3))
C("numel", lambda P, x: P.numel(x), f(3, 4), grad=False)
C("tril_indices", lambda P: P.tril_indices(4, 3, -1))
C("triu_indices", lambda P: P.triu_indices(3, 5, 1))
C("one_hot", lambda P, x: P.one_hot(x, 5), i(2, 3, lo=0, hi=5))

# ---------------------------------------------------------------- unary
for _n in ("exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
           "tanh", "asinh", "sigmoid", "floor", "ceil", "round", "trunc",
           "sign", "square", "erf", "neg", "conj", "angle", "frac", "abs"):
    C(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), f(3, 4) * 2)
for _n in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
           "digamma", "lgamma", "i0", "i1"):
    C(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), f(3, 4, lo=0.3))
for _n in ("asin", "acos", "atanh", "erfinv"):
    C(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), u(3, 4))
C("acosh", lambda P, x: P.acosh(x), f(3, 4, lo=1.2))
C("abs:int", lambda P, x: P.abs(x), i(5))
C("sign:int", lambda P, x: P.sign(x), i(5))
C("conj:complex", lambda P, x: P.conj(P.as_complex(x)), f(3, 2),
  grad=False)
C("angle:complex", lambda P, x: P.angle(P.as_complex(x)), f(3, 2))

# --------------------------------------------------------------- binary
for _n in ("add", "subtract", "multiply", "maximum", "minimum", "atan2",
           "logaddexp", "hypot", "copysign", "fmax", "fmin"):
    C(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n),
      f(3, 4), f(4))
C("divide", lambda P, x, y: P.divide(x, y), f(3, 4), f(3, 4, lo=0.5))
C("divide:int", lambda P, x, y: P.divide(x, y), i(6), i(6, lo=1, hi=4))
C("divide:scalar", lambda P, x: P.divide(x, 4.0), f(5))
C("floor_divide", lambda P, x, y: P.floor_divide(x, y), f(6) * 4,
  f(6, lo=0.5))
C("floor_divide:int", lambda P, x, y: P.floor_divide(x, y),
  np.array([7, -7, 7, -7, 0, 5]), np.array([2, 2, -2, -2, 3, -1]))
C("mod", lambda P, x, y: P.mod(x, y), np.array([7, -7, 7, -7]),
  np.array([3, 3, -3, -3]))
C("mod:float", lambda P, x, y: P.mod(x, y), f(6) * 4, u(6, lo=0.5, hi=2))
C("remainder", lambda P, x, y: P.remainder(x, y),
  np.array([5, -5, 5, -5, 9]), np.array([3, 3, -3, -3, 4]))
C("remainder:float", lambda P, x: P.remainder(x, -1.5), f(6) * 4)
C("pow", lambda P, x: P.pow(x, 3), f(3, 4))
C("pow:tensor", lambda P, x, y: P.pow(x, y), f(3, 4, lo=0.5), f(3, 4))
C("pow:int", lambda P, x: P.pow(x, 2), i(5))
C("add:scalar", lambda P, x: P.add(x, 2.5), f(3))
C("multiply:int", lambda P, x, y: P.multiply(x, y), i(4), i(4))
C("maximum:nan", lambda P, x, y: P.maximum(x, y), grad=False, *(
  np.array([1.0, np.nan, 3.0], np.float32), f(3)))
C("fmax:nan", lambda P, x, y: P.fmax(x, y), grad=False, *(
  np.array([1.0, np.nan, 3.0], np.float32), f(3)))
C("fmin:nan", lambda P, x, y: P.fmin(x, y), grad=False, *(
  np.array([np.nan, 2.0, 3.0], np.float32), f(3)))
C("heaviside", lambda P, x, y: P.heaviside(x, y),
  np.array([-1.0, 0.0, 2.0], np.float32), f(3))
C("gcd", lambda P, x, y: P.gcd(x, y), i(6, lo=-12, hi=13),
  i(6, lo=1, hi=9))
C("lcm", lambda P, x, y: P.lcm(x, y), i(6, lo=1, hi=13), i(6, lo=1, hi=9))

# ---------------------------------------------------- scalar-attr ops
C("scale", lambda P, x: P.scale(x, 2.0, 0.5), f(3, 4))
C("scale:before", lambda P, x: P.scale(x, 2.0, 0.5, bias_after_scale=False,
                                       act="tanh"), f(3, 4))
C("clip", lambda P, x: P.clip(x, -0.5, 0.7), f(3, 4))
C("clip:min", lambda P, x: P.clip(x, min=0.1), f(3, 4))
C("lerp", lambda P, x, y: P.lerp(x, y, 0.3), f(3, 4), f(3, 4))
C("lerp:tensor", lambda P, x, y, w: P.lerp(x, y, w), f(3, 4), f(3, 4),
  u(3, 4, lo=0, hi=1))
C("stanh", lambda P, x: P.stanh(x, 0.5, 1.5), f(3, 4))
C("addmm", lambda P, a, x, y: P.addmm(a, x, y, 0.5, 2.0), f(3, 2),
  f(3, 4), f(4, 2))
C("multiplex", lambda P, x, y, idx: P.multiplex([x, y], idx), f(4, 3),
  f(4, 3), np.array([[0], [1], [1], [0]]))

# ------------------------------------------------------------ reductions
for _n in ("sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
           "nanmean", "logsumexp"):
    C(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), f(3, 4))
    C(_n + ":axis", (lambda n: lambda P, x: getattr(P, n)(
        x, axis=[0, 2], keepdim=True))(_n), f(2, 3, 4))
C("sum:int", lambda P, x: P.sum(x, axis=1), i(3, 4).astype(np.int32))
C("sum:dtype", lambda P, x: P.sum(x, dtype="float64"), f(3, 4))
C("prod:int", lambda P, x: P.prod(x, axis=0), i(3, 4, lo=1, hi=3))
C("nansum:nan", lambda P, x: P.nansum(x, axis=1),
  np.array([[1.0, np.nan], [2.0, 3.0]], np.float32))
C("nanmean:nan", lambda P, x: P.nanmean(x, axis=1),
  np.array([[1.0, np.nan], [2.0, 3.0]], np.float32))
C("all", lambda P, x: P.all(x, axis=1), b(3, 4))
C("all:every", lambda P, x: P.all(x), b(3, 4))
C("any", lambda P, x: P.any(x, axis=0, keepdim=True), b(3, 4))
C("any:every", lambda P, x: P.any(x), b(3, 4))
C("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1), i(3, 4, lo=-1,
                                                              hi=2))
C("argmax", lambda P, x: P.argmax(x, axis=1), f(3, 4))
C("argmax:flat", lambda P, x: P.argmax(x, dtype="int32"), f(3, 4))
C("argmin", lambda P, x: P.argmin(x, axis=0, keepdim=True), f(3, 4))
C("cumsum", lambda P, x: P.cumsum(x, axis=1), f(3, 4))
C("cumsum:flat", lambda P, x: P.cumsum(x), i(3, 4).astype(np.int32))
C("cumprod", lambda P, x: P.cumprod(x, dim=1), f(3, 4))
C("cummax", lambda P, x: P.cummax(x, axis=1), f(3, 6))
C("cummax:ties", lambda P, x: P.cummax(x, axis=0), np.array(
    [1, 3, 3, 2, 5, 5, 4]))
C("cummin", lambda P, x: P.cummin(x, axis=0), f(5, 3))
C("cummin:ties", lambda P, x: P.cummin(x), np.array([[4, 2], [2, 1]]))
C("median", lambda P, x: P.median(x, axis=1), f(3, 4))
C("median:odd", lambda P, x: P.median(x, axis=0, keepdim=True), f(5, 3))
C("median:all", lambda P, x: P.median(x), f(3, 4))
C("quantile", lambda P, x: P.quantile(x, 0.3, axis=1), f(3, 5))
C("quantile:list", lambda P, x: P.quantile(x, [0.25, 0.75]), f(3, 5))
C("std", lambda P, x: P.std(x, axis=1), f(3, 5))
C("std:biased", lambda P, x: P.std(x, unbiased=False), f(3, 5))
C("var", lambda P, x: P.var(x, axis=0, keepdim=True), f(4, 3))
C("var:biased", lambda P, x: P.var(x, axis=[0, 1], unbiased=False),
  f(4, 3, 2))
C("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1), f(3, 5))
C("trace", lambda P, x: P.trace(x, 1), f(4, 4))
C("nan_to_num", lambda P, x: P.nan_to_num(x, 0.5, 9.0, -9.0), np.array(
    [np.nan, np.inf, -np.inf, 1.0], np.float32))
C("increment", lambda P, x: (P.increment(x, 2.0), x),
  np.array([1.5], np.float32), grad=False)
C("increment_", lambda P, x: P._op_registry.get_op("increment_").fn(x),
  np.array([3.0], np.float32),
  grad=False)
C("outer", lambda P, x, y: P.outer(x, y), f(3), f(4))
C("inner", lambda P, x, y: P.inner(x, y), f(2, 4), f(3, 4))
C("broadcast_shape", lambda P: P.broadcast_shape([2, 1, 3], [4, 1]))

# ---------------------------------------------------------------- logic
for _n in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"):
    C(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n),
      i(3, 4, lo=0, hi=3), i(4, lo=0, hi=3))
C("equal:scalar", lambda P, x: P.equal(x, 1), i(5, lo=0, hi=3))
for _n in ("logical_and", "logical_or", "logical_xor"):
    C(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n), b(3, 4),
      b(3, 4))
C("logical_not", lambda P, x: P.logical_not(x), b(3, 4))
_SPECIAL = np.array([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
for _n in ("isnan", "isinf", "isfinite", "isneginf", "isposinf", "isreal"):
    C(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), _SPECIAL)
C("isreal:complex", lambda P, x: P.isreal(P.complex(x, x * 0)), f(3))
C("allclose", lambda P, x, y: P.allclose(x, x + y * 1e-7), f(3), f(3))
C("allclose:false", lambda P, x, y: P.allclose(x, y), f(3), f(3))
C("isclose", lambda P, x, y: P.isclose(x, y, atol=0.5), f(6), f(6))
C("equal_all", lambda P, x: P.equal_all(x, x), i(3))
C("equal_all:shape", lambda P, x, y: P.equal_all(x, y), i(3), i(2))
C("is_empty", lambda P, x: P.is_empty(x), f(0, 3))
C("is_tensor", lambda P, x: (P.is_tensor(x), P.is_tensor(3)), f(2))
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    C(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n),
      i(6, lo=-20, hi=20), i(6, lo=-20, hi=20))
C("bitwise_not", lambda P, x: P.bitwise_not(x), i(6, lo=-20, hi=20))
C("bitwise_and:bool", lambda P, x, y: P.bitwise_and(x, y), b(5), b(5))
C("bitwise_left_shift", lambda P, x, y: P.bitwise_left_shift(x, y),
  i(6, lo=-20, hi=20), i(6, lo=0, hi=5))
C("bitwise_right_shift", lambda P, x, y: P.bitwise_right_shift(x, y),
  i(6, lo=-20, hi=20), i(6, lo=0, hi=5))
C("where", lambda P, c, x, y: P.where(c, x, y), b(3, 4), f(3, 4), f(4))
C("where:scalar", lambda P, c, x: P.where(c, x, 0.0), b(3, 4), f(3, 4))
C("where:one", lambda P, c: P.where(c), b(3, 4))

# ------------------------------------------------------------- reshape
C("reshape", lambda P, x: P.reshape(x, [4, -1]), f(2, 3, 2))
C("reshape_", lambda P, x: (P.reshape_(x, [3, 2]), x), f(2, 3),
  grad=False)
C("view", lambda P, x: P.view(x, [6]), f(2, 3))
C("view:dtype", lambda P, x: P.view(x, "int32"), f(2, 3), grad=False)
C("flatten", lambda P, x: P.flatten(x, 1, 2), f(2, 3, 4, 2))
C("flatten:all", lambda P, x: P.flatten(x), f(2, 3))
C("squeeze", lambda P, x: P.squeeze(x, [0, 1]), f(1, 3, 1))
C("squeeze:all", lambda P, x: P.squeeze(x), f(1, 3, 1))
C("unsqueeze", lambda P, x: P.unsqueeze(x, [0, -1]), f(2, 3))
C("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), f(2, 3, 4))
C("moveaxis", lambda P, x: P.moveaxis(x, 0, -1), f(2, 3, 4))
C("swapaxes", lambda P, x: P.swapaxes(x, 0, 2), f(2, 3, 4))
C("rot90", lambda P, x: P.rot90(x, 1, (0, 1)), f(2, 3))
C("flip", lambda P, x: P.flip(x, [0, 2]), f(2, 3, 4))
C("roll", lambda P, x: P.roll(x, 2, 1), f(3, 4))
C("roll:flat", lambda P, x: P.roll(x, -1), f(3, 4))
C("concat", lambda P, x, y: P.concat([x, y], axis=1), f(2, 3), f(2, 2))
C("stack", lambda P, x, y: P.stack([x, y], axis=1), f(2, 3), f(2, 3))
C("split", lambda P, x: P.split(x, 3, axis=1), f(2, 6))
C("split:sections", lambda P, x: P.split(x, [1, -1, 2], axis=1), f(2, 6))
C("chunk", lambda P, x: P.chunk(x, 3, axis=0), f(7, 2))
C("unstack", lambda P, x: P.unstack(x, axis=1), f(2, 3))
C("unbind", lambda P, x: P.unbind(x, axis=0), f(2, 3))
C("tile", lambda P, x: P.tile(x, [2, 1, 3]), f(2, 3))
C("expand", lambda P, x: P.expand(x, [2, -1, 3]), f(4, 1))
C("expand_as", lambda P, x, y: P.expand_as(x, y), f(1, 3), f(2, 3))
C("broadcast_to", lambda P, x: P.broadcast_to(x, [2, 3, 4]), f(3, 1))
C("broadcast_tensors", lambda P, x, y: P.broadcast_tensors([x, y]),
  f(3, 1), f(1, 4))

# ------------------------------------------------------- gather/scatter
C("gather", lambda P, x, idx: P.gather(x, idx, axis=1), f(3, 5),
  np.array([4, 0, 2, 2]))
C("gather:column", lambda P, x, idx: P.gather(x, idx), f(4, 3),
  np.array([[3], [1]]))
C("gather_nd", lambda P, x, idx: P.gather_nd(x, idx), f(3, 4, 2),
  np.array([[0, 1], [2, 3], [1, 0]]))
C("take_along_axis", lambda P, x, idx: P.take_along_axis(x, idx, 1),
  f(3, 4), i(3, 2, lo=0, hi=4))
C("put_along_axis", lambda P, x, idx, v: P.put_along_axis(x, idx, v, 1),
  f(3, 4), np.array([[1], [3], [0]]), f(3, 1))
C("put_along_axis:add", lambda P, x, idx, v: P.put_along_axis(
    x, idx, v, 1, reduce="add"), f(3, 4), np.array([[1, 1], [3, 0], [0, 2]]),
  f(3, 2))
C("scatter", lambda P, x, idx, v: P.scatter(x, idx, v), f(5, 3),
  np.array([4, 0, 2]), f(3, 3))
C("scatter:accumulate", lambda P, x, idx, v: P.scatter(
    x, idx, v, overwrite=False), f(5, 3), np.array([1, 3, 1, 1]), f(4, 3))
C("scatter_nd_add", lambda P, x, idx, v: P.scatter_nd_add(x, idx, v),
  f(4, 3), np.array([[1], [3], [1]]), f(3, 3))
C("scatter_nd", lambda P, idx, v: P.scatter_nd(idx, v, [3, 4]),
  np.array([[0, 1], [2, 3], [0, 1]]), f(3))
C("index_select", lambda P, x, idx: P.index_select(x, idx, axis=1),
  f(3, 5), np.array([4, 1, 1]))
C("index_sample", lambda P, x, idx: P.index_sample(x, idx), f(3, 5),
  i(3, 2, lo=0, hi=5))
C("index_add", lambda P, x, idx, v: P.index_add(x, idx, 1, v), f(3, 5),
  np.array([0, 4, 0]), f(3, 3))
C("index_put", lambda P, x, r, c, v: P.index_put(x, (r, c), v), f(3, 4),
  np.array([0, 2]), np.array([1, 3]), f(2))
C("index_put:accumulate", lambda P, x, r, v: P.index_put(
    x, (r,), v, accumulate=True), f(3, 4), np.array([0, 2, 0]), f(3, 4))
C("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=1),
  f(2, 3))
C("repeat_interleave:flat", lambda P, x: P.repeat_interleave(x, 3), f(2, 2))
C("pad", lambda P, x: P.pad(x, [1, 2, 0, 1], value=0.5), f(2, 3, 4, 5))
C("pad:all", lambda P, x: P.pad(x, [1, 0, 0, 2]), f(3, 4))
C("pad:reflect", lambda P, x: P.pad(x, [1, 2, 2, 1], mode="reflect"),
  f(2, 3, 4, 5))
C("pad:replicate", lambda P, x: P.pad(x, [2, 1], mode="replicate"),
  f(2, 3, 4))
C("pad:circular", lambda P, x: P.pad(x, [1, 1, 2, 0], mode="circular",
                                     data_format="NHWC"), f(2, 4, 5, 3))
C("topk", lambda P, x: P.topk(x, 2), f(3, 5))
C("topk:smallest", lambda P, x: P.topk(x, 3, axis=0, largest=False),
  f(4, 3))
C("sort", lambda P, x: P.sort(x, axis=1, descending=True), f(3, 5))
C("argsort", lambda P, x: P.argsort(x, axis=1), f(3, 5))
C("argsort:ties", lambda P, x: P.argsort(x, descending=True),
  np.array([2, 1, 2, 3, 1, 2]))
C("searchsorted", lambda P, s, v: P.searchsorted(s, v), np.array(
    [1.0, 2.0, 2.0, 5.0], np.float32), np.array([2.0, 0.0, 6.0],
                                                np.float32))
C("searchsorted:right", lambda P, s, v: P.searchsorted(s, v, True, True),
  np.array([1.0, 2.0, 2.0, 5.0], np.float32), np.array([2.0, 3.0],
                                                       np.float32))
C("bucketize", lambda P, x, s: P.bucketize(x, s), np.array(
    [0.5, 2.0, 4.0], np.float32), np.array([1.0, 2.0, 3.0], np.float32))
C("nonzero", lambda P, x: P.nonzero(x), i(3, 4, lo=-1, hi=2))
C("nonzero:tuple", lambda P, x: P.nonzero(x, as_tuple=True),
  i(3, 4, lo=-1, hi=2))
C("masked_select", lambda P, x, m: P.masked_select(x, m), f(3, 4), b(4))
C("masked_fill", lambda P, x, m: P.masked_fill(x, m, -1.5), f(3, 4), b(4))
C("unique", lambda P, x: P.unique(x), i(3, 4, lo=0, hi=4))
C("unique:flags", lambda P, x: P.unique(x, True, True, True),
  i(3, 4, lo=0, hi=4))
C("unique:axis", lambda P, x: P.unique(x, return_inverse=True, axis=0),
  np.array([[2, 1], [1, 0], [2, 1]]))
C("unique_consecutive", lambda P, x: P.unique_consecutive(
    x, return_inverse=True, return_counts=True), np.array([[1, 1, 2],
                                                          [2, 3, 3]]))
C("unique_consecutive:axis", lambda P, x: P.unique_consecutive(x, axis=0),
  np.array([[1, 2], [1, 2], [3, 4]]))
C("cast", lambda P, x: P.cast(x, "int32"), f(3, 4) * 3, grad=False)
C("cast:float64", lambda P, x: P.cast(x, "float64"), f(3, 4))
C("slice", lambda P, x: P.slice(x, [0, 1], [1, -3], [3, 10]), f(4, 5))
C("strided_slice", lambda P, x: P.strided_slice(x, [0, 1], [0, 4], [4, 0],
                                                [2, -2]), f(5, 6))
C("crop", lambda P, x: P.crop(x, [2, -1], [1, 2]), f(4, 5))
C("crop:clamped", lambda P, x: P.crop(x, [3, 2], [3, 0]), f(4, 5))
C("as_complex", lambda P, x: P.as_complex(x), f(3, 2), grad=False)
C("as_real", lambda P, x: P.as_real(P.as_complex(x)), f(3, 2))
C("real", lambda P, x: P.real(P.as_complex(x)), f(3, 2))
C("imag", lambda P, x: P.imag(P.as_complex(x)), f(3, 2))
C("imag:real", lambda P, x: P.imag(x), f(3))

# ---------------------------------------------------------------- linalg
_L = dict(tol=1e-4)
C("matmul", lambda P, x, y: P.matmul(x, y), f(2, 3, 4), f(4, 5), **_L)
C("matmul:transpose", lambda P, x, y: P.matmul(x, y, transpose_x=True,
                                               transpose_y=True),
  f(4, 3), f(5, 4), **_L)
C("matmul:vector", lambda P, x, y: P.matmul(x, y), f(3, 4), f(4), **_L)
C("mm", lambda P, x, y: P.mm(x, y), f(3, 4), f(4, 2), **_L)
C("bmm", lambda P, x, y: P.bmm(x, y), f(2, 3, 4), f(2, 4, 2), **_L)
C("mv", lambda P, x, y: P.mv(x, y), f(3, 4), f(4), **_L)
C("dot", lambda P, x, y: P.dot(x, y), f(3, 4), f(3, 4), **_L)
C("t", lambda P, x: P.t(x), f(3, 4), **_L)
C("norm", lambda P, x: P.norm(x), f(3, 4), **_L)
C("norm:p1", lambda P, x: P.norm(x, p=1, axis=1, keepdim=True), f(3, 4),
  **_L)
C("norm:inf", lambda P, x: P.norm(x, p=float("inf"), axis=0), f(3, 4), **_L)
C("norm:fro", lambda P, x: P.norm(x, p="fro", axis=[0, 1]), f(3, 4), **_L)
C("norm:p0", lambda P, x: P.norm(x, p=0, axis=1), f(3, 4), grad=False, **_L)
C("dist", lambda P, x, y: P.dist(x, y, 3), f(3, 4), f(3, 4), **_L)
C("histogram", lambda P, x: P.histogram(x, bins=5, min=-2, max=2),
  f(40), **_L)
C("histogram:range", lambda P, x: P.histogram(x, bins=4), f(30), **_L)
C("cross", lambda P, x, y: P.cross(x, y), f(4, 3), f(4, 3), **_L)
C("cholesky", lambda P, x: P.cholesky(x), spd(4), **_L)
C("cholesky:upper", lambda P, x: P.cholesky(x, upper=True), spd(3), **_L)
C("cholesky_solve", lambda P, b_, x: P.cholesky_solve(b_, P.cholesky(x)),
  f(3, 2), spd(3), **_L)
C("qr", lambda P, x: P.matmul(*P.qr(x)), f(5, 3), **_L)
C("qr:factors", lambda P, x: P.qr(x), f(4, 3), grad=False,
  post=lambda o: list(_canon_cols(o[0], o[1])), **_L)
C("svd", lambda P, x: (P.svd(x)[1], P.matmul(P.svd(x)[0] * P.svd(x)[1],
                                             P.svd(x)[2])), f(5, 3), **_L)
#: a rotation-and-scale block beside a real eigenvalue: complex eigenvalues
#: (numpy, under the JAX eig, returns a real array for a real spectrum)
_ROT = np.array([[1.0, -2.0, 0.3], [2.0, 1.0, 0.1], [0.0, 0.2, 3.0]],
                np.float32)
C("eig", lambda P, x: P.eig(x)[0], _ROT,
  post=_sorted_complex, grad=False, **_L)
C("eigh", lambda P, x: (P.eigh(x)[0], P.matmul(
    P.eigh(x)[1] * P.eigh(x)[0], P.t(P.eigh(x)[1]))), spd(4), **_L)
C("eigh:upper", lambda P, x: P.eigh(x, UPLO="U")[0], f(4, 4), **_L)
C("eigvals", lambda P, x: P.eigvals(x), _ROT,
  post=_sorted_complex, grad=False, **_L)
C("eigvalsh", lambda P, x: P.eigvalsh(x), spd(4), **_L)
C("inverse", lambda P, x: P.inverse(x), spd(3), **_L)
C("pinv", lambda P, x: P.pinv(x), f(4, 3), **_L)
C("solve", lambda P, x, y: P.solve(x, y), spd(3), f(3, 2), **_L)
C("solve:vector", lambda P, x, y: P.solve(x, y), spd(3), f(3), **_L)
C("triangular_solve", lambda P, x, y: P.triangular_solve(x, y),
  np.triu(spd(3)), f(3, 2), **_L)
C("triangular_solve:lower", lambda P, x, y: P.triangular_solve(
    x, y, upper=False, transpose=True, unitriangular=True),
  np.tril(spd(3)), f(3, 2), **_L)
C("lstsq", lambda P, x, y: P.lstsq(x, y), f(5, 3), f(5, 2), grad=False,
  **_L)
C("det", lambda P, x: P.det(x), spd(3) / 3, **_L)
C("slogdet", lambda P, x: P.slogdet(x), f(3, 3), **_L)
C("matrix_power", lambda P, x: P.matrix_power(x, 3), f(3, 3), **_L)
C("matrix_rank", lambda P, x: P.matrix_rank(x), f(4, 2) @ f(2, 4), **_L)
C("matrix_rank:tol", lambda P, x: P.matrix_rank(x, tol=1.0), f(4, 4), **_L)
C("cond", lambda P, x: P.cond(x), spd(3), grad=False, **_L)
C("multi_dot", lambda P, x, y, z: P.multi_dot([x, y, z]), f(2, 3), f(3, 4),
  f(4, 2), **_L)
C("lu", lambda P, x: P.lu(x, get_infos=True), f(4, 4), grad=False, **_L)
C("tensordot", lambda P, x, y: P.tensordot(x, y, axes=[[1], [0]]),
  f(2, 3, 4), f(3, 5), **_L)
C("tensordot:int", lambda P, x, y: P.tensordot(x, y, 2), f(2, 3, 4),
  f(3, 4, 2), **_L)
C("corrcoef", lambda P, x: P.corrcoef(x), f(3, 6), **_L)
C("cov", lambda P, x: P.cov(x, rowvar=False), f(6, 3), **_L)
C("cov:biased", lambda P, x: P.cov(x, ddof=False), f(3, 6), **_L)
C("einsum", lambda P, x, y: P.einsum("bij,jk->bik", x, y), f(2, 3, 4),
  f(4, 5), **_L)

# ---------------------------------------------------------------- extras
C("add_n", lambda P, x, y, z: P.add_n([x, y, z]), f(3, 4), f(3, 4), f(3, 4))
C("bincount", lambda P, x: P.bincount(x, minlength=7), i(10, lo=0, hi=5))
C("bincount:weights", lambda P, x, w: P.bincount(x, w), i(10, lo=0, hi=5),
  f(10))
C("diagonal", lambda P, x: P.diagonal(x, 1, 1, 2), f(2, 3, 4))
C("diag_embed", lambda P, x: P.diag_embed(x, 1), f(2, 3))
C("kron", lambda P, x, y: P.kron(x, y), f(2, 2), f(3, 2))
C("complex", lambda P, x, y: P.complex(x, y), f(3), f(3), grad=False)
C("clip_by_norm", lambda P, x: P.clip_by_norm(x, 1.0), f(3, 4))
C("logit", lambda P, x: P.logit(x), u(3, 4, lo=0.05, hi=0.95))
C("logit:eps", lambda P, x: P.logit(x, eps=0.2), u(3, 4, lo=0.05, hi=0.95))
C("nanmedian", lambda P, x: P.nanmedian(x, axis=1), np.array(
    [[1.0, np.nan, 3.0, 2.0], [4.0, 5.0, 6.0, 0.5]], np.float32))
C("nanmedian:all", lambda P, x: P.nanmedian(x), f(3, 4))
C("mode", lambda P, x: P.mode(x, axis=1), np.array(
    [[3.0, 1.0, 3.0, 1.0, 2.0], [5.0, 5.0, 4.0, 4.0, 4.0]], np.float32))
C("mode:keepdim", lambda P, x: P.mode(x, axis=0, keepdim=True),
  i(5, 3, lo=0, hi=3))
C("renorm", lambda P, x: P.renorm(x, 2.0, 0, 1.5), f(3, 4))
C("logcumsumexp", lambda P, x: P.logcumsumexp(x, axis=1), f(3, 4))
C("logcumsumexp:flat", lambda P, x: P.logcumsumexp(x), f(3, 4))
C("nextafter", lambda P, x, y: P.nextafter(x, y), f(4), f(4), grad=False)
C("polygamma", lambda P, x: P.polygamma(x, 1), f(3, 4, lo=0.5))
C("i0e", lambda P, x: P.i0e(x), f(3, 4))
C("i1e", lambda P, x: P.i1e(x), f(3, 4))
C("gather_tree", lambda P, ids, par: P.gather_tree(ids, par),
  i(4, 2, 3, lo=0, hi=9), i(4, 2, 3, lo=0, hi=3))
C("edit_distance", lambda P, h, r: P.edit_distance(h, r),
  i(3, 5, lo=0, hi=4), i(3, 4, lo=0, hi=4))
C("edit_distance:lengths", lambda P, h, r, hl, rl: P.edit_distance(
    h, r, normalized=False, ignored_tokens=[0], input_length=hl,
    label_length=rl), i(3, 6, lo=0, hi=4), i(3, 5, lo=0, hi=4),
  np.array([6, 3, 0]), np.array([2, 5, 4]))
C("squared_l2_norm", lambda P, x: P.squared_l2_norm(x), f(3, 4))
C("shard_index", lambda P, x: P.shard_index(x, 20, 3, 1), i(6, lo=0, hi=20))
C("temporal_shift", lambda P, x: P.temporal_shift(x, 2, 0.25), f(4, 8, 2, 2))
C("temporal_shift:nhwc", lambda P, x: P.temporal_shift(
    x, 2, 0.25, data_format="NHWC"), f(4, 2, 2, 8))
C("fill_diagonal", lambda P, x: P.fill_diagonal(x, 9.0, offset=1), f(3, 5))


#: draws of the random ops' moment checks
RANDOM_N = 20000
#: op -> (call of a package P at size n, support (lo, hi; None: no
#: bound), mean, std (None: not checked))
RANDOM_CASES = {
    "uniform": (lambda P, n: P.uniform([n], min=-2.0, max=3.0),
                (-2.0, 3.0), 0.5, 5 / 12 ** 0.5),
    "uniform_": (lambda P, n: P.uniform_(P.zeros([n]), -1.0, 1.0),
                 (-1.0, 1.0), 0.0, 1 / 3 ** 0.5),
    "normal": (lambda P, n: P.normal(1.0, 2.0, [n]), None, 1.0, 2.0),
    "normal_": (lambda P, n: P.normal_(P.zeros([n]), -1.0, 0.5), None,
                -1.0, 0.5),
    "standard_normal": (lambda P, n: P.standard_normal([n]), None, 0.0,
                        1.0),
    "randn": (lambda P, n: P.randn([n, 2]), None, 0.0, 1.0),
    "rand": (lambda P, n: P.rand([n]), (0.0, 1.0), 0.5, 1 / 12 ** 0.5),
    "randint": (lambda P, n: P.randint(-3, 5, [n]), (-3, 4), 0.5,
                (63 / 12) ** 0.5),
    "randint_like": (lambda P, n: P.randint_like(P.zeros([n], "int32"), 0,
                                                 4), (0, 3), 1.5,
                     (15 / 12) ** 0.5),
    "randperm": (lambda P, n: P.randperm(n), (0, RANDOM_N - 1),
                 (RANDOM_N - 1) / 2, None),
    "bernoulli": (lambda P, n: P.bernoulli(P.full([n], 0.3)), (0.0, 1.0),
                  0.3, 0.21 ** 0.5),
    "poisson": (lambda P, n: P.poisson(P.full([n], 4.0)), (0.0, None),
                4.0, 2.0),
    "multinomial": (lambda P, n: P.multinomial(
        P.to_tensor([0.2, 0.3, 0.5]), n, replacement=True), (0, 2), 1.3,
        0.61 ** 0.5),
    "exponential_": (lambda P, n: P.exponential_(P.zeros([n]), 2.0),
                     (0.0, None), 0.5, 0.5),
    "rand_like": (lambda P, n: P.rand_like(P.zeros([n], "float64")),
                  (0.0, 1.0), 0.5, 1 / 12 ** 0.5),
    "randn_like": (lambda P, n: P.randn_like(P.zeros([n])), None, 0.0,
                   1.0),
    "gumbel_softmax": (lambda P, n: P.gumbel_softmax(P.zeros([n, 2]))[:, 0],
                       (0.0, 1.0), 0.5, None),
    "truncated_normal": (lambda P, n: P.truncated_normal([n], 1.0, 2.0),
                         (-3.0, 5.0), 1.0, 2.0 * 0.8796),
}
#: the random ops, held to distributions rather than values
RANDOM_OPS = set(RANDOM_CASES)


def check_moments(x, support, mean, std) -> None:
    """A large draw ``x`` within ``support``, its mean within 5 standard
    errors of ``mean`` and its std within 5% of ``std``."""
    v = x.double()
    if support is not None:
        lo, hi = support
        assert v.min() >= lo and (hi is None or v.max() <= hi), \
            f"range [{float(v.min())}, {float(v.max())}] outside {support}"
    sd = float(v.std())
    m = float(v.mean())
    assert abs(m - mean) <= 5 * (std or sd) / v.numel() ** 0.5 + 1e-6, \
        f"mean {m}, expected {mean}"
    if std is not None:
        assert abs(sd - std) <= 0.05 * std, f"std {sd}, expected {std}"


def to_numpy(v):
    """A tensor of either package (on any device) as a numpy array;
    anything else as it is."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.resolve_conj().numpy() if v.is_complex() else v.numpy()
    if hasattr(v, "numpy") and not isinstance(v, np.ndarray):
        return np.asarray(v.numpy())
    return v


def flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in flat(o)]
    return [out]


def compare(got, want, tol, what):
    if not isinstance(want, np.ndarray):
        assert not isinstance(got, np.ndarray) and got == want, \
            f"{what}: {got!r} != {want!r}"
        return
    assert isinstance(got, np.ndarray), f"{what}: {type(got)}"
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != " \
        f"{want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
        f"{want.shape}"
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    w, g = np.where(nan, 0, want), np.where(nan, 0, got)
    finite = np.isfinite(w)
    np.testing.assert_array_equal(g[~finite], w[~finite], err_msg=what)
    scale = max(float(np.abs(w[finite]).max(initial=0.0)), 1e-30)
    err = float(np.abs(g[finite] - w[finite]).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"
