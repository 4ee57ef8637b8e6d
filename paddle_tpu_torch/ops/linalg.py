"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``),
through ``torch.linalg``: none of them is a Pallas kernel in the JAX
package, so the library calls are the port.

``matmul(x, y, transpose_x, transpose_y)`` promotes mixed operand
dtypes as the JAX package does. ``eig`` and ``eigvals`` give complex
results, on the card too (the JAX package computes them with numpy on the
host, which returns real arrays when every eigenvalue is real).
``eigh`` and ``eigvalsh`` read one triangle, which alone receives the
gradient, as in the JAX package. ``lstsq`` returns the JAX package's
four outputs: the solution, the squared residual of each column, the
rank and the singular values. On
the card torch has only the ``gels`` driver, which needs an
overdetermined system of full rank: an underdetermined one raises
there, where the CPU takes ``gelsd``.
"""
from __future__ import annotations

import torch

from ..core.tensor import to_tensor
from .registry import register_op

__all__: list = []


def _export(name, fn, methods=(), differentiable=True, amp=True):
    op = register_op(name, fn, methods=methods,
                     differentiable=differentiable, tags=("linalg",),
                     amp=amp)
    globals()[name] = op
    __all__.append(name)
    return op


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def _promote(a, b):
    if a.dtype != b.dtype:
        d = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(d), b.to(d)
    return a, b


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = _promote(_t(x), _t(y))
    if transpose_x and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.ndim > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dot(x, y, name=None):
    return (_t(x) * _t(y)).sum(-1)


def t(input, name=None):
    a = _t(input)
    return a.permute(list(range(a.ndim))[::-1]) if a.ndim >= 2 else a


for _n in ("matmul", "mm", "bmm", "mv", "dot", "t"):
    _export(_n, globals()[_n], methods=[_n])


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The JAX package's norms: the 2-norm of every element by default;
    ``inf``, ``-inf``, 0, ``"fro"`` and any ``p`` over ``axis``."""
    a = _t(x)
    if axis is None and p is None:
        return a.abs().square().sum().sqrt()
    dims = tuple(range(a.ndim)) if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    pp = 2 if p is None or p == "fro" else p
    if pp == float("inf"):
        return a.abs().amax(dims, keepdim=keepdim)
    if pp == float("-inf"):
        return a.abs().amin(dims, keepdim=keepdim)
    if pp == 0:
        return (a != 0).to(a.dtype).sum(dims, keepdim=keepdim)
    return a.abs().pow(pp).sum(dims, keepdim=keepdim).pow(1.0 / pp)


def dist(x, y, p=2, name=None):
    return norm(_t(x) - _t(y), p=float(p))


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """numpy's histogram over ``[min, max]`` (the data's range when both
    are 0), the last bin closed: int64 counts, or with ``weight`` or
    ``density`` sums in the input's float dtype."""
    a = _t(input).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = a.min().item(), a.max().item()
    else:
        lo, hi = float(min), float(max)
    bins = int(bins)
    af = a.double()
    idx = ((af - lo) * (bins / (hi - lo))).floor().long() if hi > lo else \
        torch.zeros_like(a, dtype=torch.long)
    idx = torch.where(af == hi, bins - 1, idx)
    keep = (af >= lo) & (af <= hi)
    w = torch.ones_like(af) if weight is None else \
        _t(weight).reshape(-1).double()
    h = torch.zeros(bins, dtype=torch.float64, device=a.device).index_add(
        0, idx[keep], w[keep])
    if density:
        h = h / (h.sum() * ((hi - lo) / bins))
    if weight is None and not density:
        return h.to(torch.int64)
    return h.to(a.dtype if a.is_floating_point() else torch.float32)


def cross(x, y, axis=9, name=None):
    x = _t(x)
    ax = axis if axis != 9 else next(i for i, s in enumerate(x.shape)
                                     if s == 3)
    return torch.linalg.cross(*_promote(x, _t(y)), dim=int(ax))


for _n in ("norm", "dist", "histogram", "cross"):
    _export(_n, globals()[_n], methods=[_n],
            differentiable=_n != "histogram", amp=_n != "histogram")


# ---------------------------------------------------- decompositions
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(_t(x), upper=bool(upper))


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(_t(x), _t(y), upper=bool(upper))


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(_t(x), mode=mode))


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(_t(x), full_matrices=full_matrices))


def eig(x, name=None):
    return tuple(torch.linalg.eig(_t(x)))


def _from_triangle(a, UPLO):
    """The Hermitian matrix of one triangle of ``a`` (the other's
    entries are not read, and receive no gradient)."""
    tri = torch.triu(a) if UPLO == "U" else torch.tril(a)
    return tri + tri.transpose(-1, -2).conj() - torch.diag_embed(
        torch.diagonal(a, 0, -2, -1))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_from_triangle(_t(x), UPLO)))


def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_from_triangle(_t(x), UPLO))


def inverse(x, name=None):
    return torch.linalg.inv(_t(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    a, b = _t(x), _t(y)
    if b.ndim == a.ndim - 1:
        return torch.linalg.solve(a, b[..., None])[..., 0]
    return torch.linalg.solve(a, b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = _t(x), _t(y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=bool(upper),
                                         unitriangular=bool(unitriangular))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular_values)``: the squared
    residual of every column of ``y``, the rank (int64) counting singular
    values above ``rcond`` times the largest (``rcond`` None: the dtype's
    eps times the larger side), as the JAX package returns them."""
    a, b = _t(x), _t(y)
    on_card = a.device.type == "cuda"
    if on_card and a.shape[-2] < a.shape[-1]:
        raise ValueError(
            "lstsq: on the card torch has only the 'gels' driver, which "
            f"needs an overdetermined system; this one is {a.shape[-2]} x "
            f"{a.shape[-1]}")
    sol = torch.linalg.lstsq(a, b, rcond=rcond,
                             driver="gels" if on_card else
                             (driver or "gelsd")).solution
    resid = (a @ sol - b).square().sum(-2)
    s = torch.linalg.svdvals(a)
    eps = torch.finfo(a.dtype).eps * max(a.shape[-2:]) if rcond is None \
        else rcond
    rank = (s > eps * s[..., :1]).sum(-1)
    return sol, resid, rank, s


def det(x, name=None):
    return torch.linalg.det(_t(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(_t(x))
    return torch.stack([sign, logdet], 0)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_t(x), int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    a = _t(x)
    if tol is None:
        return torch.linalg.matrix_rank(a, hermitian=hermitian)
    # Paddle's tol is an absolute singular-value threshold
    s = torch.linalg.eigvalsh(a).abs() if hermitian else \
        torch.linalg.svdvals(a)
    return (s > tol).sum(-1)


def cond(x, p=None, name=None):
    return torch.linalg.cond(_t(x), p)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([_t(t) for t in x])


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)``, the pivots 1-based int32 (LAPACK's); with
    ``get_infos`` also LAPACK's int32 info."""
    lu_, piv, info = torch.linalg.lu_factor_ex(_t(x), pivot=pivot)
    return (lu_, piv, info) if get_infos else (lu_, piv)


def tensordot(x, y, axes=2, name=None):
    if torch.is_tensor(axes):
        axes = axes.tolist()
    return torch.tensordot(_t(x), _t(y), dims=axes)


def corrcoef(x, rowvar=True, name=None):
    a = _t(x)
    return torch.corrcoef(a if rowvar else a.transpose(-1, -2))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = _t(x)
    return torch.cov(a if rowvar else a.transpose(-1, -2),
                     correction=1 if ddof else 0)


for _n in ("cholesky", "cholesky_solve", "qr", "svd", "eig", "eigh",
           "eigvals", "eigvalsh", "inverse", "pinv", "solve",
           "triangular_solve", "lstsq", "det", "slogdet", "matrix_power",
           "matrix_rank", "cond", "multi_dot", "lu", "tensordot",
           "corrcoef", "cov"):
    _diff = _n not in ("eig", "eigvals", "lstsq", "matrix_rank", "lu")
    _export(_n, globals()[_n], methods=[_n], differentiable=_diff,
            amp=_diff and _n != "cond")


def einsum(equation, *operands):
    return torch.einsum(equation, *[_t(o) for o in operands])


_export("einsum", einsum)
