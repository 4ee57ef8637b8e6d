"""``paddle.linalg``: the namespaced view of the linear-algebra ops of
``ops/linalg.py`` (counterpart of ``paddle_tpu/linalg.py``), one
implementation under two names, ``inv`` among them."""
from __future__ import annotations

from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, cross, det, dot, eig,
    eigh, eigvals, eigvalsh, lstsq, lu, matmul, matrix_power, matrix_rank,
    multi_dot, norm, pinv, qr, slogdet, solve, svd, triangular_solve,
)
from .ops.linalg import inverse  # noqa: F401
from .ops.linalg import inverse as inv  # noqa: F401

__all__ = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "cross",
    "det", "dot", "eig", "eigh", "eigvals", "eigvalsh", "inv", "inverse",
    "lstsq", "lu", "matmul", "matrix_power", "matrix_rank", "multi_dot",
    "norm", "pinv", "qr", "slogdet", "solve", "svd", "triangular_solve",
]
