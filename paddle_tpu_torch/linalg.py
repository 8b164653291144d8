"""``paddle.linalg`` (counterpart of ``paddle_tpu/linalg.py``): the
linear algebra of the op library under its own namespace."""
from .tensor.linalg import (  # noqa: F401
    matmul, bmm, dot, mv, norm, p_norm, dist, cholesky, inv, matrix_power,
    multi_dot, det, slogdet, svd, qr, eig, eigh, eigvals, eigvalsh,
    matrix_rank, pinv, solve, triangular_solve, lstsq, cond, lu,
    cholesky_solve, cross, householder_product, corrcoef, cov)
from .tensor.math import histogram  # noqa: F401

__all__ = ["matmul", "bmm", "dot", "mv", "norm", "p_norm", "dist",
           "cholesky", "inv", "matrix_power", "multi_dot", "det", "slogdet",
           "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
           "pinv", "solve", "triangular_solve", "lstsq", "cond", "lu",
           "cholesky_solve", "cross", "householder_product", "corrcoef",
           "cov", "histogram"]
