"""Linear algebra (counterpart of ``paddle_tpu/tensor/linalg.py``).

Decompositions are ``torch.linalg`` calls on the input's device.  Where
the JAX package computes on the host (``cond``, ``lu``, ``eig``,
``eigvals`` and ``lstsq`` through numpy / scipy), the port stays on the
device, except that ``eig`` and ``eigvals`` on the card run through
torch's host LAPACK path, and ``lstsq`` reads the rank back to decide
whether it has residuals.  As in JAX, a failed factorization does not
raise: ``cholesky``, ``inv``, ``solve`` and ``lu`` take torch's ``_ex``
forms, which check nothing on the host (torch's ``svd`` and ``eigh``
families check their info flags on the host, so on the card they wait
for the device).  ``eigh`` and ``eigvalsh`` symmetrize their
input first, as ``jnp.linalg.eigh(symmetrize_input=True)`` does.
``lu`` returns 1-based int32 pivots, as scipy's ``lu_factor`` does.
"""
from __future__ import annotations

import math

import torch

from ..autograd import apply
from ._util import tensor as _t
from .math import bmm, dot, matmul, mv  # noqa: F401  (re-export)

__all__ = ["matmul", "bmm", "dot", "mv", "norm", "p_norm", "vector_norm",
           "matrix_norm", "cond", "cholesky", "cholesky_solve", "inv",
           "inverse", "det", "slogdet", "svd", "svdvals", "qr", "lu", "eig",
           "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank",
           "pinv", "solve", "triangular_solve", "lstsq", "cross",
           "multi_dot", "corrcoef", "cov", "householder_product", "dist"]


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius by default (a vector 2-norm along an int ``axis``); ``p``
    in {1, 2, inf, -inf, 0, 'fro', 'nuc'} or any float, elementwise over
    ``axis`` (all dims when None) but for ``'nuc'``."""
    def _norm(a):
        pp = p
        if pp is None:
            pp = "fro" if axis is None or isinstance(axis, (list, tuple)) \
                else 2
        ax = _ax(axis)
        dims = tuple(range(a.dim())) if ax is None else ax
        if pp == "fro":
            return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
        if pp == "nuc":
            return torch.sum(torch.linalg.svdvals(a), -1, keepdim=keepdim)
        if pp == math.inf:
            return torch.amax(a.abs(), dim=dims, keepdim=keepdim)
        if pp == -math.inf:
            return torch.amin(a.abs(), dim=dims, keepdim=keepdim)
        if pp == 0:
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
        return torch.sum(a.abs() ** pp, dim=dims, keepdim=keepdim) ** (1.0 / pp)

    return apply(_norm, _t(x), name="norm")


def p_norm(x, p=2, axis=None, keepdim=False):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def vector_norm(x, p=2, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return norm(x, p=p, axis=list(axis), keepdim=keepdim)


def cond(x, p=None, name=None):
    return torch.linalg.cond(_t(x), 2 if p is None else p)


def cholesky(x, upper=False, name=None):
    return apply(lambda a: torch.linalg.cholesky_ex(a, upper=upper).L,
                 _t(x), name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    """Solves ``A z = x`` for ``A = L L^T`` given by its factor ``y``,
    as two triangular solves (only the factor's triangle is read, and
    only it gets a gradient)."""
    def _cs(b, f):
        lo = f.transpose(-1, -2) if upper else f
        z = torch.linalg.solve_triangular(lo, b, upper=False)
        return torch.linalg.solve_triangular(lo.transpose(-1, -2), z,
                                             upper=True)
    return apply(_cs, _t(x), _t(y), name="cholesky_solve")


def inv(x, name=None):
    return apply(lambda a: torch.linalg.inv_ex(a).inverse, _t(x),
                 name="inverse")


inverse = inv


def det(x, name=None):
    return apply(torch.linalg.det, _t(x), name="determinant")


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked on a leading dim."""
    return apply(lambda a: torch.stack(torch.linalg.slogdet(a)), _t(x),
                 name="slogdet")


def svd(x, full_matrices=False, name=None):
    """``(U, S, Vh)``."""
    return apply(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), _t(x), name="svd")


def svdvals(x, name=None):
    return apply(torch.linalg.svdvals, _t(x), name="svdvals")


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; ``mode='r'`` gives ``R`` alone."""
    def _qr(a):
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)
    return apply(_qr, _t(x), name="qr")


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` packed as LAPACK's getrf leaves them, pivots
    1-based int32; ``get_infos`` adds one int32 info for the whole batch
    (0: every factorization succeeded)."""
    lu_, piv, info = torch.linalg.lu_factor_ex(_t(x), pivot=pivot)
    return (lu_, piv, info.reshape(-1).amax()) if get_infos else (lu_, piv)


def eig(x, name=None):
    """Complex ``(eigenvalues, eigenvectors)``."""
    return torch.linalg.eig(_t(x))


def _sym(a):
    return (a + a.transpose(-1, -2).conj()) / 2


def eigh(x, UPLO="L", name=None):
    return apply(lambda a: tuple(torch.linalg.eigh(_sym(a), UPLO=UPLO)),
                 _t(x), name="eigh")


def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda a: torch.linalg.eigvalsh(_sym(a), UPLO=UPLO), _t(x),
                 name="eigvalsh")


def matrix_power(x, n, name=None):
    return apply(lambda a: torch.linalg.matrix_power(a, n), _t(x),
                 name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above ``tol`` times the largest (default
    ``max(m, n)`` ulps) count."""
    return torch.linalg.matrix_rank(_t(x), rtol=tol, hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian),
                 _t(x), name="pinv")


def solve(x, y, name=None):
    return apply(lambda a, b: torch.linalg.solve_ex(a, b).result, _t(x),
                 _t(y), name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solves ``op(x) z = y`` for triangular ``x`` (only its triangle is
    read); ``op`` transposes when ``transpose``."""
    def _ts(a, b):
        up = upper
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply(_ts, _t(x), _t(y), name="triangular_solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` as numpy's
    ``lstsq`` gives them: the residuals' squared norms per column, empty
    unless ``x`` has full column rank and more rows than columns."""
    a, b = _t(x), _t(y)
    m, n = a.shape[-2:]
    rtol = max(m, n) * torch.finfo(a.dtype).eps if rcond is None else rcond
    sv = torch.linalg.svdvals(a)
    rank = (sv > rtol * sv[..., :1]).sum(-1)
    sol = torch.linalg.pinv(a, rtol=rtol) @ b
    if m > n and int(rank) == n:
        r = a @ sol - b
        res = (r * r).sum(-2)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return sol, res, rank, sv


def cross(x, y, axis=9, name=None):
    """``axis=9`` (Paddle's default): the first dim of size 3."""
    def _cross(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply(_cross, _t(x), _t(y), name="cross")


def multi_dot(x, name=None):
    return apply(lambda *arrs: torch.linalg.multi_dot(arrs),
                 *[_t(v) for v in x], name="multi_dot")


def corrcoef(x, rowvar=True, name=None):
    return apply(lambda a: torch.corrcoef(a if rowvar else a.T), _t(x),
                 name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply(lambda a: torch.cov(a if rowvar else a.T,
                                     correction=1 if ddof else 0,
                                     fweights=fweights, aweights=aweights),
                 _t(x), name="cov")


def householder_product(x, tau, name=None):
    """The first ``n`` columns of the product of the Householder
    reflectors ``I - tau_i v_i v_i^T`` stored below ``x``'s diagonal."""
    return apply(torch.linalg.householder_product, _t(x), _t(tau),
                 name="householder_product")


def dist(x, y, p=2, name=None):
    """The p-norm of ``x - y`` (broadcast) in f32: p=0 counts non-zero
    entries, p=inf / -inf are the max / min ``|x - y|``."""
    pf = float(p)

    def fn(a, b):
        d = (a - b).float()
        if pf == 0:
            return (d != 0).float().sum()
        if math.isinf(pf):
            m = d.abs()
            return m.max() if pf > 0 else m.min()
        return (d.abs() ** pf).sum() ** (1.0 / pf)

    return apply(fn, _t(x), _t(y), name="dist")
