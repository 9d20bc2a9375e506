"""Linear algebra (port of ``paddle1_tpu/ops/linalg_ops.py``).

Plain ``torch.linalg`` calls: none of these is a hand-written kernel in
the JAX package either. Decompositions are unique only up to sign or
phase, so they are held to their reconstructions. ``eig`` and
``eigvals`` return complex tensors always (numpy's, in the reference,
are real when every eigenvalue is); ``lu``'s pivots are 0-based, as
``jax.scipy.linalg.lu_factor`` gives them. ``lstsq`` computes through
the SVD on every device (torch's CUDA ``lstsq`` returns no rank and no
singular values).
"""

from __future__ import annotations

import torch

from ..amp import cast_point
from ..core.tensor import to_tensor

__all__ = [
    "cholesky", "inv", "pinv", "svd", "qr", "lu", "matrix_power", "det",
    "slogdet", "solve", "triangular_solve", "cholesky_solve", "lstsq",
    "eig", "eigh", "eigvals", "eigvalsh", "norm", "dist", "cond",
    "matrix_rank", "multi_dot", "cov", "corrcoef", "householder_product",
]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(_t(x), upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(_t(x))


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian)


def svd(x, full_matrices=False, name=None):
    """``(U, S, Vh)`` with ``x = U diag(S) Vh``."""
    return tuple(torch.linalg.svd(_t(x), full_matrices=full_matrices))


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(_t(x), mode=mode)
    return r if mode == "r" else (q, r)


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` packed as LAPACK's getrf, the pivots 0-based int32
    (``jax.scipy.linalg.lu_factor``); with ``get_infos`` also zeros."""
    x = _t(x)
    lu_, piv = torch.linalg.lu_factor(x)
    piv = (piv - 1).to(torch.int32)
    if get_infos:
        info = torch.zeros(tuple(x.shape[:-2]), dtype=torch.int32,
                           device=x.device)
        return lu_, piv, info
    return lu_, piv


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_t(x), n)


def det(x, name=None):
    return torch.linalg.det(_t(x))


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked on a new first axis."""
    sign, logdet = torch.linalg.slogdet(_t(x))
    return torch.stack([sign, logdet], 0)


def solve(x, y, name=None):
    a, b = _t(x), _t(y)
    if b.dim() == a.dim() - 1:
        return torch.linalg.solve(a, torch.unsqueeze(b, -1))[..., 0]
    return torch.linalg.solve(a, b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = _t(x), _t(y)
    if transpose:
        a, upper = torch.swapaxes(a, -1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, left=True,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A X = x`` for ``A`` given by its Cholesky factor ``y``."""
    return torch.cholesky_solve(_t(x), _t(y), upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` as
    ``jnp.linalg.lstsq``: singular values under ``rcond`` x the largest
    (default eps x max(m, n)) are cut; the residuals are the squared
    norms of each column's misfit (one for a vector ``y``); rank int32."""
    a, b = _t(x), _t(y)
    m, n = a.shape[-2], a.shape[-1]
    vec = b.dim() == 1
    b2 = torch.unsqueeze(b, -1) if vec else b
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    keep = s > rcond * (s[..., :1] if s.shape[-1] else s)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    ub = torch.matmul(torch.conj(torch.swapaxes(u, -1, -2)), b2)
    sol = torch.matmul(torch.conj(torch.swapaxes(vh, -1, -2)),
                       torch.unsqueeze(s_inv, -1) * ub)
    rank = torch.sum(keep, -1).to(torch.int32)
    resid = torch.sum(torch.abs(b2 - torch.matmul(a, sol)) ** 2, -2)
    return (sol[..., 0] if vec else sol), resid, rank, s


def eig(x, name=None):
    """Eigenvalues and right eigenvectors of a general matrix, complex."""
    w, v = torch.linalg.eig(_t(x))
    return w, v


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(_t(x), UPLO=UPLO)
    return w, v


def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_t(x), UPLO=UPLO)


@cast_point("norm")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The reference's norms: Frobenius / 2-norm (``p`` None or "fro"),
    max / min of ``|x|`` (inf, -inf), the count of non-zeros (0), else
    ``sum(|x|**p) ** (1/p)``, over ``axis`` (every axis for None)."""
    x = _t(x)
    if p in (None, "fro") and axis is None:
        return torch.sqrt(torch.sum(x * x))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        ax = tuple(range(x.dim()))
    if p in (None, "fro"):
        return torch.sqrt(torch.sum(x * x, ax, keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), ax, keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), ax, keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), ax, keepdim)
    return torch.sum(torch.abs(x) ** p, ax, keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(_t(x) - _t(y), p=p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(_t(x), p)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (an absolute threshold,
    as ``jnp.linalg.matrix_rank`` reads it), or, for None, above eps x
    max(m, n) x the largest."""
    kw = {} if tol is None else {"atol": tol, "rtol": 0.0}
    return torch.linalg.matrix_rank(_t(x), hermitian=hermitian,
                                    **kw).to(torch.int64)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([_t(e) for e in x])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance of ``x``'s rows (columns when not ``rowvar``);
    ``fweights`` and ``aweights`` are ignored, as in the reference."""
    x = _t(x)
    return torch.cov(x if rowvar else torch.swapaxes(x, 0, 1),
                     correction=1 if ddof else 0)


def corrcoef(x, rowvar=True, name=None):
    x = _t(x)
    return torch.corrcoef(x if rowvar else torch.swapaxes(x, 0, 1))


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(_t(x), _t(tau))
