"""LAPACK — counterpart of ``tpukk/lapack`` (lapack/src/KokkosLapack_{gesv,
svd,trtri}.hpp, and getrf/getrs, geqrf, cholesky).

The reference hands the work to a TPL (host LAPACK, cuSOLVER, MAGMA) and
``tpukk`` to XLA's ``lax.linalg``; here ``torch.linalg`` (cuSOLVER/MAGMA on
the card) is that TPL.  Pivots follow ``tpukk``: ``getrf`` returns
``jax.lax.linalg.lu``'s 0-based pivots (the row swapped with row i at step
i) and the permutation (A[perm] = L·U), where ``torch.linalg.lu_factor``
gives LAPACK's 1-based pivots; ``getrs`` takes ``getrf``'s output.
"""
from __future__ import annotations

import torch

from ..common import check
from ..common.tracing import annotate

__all__ = ["gesv", "svd", "trtri", "getrf", "getrs", "geqrf", "cholesky"]


@annotate("lapack.gesv")
def gesv(A, B):
    """Solve A·X = B by LU with partial pivoting (cf. KokkosLapack_gesv.hpp)."""
    check(A.ndim == 2 and A.shape[0] == A.shape[1], "gesv: A must be square")
    return torch.linalg.solve(A, B)


@annotate("lapack.svd")
def svd(A, full_matrices: bool = False, compute_uv: bool = True):
    """(U, s, Vh), or s alone with compute_uv=False (cf. KokkosLapack_svd.hpp)."""
    if not compute_uv:
        return torch.linalg.svdvals(A)
    return torch.linalg.svd(A, full_matrices=full_matrices)


@annotate("lapack.trtri")
def trtri(A, uplo: str = "L", diag: str = "N"):
    """Inverse of a triangular matrix (cf. KokkosLapack_trtri.hpp): a
    triangular solve against I, as in ``tpukk``."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(A, eye, upper=uplo.upper() != "L",
                                         unitriangular=diag.upper() == "U")


@annotate("lapack.getrf")
def getrf(A):
    """LU with partial pivoting: (lu, pivots, permutation), pivots 0-based
    int32 and A[permutation] = L·U, as ``jax.lax.linalg.lu`` gives them."""
    lu, piv = torch.linalg.lu_factor(A)
    piv = (piv - 1).to(torch.int32)
    # the row swaps in turn: row i of L·U is row perm[i] of A (any dtype)
    return lu, piv, _piv_to_perm(piv, A.shape[-2]).to(torch.int32)


def _piv_to_perm(piv, n):
    """LAPACK-style sequential row swaps (0-based) -> permutation (..., n)."""
    flat = piv.reshape(-1, piv.shape[-1]).long()
    perm = torch.arange(n, device=piv.device).repeat(flat.shape[0], 1)
    for i in range(flat.shape[1]):
        j = flat[:, i:i + 1]
        a = perm[:, i:i + 1].clone()
        perm[:, i:i + 1] = perm.gather(1, j)
        perm.scatter_(1, j, a)
    return perm.reshape(piv.shape[:-1] + (n,))


@annotate("lapack.getrs")
def getrs(lu, piv, b):
    """Solve A·x = b from ``getrf``'s (lu, 0-based pivots); b (n,) or (n, k)."""
    vec = b.ndim == lu.ndim - 1
    x = torch.linalg.lu_solve(lu, (piv + 1).to(torch.int32), b[..., None] if vec else b)
    return x[..., 0] if vec else x


@annotate("lapack.geqrf")
def geqrf(A):
    """QR factorization (economy): (Q, R)."""
    return torch.linalg.qr(A, mode="reduced")


@annotate("lapack.cholesky")
def cholesky(A, upper: bool = False):
    """L with A = L·Lᵀ, or Lᵀ with upper=True."""
    L = torch.linalg.cholesky(A)
    return L.mT if upper else L
