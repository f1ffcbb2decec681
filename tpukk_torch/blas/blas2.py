"""BLAS2 — gemv / ger / syr / syr2, counterpart of ``tpukk/blas/blas2.py``
(blas/src/KokkosBlas2_*.hpp).  ``tpukk`` hands these to XLA's dot and outer
fusions, so they are torch ops here (cuBLAS on the card; f32 products stay
f32: TF32 is off by default).  Transpose modes are the reference's mode chars:
'N', 'T', and 'C' the conjugate transpose ('H', SpMV's spelling of it, is
taken too)."""
from __future__ import annotations

import torch

from ..common import arith_traits, check
from ..common.tracing import annotate

__all__ = ["gemv", "ger", "syr", "syr2"]


def _apply_trans(A, trans: str):
    t = trans.upper()
    check(t in ("N", "T", "C", "H"), f"invalid trans '{trans}'")
    if t == "N":
        return A
    return A.mT if t == "T" else A.mH


@annotate("blas2.gemv")
def gemv(trans, alpha, A, x, beta, y):
    """beta*y + alpha*op(A)·x — cf. blas/src/KokkosBlas2_gemv.hpp."""
    return beta * y + alpha * torch.matmul(_apply_trans(A, trans), x)


@annotate("blas2.ger")
def ger(alpha, x, y, A, conj_y: bool = True):
    """A + alpha * x yᴴ (rank-1 update) — cf. KokkosBlas2_ger.hpp."""
    yv = arith_traits(A.dtype).conj(y) if conj_y else y
    return A + alpha * torch.outer(x, yv)


def _triangle(A, uplo: str):
    ones = torch.ones(A.shape, dtype=torch.bool, device=A.device)
    return torch.tril(ones) if uplo.upper() == "L" else torch.triu(ones)


@annotate("blas2.syr")
def syr(uplo, alpha, x, A):
    """Symmetric rank-1 update of the given triangle — cf. KokkosBlas2_syr.hpp."""
    return A + torch.where(_triangle(A, uplo), alpha * torch.outer(x, x), 0)


@annotate("blas2.syr2")
def syr2(uplo, alpha, x, y, A):
    """Symmetric rank-2 update of the given triangle — cf. KokkosBlas2_syr2.hpp."""
    full = alpha * (torch.outer(x, y) + torch.outer(y, x))
    return A + torch.where(_triangle(A, uplo), full, 0)
