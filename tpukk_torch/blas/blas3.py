"""BLAS3 — gemm / trmm / trsm, counterpart of ``tpukk/blas/blas3.py``
(blas/src/KokkosBlas3_*.hpp).

``tpukk`` computes gemm as one XLA dot with an accumulation dtype
(``preferred_element_type``) and HIGHEST precision, outside any Pallas
kernel, so ``torch.matmul`` (cuBLAS) is the port: the operands go to the
accumulation dtype (A's, at least f32) and are multiplied there.  f32
products stay f32 on the card (``torch.backends.cuda.matmul.allow_tf32`` is
False and the float32 matmul precision "highest", PyTorch's defaults, which
this module does not change).  trsm is ``torch.linalg.solve_triangular``.
"""
from __future__ import annotations

import torch

from ..common import check
from ..common.arith_traits import _torch_dtype
from ..common.tracing import annotate

__all__ = ["gemm", "trmm", "trsm"]


def _op(A, trans: str):
    t = trans.upper()
    check(t in ("N", "T", "C"), f"invalid trans '{trans}'")
    if t == "N":
        return A
    return A.mT if t == "T" else A.mH


@annotate("blas3.gemm")
def gemm(transA, transB, alpha, A, B, beta, C, preferred_element_type=None):
    """beta*C + alpha*op(A)·op(B) in C's dtype — cf.
    blas/src/KokkosBlas3_gemm.hpp:96."""
    pet = (_torch_dtype(preferred_element_type) if preferred_element_type is not None
           else torch.promote_types(A.dtype, torch.float32))
    prod = torch.matmul(_op(A, transA).to(pet), _op(B, transB).to(pet))
    return (beta * C + alpha * prod).to(C.dtype)


def _tri_mask(A, uplo: str, diag: str):
    m = torch.tril(A) if uplo.upper() == "L" else torch.triu(A)
    if diag.upper() == "U":  # unit diagonal
        m = m - torch.diag(torch.diag(m)) + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return m


@annotate("blas3.trmm")
def trmm(side, uplo, trans, diag, alpha, A, B):
    """alpha*op(tri(A))·B (side='L') or alpha*B·op(tri(A)) (side='R')."""
    T = _op(_tri_mask(A, uplo, diag), trans)
    if side.upper() == "L":
        return alpha * torch.matmul(T, B)
    return alpha * torch.matmul(B, T)


@annotate("blas3.trsm")
def trsm(side, uplo, trans, diag, alpha, A, B):
    """Solve op(tri(A))·X = alpha*B (side='L') or X·op(tri(A)) = alpha*B.
    As in ``tpukk`` (lax.linalg.triangular_solve's flags): 'T' transposes A,
    'C' conjugates it without transposing, anything else is A."""
    t = trans.upper()
    lower = uplo.upper() == "L"
    Aop = A.mT if t == "T" else (A.conj() if t == "C" else A)
    # a transpose moves the stored triangle to the other side
    upper = lower if t == "T" else not lower
    return torch.linalg.solve_triangular(Aop, alpha * B, upper=upper, left=side.upper() == "L",
                                         unitriangular=diag.upper() == "U")
