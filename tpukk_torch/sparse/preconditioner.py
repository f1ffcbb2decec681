"""Preconditioner interface — counterpart of ``tpukk/sparse/preconditioner.py``
(sparse/src/KokkosSparse_Preconditioner.hpp, KokkosSparse_MatrixPrec.hpp,
KokkosSparse_LUPrec.hpp).

A preconditioner is apply(x) ≈ M⁻¹x.  ``LUPrec`` applies two level-scheduled
triangular solves (one K4 launch each), or with ``jacobi_sweeps`` a fixed number
of Jacobi-Richardson sweeps on the SpMV kernels.  ``GsPrec`` applies
symmetric Gauss-Seidel sweeps from a zero guess (K5, one K6 launch per color
and direction, K5 for POINT and CLUSTER).
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers import CsrMatrix
from .gauss_seidel import GsHandle, gauss_seidel_apply
from .spmv import SpmvHandle
from .sptrsv import SptrsvHandle, sptrsv_solve, sptrsv_symbolic

__all__ = ["Preconditioner", "IdentityPrec", "MatrixPrec", "JacobiPrec", "LUPrec", "GsPrec"]


def _inv_diag(T: CsrMatrix) -> torch.Tensor:
    """1/diag(T), with 1 where the diagonal is 0, in T's value dtype."""
    d = T.to_scipy().diagonal()
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    return torch.from_numpy(inv.astype(T.host_values().dtype)).to(T.device)


class Preconditioner:
    def apply(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(x)


class IdentityPrec(Preconditioner):
    def apply(self, x):
        return x


class MatrixPrec(Preconditioner):
    """M⁻¹ given explicitly as a matrix (apply = spmv) — cf. MatrixPrec."""

    def __init__(self, M: CsrMatrix):
        self._h = SpmvHandle(M)

    def apply(self, x):
        return self._h(x)


class JacobiPrec(Preconditioner):
    """apply(x) = D⁻¹x, with 1 where the diagonal is 0."""

    def __init__(self, A: CsrMatrix):
        self.inv_diag = _inv_diag(A)

    def apply(self, x):
        return self.inv_diag * x if x.ndim == 1 else self.inv_diag[:, None] * x


class _JacobiTri:
    """Inexact triangular solve by k Jacobi-Richardson sweeps,
    x_{m+1} = D⁻¹(b − N x_m) with T = D + N (the inner iteration of the
    reference's two-stage GS, twostage_gauss_seidel_impl.hpp:120-256, applied
    to the ILU apply).  Each sweep is one SpMV of N through its AUTO route
    (K1 for a banded N, K3 otherwise)."""

    def __init__(self, T: CsrMatrix, sweeps: int):
        N = T.to_scipy().tocsr()
        N.setdiag(0.0)
        N.eliminate_zeros()
        N.sort_indices()
        self.inv_diag = _inv_diag(T)
        self._hn = SpmvHandle(CsrMatrix.from_scipy(N, device=T.device))
        self.sweeps = sweeps

    def solve(self, b):
        x = self.inv_diag * b
        for _ in range(self.sweeps):
            x = self.inv_diag * (b - self._hn(x))
        return x


class LUPrec(Preconditioner):
    """Apply (LU)⁻¹ by two triangular solves — cf. KokkosSparse_LUPrec.hpp
    (the ILU preconditioner of example/gmres/test_prec).

    ``jacobi_sweeps=k`` replaces the exact solves by k Jacobi-Richardson
    sweeps per factor: a fixed linear operator (so GMRES and CG stay valid)
    whose apply is a few SpMVs instead of two dependent level chains."""

    def __init__(self, L: CsrMatrix, U: CsrMatrix, jacobi_sweeps: int | None = None):
        self._L, self._U = L, U
        self._jl = self._ju = None
        if jacobi_sweeps:
            self._jl = _JacobiTri(L, jacobi_sweeps)
            self._ju = _JacobiTri(U, jacobi_sweeps)
            return
        self._hl = SptrsvHandle(lower=True)
        sptrsv_symbolic(self._hl, L)
        self._hu = SptrsvHandle(lower=False)
        sptrsv_symbolic(self._hu, U)

    def apply(self, x):
        if self._jl is not None:
            return self._ju.solve(self._jl.solve(x))
        return sptrsv_solve(self._hu, self._U, sptrsv_solve(self._hl, self._L, x))


class GsPrec(Preconditioner):
    """Gauss-Seidel sweeps as a preconditioner (the pcg use of
    perf_test/sparse/KokkosSparse_pcg.cpp): ``sweeps`` symmetric sweeps from
    x = 0 with a handle that has been through the numeric phase.  Symmetric
    sweeps on a symmetric matrix make a symmetric operator, so CG stays
    valid."""

    def __init__(self, handle: GsHandle, A: CsrMatrix, sweeps: int = 1):
        self._h, self._A, self._sweeps = handle, A, sweeps

    def apply(self, x):
        return gauss_seidel_apply(self._h, self._A, None, x, num_sweeps=self._sweeps,
                                  direction="symmetric")
