"""Preconditioner interface — counterpart of ``tpukk/sparse/preconditioner.py``
(sparse/src/KokkosSparse_Preconditioner.hpp, KokkosSparse_MatrixPrec.hpp).

A preconditioner is apply(x) ≈ M⁻¹x.  ``LUPrec`` and ``GsPrec`` need the
sparse triangular solve and Gauss-Seidel kernels (ROADMAP queue B, items B6
and B7) and are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers import CsrMatrix
from .spmv import SpmvHandle

__all__ = ["Preconditioner", "IdentityPrec", "MatrixPrec", "JacobiPrec"]


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
        d = A.to_scipy().diagonal()
        inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
        self.inv_diag = torch.from_numpy(inv.astype(A.host_values().dtype)).to(A.device)

    def apply(self, x):
        return self.inv_diag * x if x.ndim == 1 else self.inv_diag[:, None] * x
