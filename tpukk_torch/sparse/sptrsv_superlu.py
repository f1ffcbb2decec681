"""External-factor import for the triangular solvers — counterpart of
``tpukk/sparse/sptrsv_superlu.py`` (the role of the reference's SuperLU
adapter, sparse/src/KokkosSparse_sptrsv_superlu.hpp:87-140): scipy's SuperLU
object (``scipy.sparse.linalg.splu``) owns the numeric factorization, this
package owns the solve.  ``superlu_import`` turns its L and U into
``SptrsvHandle``s (level-set or supernodal, the supernodes detected on the
imported pattern), and ``SuperLUSolve`` applies
x = Pc·(U⁻¹·(L⁻¹·(Pr·b))) as two K4 launches: Pr is composed into the L
solve's ``src`` and Pc into the U solve's ``dst`` when the solver is built.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.tracing import annotate
from ..containers import CsrMatrix
from .sptrsv import SptrsvAlgorithm, SptrsvHandle, _permuted_solve, sptrsv_symbolic

__all__ = ["SuperLUSolve", "superlu_import"]


class SuperLUSolve:
    """Imported LU solve: two handles and the row and column permutations of
    an external factorization, on the factors' device.  Callable as
    x = solver(b); ``apply`` is the preconditioner contract (``LUPrec``'s)."""

    def __init__(self, Lh, Uh, L: CsrMatrix, U: CsrMatrix, perm_r, perm_c):
        self.Lh, self.Uh = Lh, Uh
        self.L, self.U = L, U
        # scipy's convention: Pr·A·Pc = L·U with (Pr·b)[perm_r[i]] = b[i] and Pc·z = z[perm_c]
        self.inv_perm_r = torch.from_numpy(np.argsort(perm_r).astype(np.int32)).to(L.device)
        self.perm_c = torch.from_numpy(np.asarray(perm_c, np.int32)).to(L.device)
        self._solve_l = _permuted_solve(Lh, before=self.inv_perm_r)
        self._solve_u = _permuted_solve(Uh, after=self.perm_c)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve_u(self._solve_l(b))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self(r)


@annotate("sptrsv_superlu_import")
def superlu_import(lu, algorithm: SptrsvAlgorithm = SptrsvAlgorithm.SEQLVLSCHD,
                   value_dtype=None, device=None) -> SuperLUSolve:
    """Import a scipy ``SuperLU`` object into solve handles on ``device``
    (the reference's ``read_superlu_*``); ``algorithm`` picks the level-set
    solve (default) or SUPERNODAL."""
    Lsp = lu.L.tocsr()
    Usp = lu.U.tocsr()
    Lsp.sort_indices()
    Usp.sort_indices()
    L = CsrMatrix.from_scipy(Lsp, value_dtype=value_dtype, device=device)
    U = CsrMatrix.from_scipy(Usp, value_dtype=value_dtype, device=device)
    Lh = SptrsvHandle(lower=True, algorithm=algorithm)
    Uh = SptrsvHandle(lower=False, algorithm=algorithm)
    sptrsv_symbolic(Lh, L)
    sptrsv_symbolic(Uh, U)
    return SuperLUSolve(Lh, Uh, L, U, np.asarray(lu.perm_r, np.int64),
                        np.asarray(lu.perm_c, np.int64))
