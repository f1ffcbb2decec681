"""trsv — dense-RHS sparse triangular solve, counterpart of
``tpukk/sparse/trsv.py`` (the reference's sparse/src/KokkosSparse_trsv.hpp,
a host-sequential solve).  It routes through the level-scheduled sptrsv plan
(K5, K4, K5 per column)."""
from __future__ import annotations

import torch

from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix
from ..containers.sort_crs import transpose
from .sptrsv import SptrsvHandle, sptrsv_solve, sptrsv_symbolic

__all__ = ["trsv"]


@annotate("trsv")
def trsv(uplo: str, trans: str, diag: str, A: CsrMatrix, b: torch.Tensor) -> torch.Tensor:
    """Solve op(tri(A))·x = b.  uplo 'L'/'U', trans 'N'/'T'/'C', diag 'N'/'U'
    (unit diagonal); b is (n,) or (n, k), solved column by column."""
    check(uplo.upper() in ("L", "U"), "trsv: uplo must be L or U")
    check(trans.upper() in ("N", "T", "C"), "trsv: trans must be N, T or C")
    check(diag.upper() in ("N", "U"), "trsv: diag must be N or U")
    work = A
    lower = uplo.upper() == "L"
    if trans.upper() in ("T", "C"):
        work = transpose(A)
        if trans.upper() == "C":
            # the conjugate transpose (tpukk/sparse/trsv.py:30); real values are
            # their own conjugate
            work = work.with_values(torch.conj_physical(work.values))
        lower = not lower
    if diag.upper() == "U":
        # unit diagonal: set the diagonal to 1 explicitly
        sp = work.to_scipy().tolil()
        sp.setdiag(1.0)
        spc = sp.tocsr()
        spc.sort_indices()
        work = CsrMatrix.from_scipy(spc, value_dtype=work.host_values().dtype,
                                    device=A.device)
    h = SptrsvHandle(lower=lower)
    sptrsv_symbolic(h, work)
    if b.ndim == 1:
        return sptrsv_solve(h, work, b)
    return torch.stack([sptrsv_solve(h, work, b[:, j]) for j in range(b.shape[1])], dim=1)
