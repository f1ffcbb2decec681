"""CRS transforms — counterpart of ``tpukk/containers/sort_crs.py`` (the
subset the SpMV slice uses: ``transpose`` for modes T/H, ``is_sorted``).
Shape-changing transforms are symbolic, so they run on the host in scipy."""
from __future__ import annotations

import numpy as np

from .csr import CsrMatrix

__all__ = ["transpose", "is_sorted"]


def transpose(csr: CsrMatrix, sorted_cols: bool = True) -> CsrMatrix:
    """Materialised Aᵀ on the same device (KokkosSparse_Utils.hpp:338-392)."""
    sp = csr.to_scipy().T.tocsr()
    if sorted_cols:
        sp.sort_indices()
    return CsrMatrix.from_scipy(sp, device=csr.device)


def is_sorted(csr: CsrMatrix) -> bool:
    """Whether every row's column ids ascend."""
    rm = csr.host_row_map()
    ent = csr.host_entries().astype(np.int64)
    if ent.size < 2:
        return True
    descents = np.nonzero(np.diff(ent) < 0)[0] + 1  # positions p with ent[p] < ent[p-1]
    # a descent is allowed only where p starts a new row
    row_starts = rm[1:-1]
    return bool(np.isin(descents, row_starts).all())
