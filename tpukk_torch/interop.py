"""Hand ``tpukk``'s host arrays to this package.

``tpukk`` keeps host numpy mirrors of its matrices (``A.host_row_map()``,
``A.host_entries()``, ``A.host_values_full()``) and of its DIA plans
(``DiaPlan.diags_host``).  These functions turn such arrays into this
package's objects, so one matrix can be given to both packages; this module
imports neither JAX nor ``tpukk``.
"""
from __future__ import annotations

import numpy as np

from .containers import CsrMatrix
from .sparse.spmv_impl import DiaPlan

__all__ = ["csr_from_numpy", "dia_plan_from_numpy"]


def csr_from_numpy(row_map, entries, values, *, nrows: int, ncols: int,
                   device) -> CsrMatrix:
    return CsrMatrix.from_arrays(np.asarray(row_map), np.asarray(entries),
                                 np.asarray(values), nrows=nrows, ncols=ncols,
                                 device=device)


def dia_plan_from_numpy(diags, offsets, nrows: int, ncols: int, device) -> DiaPlan:
    return DiaPlan.from_numpy(np.asarray(diags), offsets, nrows, ncols, device)
