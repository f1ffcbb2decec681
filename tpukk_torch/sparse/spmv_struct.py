"""Structured-grid SpMV — counterpart of ``tpukk/sparse/spmv_struct.py``
(the spmv_struct entry points of sparse/src/KokkosSparse_spmv.hpp; impl
sparse/impl/KokkosSparse_spmv_struct_impl.hpp:92-97, with interior and
boundary functors for 3/5/9-point FD and 7/27-point FE stencils).

A structured-grid matrix is a DIA plan whose diagonal offsets are the
stencil's: the caller states the grid's extents, the matrix's offsets are
checked against the stencil, and the product runs on ``SpmvHandle(DIA)``, K1
(``dia_spmv``) for a vector and K2 (``dia_spmm``) for a multivector.
"""
from __future__ import annotations

import numpy as np

from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix
from .spmv import SpmvAlgorithm, SpmvHandle
from .spmv_impl import detect_dia_offsets

__all__ = ["spmv_struct", "structured_stencil_offsets"]


@annotate("structured_stencil_offsets")
def structured_stencil_offsets(grid, stencil_type: str = "FD"):
    """Expected diagonal offsets for an FD/FE stencil on ``grid``
    (nx[, ny[, nz]]): 3/5/7-point FD, 9/27-point FE."""
    dims = [d for d in grid if d > 1]
    if len(dims) == 1:
        offs = [-1, 0, 1]
    elif len(dims) == 2:
        nx = dims[0]
        offs = [-nx, -1, 0, 1, nx]
        if stencil_type.upper() == "FE":  # 9-point
            offs = sorted(set(offs + [-nx - 1, -nx + 1, nx - 1, nx + 1]))
    else:
        nx, ny = dims[0], dims[1]
        offs = [-nx * ny, -nx, -1, 0, 1, nx, nx * ny]
        if stencil_type.upper() == "FE":  # 27-point
            offs = sorted({a + b + c for a in (0, 1, -1)
                           for b in (0, nx, -nx)
                           for c in (0, nx * ny, -nx * ny)})
    return np.asarray(sorted(offs), dtype=np.int64)


@annotate("spmv_struct")
def spmv_struct(A: CsrMatrix, grid, x, alpha=1.0, beta=0.0, y=None,
                stencil_type: str = "FD", mode: str = "N"):
    """y = beta*y + alpha*op(A)·x for a structured-grid matrix.

    Checks that A's offsets lie within the declared stencil, then runs the
    DIA route (K1 for a vector, K2 for a multivector)."""
    offs = detect_dia_offsets(A)
    check(offs is not None, "spmv_struct: matrix is not a stencil matrix")
    expected = structured_stencil_offsets(grid, stencil_type)
    check(np.isin(offs, expected).all(),
          f"spmv_struct: offsets {offs.tolist()} not within the declared "
          f"{stencil_type} stencil for grid {tuple(grid)}")
    h = SpmvHandle(A, SpmvAlgorithm.DIA)
    return h(x, alpha=alpha, beta=beta, y=y, mode=mode)
