"""Hand ``tpukk``'s host arrays to this package.

``tpukk`` keeps host numpy mirrors of its matrices (``A.host_row_map()``,
``A.host_entries()``, ``A.host_values_full()``) and of its DIA plans
(``DiaPlan.diags_host``), of its ILU factors, of its triangular-solve
levels, of its Gauss-Seidel colorings and clusterings, and of its SpGEMM
patterns.  These functions turn such arrays into this package's objects, so
one matrix, one factorization, one level schedule or one product's pattern
can be given to both packages; this module imports neither JAX nor ``tpukk``.
"""
from __future__ import annotations

import numpy as np

from .common import check
from .containers import CsrMatrix
from .sparse.gauss_seidel import GsHandle, set_color_order
from .sparse.spgemm import SpgemmHandle, set_row_plan
from .sparse.spgemm_cuda import check_pattern
from .sparse.spmv_impl import DiaPlan
from .sparse.sptrsv_cuda import LevelPlan, build_level_plan

__all__ = ["csr_from_numpy", "dia_plan_from_numpy", "csr_pair_from_numpy",
           "level_plan_from_numpy", "gs_symbolic_from_numpy", "spgemm_symbolic_from_numpy"]


def csr_from_numpy(row_map, entries, values, *, nrows: int, ncols: int,
                   device) -> CsrMatrix:
    return CsrMatrix.from_arrays(np.asarray(row_map), np.asarray(entries),
                                 np.asarray(values), nrows=nrows, ncols=ncols,
                                 device=device)


def dia_plan_from_numpy(diags, offsets, nrows: int, ncols: int, device) -> DiaPlan:
    return DiaPlan.from_numpy(np.asarray(diags), offsets, nrows, ncols, device)


def csr_pair_from_numpy(L, U, *, device) -> tuple:
    """(L, U) CsrMatrix pair from two square factors, each given as a
    (row_map, entries, values) tuple of host arrays (``tpukk``'s
    ``spiluk_numeric`` output through ``host_row_map()``, ``host_entries()``
    and ``host_values_full()``)."""
    out = []
    for rm, ent, vals in (L, U):
        n = len(rm) - 1
        out.append(csr_from_numpy(rm, ent, vals, nrows=n, ncols=n, device=device))
    return tuple(out)


def level_plan_from_numpy(row_map, entries, values, levels, lower: bool,
                          device) -> LevelPlan:
    """Triangular-solve plan from host CSR arrays and a 1-based level per row
    (``tpukk.sparse.sptrsv._compute_levels``'s output)."""
    rm = np.asarray(row_map)
    return build_level_plan(rm, np.asarray(entries), np.asarray(values), len(rm) - 1,
                            np.asarray(levels), lower, device)


def gs_symbolic_from_numpy(handle: GsHandle, A: CsrMatrix, colors=None,
                           cluster_labels=None) -> None:
    """The symbolic phase of a POINT or CLUSTER handle from a coloring (and
    clustering) computed elsewhere — ``tpukk``'s ``GsHandle.colors`` and
    ``cluster_labels``, as numpy arrays — so both packages sweep in one
    order even where a coloring is not unique.  Given labels but no colors,
    the port colors the cluster graph itself."""
    from .sparse.gauss_seidel import _cluster_colors

    check(colors is not None or cluster_labels is not None,
          "gs_symbolic_from_numpy: give colors, cluster labels or both")
    if colors is None:
        colors = _cluster_colors(handle, A, np.asarray(cluster_labels))
    set_color_order(handle, A, np.asarray(colors), cluster_labels)


def spgemm_symbolic_from_numpy(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix, row_map_c,
                               entries_c) -> None:
    """The symbolic phase of C = A·B from a pattern computed elsewhere
    (``tpukk``'s ``SpgemmHandle.row_map_c`` and ``entries_c``, as numpy
    arrays), so both packages run the numeric phase on one pattern.  C's
    columns must be sorted within each row, and the pattern must hold every
    product's column (``spgemm_cuda.check_pattern``)."""
    rm = np.asarray(row_map_c, np.int64)
    ent = np.asarray(entries_c, np.int64)
    check(len(rm) == A.nrows + 1 and rm[0] == 0 and rm[-1] == len(ent)
          and bool(np.all(np.diff(rm) >= 0)),
          "spgemm_symbolic_from_numpy: row_map_c must rise from 0 to C's entries over A's rows")
    inner = np.diff(ent) > 0
    starts = rm[1:-1]
    inner[starts[(starts > 0) & (starts < len(ent))] - 1] = True  # a row may start lower
    check(bool(inner.all()),
          "spgemm_symbolic_from_numpy: C's columns must be sorted and distinct within a row")
    set_row_plan(handle, A, B, rm, ent)
    check_pattern(handle.row_plan)
