"""Hand ``tpukk``'s host arrays to this package.

``tpukk`` keeps host numpy mirrors of its matrices (``A.host_row_map()``,
``A.host_entries()``, ``A.host_values_full()``) and of its DIA plans
(``DiaPlan.diags_host``), of its ILU factors, of its triangular-solve
levels, of its Gauss-Seidel colorings and clusterings, and of its SpGEMM
pair plans.  These functions turn such arrays into this package's objects, so
one matrix, one factorization, one level schedule or one pair plan can be
given to both packages; this module imports neither JAX nor ``tpukk``.
"""
from __future__ import annotations

import numpy as np

from .common import check
from .containers import CsrMatrix
from .sparse.gauss_seidel import GsHandle, set_color_order
from .sparse.spgemm import SpgemmHandle, set_pair_plan
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
                               entries_c, a_idx, b_idx, c_idx) -> None:
    """The symbolic phase of C = A·B from a pattern and a c-sorted pair plan
    computed elsewhere (``tpukk``'s ``SpgemmHandle.row_map_c``,
    ``entries_c`` and ``pair_plan`` arrays, as numpy arrays), so both
    packages run the numeric phase on one plan."""
    c_idx = np.asarray(c_idx, np.int64)
    nnz_c = len(entries_c)
    check(bool(np.all(np.diff(c_idx) >= 0)) and (len(c_idx) == 0 or (
        c_idx[0] >= 0 and c_idx[-1] < nnz_c)),
          "spgemm_symbolic_from_numpy: c_idx must be sorted and inside C's entries")
    c_ptr = np.zeros(nnz_c + 1, np.int64)
    np.cumsum(np.bincount(c_idx, minlength=nnz_c), out=c_ptr[1:])
    set_pair_plan(handle, A, B, row_map_c, entries_c, a_idx, b_idx, c_ptr)
