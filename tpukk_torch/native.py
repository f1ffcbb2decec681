"""Host planners in C++ — counterpart of ``tpukk/native`` (the subset the
ILU(k)-GMRES, Gauss-Seidel, SpGEMM and factor-and-solve slices use).

The library is ``csrc/host.cpp``, built with g++ at first use into
``build/tpukk_torch/`` (``_kernels.py``), never beside the source.  Unlike
``tpukk.native``, nothing here returns None for a missing toolchain: a failed
build raises, so the solve path never drops silently to the Python planners.
Those stay beside their callers as the plain versions the tests hold these
against (``sparse/spiluk.py``: ``_iluk_pattern``, ``_ilu_numeric_plain``;
``graph/ordering.py``: ``rcm_plain``; ``graph/coloring.py``:
``serial_greedy_plain``; ``sparse/spgemm.py``: ``symbolic_plain``;
``graph/triangle.py``: ``count_plain``; ``sparse/mdf.py``: ``mdf_order_plain``).
"""
from __future__ import annotations

import numpy as np

from . import _kernels
from .common import TpuKKError

__all__ = ["iluk_symbolic", "ilu_numeric", "iluk_depth", "rcm", "d1_greedy_color",
           "d2_greedy_color", "spgemm_symbolic", "triangle_count", "mdf_order"]


def _lib():
    return _kernels.library("host")


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def iluk_symbolic(indptr, indices, n: int, k: int):
    """ILU(k) pattern (row map, sorted column ids, diagonal included) of the
    square CSR pattern (indptr, indices)."""
    indptr, indices = _i32(indptr), _i32(indices)
    lib = _lib()
    nnz = lib.tpukk_iluk_symbolic(n, k, indptr.ctypes.data, indices.ctypes.data, None, None)
    out_indptr = np.zeros(n + 1, np.int32)
    out_indices = np.zeros(max(nnz, 1), np.int32)
    lib.tpukk_iluk_symbolic(n, k, indptr.ctypes.data, indices.ctypes.data,
                            out_indptr.ctypes.data, out_indices.ctypes.data)
    return out_indptr, out_indices[:nnz]


def ilu_numeric(p_indptr, p_indices, a_indptr, a_indices, a_values, n: int) -> np.ndarray:
    """f64 L\\U values on the pattern (p_indptr, p_indices) of A's IKJ
    incomplete factorization."""
    arrays = [_i32(p_indptr), _i32(p_indices), _i32(a_indptr), _i32(a_indices),
              np.ascontiguousarray(a_values, np.float64)]
    lu_vals = np.zeros(len(arrays[1]), np.float64)
    rc = _lib().tpukk_ilu_numeric(n, *(a.ctypes.data for a in arrays), lu_vals.ctypes.data)
    if rc != 0:
        raise TpuKKError(f"ilu_numeric failed (rc={rc}: "
                         f"{'missing diagonal' if rc == -1 else 'zero pivot'})")
    return lu_vals


def iluk_depth(row_map, entries, n: int) -> int:
    """Entry-dependency DAG depth of an ILU(k) pattern (sorted columns,
    diagonal present)."""
    rm, ent = _i32(row_map), _i32(entries)
    return int(_lib().tpukk_iluk_depth(n, rm.ctypes.data, ent.ctypes.data))


def rcm(row_map, entries, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old) of the pattern's
    graph, as given (pass a symmetric pattern for the textbook ordering)."""
    rm, ent = _i32(row_map), _i32(entries)
    perm = np.empty(n, np.int32)
    _lib().tpukk_rcm(n, rm.ctypes.data, ent.ctypes.data, perm.ctypes.data)
    return perm


def d1_greedy_color(row_map, entries, n: int) -> np.ndarray:
    """1-based distance-1 greedy colors in vertex order (self loops ignored)."""
    rm, ent = _i32(row_map), _i32(entries)
    colors = np.zeros(n, np.int32)
    _lib().tpukk_d1_greedy_color(n, rm.ctypes.data, ent.ctypes.data, colors.ctypes.data)
    return colors


def d2_greedy_color(row_map, entries, n: int, row_map_t=None, entries_t=None, m=None,
                    include_d1: bool = True) -> np.ndarray:
    """1-based distance-2 greedy colors without forming G².  With no
    transpose given the graph is square and symmetric; otherwise rows that
    share a column conflict, through the column→row transpose (m columns)."""
    rm, ent = _i32(row_map), _i32(entries)
    if row_map_t is None:
        rm_t, ent_t, m = rm, ent, n
    else:
        rm_t, ent_t = _i32(row_map_t), _i32(entries_t)
    colors = np.zeros(n, np.int32)
    _lib().tpukk_d2_greedy_color(n, rm.ctypes.data, ent.ctypes.data, m, rm_t.ctypes.data,
                                 ent_t.ctypes.data, 1 if include_d1 else 0,
                                 colors.ctypes.data)
    return colors


def spgemm_symbolic(rmA, ciA, n: int, bcols: int, rmB, ciB):
    """C = A·B's pattern and pair plan: (row_map_c int32, entries_c int32,
    a_idx int32, b_idx int32, c_ptr int64).  The pairs of C entry c are
    c_ptr[c] .. c_ptr[c+1]-1, in (A entry, B entry) order; a_idx and b_idx
    index A's and B's values."""
    rmA, ciA, rmB, ciB = _i32(rmA), _i32(ciA), _i32(rmB), _i32(ciB)
    # the C++ loops index B's rows by A's columns and C's columns by B's
    for name, ci, bound in (("A", ciA, len(rmB) - 1), ("B", ciB, bcols)):
        if ci.size and (int(ci.min()) < 0 or int(ci.max()) >= bound):
            raise TpuKKError(f"spgemm_symbolic: a column id of {name} lies outside [0, {bound})")
    lib = _lib()
    row_map_c = np.empty(n + 1, np.int32)
    nnz_c = int(lib.tpukk_spgemm_symbolic_count(n, rmA.ctypes.data, ciA.ctypes.data, bcols,
                                                rmB.ctypes.data, ciB.ctypes.data,
                                                row_map_c.ctypes.data))
    if nnz_c >= 2**31:
        raise TpuKKError(f"spgemm_symbolic: nnz(C) = {nnz_c} does not fit the int32 row map")
    P = int((rmB[1:] - rmB[:-1]).astype(np.int64)[ciA].sum())
    entries_c = np.empty(nnz_c, np.int32)
    a_idx = np.empty(P, np.int32)
    b_idx = np.empty(P, np.int32)
    c_ptr = np.empty(nnz_c + 1, np.int64)
    lib.tpukk_spgemm_pairs(n, rmA.ctypes.data, ciA.ctypes.data, bcols, rmB.ctypes.data,
                           ciB.ctypes.data, row_map_c.ctypes.data, entries_c.ctypes.data,
                           a_idx.ctypes.data, b_idx.ctypes.data, c_ptr.ctypes.data)
    return row_map_c, entries_c, a_idx, b_idx, c_ptr


def triangle_count(row_map, entries, n: int):
    """(total, per-row counts int64) of the triangles of a strict lower
    triangle given as CSR with sorted columns."""
    rm, ent = _i32(row_map), _i32(entries)
    per_row = np.zeros(n, np.int64)
    total = _lib().tpukk_triangle_count(n, rm.ctypes.data, ent.ctypes.data, per_row.ctypes.data)
    return int(total), per_row


def mdf_order(indptr, indices, values, n: int) -> np.ndarray:
    """The minimum-discarded-fill greedy elimination order (int32, order[step]
    = the vertex eliminated at that step) of a square CSR matrix with sorted
    columns, f64 values."""
    rm, ci = _i32(indptr), _i32(indices)
    vals = np.ascontiguousarray(values, np.float64)
    order = np.empty(n, np.int32)
    _lib().tpukk_mdf_order(n, rm.ctypes.data, ci.ctypes.data, vals.ctypes.data, order.ctypes.data)
    return order
