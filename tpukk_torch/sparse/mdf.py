"""MDF — minimum discarded fill ordering and incomplete factorization,
counterpart of ``tpukk/sparse/mdf.py`` (the reference's
sparse/src/KokkosSparse_mdf.hpp:22-38, mdf_symbolic / mdf_numeric /
mdf_ordering, and sparse/impl/KokkosSparse_mdf_impl.hpp).

Greedy: at each step eliminate the vertex whose elimination discards the
least fill (the Frobenius norm of the update that falls outside A's
pattern), with the update restricted to the pattern.  The order is host work:
the C++ ``tpukk_mdf_order`` of ``csrc/host.cpp`` (``native.mdf_order``; a
failed build raises).  ``mdf_order_plain`` is the Python heap loop it is held
against in the tests.  ``mdf_numeric`` is ILU(0) of the permuted matrix, and
its apply is the triangular solve (K5, K4, K5 through ``LUPrec``).
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from .. import native
from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix
from ..graph.ordering import permute_matrix
from .spiluk import SpilukHandle, spiluk_numeric, spiluk_symbolic

__all__ = ["MdfHandle", "mdf_symbolic", "mdf_numeric", "mdf_ordering", "mdf_order_plain"]


class MdfHandle:
    def __init__(self):
        self.is_symbolic_called = False
        self.permutation = None


@annotate("mdf.mdf_ordering")
def mdf_ordering(A: CsrMatrix) -> np.ndarray:
    """The MDF elimination order (cf. mdf.hpp's ordering entry)."""
    h = MdfHandle()
    mdf_symbolic(h, A)
    return h.permutation


def _sorted_f64(A: CsrMatrix):
    check(A.nrows == A.ncols, "mdf: square matrix required")
    sp = A.to_scipy().tocsr().astype(np.float64)
    sp.sort_indices()
    return sp


@annotate("mdf.mdf_symbolic")
def mdf_symbolic(handle: MdfHandle, A: CsrMatrix):
    """The greedy minimum-discarded-fill elimination order (host C++)."""
    sp = _sorted_f64(A)
    handle.permutation = native.mdf_order(sp.indptr, sp.indices, sp.data, sp.shape[0])
    handle.is_symbolic_called = True


def mdf_order_plain(A: CsrMatrix) -> np.ndarray:
    """Plain version of ``native.mdf_order``: the same greedy in Python.

    The elimination updates stay on A's pattern, so the structure is static
    and only values change.  Scores sit in a lazy-invalidation heap of
    (score, stamp, vertex) and are recomputed only for the eliminated
    vertex's live row and column neighbours."""
    sp = _sorted_f64(A)
    n = sp.shape[0]
    rm = sp.indptr
    cols_of = [sp.indices[rm[i]:rm[i + 1]] for i in range(n)]
    pos0 = rm[:-1].copy()
    vals = sp.data.copy()
    spc = sp.tocsc()
    rows_of = [spc.indices[spc.indptr[j]:spc.indptr[j + 1]] for j in range(n)]

    def pos(i, j):
        k = np.searchsorted(cols_of[i], j)
        if k < len(cols_of[i]) and cols_of[i][k] == j:
            return pos0[i] + k
        return -1

    diag_pos = np.array([pos(i, i) for i in range(n)], np.int64)
    alive = np.ones(n, bool)

    def neighbours(v):
        R = rows_of[v][alive[rows_of[v]] & (rows_of[v] != v)]
        C = cols_of[v][alive[cols_of[v]] & (cols_of[v] != v)]
        return R, C

    def score(v):
        dp = diag_pos[v]
        piv = vals[dp] if dp >= 0 else 0.0
        if piv == 0.0:
            return np.inf
        R, C = neighbours(v)
        if len(R) == 0 or len(C) == 0:
            return 0.0
        rv = vals[pos0[v] + np.searchsorted(cols_of[v], C)]
        s = 0.0
        for r in R:
            cv = vals[pos(r, v)]
            k = np.searchsorted(cols_of[r], C)
            inpat = (k < len(cols_of[r])) & (cols_of[r][np.minimum(k, len(cols_of[r]) - 1)] == C)
            upd = (cv * rv[~inpat]) / piv
            s += float(np.sum(upd * upd))
        return s

    stamp = np.zeros(n, np.int64)
    heap = [(score(v), 0, v) for v in range(n)]
    heapq.heapify(heap)
    order = np.empty(n, np.int64)
    for step in range(n):
        v = -1
        while heap:
            _, st, u = heapq.heappop(heap)
            if alive[u] and st == stamp[u]:
                v = u
                break
        if v < 0:
            v = int(np.nonzero(alive)[0][0])
        order[step] = v
        dp = diag_pos[v]
        piv = vals[dp] if dp >= 0 and vals[dp] != 0 else 1.0
        R, C = neighbours(v)
        if len(R) and len(C):
            rv = vals[pos0[v] + np.searchsorted(cols_of[v], C)]
            for r in R:
                cv = vals[pos(r, v)]
                k = np.searchsorted(cols_of[r], C)
                kc = np.minimum(k, len(cols_of[r]) - 1)
                inpat = (cols_of[r][kc] == C) & (k < len(cols_of[r]))
                vals[pos0[r] + kc[inpat]] -= cv * rv[inpat] / piv
        alive[v] = False
        for u in np.union1d(R, C):      # only row and column neighbours' scores changed
            if alive[u]:
                stamp[u] += 1
                heapq.heappush(heap, (score(u), stamp[u], u))
    return order.astype(np.int32)


@annotate("mdf.mdf_numeric")
def mdf_numeric(handle: MdfHandle, A: CsrMatrix) -> Tuple[CsrMatrix, CsrMatrix]:
    """ILU(0) of the MDF-permuted matrix A[p][:, p]: (L, U) in the permuted
    order, on A's device (the permutation is on the handle)."""
    check(handle.is_symbolic_called, "mdf_numeric: symbolic first")
    B = permute_matrix(A, handle.permutation)
    h = SpilukHandle(0)
    spiluk_symbolic(h, B)
    return spiluk_numeric(h, B)
