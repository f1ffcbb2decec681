"""SpILUK — ILU(k) incomplete factorization, counterpart of
``tpukk/sparse/spiluk.py`` (the reference's sparse/src/KokkosSparse_spiluk.hpp,
:42 symbolic and :200 numeric, with the level-of-fill symbolic of
sparse/impl/KokkosSparse_spiluk_symbolic_impl.hpp:37-88).

Symbolic and numeric are host work, as in ``tpukk``: the C++ planners of
``csrc/host.cpp`` (``native.iluk_symbolic``, ``native.iluk_depth``,
``native.ilu_numeric``) compute the ILU(k) pattern, its entry-dependency
depth and the IKJ factorization in f64, and the factors are cast to A's dtype.
A failed build of the planners raises.  The pure-Python versions stay here
as the plain versions the tests hold the C++ against (``_iluk_pattern``,
``_ilu_numeric_plain``).

Returns L (unit lower, diagonal stored) and U (upper) as separate CSR
matrices on A's device.  ``tpukk``'s device value refresh
(``build_iluk_refresh`` / ``spiluk_refresh``) needs par_ilut's sweep plan and
is not ported yet (ROADMAP queue A, item A12).
"""
from __future__ import annotations

import bisect
from typing import Tuple

import numpy as np
import scipy.sparse as sps

from .. import native
from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix

__all__ = ["SpilukHandle", "spiluk_symbolic", "spiluk_numeric",
           "build_iluk_refresh", "spiluk_refresh"]

_REFRESH = ("the device ILU(k) value refresh is not ported yet: it needs par_ilut's "
            "sweep plan (ROADMAP queue A, item A12)")


class SpilukHandle:
    """cf. spiluk_handle.hpp (fill level k, pattern, dependency depth)."""

    def __init__(self, fill_level: int = 0):
        self.fill_level = int(fill_level)
        self.is_symbolic_called = False
        self.pattern = None      # scipy csr pattern of L+U (with diagonal)
        self.depth = None        # entry-DAG depth of the pattern


def _iluk_pattern(A: sps.csr_matrix, k: int) -> sps.csr_matrix:
    """Plain version of ``native.iluk_symbolic``: the level-of-fill
    recurrence row by row (fill(i,j) = min over paths; entry kept if
    fill <= k), in Python."""
    n = A.shape[0]
    A = A.tocsr()
    A.sort_indices()
    INF = np.iinfo(np.int32).max
    rows_cols = []
    lvl_of: list = [None] * n
    for i in range(n):
        s, e = A.indptr[i], A.indptr[i + 1]
        cols = dict.fromkeys(A.indices[s:e].tolist(), 0)
        cols[i] = 0
        # IKJ update: for each kk < i in the row, merge row kk of U
        work = sorted(cols)
        wi = 0
        while wi < len(work):
            kk = work[wi]
            wi += 1
            if kk >= i:
                continue
            lik = cols[kk]
            if lik > k:
                continue
            for jj, lkj in zip(*lvl_of[kk]):
                if jj <= kk:
                    continue
                f = lik + lkj + 1
                if f <= k and f < cols.get(jj, INF):
                    if jj not in cols:
                        bisect.insort(work, jj)
                    cols[jj] = f
        keys = sorted(cols)
        cs = np.fromiter(keys, dtype=np.int64)
        lvl_of[i] = (cs, np.fromiter((cols[c] for c in keys), dtype=np.int64))
        rows_cols.append(cs)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(c) for c in rows_cols])
    indices = np.concatenate(rows_cols) if n else np.empty(0, np.int64)
    return sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=A.shape)


def _ilu_numeric_plain(sp: sps.csr_matrix, indptr, indices) -> np.ndarray:
    """Plain version of ``native.ilu_numeric``: dense-row-workspace IKJ
    factorization restricted to the pattern, f64, in Python."""
    n = sp.shape[0]
    vals = np.zeros(len(indices))
    w = np.zeros(n)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        w[:] = 0.0
        arow = sp.getrow(i)
        w[arow.indices] = arow.data
        for idx in range(s, e):
            kk = indices[idx]
            if kk >= i:
                break
            # l_ik = w_k / u_kk
            ks, ke = indptr[kk], indptr[kk + 1]
            kcols = indices[ks:ke]
            kvals = vals[ks:ke]
            lik = w[kk] / kvals[kcols == kk][0]
            w[kk] = lik
            upd = kcols > kk
            w[kcols[upd]] -= lik * kvals[upd]
        vals[s:e] = w[cols]
    return vals


@annotate("spiluk.spiluk_symbolic")
def spiluk_symbolic(handle: SpilukHandle, A: CsrMatrix) -> int:
    """ILU(k) pattern of A (host C++); returns its number of entries."""
    check(A.nrows == A.ncols, "spiluk: square matrix required")
    sp = A.to_scipy()
    indptr, indices = native.iluk_symbolic(sp.indptr, sp.indices, A.nrows, handle.fill_level)
    handle.pattern = sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=sp.shape)
    handle.depth = native.iluk_depth(indptr, indices, A.nrows)
    handle.is_symbolic_called = True
    return handle.pattern.nnz


@annotate("spiluk.spiluk_numeric")
def spiluk_numeric(handle: SpilukHandle, A: CsrMatrix) -> Tuple[CsrMatrix, CsrMatrix]:
    """Factor within the symbolic pattern (host C++, f64); returns (L unit
    lower with its diagonal stored, U), in A's dtype on A's device."""
    check(handle.is_symbolic_called, "spiluk_numeric: symbolic first")
    sp = A.to_scipy().tocsr()
    pat = handle.pattern
    vals = native.ilu_numeric(pat.indptr, pat.indices, sp.indptr, sp.indices,
                              sp.data.astype(np.float64), sp.shape[0])
    return _split_lu(sp, pat.indptr, pat.indices, vals, A)


def _split_lu(sp, indptr, indices, vals, A: CsrMatrix):
    n = sp.shape[0]
    LU = sps.csr_matrix((vals, indices.copy(), indptr.copy()), shape=sp.shape)
    L = (sps.tril(LU, k=-1).tocsr() + sps.identity(n, format="csr")).tocsr()
    U = sps.triu(LU, k=0).tocsr()
    L.sort_indices()
    U.sort_indices()
    dt = A.host_values().dtype
    return (CsrMatrix.from_scipy(L, value_dtype=dt, device=A.device),
            CsrMatrix.from_scipy(U, value_dtype=dt, device=A.device))


def build_iluk_refresh(handle: SpilukHandle, A: CsrMatrix):
    raise NotImplementedError(_REFRESH)


def spiluk_refresh(plan, a_values):
    raise NotImplementedError(_REFRESH)
