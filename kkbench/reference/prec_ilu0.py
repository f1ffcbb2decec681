"""ILU(0) in the natural order: the factors on A's own pattern, worked out
row by row (IKJ), then two triangular solves by level sets, each level one
vectorised update.  L is unit lower triangular."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from kkbench.reference import csr


def ilu0(A: sps.csr_matrix, dtype) -> sps.csr_matrix:
    """L's strict lower and U's values on A's pattern, in one matrix."""
    A = A.tocsr().copy()
    A.sort_indices()
    ip, ix = A.indptr, A.indices
    v = A.data.astype(dtype)
    n = A.shape[0]
    diag = np.full(n, -1, np.int64)
    for i in range(n):
        hit = np.nonzero(ix[ip[i]:ip[i + 1]] == i)[0]
        if hit.size == 0:
            raise ValueError(f"ilu0: row {i} has no diagonal entry")
        diag[i] = ip[i] + hit[0]
    pos = np.full(n, -1, np.int64)
    for i in range(n):
        s, e = ip[i], ip[i + 1]
        pos[ix[s:e]] = np.arange(s, e)
        for p in range(s, diag[i]):
            k = ix[p]
            v[p] = v[p] / v[diag[k]]
            ks, ke = diag[k] + 1, ip[k + 1]
            q = pos[ix[ks:ke]]
            hit = q >= 0
            v[q[hit]] -= v[p] * v[ks:ke][hit]
        pos[ix[s:e]] = -1
    return sps.csr_matrix((v, ix.copy(), ip.copy()), shape=A.shape)


def levels(T: sps.csr_matrix, lower: bool) -> list:
    """Rows grouped by level: a row's level is one more than the deepest row
    it reads."""
    n = T.shape[0]
    lev = np.zeros(n, np.int64)
    rows = range(n) if lower else range(n - 1, -1, -1)
    ip, ix = T.indptr, T.indices
    for i in rows:
        cols = ix[ip[i]:ip[i + 1]]
        dep = cols[cols < i] if lower else cols[cols > i]
        lev[i] = lev[dep].max() + 1 if dep.size else 0
    order = np.argsort(lev, kind="stable")
    bounds = np.searchsorted(lev[order], np.arange(lev.max() + 2))
    return [order[bounds[k]:bounds[k + 1]] for k in range(len(bounds) - 1)]


class Reference:
    def __init__(self, A, tables: dict, device, dtype):
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.LU = ilu0(A, np_dtype)
        Ls = sps.tril(self.LU, k=-1).tocsr()
        Us = sps.triu(self.LU, k=1).tocsr()
        self.l_blocks = csr.row_blocks(Ls, levels(Ls, True), device, dtype)
        self.u_blocks = csr.row_blocks(Us, levels(Us, False), device, dtype)
        self.inv_u = torch.from_numpy(1.0 / self.LU.diagonal()).to(device, dtype)
        self.n, self.device, self.dtype = A.shape[0], device, dtype

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        y = torch.zeros(self.n, device=self.device, dtype=self.dtype)
        for rows, Lb in self.l_blocks:
            y[rows] = r[rows] - torch.mv(Lb, y)
        x = torch.zeros_like(y)
        for rows, Ub in self.u_blocks:
            x[rows] = self.inv_u[rows] * (y[rows] - torch.mv(Ub, x))
        return x

    def judge(self, tables: dict) -> dict:
        """ilu_gap: the largest gap between the side's factors and these, on
        A's pattern, over the largest of these; inf where the patterns
        differ."""
        L = sps.csr_matrix(tuple(reversed(tables["L"])), shape=self.LU.shape)
        U = sps.csr_matrix(tuple(reversed(tables["U"])), shape=self.LU.shape)
        got = (sps.tril(L, k=-1) + U).tocsr()
        got.sort_indices()
        ref = self.LU.tocsr()
        ref.sort_indices()
        if (got.nnz != ref.nnz or not np.array_equal(got.indptr, ref.indptr)
                or not np.array_equal(got.indices, ref.indices)):
            return {"ilu_gap": float("inf")}
        gap = np.abs(got.data.astype(np.float64) - ref.data.astype(np.float64)).max()
        return {"ilu_gap": float(gap / np.abs(ref.data).max())}


def control_tables(A, dtype, seed: int) -> dict:
    """The control's factors: this ILU(0) in ``dtype``, in the port's layout
    (L with its unit diagonal stored)."""
    LU = ilu0(A, np.float32 if dtype == torch.float32 else np.float64)
    n = A.shape[0]
    L = (sps.tril(LU, k=-1) + sps.identity(n, dtype=LU.dtype, format="csr")).tocsr()
    U = sps.triu(LU, k=0).tocsr()
    return {"L": (L.indptr, L.indices, L.data), "U": (U.indptr, U.indices, U.data)}
