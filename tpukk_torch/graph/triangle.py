"""Triangle counting — counterpart of ``tpukk/graph/triangle.py``
(graph/src/KokkosGraph_Triangle.hpp, the masked-SpGEMM triangle modes of
sparse/impl/KokkosSparse_spgemm_impl_triangle.hpp).

Triangles = Σ over edges (i, j) of L of |N_L(i) ∩ N_L(j)|, L the strict lower
triangle.  A one-shot count is the symbolic phase of the masked SpGEMM and
runs on the host in C++ (``native.triangle_count``).  ``TrianglePlan`` keeps
the closed wedges (i→k→j with (i, j) in L) as index arrays on the device, so
weighted or per-row counts under changing values on a fixed pattern run in
torch ops on the card (``triangle_count_device``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..containers import CsrMatrix

__all__ = ["TrianglePlan", "build_triangle_plan", "triangle_count", "triangle_count_device",
           "triangle_count_per_row", "count_plain"]


def _lower(A: CsrMatrix):
    sp = sps.tril(A.to_scipy(), k=-1).tocsr()
    sp.sort_indices()
    return sp.indptr.astype(np.int64), sp.indices.astype(np.int64)


def _closed_wedges(rm: np.ndarray, ent: np.ndarray, n: int):
    """Every wedge i→k→j of L whose closing edge (i, j) is in L: its legs'
    L entries (a, b), the closing entry t and the apex row i."""
    if len(ent) == 0:
        return (np.empty(0, np.int64),) * 4
    row_len = rm[1:] - rm[:-1]
    row_of = np.repeat(np.arange(n, dtype=np.int64), row_len)
    expand = row_len[ent]  # wedges through each L entry (i, k): k's row of L
    P = int(expand.sum())
    a_idx = np.repeat(np.arange(len(ent), dtype=np.int64), expand)
    b_idx = np.repeat(rm[ent], expand) + np.arange(P, dtype=np.int64) - np.repeat(
        np.cumsum(expand) - expand, expand)
    out_row = np.repeat(row_of, expand)
    # rows ascend and columns are sorted within rows, so the keys i*n+j of L
    # are sorted: one searchsorted is the merge-based membership test
    lkey = row_of * n + ent
    wkey = out_row * n + ent[b_idx]
    pos = np.searchsorted(lkey, wkey)
    hit = (pos < len(lkey)) & (lkey[np.minimum(pos, len(lkey) - 1)] == wkey)
    return a_idx[hit], b_idx[hit], pos[hit], out_row[hit]


def count_plain(A: CsrMatrix) -> np.ndarray:
    """Plain version of the C++ count: triangles per row from the numpy
    closed-wedge enumeration."""
    rm, ent = _lower(A)
    rows = _closed_wedges(rm, ent, A.nrows)[3]
    return np.bincount(rows, minlength=A.nrows).astype(np.int64)


def triangle_count(A: CsrMatrix) -> int:
    """Total triangles in the undirected graph of A."""
    from .. import native

    rm, ent = _lower(A)
    return native.triangle_count(rm, ent, A.nrows)[0]


def triangle_count_per_row(A: CsrMatrix) -> np.ndarray:
    """Triangles per row i, each counted at its largest vertex."""
    from .. import native

    rm, ent = _lower(A)
    return native.triangle_count(rm, ent, A.nrows)[1]


class TrianglePlan:
    """Closed-wedge plan over L, the strict lower triangle of A, on A's
    device: the two wedge legs (a_idx, b_idx) and the closing edge (t_idx) as
    L-entry positions, and the apex row of each wedge (rows)."""

    def __init__(self, A: CsrMatrix):
        rm, ent = _lower(A)
        self.n = A.nrows
        self.rm, self.ent = rm, ent
        a_idx, b_idx, t_idx, rows = _closed_wedges(rm, ent, self.n)
        self.num_triangles = int(len(rows))  # the symbolic phase already knows it
        dev = A.device
        self.a_idx, self.b_idx, self.t_idx, self.rows = (
            torch.from_numpy(x).to(dev) for x in (a_idx, b_idx, t_idx, rows))


def build_triangle_plan(A: CsrMatrix) -> TrianglePlan:
    return TrianglePlan(A)


def triangle_count_device(plan: TrianglePlan, values=None, per_row: bool = False):
    """Count over the plan's closed wedges on its device.

    values=None: unit weights (the count, in f32 as in ``tpukk``); else
    values are L-entry weights (the CSR order of the plan's lower triangle)
    and each triangle contributes w_ik·w_kj·w_ij.  Returns a 0-d tensor, or
    the per-row vector when per_row=True."""
    dev = plan.a_idx.device
    if values is None:
        w = torch.ones(plan.a_idx.shape[0], dtype=torch.float32, device=dev)
    else:
        v = torch.as_tensor(values).to(dev)
        w = v[plan.a_idx] * v[plan.b_idx] * v[plan.t_idx]
    if per_row:
        return torch.zeros(plan.n, dtype=w.dtype, device=dev).index_add_(0, plan.rows, w)
    return w.sum()
