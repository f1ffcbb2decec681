"""Multilevel coarsening — counterpart of ``tpukk/graph/coarsen.py``
(graph/src/KokkosGraph_CoarsenConstruct.hpp with CoarsenHeuristics.hpp, and
KokkosGraph_ExplicitCoarsening.hpp).

Heuristics: MIS2 aggregation (``graph_mis2_aggregate``) or heavy-edge
matching; the coarse graph is Pᵀ·A·P (build_coarse_graph_spgemm,
CoarsenConstruct.hpp:230-258).  Host work with scipy, as in ``tpukk``; the
coarse matrix lands on A's device.
"""
from __future__ import annotations

import enum

import numpy as np
import scipy.sparse as sps

from ..containers import CsrMatrix
from .mis2 import graph_mis2_aggregate

__all__ = ["CoarsenHeuristic", "coarsen", "explicit_coarsen", "heavy_edge_matching"]


class CoarsenHeuristic(enum.Enum):
    MIS2 = "mis2"
    HEAVY_EDGE = "heavy_edge"


def heavy_edge_matching(A: CsrMatrix, seed: int = 0) -> np.ndarray:
    """Greedy heavy-edge matching labels: matched pairs share a label
    (CoarsenHeuristics.hpp matching).  ``seed`` is accepted for ``tpukk``'s
    signature; the matching is deterministic."""
    sp = A.to_scipy().tocoo()
    order = np.argsort(-np.abs(sp.data), kind="stable")
    n = A.nrows
    mate = np.full(n, -1, np.int64)
    for k in order:
        i, j = sp.row[k], sp.col[k]
        if i != j and mate[i] < 0 and mate[j] < 0:
            mate[i], mate[j] = j, i
    labels = np.full(n, -1, np.int64)
    nxt = 0
    for v in range(n):
        if labels[v] < 0:
            labels[v] = nxt
            if mate[v] >= 0:
                labels[mate[v]] = nxt
            nxt += 1
    return labels.astype(np.int32)


def explicit_coarsen(A: CsrMatrix, labels: np.ndarray, keep_values: bool = True):
    """(coarse f64 matrix Pᵀ·A·P on A's device, P as scipy CSR) from an
    aggregation labeling (ExplicitCoarsening.hpp)."""
    n = A.nrows
    nc = int(labels.max()) + 1
    P = sps.csr_matrix((np.ones(n), (np.arange(n), labels)), shape=(n, nc))
    coarse = (P.T @ A.to_scipy() @ P).tocsr()
    if not keep_values:
        coarse.data[:] = 1.0
    coarse.sort_indices()
    return CsrMatrix.from_scipy(coarse.astype(np.float64), device=A.device), P


def coarsen(A: CsrMatrix, heuristic: CoarsenHeuristic = CoarsenHeuristic.MIS2,
            seed: int = 0):
    """One coarsening level: (coarse matrix, labels)."""
    if heuristic == CoarsenHeuristic.MIS2:
        labels = graph_mis2_aggregate(A, seed)
    else:
        labels = heavy_edge_matching(A, seed)
    coarse, _ = explicit_coarsen(A, labels)
    return coarse, labels
