"""Distance-2 maximal independent set and MIS2 aggregation — counterpart of
``tpukk/graph/mis2.py`` (graph/src/KokkosGraph_MIS2.hpp:53-68: graph_mis2,
graph_mis2_aggregate, graph_mis2_coarsen; impl
graph/impl/KokkosGraph_Distance2MIS_impl.hpp).

Luby rounds with random priorities ``np.random.default_rng(seed).permutation
(n)``, ``tpukk``'s, so the roots are ``tpukk``'s.  They run on the
diagonal-free pattern of A² + A (distance ≤ 2), which the host builds with
scipy.  From 4096 vertices up the rounds run on the graph's device, each as
two K3 ``csr_spmv`` launches on that pattern: ``reduce="max"`` finds every
undecided vertex's best undecided neighbor priority, ``"sum"`` marks the
neighborhoods of the round's winners (``tpukk``'s ``_device_loop``,
mis2.py:33-65, with one device→host read per round).  Smaller graphs run the
host loop.  Aggregation and coarsening are host work, as in ``tpukk``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..containers import CsrMatrix

__all__ = ["graph_mis2", "graph_mis2_aggregate", "graph_mis2_coarsen"]

_DEVICE_MIN_N = 4096
_MAX_ROUNDS = 128


def _pattern(graph) -> sps.csr_matrix:
    rm = graph.host_row_map()
    ent = graph.host_entries()
    # copies: the host mirrors are shared caches and scipy may mutate
    return sps.csr_matrix((np.ones(len(ent)), ent.copy(), rm.copy()),
                          shape=(graph.nrows, graph.ncols))


def _mis2_device(A2: sps.csr_matrix, prio: np.ndarray, dev) -> np.ndarray:
    """State per vertex after the device rounds: 1 in the set, -1 out."""
    from ..sparse import spmv_cuda  # lazy: sparse imports graph

    Ad = A2.copy()
    Ad.setdiag(0)
    Ad.eliminate_zeros()
    Ad.data[:] = 1.0  # A·A carries path multiplicities; the rounds need the pattern
    Am = CsrMatrix.from_scipy(Ad.astype(np.float32), device=dev)
    plan = spmv_cuda.build_csr_plan(Am, torch.float32)
    n = A2.shape[0]
    prio_t = torch.from_numpy((prio + 1.0).astype(np.float32)).to(dev)
    st = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(_MAX_ROUNDS):
        undecided = st == 0
        if not bool(undecided.any()):
            break
        p = torch.where(undecided, prio_t, zero)
        nbr_best = spmv_cuda.csr_spmv(plan, p, "max")
        win = undecided & (p > nbr_best)
        covered = spmv_cuda.csr_spmv(plan, win.to(torch.float32)) > 0
        st = torch.where(win, 1, torch.where(undecided & covered, -1, st))
    return st.cpu().numpy()


def graph_mis2(graph, seed: int = 0) -> np.ndarray:
    """Indices (host int32, ascending) of a maximal set with pairwise
    distance > 2."""
    A = _pattern(graph)
    n = A.shape[0]
    A2 = (A @ A).tocsr()
    A2 = (A2 + A).tocsr()  # distance-1 or distance-2 adjacency
    prio = np.random.default_rng(seed).permutation(n).astype(np.int64)
    if n >= _DEVICE_MIN_N:
        st = _mis2_device(A2, prio.astype(np.float64), graph.row_map.device)
        return np.nonzero(st == 1)[0].astype(np.int32)
    state = np.zeros(n, np.int8)  # 0 undecided, 1 in set, -1 out
    rm, ent = A2.indptr, A2.indices
    rows = np.repeat(np.arange(n), rm[1:] - rm[:-1])
    not_self = ent != rows
    while (state == 0).any():
        undecided = state == 0
        # v joins if its priority beats all undecided distance ≤ 2 neighbors
        cand_prio = np.where(undecided, prio, -1)
        vals = np.where(undecided[ent] & not_self, prio[ent], -1)
        nbr_best = np.full(n, -1, np.int64)
        nz = rm[1:] > rm[:-1]
        nbr_best[nz] = np.maximum.reduceat(vals, rm[:-1][nz])
        win = undecided & (cand_prio > nbr_best)
        state[win] = 1
        # the winners' distance ≤ 2 neighbors are out (A2 is symmetric)
        if win.any():
            out = (A2 @ win.astype(np.float64)) > 0
            out &= state == 0
            state[out] = -1
        elif (state == 0).any():
            # a tie stall (impossible with a permutation): the lowest index joins
            state[np.nonzero(state == 0)[0][0]] = 1
    return np.nonzero(state == 1)[0].astype(np.int32)


def graph_mis2_aggregate(graph, seed: int = 0) -> np.ndarray:
    """Label each vertex with the nearest MIS-2 root (aggregation, the
    clustering of cluster Gauss-Seidel) — cf. graph_mis2_aggregate."""
    A = _pattern(graph)
    n = A.shape[0]
    roots = graph_mis2(graph, seed)
    labels = np.full(n, -1, np.int64)
    labels[roots] = np.arange(len(roots))
    rm, ent = A.indptr, A.indices
    nz = rm[1:] > rm[:-1]
    big = np.iinfo(np.int64).max
    # from all roots at once: an unlabeled vertex adopts its smallest labeled
    # neighbor's label; a vertex no root reaches starts its own aggregate
    while (labels == -1).any():
        unl = labels == -1
        lab_n = np.where(labels[ent] >= 0, labels[ent], big)
        best = np.full(n, big)
        best[nz] = np.minimum.reduceat(lab_n, rm[:-1][nz])
        adopt = unl & (best != big)
        if adopt.any():
            labels[adopt] = best[adopt]
        else:
            labels[np.nonzero(unl)[0][0]] = labels.max() + 1
    return labels.astype(np.int32)


def graph_mis2_coarsen(graph, seed: int = 0):
    """(coarse graph Pᵀ·A·P without its diagonal, f32 on the graph's device;
    labels), P the aggregation matrix — cf. build_coarse_graph_spgemm
    (CoarsenConstruct.hpp:230-258)."""
    A = _pattern(graph)
    labels = graph_mis2_aggregate(graph, seed)
    nc = int(labels.max()) + 1
    n = A.shape[0]
    P = sps.csr_matrix((np.ones(n), (np.arange(n), labels)), shape=(n, nc))
    coarse = (P.T @ A @ P).tocsr()
    coarse.setdiag(0)
    coarse.eliminate_zeros()
    coarse.sort_indices()
    return CsrMatrix.from_scipy(coarse.astype(np.float32), device=graph.row_map.device), labels
