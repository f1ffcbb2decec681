"""Graph orderings — counterpart of ``tpukk/graph/ordering.py``: RCM
(graph/src/KokkosGraph_RCM.hpp:31-40, BFS-based, impl
graph/impl/KokkosGraph_BFS_impl.hpp) and RCB, recursive coordinate bisection
(graph/src/KokkosGraph_RCB.hpp, impl _RCB_impl.hpp).

Orderings are plan-time symbolic work, so they run on the host.  RCM is the
C++ BFS of ``csrc/host.cpp`` (George-Liu pseudo-peripheral start, then
Cuthill-McKee in ascending-degree order); scipy's csgraph RCM is its plain
version (``rcm_plain``), against which the tests hold its bandwidth.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..containers import CsrMatrix

__all__ = ["rcm", "rcm_plain", "rcb", "permute_matrix"]


def _pattern(A: CsrMatrix, symmetrize: bool):
    sp = A.to_scipy()
    if symmetrize:
        sp = (sp + sp.T).tocsr()
        sp.sort_indices()
    return sp


def rcm(A: CsrMatrix, symmetrize: bool = True) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new ordering: perm[i] = old index)."""
    sp = _pattern(A, symmetrize)
    return native.rcm(sp.indptr, sp.indices, sp.shape[0])


def rcm_plain(A: CsrMatrix, symmetrize: bool = True) -> np.ndarray:
    """Plain version of ``rcm``: scipy's reverse Cuthill-McKee.  It picks
    other start vertices and tie-breaks than the C++ BFS, so the two agree in
    quality (bandwidth), not element by element."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    sp = _pattern(A, symmetrize)
    return np.asarray(reverse_cuthill_mckee(sp, symmetric_mode=symmetrize), dtype=np.int32)


def rcb(coords: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: coords (n, d) -> part id per point.
    Splits along the widest dimension at the median (cf. _RCB_impl.hpp)."""
    n = coords.shape[0]
    parts = np.zeros(n, np.int32)

    def split(idx, lo, hi):
        if hi - lo <= 1 or idx.size == 0:
            parts[idx] = lo
            return
        span = coords[idx].max(axis=0) - coords[idx].min(axis=0)
        dim = int(np.argmax(span))
        order = np.argsort(coords[idx, dim], kind="stable")
        mid_parts = (hi - lo) // 2
        cut = idx.size * mid_parts // (hi - lo)
        split(idx[order[:cut]], lo, lo + mid_parts)
        split(idx[order[cut:]], lo + mid_parts, hi)

    split(np.arange(n), 0, n_parts)
    return parts


def permute_matrix(A: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """Symmetric permutation B = A[perm,:][:,perm] (host symbolic), on A's
    device."""
    sp = A.to_scipy()[perm][:, perm].tocsr()
    sp.sort_indices()
    return CsrMatrix.from_scipy(sp, value_dtype=A.host_values().dtype, device=A.device)
