"""SpADD (C = alpha·A + beta·B) — counterpart of ``tpukk/sparse/spadd.py``
(sparse/src/KokkosSparse_spadd.hpp:32,106).

Symbolic (host): C's union pattern and, for every entry of A and of B, its
position in C; sorted and unsorted rows alike, since positions come from the
(row, column) keys.  Numeric (device): A's scaled values are placed at their
C positions and B's added at theirs, with torch index ops; an absent side
contributes 0, so C = alpha·a + beta·b entry by entry, as in ``tpukk``.
``tpukk``'s slot-sort numeric is a TPU device trick against slow gathers and
is not carried.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import TpuKKError, check
from ..common.tracing import annotate
from ..containers import CsrMatrix, StaticCrsGraph

__all__ = ["SpaddHandle", "spadd_symbolic", "spadd_numeric", "spadd", "bspadd"]


class SpaddHandle:
    """cf. sparse/src/KokkosSparse_spadd_handle.hpp (sorted flag + result nnz)."""

    def __init__(self, sorted_input: bool = True):
        self.sorted_input = sorted_input
        self.c_graph = None     # C's pattern on the operands' device
        self.a_pos = None       # (nnz_a,) int64: C position of each A entry
        self.b_pos = None       # (nnz_b,) int64: C position of each B entry

    @property
    def is_symbolic_called(self) -> bool:
        return self.c_graph is not None

    @property
    def row_map_c(self):
        """C's row map, host int32 (None before the symbolic phase)."""
        return None if self.c_graph is None else self.c_graph.host_row_map()

    @property
    def entries_c(self):
        return None if self.c_graph is None else self.c_graph.host_entries()

    @property
    def nnz_c(self) -> int:
        return 0 if self.c_graph is None else self.c_graph.nnz


@annotate("spadd_symbolic")
def spadd_symbolic(handle: SpaddHandle, A: CsrMatrix, B: CsrMatrix):
    check(A.shape == B.shape, "spadd: shape mismatch")
    check(A.device == B.device, f"spadd: A on {A.device}, B on {B.device}")
    n, m = A.shape

    def keys(M):
        rm = M.host_row_map().astype(np.int64)
        return np.repeat(np.arange(n, dtype=np.int64), np.diff(rm)) * m \
            + M.host_entries().astype(np.int64)

    a_keys, b_keys = keys(A), keys(B)
    uniq = np.unique(np.concatenate([a_keys, b_keys]))
    row_map_c = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(uniq // max(m, 1), minlength=n), out=row_map_c[1:])
    handle.c_graph = StaticCrsGraph.from_arrays(row_map_c, uniq % max(m, 1), n, m,
                                                device=A.device)
    handle.a_pos = torch.from_numpy(np.searchsorted(uniq, a_keys)).to(A.device)
    handle.b_pos = torch.from_numpy(np.searchsorted(uniq, b_keys)).to(A.device)
    return handle.row_map_c


@annotate("spadd_numeric")
def spadd_numeric(handle: SpaddHandle, alpha, A: CsrMatrix, beta, B: CsrMatrix) -> CsrMatrix:
    check(handle.is_symbolic_called, "spadd_numeric: call spadd_symbolic first")
    check(A.nnz == handle.a_pos.shape[0] and B.nnz == handle.b_pos.shape[0]
          and A.device == handle.a_pos.device and B.device == A.device,
          "spadd_numeric: operands differ from the symbolic phase's")
    vals = torch.zeros(handle.nnz_c, dtype=A.dtype, device=A.device)
    vals[handle.a_pos] = (alpha * A.values).to(A.dtype)
    vals[handle.b_pos] += (beta * B.values).to(A.dtype)
    return CsrMatrix.from_graph(handle.c_graph, vals)


@annotate("spadd")
def spadd(alpha, A: CsrMatrix, beta, B: CsrMatrix, sorted_input: bool = True) -> CsrMatrix:
    h = SpaddHandle(sorted_input)
    spadd_symbolic(h, A, B)
    return spadd_numeric(h, alpha, A, beta, B)


def bspadd(alpha, A, beta, B):
    """Block SpADD over BSR operands: not ported yet (ROADMAP queue A item 2,
    the BSR route)."""
    raise TpuKKError("bspadd: BSR matrices are not ported yet (ROADMAP queue A item 2, "
                     "the BSR route)")
