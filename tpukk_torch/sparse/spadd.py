"""SpADD (C = alpha·A + beta·B) — counterpart of ``tpukk/sparse/spadd.py``
(sparse/src/KokkosSparse_spadd.hpp:32,106).

Symbolic (host): C's union pattern and, for every entry of A and of B, its
position in C; sorted and unsorted rows alike, since positions come from the
(row, column) keys.  Numeric (device): A's scaled values are placed at their
C positions and B's added at theirs, with torch index ops; an absent side
contributes 0, so C = alpha·a + beta·b entry by entry, as in ``tpukk``.
``tpukk``'s slot-sort numeric is a TPU device trick against slow gathers and
is not carried.  ``bspadd`` does the same on the block graph of two
BsrMatrix operands, placing whole b×b blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import check
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


def _union(A, B, n: int, m: int):
    """Host: C's union pattern over an n × m (block) graph, and the C
    position of each entry of A and of B, from their (row, column) keys."""
    def keys(M):
        rm = M.host_row_map().astype(np.int64)
        return np.repeat(np.arange(n, dtype=np.int64), np.diff(rm)) * m \
            + M.host_entries().astype(np.int64)

    a_keys, b_keys = keys(A), keys(B)
    uniq = np.unique(np.concatenate([a_keys, b_keys]))
    row_map_c = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(uniq // max(m, 1), minlength=n), out=row_map_c[1:])
    graph = StaticCrsGraph.from_arrays(row_map_c, uniq % max(m, 1), n, m, device=A.device)
    return (graph, torch.from_numpy(np.searchsorted(uniq, a_keys)).to(A.device),
            torch.from_numpy(np.searchsorted(uniq, b_keys)).to(A.device))


@annotate("spadd_symbolic")
def spadd_symbolic(handle: SpaddHandle, A: CsrMatrix, B: CsrMatrix):
    check(A.shape == B.shape, "spadd: shape mismatch")
    check(A.device == B.device, f"spadd: A on {A.device}, B on {B.device}")
    handle.c_graph, handle.a_pos, handle.b_pos = _union(A, B, *A.shape)
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


@annotate("bspadd")
def bspadd(alpha, A, beta, B):
    """Block SpADD: C = alpha·A + beta·B over BsrMatrix operands of one block
    size (the block variant of sparse/unit_test/Test_BlockSparse.hpp).  The
    symbolic part is the union of the block patterns on the host; the numeric
    part places whole b×b blocks as ``spadd_numeric`` places entries."""
    from ..containers import BsrMatrix

    check(isinstance(A, BsrMatrix) and isinstance(B, BsrMatrix),
          "bspadd: BsrMatrix operands required")
    check(A.shape == B.shape and A.block_size == B.block_size, "bspadd: shape/block mismatch")
    check(A.device == B.device, f"bspadd: A on {A.device}, B on {B.device}")
    g, a_pos, b_pos = _union(A, B, A.n_block_rows, A.n_block_cols)
    b = A.block_size
    vals = torch.zeros((g.nnz, b, b), dtype=A.dtype, device=A.device)
    vals[a_pos] = (alpha * A.values).to(A.dtype)
    vals[b_pos] += (beta * B.values).to(A.dtype)
    C = BsrMatrix(g.row_map, g.entries, vals, A.nrows, A.ncols, b)
    C._prefill(row_map=g.host_row_map(), entries=g.host_entries())
    return C
