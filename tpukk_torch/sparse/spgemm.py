"""SpGEMM (C = A·B) — counterpart of ``tpukk/sparse/spgemm.py``
(sparse/src/KokkosSparse_spgemm_symbolic.hpp:27, _numeric.hpp:34).

Two phases, with the reference handle's reuse contract
(spgemm_handle.hpp:248-252):

* **symbolic** (host C++, ``native.spgemm_symbolic``): C's pattern, moved to
  A's device once, and K8's row plan built there (``spgemm_cuda.build_row_plan``:
  the rows binned by their lanes, O(rows) bytes).
* **numeric** (device): K8 (``spgemm_cuda.spgemm_rows``) sums each C row's
  products in a shared-memory accumulator, f32, f64, complex64 and
  complex128.  New values on the
  same patterns re-run only this.

``SpgemmAlgorithm`` mirrors SPGEMMAlgorithm (spgemm_handle.hpp:44-76): KK is
the row-wise numeric (and routes banded operands with full diagonals to DIA),
DENSE_ACC a dense accumulator in torch ops for a narrow B, DEBUG scipy on the
host, DIA the offset convolution of ``spgemm_dia.py``.

Block (BSR) SpGEMM, ``bspgemm_symbolic``/``bspgemm_numeric``/``bspgemm``, is
XLA work in ``tpukk`` and torch ops here: C's block pattern from the same
host symbolic on the block graphs, a block pair plan on the host, and a
batched ``bmm`` of the block pairs summed into C's blocks in pair order.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..common import check, result_dtype
from ..common.tracing import annotate
from ..containers import CsrMatrix, StaticCrsGraph, expand_row_ids
from .spgemm_cuda import SpgemmRowPlan, build_row_plan, spgemm_rows
from .spmv_impl import segment_sum

__all__ = ["SpgemmAlgorithm", "SpgemmHandle", "spgemm_symbolic", "spgemm_numeric",
           "spgemm", "spgemm_jacobi", "symbolic_plain", "BlockPairPlan",
           "build_block_pair_plan", "bspgemm_symbolic", "bspgemm_numeric", "bspgemm"]


class SpgemmAlgorithm(enum.Enum):
    KK = "kk"                  # row-wise accumulator in shared memory (KKMEM analog)
    DENSE_ACC = "dense_acc"    # dense accumulator (KK_SPEED/KK_DENSE analog)
    DEBUG = "debug"            # host scipy (SPGEMM_DEBUG/serial analog)
    DIA = "dia"                # banded offset convolution (spgemm_dia.py): the
    #                            clipped band, which may hold explicit zeros


class SpgemmHandle:
    """cf. KokkosKernels_Handle::create_spgemm_handle (KokkosKernels_Handle.hpp:470)
    and the spgemm_handle.hpp state machine."""

    def __init__(self, algorithm: SpgemmAlgorithm = SpgemmAlgorithm.KK):
        self.algorithm = algorithm
        self.row_plan: Optional[SpgemmRowPlan] = None
        self.dia_plan = None
        self.c_graph: Optional[StaticCrsGraph] = None  # C's pattern on A's device
        self.block_plan: Optional["BlockPairPlan"] = None  # bspgemm's pair plan

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
    def nnz_c(self):
        return None if self.c_graph is None else self.c_graph.nnz


def symbolic_plain(A: CsrMatrix, B: CsrMatrix):
    """Plain version of the host symbolic, in numpy (``tpukk``'s): the same
    (row_map_c, entries_c) as ``native.spgemm_symbolic``.  Expands every
    product, then keeps each row's distinct columns by one sort."""
    arm = A.host_row_map().astype(np.int64)
    aent = A.host_entries().astype(np.int64)
    brm = B.host_row_map().astype(np.int64)
    bent = B.host_entries().astype(np.int64)
    expand = (brm[1:] - brm[:-1])[aent]   # products of each A entry
    P = int(expand.sum())
    within = np.arange(P) - np.repeat(np.cumsum(expand) - expand, expand)
    b_idx = np.repeat(brm[aent], expand) + within
    out_row = np.repeat(np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(arm)), expand)
    uniq = np.unique(out_row * B.ncols + bent[b_idx])
    row_map_c = np.zeros(A.nrows + 1, np.int64)
    np.cumsum(np.bincount(uniq // max(B.ncols, 1), minlength=A.nrows), out=row_map_c[1:])
    return row_map_c.astype(np.int32), (uniq % max(B.ncols, 1)).astype(np.int32)


def _graph(row_map_c, entries_c, A: CsrMatrix, B: CsrMatrix) -> StaticCrsGraph:
    return StaticCrsGraph.from_arrays(row_map_c, entries_c, A.nrows, B.ncols, device=A.device)


def set_row_plan(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix, row_map_c,
                 entries_c) -> None:
    """Load a symbolic phase (C's pattern, host arrays) into a handle: C's
    graph and K8's row plan on A's device."""
    g = _graph(row_map_c, entries_c, A, B)
    handle.row_plan = build_row_plan(A.row_map, A.entries, B.row_map, B.entries, g.row_map,
                                     g.entries, B.ncols)
    handle.dia_plan = None
    handle.c_graph = g


@annotate("spgemm_symbolic")
def spgemm_symbolic(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix):
    """Determine C's structure; keeps K8's row plan (or the DIA plan) in the handle."""
    from .. import native
    from . import spgemm_dia

    check(A.ncols == B.nrows, "spgemm: inner dimension mismatch")
    check(A.device == B.device, f"spgemm: A on {A.device}, B on {B.device}")
    if handle.algorithm == SpgemmAlgorithm.DEBUG:
        Cs = (A.to_scipy() @ B.to_scipy()).tocsr()
        Cs.sort_indices()
        handle.c_graph = _graph(Cs.indptr, Cs.indices, A, B)
        return handle.row_map_c
    if handle.algorithm == SpgemmAlgorithm.DIA or (
            handle.algorithm == SpgemmAlgorithm.KK and spgemm_dia.dia_operands_exact(A, B)):
        plan = spgemm_dia.build_dia_spgemm_plan(A, B)
        check(plan is not None or handle.algorithm != SpgemmAlgorithm.DIA,
              "spgemm DIA: operands are not banded (DIA-detectable)")
        if plan is not None:
            handle.dia_plan = plan
            handle.row_plan = None
            # the plan's index arrays and C's graph move to A's device here, once
            handle.c_graph = plan.device_arrays(A.device)["graph"]
            return handle.row_map_c
    set_row_plan(handle, A, B, *native.spgemm_symbolic(
        A.host_row_map(), A.host_entries(), A.nrows, B.ncols, B.host_row_map(),
        B.host_entries()))
    return handle.row_map_c


def _compute_dtype(A: CsrMatrix, B: CsrMatrix) -> torch.dtype:
    """The promotion of A's and B's dtypes: f32, f64, complex64 or
    complex128 (bf16 widens to f32)."""
    dt = torch.promote_types(A.dtype, B.dtype)
    return dt if dt in (torch.float32, torch.float64, torch.complex64, torch.complex128) \
        else torch.float32


def _numeric_dense_acc(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix, dt) -> torch.Tensor:
    """Dense accumulator (KK_SPEED analog, _impl_speed.hpp) for a modest
    ncols(B): dense rows of C accumulated on the device, then gathered at C's
    entries."""
    n, k, m = A.nrows, A.ncols, B.ncols
    dense_b = torch.zeros((k, m), dtype=dt, device=A.device)
    dense_b[expand_row_ids(B.row_map, B.nnz), B.entries.long()] = B.values.to(dt)
    contrib = A.values.to(dt)[:, None] * dense_b[A.entries.long()]
    dense_c = torch.zeros((n, m), dtype=dt, device=A.device)
    dense_c.index_add_(0, expand_row_ids(A.row_map, A.nnz), contrib)
    g = handle.c_graph
    return dense_c[expand_row_ids(g.row_map, g.nnz), g.entries.long()]


@annotate("spgemm_numeric")
def spgemm_numeric(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """Numeric phase on A's device: K8 for KK, in f32, f64, complex64 or
    complex128."""
    check(handle.is_symbolic_called, "spgemm_numeric: call spgemm_symbolic first")
    if handle.algorithm == SpgemmAlgorithm.DEBUG:
        Cs = (A.to_scipy() @ B.to_scipy()).tocsr()
        Cs.sort_indices()
        return CsrMatrix.from_scipy(Cs, device=A.device).astype(A.dtype)
    if handle.dia_plan is not None:
        from .spgemm_dia import dia_spgemm_numeric

        return dia_spgemm_numeric(handle.dia_plan, A, B)
    dt = _compute_dtype(A, B)
    if handle.algorithm == SpgemmAlgorithm.DENSE_ACC:
        vals = _numeric_dense_acc(handle, A, B, dt)
    else:
        vals = spgemm_rows(handle.row_plan, A.values.to(dt).contiguous(),
                           B.values.to(dt).contiguous())
    # A's dtype, but a complex product of a real A keeps its imaginary part
    return CsrMatrix.from_graph(handle.c_graph, vals.to(result_dtype(A.dtype, dt)))


@annotate("spgemm")
def spgemm(A: CsrMatrix, B: CsrMatrix,
           algorithm: SpgemmAlgorithm = SpgemmAlgorithm.KK) -> CsrMatrix:
    """No-reuse convenience (cf. KokkosSparse_spgemm.hpp)."""
    h = SpgemmHandle(algorithm)
    spgemm_symbolic(h, A, B)
    return spgemm_numeric(h, A, B)


def spgemm_jacobi(handle: SpgemmHandle, A: CsrMatrix, B: CsrMatrix, omega,
                  dinv) -> CsrMatrix:
    """Jacobi-fused SpGEMM: C = (I - omega·D⁻¹·A)·B (the reference's
    spgemm_jacobi, KokkosSparse_spgemm_jacobi.hpp, which builds
    smoothed-aggregation prolongators).  ``dinv`` is the inverse diagonal.
    Reuses the handle's A·B plan; the B term merges through SpADD."""
    from .spadd import spadd

    check(handle.is_symbolic_called, "spgemm_jacobi: call spgemm_symbolic first")
    AB = spgemm_numeric(handle, A, B)
    d = torch.as_tensor(dinv).to(AB.device, AB.dtype)
    rows = expand_row_ids(AB.row_map, AB.nnz)
    scaled = AB.with_values(-(omega * d[rows]) * AB.values)
    return spadd(1.0, B, 1.0, scaled)


# ---------------------------------------------------------------------------
# Block (BSR) SpGEMM — the bspgemm entry points
# (sparse/impl/KokkosSparse_bspgemm_impl*.hpp, the BlockHashmapAccumulator
# path).  The symbolic phase runs on the block graph; the numeric phase turns
# each scalar product of the CSR case into a (b×b)·(b×b) block product.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockPairPlan:
    """The block products of C = A·B, C block by C block, in (A entry, B
    entry) order within a C block: the flat index of each value of the A
    block and of the B block of each product (block · b² + j, int32 where
    it fits), and the number of products of each C block (the segment
    sum's lengths)."""

    a_flat: torch.Tensor  # (P·b²,)
    b_flat: torch.Tensor  # (P·b²,)
    c_len: torch.Tensor   # (nnz_blocks_c,) int64
    nnzb_a: int           # the operands' block counts, checked on reuse
    nnzb_b: int

    @property
    def n_products(self) -> int:
        return int(self.c_len.sum())


def build_block_pair_plan(rm_a, ent_a, rm_b, ent_b, rm_c, ent_c, ncols_c: int, block_size: int,
                          device) -> BlockPairPlan:
    """Host: expand every block product in (A entry, B entry) order, find its
    C block by its (row, column) key in C's sorted pattern, and order the
    products by C block, stably."""
    rm_a, rm_b, rm_c = (np.asarray(r, np.int64) for r in (rm_a, rm_b, rm_c))
    ent_a, ent_b, ent_c = (np.asarray(e, np.int64) for e in (ent_a, ent_b, ent_c))
    expand = (rm_b[1:] - rm_b[:-1])[ent_a]          # products of each A entry
    a_idx = np.repeat(np.arange(ent_a.size), expand)
    start = np.repeat(np.cumsum(expand) - expand, expand)
    b_idx = np.repeat(rm_b[ent_a], expand) + (np.arange(a_idx.size) - start)
    rows_a = np.repeat(np.arange(rm_a.size - 1), np.diff(rm_a))
    m = max(ncols_c, 1)
    keys_c = np.repeat(np.arange(rm_c.size - 1), np.diff(rm_c)) * m + ent_c
    c_pos = np.searchsorted(keys_c, rows_a[a_idx] * m + ent_b[b_idx])
    order = np.argsort(c_pos, kind="stable")
    c_len = np.bincount(c_pos, minlength=ent_c.size)
    bb = block_size * block_size
    flat_dt = np.int32 if max(ent_a.size, ent_b.size) * bb < 2**31 else np.int64

    def flat(idx):
        f = (idx[order, None] * bb + np.arange(bb)).astype(flat_dt)
        return torch.from_numpy(f.reshape(-1)).to(device)

    return BlockPairPlan(flat(a_idx), flat(b_idx), torch.from_numpy(c_len).to(device),
                         ent_a.size, ent_b.size)


def _check_bsr_pair(A, B, name: str) -> None:
    from ..containers import BsrMatrix

    check(isinstance(A, BsrMatrix) and isinstance(B, BsrMatrix),
          f"{name}: BsrMatrix inputs required")
    check(A.block_size == B.block_size, f"{name}: equal block sizes required")
    check(A.ncols == B.nrows, f"{name}: inner dimension mismatch")
    check(A.device == B.device, f"{name}: A on {A.device}, B on {B.device}")


@annotate("bspgemm_symbolic")
def bspgemm_symbolic(handle: SpgemmHandle, A, B):
    """C's block pattern (host C++ on the block graphs) and the block pair
    plan, kept in the handle on A's device."""
    from .. import native

    _check_bsr_pair(A, B, "bspgemm")
    rm_c, ent_c = native.spgemm_symbolic(A.host_row_map(), A.host_entries(), A.n_block_rows,
                                         B.n_block_cols, B.host_row_map(), B.host_entries())
    handle.block_plan = build_block_pair_plan(A.host_row_map(), A.host_entries(),
                                              B.host_row_map(), B.host_entries(), rm_c, ent_c,
                                              B.n_block_cols, A.block_size, A.device)
    handle.row_plan = handle.dia_plan = None
    handle.c_graph = StaticCrsGraph.from_arrays(rm_c, ent_c, A.n_block_rows, B.n_block_cols,
                                                device=A.device)
    handle.nrows_c, handle.ncols_c, handle.block_size = A.nrows, B.ncols, A.block_size
    return handle.row_map_c


@annotate("bspgemm_numeric")
def bspgemm_numeric(handle: SpgemmHandle, A, B):
    """C's blocks: the pair plan's block products in the compute dtype (A's,
    at least f32, as ``tpukk``'s), summed into each C block in pair order
    (``segment_reduce``: no atomics, the same bits every call).  New values
    on the symbolic phase's patterns re-run only this."""
    from ..containers import BsrMatrix

    _check_bsr_pair(A, B, "bspgemm_numeric")
    check(handle.block_plan is not None, "bspgemm_numeric: call bspgemm_symbolic first")
    plan = handle.block_plan
    check((A.nnz_blocks, B.nnz_blocks, A.block_size) == (plan.nnzb_a, plan.nnzb_b,
                                                          handle.block_size),
          "bspgemm_numeric: operands differ from the symbolic phase's")
    dt = torch.promote_types(A.dtype, torch.float32)
    b = A.block_size
    # gathers of single values: index_select of the b·b-value blocks ran 6-14×
    # slower on the H100 (scripts/bsr_parts_torch.py)
    pa = A.values.reshape(-1).index_select(0, plan.a_flat).view(-1, b, b).to(dt)
    pb = B.values.reshape(-1).index_select(0, plan.b_flat).view(-1, b, b).to(dt)
    if b <= 4:
        # b products and a sum over them an entry: cuBLAS's batched bmm of
        # millions of 2×2 and 4×4 products took 6-70× as long on the H100
        prod = (pa[:, :, :, None] * pb[:, None, :, :]).sum(2)
    else:
        prod = torch.bmm(pa, pb)
    vals = segment_sum(prod, plan.c_len).to(A.dtype)
    g = handle.c_graph
    C = BsrMatrix(g.row_map, g.entries, vals, handle.nrows_c, handle.ncols_c, handle.block_size)
    C._prefill(row_map=g.host_row_map(), entries=g.host_entries())
    return C


@annotate("bspgemm")
def bspgemm(A, B):
    """No-reuse convenience: C = A·B for BSR operands."""
    h = SpgemmHandle(SpgemmAlgorithm.KK)
    bspgemm_symbolic(h, A, B)
    return bspgemm_numeric(h, A, B)
