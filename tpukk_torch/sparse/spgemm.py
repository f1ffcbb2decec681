"""SpGEMM (C = A·B) — counterpart of ``tpukk/sparse/spgemm.py``
(sparse/src/KokkosSparse_spgemm_symbolic.hpp:27, _numeric.hpp:34).

Two phases, with the reference handle's reuse contract
(spgemm_handle.hpp:248-252):

* **symbolic** (host C++, ``native.spgemm_symbolic``): C's pattern, moved to
  A's device once, and K8's row plan built there (``spgemm_cuda.build_row_plan``:
  the rows binned by their lanes, O(rows) bytes).
* **numeric** (device): K8 (``spgemm_cuda.spgemm_rows``) sums each C row's
  products in a shared-memory accumulator, f32 and f64.  New values on the
  same patterns re-run only this.

``SpgemmAlgorithm`` mirrors SPGEMMAlgorithm (spgemm_handle.hpp:44-76): KK is
the row-wise numeric (and routes banded operands with full diagonals to DIA),
DENSE_ACC a dense accumulator in torch ops for a narrow B, DEBUG scipy on the
host, DIA the offset convolution of ``spgemm_dia.py``.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..common import TpuKKError, check
from ..common.tracing import annotate
from ..containers import CsrMatrix, StaticCrsGraph, expand_row_ids
from .spgemm_cuda import SpgemmRowPlan, build_row_plan, spgemm_rows

__all__ = ["SpgemmAlgorithm", "SpgemmHandle", "spgemm_symbolic", "spgemm_numeric",
           "spgemm", "spgemm_jacobi", "symbolic_plain", "bspgemm_symbolic",
           "bspgemm_numeric", "bspgemm"]


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
    dt = torch.promote_types(A.dtype, B.dtype)
    check(not dt.is_complex, "spgemm: complex values are not ported (ROADMAP queue A item 3)")
    return dt if dt in (torch.float32, torch.float64) else torch.float32


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
    """Numeric phase on A's device: K8 for KK, in f32 or f64."""
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
    return CsrMatrix.from_graph(handle.c_graph, vals.to(A.dtype))


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


_BSR = "BSR matrices are not ported yet (ROADMAP queue A item 2, the BSR route)"


def bspgemm_symbolic(handle: SpgemmHandle, A, B):
    raise TpuKKError(f"bspgemm_symbolic: {_BSR}")


def bspgemm_numeric(handle: SpgemmHandle, A, B):
    raise TpuKKError(f"bspgemm_numeric: {_BSR}")


def bspgemm(A, B):
    raise TpuKKError(f"bspgemm: {_BSR}")
