"""SpMV implementation layer — counterpart of ``tpukk/sparse/spmv_impl.py``.

The algorithm enum, the DIA plan (offset detection, plan build and the plain
shifted-slice apply), and the routes ``tpukk`` hands to XLA, here as torch
ops:

* ELL — rows bucketed by length into power-of-2 padded widths on the host at
  plan time; each bucket is a dense (rows, width) gather + row sum.
* SEGSUM — per-entry products summed into rows with ``index_add_``.
* DENSE — densify a tiny matrix and ``torch.matmul`` (f32 matmuls run in full
  f32: ``torch.backends.cuda.matmul.allow_tf32`` is False by default).
* BSR — gather x's blocks by block column, one (b×b)·(b×k) product a stored
  block (elementwise products summed a row for a vector, ``torch.bmm`` for a
  multivector), and a segment sum over each block row's run
  of blocks in CSR order (``torch.segment_reduce``: no atomics, so two calls
  on the same input give the same bits; it has no complex kernel, so a
  complex sum runs over the ``view_as_real`` parts, ``segment_sum``).

Plans are built once per (matrix, compute dtype) on the host and moved to the
matrix's device (the symbolic/numeric split of the reference's SPMVHandle,
KokkosSparse_spmv_handle.hpp:91-135).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..common import check, round_up
from ..containers import BsrMatrix, CsrMatrix, expand_row_ids

__all__ = [
    "SpmvAlgorithm",
    "EllBucket",
    "EllPlan",
    "DiaPlan",
    "SegsumPlan",
    "BsrPlan",
    "detect_dia_offsets",
    "build_dia_plan",
    "build_ell_plan",
    "build_segsum_plan",
    "build_bsr_rows",
    "apply_dia",
    "apply_ell",
    "apply_segsum",
    "apply_bsr",
    "apply_dense",
    "segment_sum",
]


class SpmvAlgorithm(enum.Enum):
    """Analog of SPMVAlgorithm (KokkosSparse_spmv_handle.hpp:32-48); the same
    members as ``tpukk``'s enum."""

    AUTO = "auto"
    ELL = "ell"            # bucketed padded rows (replaces MERGE_PATH)
    SEGSUM = "segsum"      # per-nnz segmented reduction (replaces NATIVE)
    DENSE = "dense"        # densify + matmul
    BSR = "bsr"            # block CSR: batched block products + block-row sums
    DIA = "dia"            # diagonal-offset streaming: the DIA CUDA kernels
    PALLAS = "pallas"      # tpukk's hand-written kernel path: the DIA CUDA kernels
    ONEHOT = "onehot"      # unstructured route: the CSR CUDA kernel
    DS = "ds"              # f64: the AUTO route computed in native f64
    RCM = "rcm"            # RCM-reorder route: the AUTO route of P·A·Pᵀ between permutes


# ----------------------------------------------------------------------
# ELL (bucketed) plan
# ----------------------------------------------------------------------

@dataclasses.dataclass
class EllBucket:
    """One padded-width bucket: dense (rows, width) col ids + values."""

    cols: torch.Tensor   # (rows, width) int64, pads -> 0
    vals: torch.Tensor   # (rows, width) scalar, pads -> 0

    @property
    def width(self) -> int:
        return self.cols.shape[1]


@dataclasses.dataclass
class EllPlan:
    buckets: tuple           # tuple[EllBucket]
    inv_perm: torch.Tensor   # (nrows,) int64: y = concat(bucket_ys)[inv_perm]
    nrows: int
    ncols: int


def _bucket_widths(lengths: np.ndarray, max_buckets: int) -> list:
    """Power-of-2 width ladder covering [1, max_len]; merge tiny buckets."""
    max_len = int(lengths.max(initial=0))
    if max_len == 0:
        return [1]
    widths = []
    w = 1
    while w < max_len:
        w *= 2
        widths.append(w)
    if not widths:
        widths = [1]
    if len(widths) > max_buckets:
        widths = widths[-max_buckets:]
    return widths


def build_ell_plan(A: CsrMatrix, dtype: torch.dtype, max_buckets: int = 4,
                   row_block: int = 8) -> EllPlan:
    """Host-side symbolic phase: bucket rows by nnz, pad, lay out."""
    rm = A.host_row_map()
    ent = A.host_entries()
    vals = A.host_values()
    lengths = rm[1:] - rm[:-1]
    widths = _bucket_widths(lengths, max_buckets)
    bucket_of = np.minimum(np.searchsorted(widths, np.maximum(lengths, 1)),
                           len(widths) - 1)

    buckets = []
    perm_parts = []
    for bi, w in enumerate(widths):
        rows = np.nonzero(bucket_of == bi)[0]
        if rows.size == 0 and len(widths) > 1:
            continue
        nrows_b = round_up(rows.size, row_block) if rows.size else row_block
        cols2d = np.zeros((nrows_b, w), dtype=np.int64)
        vals2d = np.zeros((nrows_b, w), dtype=vals.dtype)
        if rows.size:
            # slot j of row r reads csr position rm[r]+j
            lens = (rm[rows + 1] - rm[rows]).astype(np.int64)
            pos = rm[rows][:, None] + np.arange(w)[None, :]
            mask = np.arange(w)[None, :] < lens[:, None]
            pos = np.minimum(pos, len(ent) - 1 if len(ent) else 0)
            cols2d[: rows.size] = np.where(mask, ent[pos], 0)
            vals2d[: rows.size] = np.where(mask, vals[pos], 0)
        # padded rows read column 0 with value 0; the inverse permutation drops them
        buckets.append(EllBucket(torch.from_numpy(cols2d).to(A.device),
                                 torch.from_numpy(vals2d).to(A.device, dtype)))
        perm_parts.append((rows, nrows_b))

    pos = np.zeros(A.nrows, dtype=np.int64)
    offset = 0
    for rows, nb in perm_parts:
        pos[rows] = offset + np.arange(rows.size)
        offset += nb
    return EllPlan(tuple(buckets), torch.from_numpy(pos).to(A.device), A.nrows, A.ncols)


def apply_ell(plan: EllPlan, x: torch.Tensor) -> torch.Tensor:
    """A·x (no alpha/beta: the caller fuses them) for vector or multivector x."""
    outs = []
    for b in plan.buckets:
        xg = x[b.cols]                                  # (rows, w[, k])
        v = b.vals if x.ndim == 1 else b.vals[..., None]
        outs.append((v * xg).sum(dim=1))                # (rows[, k])
    return torch.cat(outs, dim=0)[plan.inv_perm]


# ----------------------------------------------------------------------
# DIA plan — the stencil/banded route of the DIA kernels
# ----------------------------------------------------------------------

@dataclasses.dataclass
class DiaPlan:
    """y[i] = Σ_d diags[d][i] * x[i+off[d]] — the structured-grid SpMV of
    sparse/impl/KokkosSparse_spmv_struct_impl.hpp.  ``diags`` is
    (ndiags, nrows), 0 where a diagonal has no entry; ``offsets_dev`` is the
    same offsets as an int32 tensor on the plan's device, for the kernels."""

    diags: torch.Tensor
    offsets: tuple
    nrows: int
    ncols: int
    offsets_dev: torch.Tensor

    @classmethod
    def from_numpy(cls, diags: np.ndarray, offsets, nrows: int, ncols: int,
                   device, dtype: Optional[torch.dtype] = None) -> "DiaPlan":
        offsets = tuple(int(o) for o in offsets)
        check(list(offsets) == sorted(set(offsets)), "DiaPlan: offsets must be sorted and unique")
        check(diags.shape == (len(offsets), nrows), "DiaPlan: diags must be (ndiags, nrows)")
        d = torch.from_numpy(np.ascontiguousarray(diags)).to(device)
        d = d if dtype is None else d.to(dtype)
        offs = torch.tensor(offsets, dtype=torch.int32, device=device)
        return cls(d.contiguous(), offsets, int(nrows), int(ncols), offs)


def detect_dia_offsets(A: CsrMatrix, max_diags: int = 32) -> Optional[np.ndarray]:
    """Host-side: unique (col - row) offsets, or None if too many to be a
    banded/stencil matrix."""
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), A.row_lengths())
    offs = np.unique(A.host_entries().astype(np.int64) - rows)
    if offs.size > max_diags:
        return None
    return offs


def build_dia_plan(A: CsrMatrix, offsets: Optional[np.ndarray] = None,
                   dtype: Optional[torch.dtype] = None) -> DiaPlan:
    """DIA plan of A in ``dtype``.  The default is the dtype of A's host
    values, where bf16 is already widened to f32: bf16 matrices are upcast
    once at plan time, as tpukk's build_dia_pallas_plan does."""
    if offsets is None:
        # explicit DIA requests accept wider bands than the AUTO gate
        offsets = detect_dia_offsets(A, max_diags=256)
        if offsets is None:
            raise ValueError("build_dia_plan: matrix is not banded enough; use ELL")
    ent = A.host_entries().astype(np.int64)
    vals = A.host_values_full()
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), A.row_lengths())
    offsets = np.asarray(offsets, dtype=np.int64)
    idx = np.searchsorted(offsets, ent - rows)
    check(bool(np.all(offsets[np.minimum(idx, len(offsets) - 1)] == ent - rows))
          if len(ent) else True, "build_dia_plan: an entry lies off the given offsets")
    slot = idx * A.nrows + rows
    # a duplicate (row, col) pair would overwrite, not add: refuse it
    check(np.bincount(slot, minlength=1).max(initial=0) <= 1,
          "build_dia_plan: duplicate (row, col) entries; merge them first")
    diags = np.zeros((len(offsets), A.nrows), dtype=vals.dtype)
    diags.reshape(-1)[slot] = vals
    return DiaPlan.from_numpy(diags, offsets, A.nrows, A.ncols, A.device, dtype)


def apply_dia(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain shifted-slice DIA product for vector or multivector x: one
    multiply-add per diagonal over the rows where its column is in range."""
    n, m = plan.nrows, plan.ncols
    acc = torch.zeros((n,) + tuple(x.shape[1:]),
                      dtype=torch.promote_types(x.dtype, plan.diags.dtype), device=x.device)
    for j, off in enumerate(plan.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi <= lo:
            continue
        d = plan.diags[j, lo:hi]
        acc[lo:hi] += (d if x.ndim == 1 else d[:, None]) * x[lo + off:hi + off]
    return acc


# ----------------------------------------------------------------------
# SEGSUM plan
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SegsumPlan:
    rows: torch.Tensor     # (nnz,) int64 row of every entry
    cols: torch.Tensor     # (nnz,) int64 column of every entry
    vals: torch.Tensor     # (nnz,) values in the compute dtype
    nrows: int
    ncols: int


def build_segsum_plan(A: CsrMatrix, dtype: torch.dtype) -> SegsumPlan:
    return SegsumPlan(expand_row_ids(A.row_map, A.nnz), A.entries.long(), A.values.to(dtype), A.nrows, A.ncols)


def apply_segsum(plan: SegsumPlan, x: torch.Tensor) -> torch.Tensor:
    xg = x[plan.cols]
    prod = (plan.vals if x.ndim == 1 else plan.vals[:, None]) * xg
    out = torch.zeros((plan.nrows,) + tuple(x.shape[1:]), dtype=prod.dtype, device=x.device)
    return out.index_add_(0, plan.rows, prod)


# ----------------------------------------------------------------------
# BSR — batched block products, summed over each block row
# ----------------------------------------------------------------------

@dataclasses.dataclass
class BsrPlan:
    """A BSR matrix's blocks in the compute dtype, the x index of each of
    their columns, and the number of blocks in each block row, on the
    matrix's device."""

    values: torch.Tensor    # (nnz_blocks, b, b)
    cols: torch.Tensor      # (nnz_blocks * b,) int32: block column · b + j
    lengths: torch.Tensor   # (n_block_rows,) int64 blocks a block row
    n_block_rows: int
    block_size: int


def build_bsr_rows(A: BsrMatrix, dtype: torch.dtype) -> BsrPlan:
    """The BSR route's plan (``tpukk``'s per-block row ids, here as block-row
    lengths for the segment sum)."""
    b = A.block_size
    rm = A.host_row_map().astype(np.int64)
    cols = (A.host_entries().astype(np.int64)[:, None] * b + np.arange(b)).astype(np.int32)
    return BsrPlan(A.values.to(dtype).contiguous(), torch.from_numpy(cols.reshape(-1)).to(A.device),
                   torch.from_numpy(np.diff(rm)).to(A.device), A.n_block_rows, b)


def apply_bsr(plan: BsrPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for BSR, x of shape (ncols,) or (ncols, k) in the plan's dtype:
    gather x's blocks, one (b×b)·(b×k) product a stored block, and each block
    row's products summed in CSR order."""
    b = plan.block_size
    # a gather of single values: torch's row gathers of b-value rows ran 40×
    # slower on the H100 (scripts/bsr_parts_torch.py)
    xg = x.index_select(0, plan.cols).view(-1, b, *x.shape[1:])  # (nnzb, b[, k])
    if x.ndim == 1:
        # b products and a sum over them a row: cuBLAS's batched bmm of 1M
        # (4×4)·(4×1) products took 5× as long on the H100
        prod = (plan.values * xg[:, None, :]).sum(-1)
    else:
        prod = torch.bmm(plan.values, xg)
    yb = segment_sum(prod, plan.lengths)
    return yb.reshape((plan.n_block_rows * b,) + tuple(x.shape[1:]))


def segment_sum(t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of ``lengths`` rows of t, in row order
    (``torch.segment_reduce``, which takes no complex values: a complex t is
    summed as its real and imaginary parts, which gives the same sums)."""
    if t.dtype.is_complex:
        return torch.view_as_complex(segment_sum(torch.view_as_real(t), lengths))
    return torch.segment_reduce(t, "sum", lengths=lengths, axis=0, unsafe=True)


# ----------------------------------------------------------------------
# Dense fallback
# ----------------------------------------------------------------------

def apply_dense(dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(dense, x)
