"""CUDA kernel wrappers for SpMV — counterpart of ``tpukk/sparse/spmv_pallas.py``.

Four hand-written kernels (``tpukk_torch/csrc``) close the 16 Pallas kernels
of the SpMV and SpMM paths; the Gauss-Seidel color step of ``spmv_pallas.py``
is K6 (``gs_cuda.py``):

* ``dia_spmv`` (K1, ``csrc/dia.cu``): banded SpMV in f32 and f64 — replaces
  ``_dia_call`` and the double-single ``_dia_ds_call``.
* ``dia_spmm`` (K2, ``csrc/dia.cu``): banded SpMM, one diagonal pass for all
  k columns — replaces ``_dia_mv_call``.
* ``csr_spmv`` (K3, ``csrc/csr.cu``): unstructured vector-CSR SpMV, sum or
  max, f32 and f64 — replaces the seven one-hot/gather-table layouts behind
  ``onehot_spmv`` and the double-single ``_gi4_ds_call_batched``.
* ``csr_spmm`` (K7, ``csrc/csr.cu``): unstructured CSR SpMM for row-major X
  of shape (ncols, k), 1 ≤ k ≤ 16, one pass over A for all k columns, f32 and
  f64 — replaces the five multi-RHS layouts behind ``onehot_spmm``
  (``_dl_mm_call``, ``_dl_mm_call_batched``, ``_onehot_spmm_call``,
  ``_gt_mm_call_batched``, ``_pk_mm_call_batched``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CPU tensor it runs the kernel's plain version, which
lives beside it (``dia_plain``, ``csr_plain``, ``csr_spmm_plain``).  On a CUDA tensor it launches
the kernel on the current stream or raises: there is no fallback.  It adds one
to its ``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..common import check
from ..containers import CsrMatrix, expand_row_ids
from .spmv_impl import DiaPlan, apply_dia

__all__ = [
    "CsrPlan",
    "build_csr_plan",
    "lanes_per_row",
    "dia_spmv",
    "dia_spmm",
    "csr_spmv",
    "csr_spmm",
    "dia_plain",
    "csr_plain",
    "csr_spmm_plain",
    "SPMM_MAX_K",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

_DTYPE_CODE = _kernels.DTYPE_CODE
_REDUCE_CODE = {"sum": 0, "max": 1}
_stream = _kernels.stream_of
_check_launch = _kernels.check_launch
_check_operand = _kernels.check_operand
_on_cuda = _kernels.on_cuda


# ----------------------------------------------------------------------
# K1 / K2: DIA
# ----------------------------------------------------------------------

def dia_plain(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and K2: shifted-slice sums (``apply_dia``)."""
    return apply_dia(plan, x)


def _check_dia(plan: DiaPlan, x: torch.Tensor, ndim: int, name: str) -> None:
    check(x.ndim == ndim, f"{name}: x must be rank-{ndim}, got rank {x.ndim}")
    check(x.shape[0] == plan.ncols, f"{name}: x has {x.shape[0]} rows, plan {plan.ncols} cols")
    check(plan.diags.dtype in _DTYPE_CODE, f"{name}: plan dtype {plan.diags.dtype} not f32/f64")
    check(len(plan.offsets) <= 256, f"{name}: at most 256 diagonals")
    _check_operand(x, name, plan.diags.dtype, plan.diags.device)
    check(plan.diags.is_contiguous() and plan.offsets_dev.device == x.device,
          f"{name}: plan arrays must be contiguous and on x's device")


def dia_spmv(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """K1: y = A·x for a DiaPlan and vector x (plan dtype, same device)."""
    _check_dia(plan, x, 1, "dia_spmv")
    if not _on_cuda(x, "dia_spmv"):
        return dia_plain(plan, x)
    y = torch.empty(plan.nrows, dtype=x.dtype, device=x.device)
    if plan.nrows == 0:
        return y
    err = _kernels.library("dia").tpukk_dia_spmv(
        _DTYPE_CODE[x.dtype], plan.diags.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.offsets), x.data_ptr(), y.data_ptr(), plan.nrows, plan.ncols, _stream(x))
    _check_launch(err, "dia_spmv")
    dia_spmv.launches += 1
    return y


def dia_spmm(plan: DiaPlan, X: torch.Tensor) -> torch.Tensor:
    """K2: Y = A·X for a DiaPlan and row-major X of shape (ncols, k), any k."""
    _check_dia(plan, X, 2, "dia_spmm")
    if not _on_cuda(X, "dia_spmm"):
        return dia_plain(plan, X)
    k = X.shape[1]
    Y = torch.empty((plan.nrows, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    err = _kernels.library("dia").tpukk_dia_spmm(
        _DTYPE_CODE[X.dtype], plan.diags.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.offsets), X.data_ptr(), Y.data_ptr(), plan.nrows, plan.ncols, k, _stream(X))
    _check_launch(err, "dia_spmm")
    dia_spmm.launches += 1
    return Y


# ----------------------------------------------------------------------
# K3: CSR
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CsrPlan:
    """The CSR arrays in the compute dtype, and the lanes per row."""

    row_map: torch.Tensor   # (nrows+1,) int32
    entries: torch.Tensor   # (nnz,) int32
    values: torch.Tensor    # (nnz,) f32/f64
    nrows: int
    ncols: int
    group: int              # lanes per row: 1, 2, 4, 8, 16 or 32
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    def rows(self) -> torch.Tensor:
        """(nnz,) int64 row ids, built on first use by the plain version."""
        if self._rows is None:
            self._rows = expand_row_ids(self.row_map, self.entries.shape[0])
        return self._rows


def lanes_per_row(nnz: int, nrows: int) -> int:
    """The largest power of two not above the mean entries per row, in
    [1, 32] — the vector length rule of KokkosSparse_spmv_impl.hpp:135-154."""
    mean = nnz / max(nrows, 1)
    g = 1
    while g * 2 <= min(mean, 32):
        g *= 2
    return g


def build_csr_plan(A: CsrMatrix, dtype: torch.dtype) -> CsrPlan:
    check(dtype in _DTYPE_CODE, f"csr plan: dtype {dtype} not f32/f64")
    return CsrPlan(A.row_map, A.entries, A.values.to(dtype).contiguous(), A.nrows, A.ncols,
                   lanes_per_row(A.nnz, A.nrows))


def csr_plain(plan: CsrPlan, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Plain version of K3: ``index_add_`` (sum) or ``scatter_reduce`` amax
    over 0 (max) of the per-entry products."""
    prod = plan.values * x[plan.entries.long()]
    y = torch.zeros(plan.nrows, dtype=prod.dtype, device=x.device)
    if reduce == "sum":
        return y.index_add_(0, plan.rows(), prod)
    return y.scatter_reduce_(0, plan.rows(), prod, reduce="amax", include_self=True)


def csr_spmv(plan: CsrPlan, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """K3: y = A·x, or the (max, ×) row reduction with neutral 0."""
    check(reduce in _REDUCE_CODE, f"csr_spmv: reduce must be 'sum' or 'max', got {reduce!r}")
    check(x.ndim == 1, f"csr_spmv: x must be rank-1, got rank {x.ndim}")
    check(x.shape[0] == plan.ncols, f"csr_spmv: x has {x.shape[0]} rows, plan {plan.ncols} cols")
    _check_operand(x, "csr_spmv", plan.values.dtype, plan.values.device)
    check(plan.row_map.device == x.device and plan.entries.device == x.device,
          "csr_spmv: plan arrays must be on x's device")
    if not _on_cuda(x, "csr_spmv"):
        return csr_plain(plan, x, reduce)
    check(plan.row_map.dtype == torch.int32 and plan.entries.dtype == torch.int32
          and plan.row_map.is_contiguous() and plan.entries.is_contiguous(),
          "csr_spmv: row_map/entries must be contiguous int32")
    y = torch.empty(plan.nrows, dtype=x.dtype, device=x.device)
    if plan.nrows == 0:
        return y
    err = _kernels.library("csr").tpukk_csr_spmv(
        _DTYPE_CODE[x.dtype], _REDUCE_CODE[reduce], plan.group, plan.row_map.data_ptr(),
        plan.entries.data_ptr(), plan.values.data_ptr(), x.data_ptr(), y.data_ptr(),
        plan.nrows, _stream(x))
    _check_launch(err, "csr_spmv")
    csr_spmv.launches += 1
    return y


# ----------------------------------------------------------------------
# K7: CSR SpMM
# ----------------------------------------------------------------------

SPMM_MAX_K = 16  # columns of K7's register panel


def csr_spmm_plain(plan: CsrPlan, X: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: ``index_add_`` of the per-entry row products."""
    prod = plan.values[:, None] * X[plan.entries.long()]
    Y = torch.zeros((plan.nrows, X.shape[1]), dtype=prod.dtype, device=X.device)
    return Y.index_add_(0, plan.rows(), prod)


def csr_spmm(plan: CsrPlan, X: torch.Tensor) -> torch.Tensor:
    """K7: Y = A·X for row-major X of shape (ncols, k), 1 ≤ k ≤ 16."""
    check(X.ndim == 2, f"csr_spmm: X must be rank-2, got rank {X.ndim}")
    check(X.shape[0] == plan.ncols, f"csr_spmm: X has {X.shape[0]} rows, plan {plan.ncols} cols")
    check(1 <= X.shape[1] <= SPMM_MAX_K,
          f"csr_spmm: X must have 1 to {SPMM_MAX_K} columns, got {X.shape[1]}")
    _check_operand(X, "csr_spmm", plan.values.dtype, plan.values.device)
    check(plan.row_map.device == X.device and plan.entries.device == X.device,
          "csr_spmm: plan arrays must be on X's device")
    if not _on_cuda(X, "csr_spmm"):
        return csr_spmm_plain(plan, X)
    check(plan.row_map.dtype == torch.int32 and plan.entries.dtype == torch.int32
          and plan.row_map.is_contiguous() and plan.entries.is_contiguous(),
          "csr_spmm: row_map/entries must be contiguous int32")
    Y = torch.empty((plan.nrows, X.shape[1]), dtype=X.dtype, device=X.device)
    if plan.nrows == 0:
        return Y
    err = _kernels.library("csr").tpukk_csr_spmm(
        _DTYPE_CODE[X.dtype], plan.group, plan.row_map.data_ptr(), plan.entries.data_ptr(),
        plan.values.data_ptr(), X.data_ptr(), Y.data_ptr(), plan.nrows, X.shape[1], _stream(X))
    _check_launch(err, "csr_spmm")
    csr_spmm.launches += 1
    return Y


# ----------------------------------------------------------------------
# launch counts
# ----------------------------------------------------------------------

KERNELS = (dia_spmv, dia_spmm, csr_spmv, csr_spmm)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
