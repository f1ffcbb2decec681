"""CUDA kernel wrapper for the colored Gauss-Seidel color step — counterpart
of ``_gi4_gs_fused_batched`` in ``tpukk/sparse/spmv_pallas.py``.

* ``gs_color_step`` (K6, ``csrc/gs.cu``): one color block's update
  ``x ← (1−ω)·x + ω·invd·(b − A_offdiag·x)`` on its rows of the
  color-permuted x, for a vector or a row-major (n, k) multivector with
  k ≤ 16, f32 and f64 — replaces ``_gi4_gs_fused_batched``.

A ``GsBlock`` is one color block: the CSR of its rows with the diagonal
removed and the columns renamed to the permuted space (a ``CsrPlan`` of
nrows × n, so its lanes per row follow K3's rule), ``inv_diag`` (0 where the
diagonal is 0), the block's first row ``start`` in the permuted order, and
``coupled``: whether a row of the block refers to a row of the same block,
which decides K6's mode.  An uncoupled block (every block of a distance-1
coloring) is updated in place; a coupled one (a CLUSTER block) is written to
a block-sized buffer that is then copied into x, so its products all read
the old x, as in ``tpukk`` — in place, lanes would read rows other lanes are
writing.

The wrapper checks device, dtype, shape and contiguity and raises on anything
else.  On a CPU tensor it runs the plain version ``gs_color_step_plain``.  On
a CUDA tensor it launches the kernel on the current stream or raises: there
is no fallback.  It adds one to its ``launches`` count each time it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..common import check
from .spmv_cuda import CsrPlan, csr_spmm_plain, lanes_per_row

__all__ = ["GsBlock", "build_gs_block", "gs_color_step", "gs_color_step_plain",
           "step_error_bound", "GS_MAX_K", "KERNELS", "launch_counts", "reset_launch_counts"]

GS_MAX_K = 16  # columns of K6's register panel


@dataclasses.dataclass
class GsBlock:
    """One color block of the permuted matrix, off-diagonal part."""

    csr: CsrPlan            # nrows × n, permuted-space column ids, no diagonal
    inv_diag: torch.Tensor  # (nrows,) in the values' dtype, 0 where the diagonal is 0
    start: int              # first row of the block in the permuted order
    coupled: bool           # a row of the block refers to a row of the block

    @property
    def nrows(self) -> int:
        return self.csr.nrows

    def to(self, dtype: torch.dtype) -> "GsBlock":
        """The same block with values and inv_diag in ``dtype``."""
        return dataclasses.replace(self, csr=dataclasses.replace(
            self.csr, values=self.csr.values.to(dtype)), inv_diag=self.inv_diag.to(dtype))


def build_gs_block(row_map, entries, values, inv_diag, start: int, n: int, device) -> GsBlock:
    """Block from host arrays: ``row_map`` relative to the block, ``entries``
    in the permuted space (of n rows) without the diagonal."""
    rm = np.ascontiguousarray(row_map, np.int32)
    ent = np.ascontiguousarray(entries, np.int32)
    nrows = rm.shape[0] - 1
    csr = CsrPlan(torch.from_numpy(rm).to(device), torch.from_numpy(ent).to(device),
                  torch.from_numpy(np.ascontiguousarray(values)).to(device), nrows, n,
                  lanes_per_row(ent.shape[0], nrows))
    coupled = bool(((ent >= start) & (ent < start + nrows)).any())
    return GsBlock(csr, torch.from_numpy(np.ascontiguousarray(inv_diag)).to(device),
                   int(start), coupled)


def _as_columns(v: torch.Tensor) -> torch.Tensor:
    return v if v.ndim == 2 else v[:, None]


def gs_color_step_plain(blk: GsBlock, x: torch.Tensor, b: torch.Tensor,
                        omega: float) -> torch.Tensor:
    """Plain version of K6: the block's products from the old x (K7's plain
    version), then the update written into x's block rows."""
    xm, bm = _as_columns(x), _as_columns(b)
    s, e = blk.start, blk.start + blk.nrows
    ax = csr_spmm_plain(blk.csr, xm)
    xm[s:e] = (1.0 - omega) * xm[s:e] + omega * blk.inv_diag[:, None] * (bm[s:e] - ax)
    return x


def step_error_bound(blk: GsBlock, x: torch.Tensor, b: torch.Tensor,
                     omega: float) -> torch.Tensor:
    """Per-element bound on two evaluations of one color step that sum the
    block's products in different orders: 20·eps·(|1−ω|·|x| +
    |ω·invd|·(|b| + |A_offdiag|·|x|)) on the block's rows, x the old x; the
    shape of x's block rows."""
    s, e = blk.start, blk.start + blk.nrows
    abs_csr = dataclasses.replace(blk.csr, values=blk.csr.values.abs())
    ax = csr_spmm_plain(abs_csr, _as_columns(x.abs()))
    bound = (abs(1.0 - omega) * _as_columns(x.abs())[s:e]
             + abs(omega) * blk.inv_diag.abs()[:, None] * (_as_columns(b.abs())[s:e] + ax))
    return 20 * torch.finfo(x.dtype).eps * (bound if x.ndim == 2 else bound[:, 0])


def gs_color_step(blk: GsBlock, x: torch.Tensor, b: torch.Tensor, omega: float,
                  scratch: torch.Tensor | None = None) -> torch.Tensor:
    """K6: update the block's rows of the permuted x (a vector, or row-major
    (n, k) with k ≤ 16) and return x.  An uncoupled block is updated in
    place; a coupled one is written to the front of ``scratch`` (a flat
    buffer of at least nrows·k elements in x's dtype on x's device, kept by
    the caller across steps) or, without one, to a new buffer, and then
    copied into x.  The plain version has one mode and needs no buffer."""
    check(x.ndim in (1, 2) and x.shape == b.shape,
          f"gs_color_step: x {tuple(x.shape)} and b {tuple(b.shape)} must be one (n,) or (n, k) shape")
    k = 1 if x.ndim == 1 else x.shape[1]
    check(1 <= k <= GS_MAX_K, f"gs_color_step: 1 to {GS_MAX_K} columns, got {k}")
    check(blk.start + blk.nrows <= x.shape[0],
          f"gs_color_step: block rows [{blk.start}, {blk.start + blk.nrows}) beyond x's "
          f"{x.shape[0]} rows")
    csr = blk.csr
    check(csr.ncols == x.shape[0], f"gs_color_step: block of {csr.ncols} columns, x has "
          f"{x.shape[0]} rows")
    _kernels.check_operand(x, "gs_color_step", csr.values.dtype, csr.values.device)
    _kernels.check_operand(b, "gs_color_step", csr.values.dtype, csr.values.device)
    check(blk.inv_diag.dtype == csr.values.dtype and csr.row_map.device == x.device
          and csr.entries.device == x.device and blk.inv_diag.device == x.device,
          "gs_color_step: block arrays must be on x's device, inv_diag in the values' dtype")
    if not _kernels.on_cuda(x, "gs_color_step"):
        return gs_color_step_plain(blk, x, b, omega)
    check(csr.row_map.dtype == torch.int32 and csr.entries.dtype == torch.int32
          and csr.row_map.is_contiguous() and csr.entries.is_contiguous()
          and csr.values.is_contiguous() and blk.inv_diag.is_contiguous(),
          "gs_color_step: block arrays must be contiguous, row_map/entries int32")
    if blk.nrows == 0:
        return x
    rows = slice(blk.start, blk.start + blk.nrows)
    if not blk.coupled:
        out = x[rows]
    elif scratch is None:
        out = torch.empty_like(x[rows])
    else:
        check(scratch.dtype == x.dtype and scratch.device == x.device
              and scratch.ndim == 1 and scratch.numel() >= blk.nrows * k,
              f"gs_color_step: scratch must be a flat {x.dtype} buffer on {x.device} of at "
              f"least {blk.nrows * k} elements")
        out = scratch[:blk.nrows * k].view(x[rows].shape)
    err = _kernels.library("gs").tpukk_gs_color_step(
        _kernels.DTYPE_CODE[x.dtype], csr.group, csr.row_map.data_ptr(), csr.entries.data_ptr(),
        csr.values.data_ptr(), blk.inv_diag.data_ptr(), b.data_ptr(), x.data_ptr(),
        out.data_ptr(), blk.start, blk.nrows, k, float(omega), _kernels.stream_of(x))
    _kernels.check_launch(err, "gs_color_step")
    gs_color_step.launches += 1
    if blk.coupled:
        x[rows] = out
    return x


KERNELS = (gs_color_step,)
gs_color_step.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
