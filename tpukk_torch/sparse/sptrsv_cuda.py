"""CUDA kernel wrappers for the triangular solve — counterpart of
``tpukk/sparse/sptrsv_pallas.py`` and the permutes of
``tpukk/common/permute.py``.

Two hand-written kernels (``tpukk_torch/csrc``) close the five Pallas kernels
of the level-scheduled solve:

* ``sptrsv_levels`` (K4, ``csrc/sptrsv.cu``): the whole level-scheduled
  triangle in one launch, f32 and f64 — replaces ``_fused_call_wide_pk``,
  ``_fused_call_wide`` and ``_fused_call``.
* ``permute_gather`` (K5, ``csrc/permute.cu``, wrapper in
  ``common/permute.py``): ``out[i] = x[src[i]]`` — replaces the routed
  permutation phases ``_rowperm3_call`` and ``_rowperm_call`` that
  ``fused_sptrsv_solve`` runs on both sides of the solve.

The plan (``LevelPlan``) is the strict triangle as CSR in level order: rows
sorted by level (stable), columns renamed to level-order positions, so every
dependency of a row lies at a lower position, for L and U alike.  It also
holds 1/diag in that order, the ``order``/``inv_order`` permutations, and the
ready flags and state K4 uses to order its rows.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CPU tensor it runs the kernel's plain version
(``sptrsv_plain``, ``permute_plain``).  On a CUDA tensor it launches the
kernel on the current stream or raises: there is no fallback.  It adds one
to its ``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..common import check, cdiv
from ..common.permute import permute_gather, permute_plain
from ..containers import expand_row_ids

__all__ = [
    "LevelPlan",
    "build_level_plan",
    "sptrsv_levels",
    "sptrsv_plain",
    "solve_error_bound",
    "permute_gather",
    "permute_plain",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]


@dataclasses.dataclass
class LevelPlan:
    """The strict triangle of T in level order, for x = T⁻¹b.

    Device arrays: ``rowptr`` (n+1,) and ``cols`` (nnz,) int32, ``vals``
    (nnz,) and ``invd`` (n,) in the compute dtype, ``order`` / ``inv_order``
    (n,) int32 with ``b_level = b[order]`` and ``x = x_level[inv_order]``,
    and K4's ``flags`` (n,) and ``state`` (3,) int32 scratch.  Host arrays:
    ``level_ptr`` (num_levels+1,) row offsets of each level and
    ``rowptr_host``, for the plain version."""

    rowptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    invd: torch.Tensor
    order: torch.Tensor
    inv_order: torch.Tensor
    flags: torch.Tensor
    state: torch.Tensor
    level_ptr: np.ndarray
    rowptr_host: np.ndarray
    n: int
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    @property
    def num_levels(self) -> int:
        return len(self.level_ptr) - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def rows(self) -> torch.Tensor:
        """(nnz,) int64 level-order row id of every entry, for the plain
        version."""
        if self._rows is None:
            self._rows = expand_row_ids(self.rowptr, self.cols.shape[0])
        return self._rows

    def astype(self, dtype: torch.dtype) -> "LevelPlan":
        """The same plan with values in ``dtype``; the flags and state are
        shared (one solve at a time per plan)."""
        if dtype == self.dtype:
            return self
        return dataclasses.replace(self, vals=self.vals.to(dtype), invd=self.invd.to(dtype))


def build_level_plan(rm, ent, vals, n: int, levels, lower: bool, device) -> LevelPlan:
    """Level plan of tri(T) from host CSR arrays (rm, ent, vals) and a level
    (1-based) per row, as ``_compute_levels`` gives it.  Values keep vals'
    dtype (f32 or f64), and 1/diag is taken in it, as ``tpukk`` does."""
    rm = np.asarray(rm, np.int64)
    ent = np.asarray(ent, np.int64)
    vals = np.asarray(vals)
    check(vals.dtype in (np.float32, np.float64),
          f"sptrsv: values must be f32 or f64, got {vals.dtype}")
    levels = np.asarray(levels, np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), rm[1:] - rm[:-1])
    order = np.argsort(levels, kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    nlev = int(levels.max(initial=0))
    counts = np.bincount(levels, minlength=nlev + 1)[1:]
    level_ptr = np.zeros(nlev + 1, np.int64)
    np.cumsum(counts, out=level_ptr[1:])

    diag = np.zeros(n, vals.dtype)
    is_diag = ent == rows
    np.add.at(diag, rows[is_diag], vals[is_diag])
    bad = np.nonzero(diag == 0)[0]
    if bad.size:
        lv = int(levels[bad].min()) - 1  # the first level holding a zero pivot
        check(False, f"sptrsv: zero diagonal in level {lv}")
    keep = ent < rows if lower else ent > rows
    r_new, c_new, v = inv[rows[keep]], inv[ent[keep]], vals[keep]
    # a dependency at or after its row would make K4 wait forever
    check(bool((c_new < r_new).all()), "sptrsv: levels do not order the triangle")
    srt = np.lexsort((c_new, r_new))
    r_new, c_new, v = r_new[srt], c_new[srt], v[srt]
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r_new, minlength=n), out=rowptr[1:])
    invd = (vals.dtype.type(1) / diag)[order]

    def dev(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a if dt is None else a.astype(dt))).to(device)

    return LevelPlan(
        rowptr=dev(rowptr, np.int32), cols=dev(c_new, np.int32), vals=dev(v), invd=dev(invd),
        order=dev(order, np.int32), inv_order=dev(inv, np.int32),
        flags=torch.zeros(n, dtype=torch.int32, device=device),
        state=torch.zeros(3, dtype=torch.int32, device=device),
        level_ptr=level_ptr, rowptr_host=rowptr, n=n)


# ----------------------------------------------------------------------
# K4: level-scheduled triangular solve
# ----------------------------------------------------------------------

def sptrsv_plain(plan: LevelPlan, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: level by level, x[l] = (b[l] − Σ v·x[c])·invd[l]
    with an ``index_add_`` per level (b and x in level order)."""
    x = torch.empty_like(b)
    rows, cols = plan.rows(), plan.cols.long()
    lp, rp = plan.level_ptr, plan.rowptr_host
    for lv in range(plan.num_levels):
        s, e = int(lp[lv]), int(lp[lv + 1])
        ps, pe = int(rp[s]), int(rp[e])
        acc = torch.zeros(e - s, dtype=b.dtype, device=b.device)
        acc.index_add_(0, rows[ps:pe] - s, plan.vals[ps:pe] * x[cols[ps:pe]])
        x[s:e] = (b[s:e] - acc) * plan.invd[s:e]
    return x


def solve_error_bound(plan: LevelPlan, x: torch.Tensor, c: float = 40.0) -> torch.Tensor:
    """Elementwise bound on |x − x'| for two solves x, x' of tri(T)·x = b in
    x's dtype, in level order and f64: M(T)⁻¹·(c·eps·|T||x|), with M(T) =
    (|diag|, −|offdiag|) the comparison matrix.  For a triangle |T⁻¹| ≤
    M(T)⁻¹, and a solve that sums its rows in any order is exact for a T
    perturbed by at most (c/2)·eps·|T| (rows of up to c/2 entries); so this
    holds K4 to its plain version, whose sums run in another order."""
    xa = x.abs().double()
    tx = xa / plan.invd.abs().double()
    tx.index_add_(0, plan.rows(), plan.vals.abs().double() * xa[plan.cols.long()])
    mplan = dataclasses.replace(plan, vals=-plan.vals.abs().double(),
                                invd=plan.invd.abs().double())
    return sptrsv_plain(mplan, c * torch.finfo(x.dtype).eps * tx)


@functools.cache
def _blocks_cap(device_index: int) -> int:
    """8 blocks of 256 threads per SM: every warp K4 launches is resident."""
    return 8 * torch.cuda.get_device_properties(device_index).multi_processor_count


def sptrsv_levels(plan: LevelPlan, b: torch.Tensor) -> torch.Tensor:
    """K4: x with tri(T)·x = b, b and x in the plan's level order."""
    check(b.ndim == 1, f"sptrsv_levels: b must be rank-1, got rank {b.ndim}")
    check(b.shape[0] == plan.n, f"sptrsv_levels: b has {b.shape[0]} rows, plan {plan.n}")
    _kernels.check_operand(b, "sptrsv_levels", plan.vals.dtype, plan.vals.device)
    check(all(t.device == b.device for t in (plan.rowptr, plan.cols, plan.invd, plan.flags,
                                              plan.state)),
          "sptrsv_levels: plan arrays must be on b's device")
    if not _kernels.on_cuda(b, "sptrsv_levels"):
        return sptrsv_plain(plan, b)
    check(b.dtype in _kernels.DTYPE_CODE, f"sptrsv_levels: dtype {b.dtype} not f32/f64")
    x = torch.empty_like(b)
    if plan.n == 0:
        return x
    blocks = min(cdiv(plan.n * 32, 256), _blocks_cap(b.device.index))
    err = _kernels.library("sptrsv").tpukk_sptrsv_levels(
        _kernels.DTYPE_CODE[b.dtype], plan.rowptr.data_ptr(), plan.cols.data_ptr(),
        plan.vals.data_ptr(), plan.invd.data_ptr(), b.data_ptr(), x.data_ptr(),
        plan.flags.data_ptr(), plan.state.data_ptr(), plan.n, blocks, _kernels.stream_of(b))
    _kernels.check_launch(err, "sptrsv_levels")
    sptrsv_levels.launches += 1
    return x


# ----------------------------------------------------------------------
# launch counts
# ----------------------------------------------------------------------

KERNELS = (sptrsv_levels, permute_gather)
sptrsv_levels.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
