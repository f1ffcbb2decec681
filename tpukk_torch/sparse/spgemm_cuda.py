"""CUDA kernel wrapper for the SpGEMM numeric phase — counterpart of
``tpukk/sparse/spgemm_pallas.py``.

One hand-written kernel closes the seven Pallas kernels of that file:

* ``spgemm_pairs`` (K8, ``csrc/spgemm.cu``): C's values from a pair plan,
  ``C[c] = Σ_{p in c's range} A[a_idx[p]]·B[b_idx[p]]``, f32 and f64 —
  replaces the flat, dst-lane, gather-table and packed pair layouts
  (``_onehot_pair_call``, ``_dl_pair_call``, ``_dl_pair_call_batched``,
  ``_gt_pair_call``, ``_gtp_pk_call``) and the sort-based pipeline's
  ``_expand3_call`` and ``_rowperm3a_call``, which all compute this function.

The wrapper checks device, dtype, shape and contiguity and raises on anything
else.  On a CPU tensor it runs the plain version beside it
(``spgemm_pairs_plain``).  On a CUDA tensor it launches the kernel on the
current stream or raises: there is no fallback.  It adds one to its
``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..common import check
from .spmv_cuda import lanes_per_row

__all__ = ["SpgemmPairPlan", "build_pair_plan", "spgemm_pairs", "spgemm_pairs_plain",
           "KERNELS", "launch_counts", "reset_launch_counts"]


@dataclasses.dataclass
class SpgemmPairPlan:
    """The pair plan of C = A·B on one device: C entry c sums the products
    of pairs c_ptr[c] .. c_ptr[c+1]-1, in plan order."""

    c_ptr: torch.Tensor   # (nnz_c+1,) int64
    a_idx: torch.Tensor   # (P,) int32 into A's values
    b_idx: torch.Tensor   # (P,) int32 into B's values
    nnz_a: int            # the lengths of A's and B's values the plan indexes
    nnz_b: int
    group: int            # lanes per C entry: 1, 2, 4, 8, 16 or 32
    _c_idx: torch.Tensor = dataclasses.field(default=None, repr=False)

    @property
    def nnz_c(self) -> int:
        return int(self.c_ptr.shape[0]) - 1

    @property
    def npairs(self) -> int:
        return int(self.a_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.c_ptr.device

    def c_idx(self) -> torch.Tensor:
        """(P,) int64 C entry of every pair, built on first use by the plain
        version."""
        if self._c_idx is None:
            self._c_idx = torch.repeat_interleave(
                torch.arange(self.nnz_c, device=self.device), torch.diff(self.c_ptr),
                output_size=self.npairs)
        return self._c_idx


def build_pair_plan(c_ptr, a_idx, b_idx, nnz_a: int, nnz_b: int, device) -> SpgemmPairPlan:
    """A plan on ``device`` from host arrays (``native.spgemm_symbolic``'s
    c_ptr, a_idx, b_idx) for values of lengths nnz_a and nnz_b; checks that
    every index lies inside them, since the kernel's gathers do not."""
    # writable contiguous host copies where needed: the CPU tensors share them
    c_ptr, a_idx, b_idx = (np.require(x, dt, ["C", "W"]) for x, dt in (
        (c_ptr, np.int64), (a_idx, np.int32), (b_idx, np.int32)))
    nnz_c, P = len(c_ptr) - 1, len(a_idx)
    check(nnz_c >= 0 and len(b_idx) == P and int(c_ptr[0]) == 0 and int(c_ptr[-1]) == P
          and bool(np.all(np.diff(c_ptr) >= 0)),
          "spgemm pair plan: c_ptr must rise from 0 to the number of pairs")
    check(P == 0 or (0 <= int(a_idx.min()) and int(a_idx.max()) < nnz_a
                     and 0 <= int(b_idx.min()) and int(b_idx.max()) < nnz_b),
          "spgemm pair plan: an index lies outside A's or B's values")
    return SpgemmPairPlan(torch.from_numpy(c_ptr).to(device), torch.from_numpy(a_idx).to(device),
                          torch.from_numpy(b_idx).to(device), int(nnz_a), int(nnz_b),
                          lanes_per_row(P, nnz_c))


def spgemm_pairs_plain(plan: SpgemmPairPlan, a_vals: torch.Tensor,
                       b_vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the rounded products, summed per C entry by
    ``index_add_``."""
    prod = a_vals[plan.a_idx.long()] * b_vals[plan.b_idx.long()]
    out = torch.zeros(plan.nnz_c, dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, plan.c_idx(), prod)


def spgemm_pairs(plan: SpgemmPairPlan, a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """K8: C's values (nnz_c,) for A's and B's values of one dtype, f32 or
    f64, on the plan's device."""
    check(a_vals.ndim == 1 and b_vals.ndim == 1, "spgemm_pairs: values must be rank-1")
    check(a_vals.dtype in _kernels.DTYPE_CODE,
          f"spgemm_pairs: dtype {a_vals.dtype} not f32/f64")
    _kernels.check_operand(a_vals, "spgemm_pairs", a_vals.dtype, plan.device)
    _kernels.check_operand(b_vals, "spgemm_pairs", a_vals.dtype, plan.device)
    # the kernel does not bounds-check its gathers: the plan must fit these values
    check(a_vals.shape[0] == plan.nnz_a and b_vals.shape[0] == plan.nnz_b,
          f"spgemm_pairs: values of lengths ({a_vals.shape[0]}, {b_vals.shape[0]}), "
          f"plan made for ({plan.nnz_a}, {plan.nnz_b})")
    if not _kernels.on_cuda(a_vals, "spgemm_pairs"):
        return spgemm_pairs_plain(plan, a_vals, b_vals)
    check(plan.c_ptr.is_contiguous() and plan.a_idx.is_contiguous()
          and plan.b_idx.is_contiguous() and plan.c_ptr.dtype == torch.int64
          and plan.a_idx.dtype == torch.int32 and plan.b_idx.dtype == torch.int32,
          "spgemm_pairs: plan arrays must be contiguous int64 c_ptr, int32 a_idx/b_idx")
    c = torch.empty(plan.nnz_c, dtype=a_vals.dtype, device=a_vals.device)
    if plan.nnz_c == 0:
        return c
    err = _kernels.library("spgemm").tpukk_spgemm_pair_sum(
        _kernels.DTYPE_CODE[a_vals.dtype], plan.group, plan.c_ptr.data_ptr(),
        plan.a_idx.data_ptr(), plan.b_idx.data_ptr(), a_vals.data_ptr(), b_vals.data_ptr(),
        c.data_ptr(), plan.nnz_c, _kernels.stream_of(a_vals))
    _kernels.check_launch(err, "spgemm_pairs")
    spgemm_pairs.launches += 1
    return c


KERNELS = (spgemm_pairs,)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
