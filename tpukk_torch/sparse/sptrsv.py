"""Sparse triangular solve — counterpart of ``tpukk/sparse/sptrsv.py`` (the
reference's sparse/src/KokkosSparse_sptrsv.hpp, symbolic :55,119 and solve
:270,407, with level-set scheduling, SPTRSVAlgorithm SEQLVLSCHD_*).

Symbolic computes the level of every row on the host (Kahn wavefronts, the
level_sched of spiluk_symbolic_impl.hpp:37-88) and builds one level-ordered
CSR plan of the strict triangle (``sptrsv_cuda.build_level_plan``).  Solve is
three launches: K5 puts b in level order, K4 solves the whole triangle in one
launch, K5 puts x back in natural order — the steps of ``tpukk``'s
``fused_sptrsv_solve`` (sptrsv_pallas.py:646-680).  f32 and f64, 1-D b.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix
from .sptrsv_cuda import LevelPlan, build_level_plan, permute_gather, sptrsv_levels

__all__ = ["SptrsvHandle", "SptrsvAlgorithm", "sptrsv_symbolic", "sptrsv_solve"]


class SptrsvAlgorithm(enum.Enum):
    """cf. SPTRSVAlgorithm, sptrsv_handle.hpp:42-51.  SEQLVLSCHD covers the
    SEQLVLSCHD_RP/TP1/TP1CHAIN family; SUPERNODAL (the supernode-blocked
    solves) is not ported yet (ROADMAP queue A, item A10)."""
    SEQLVLSCHD = "lvlsched"
    SUPERNODAL = "supernodal"


class SptrsvHandle:
    """cf. sptrsv_handle.hpp; one handle per (matrix, uplo)."""

    def __init__(self, lower: bool = True,
                 algorithm: SptrsvAlgorithm = SptrsvAlgorithm.SEQLVLSCHD,
                 supernode_max_size: int = 64):
        if algorithm is SptrsvAlgorithm.SUPERNODAL:
            raise NotImplementedError(
                "the supernodal triangular solve is not ported yet (ROADMAP queue A, item A10)")
        self.lower = lower
        self.algorithm = algorithm
        self.supernode_max_size = supernode_max_size
        self.is_symbolic_called = False
        self.plan: LevelPlan | None = None
        self.num_levels = 0
        self.order = None       # host (n,) int32: level-order position -> row
        self.inv_order = None   # host (n,) int32: row -> level-order position
        self._plans: dict = {}  # compute dtype -> LevelPlan

    def plan_for(self, dtype: torch.dtype) -> LevelPlan:
        """The plan with values in ``dtype`` (built from the symbolic plan
        once per dtype)."""
        p = self._plans.get(dtype)
        if p is None:
            p = self._plans[dtype] = self.plan.astype(dtype)
        return p


def _compute_levels(rm, ent, n, lower: bool) -> np.ndarray:
    """level[r] = 1 + max(level of dependencies) via Kahn wavefronts —
    O(nnz) total (the level_sched of spiluk_symbolic_impl.hpp:37-88)."""
    rm = np.asarray(rm)
    ent = np.asarray(ent)
    rows = np.repeat(np.arange(n), rm[1:] - rm[:-1])
    dep_mask = ent < rows if lower else ent > rows
    dep_rows = rows[dep_mask].astype(np.int64)   # edge: dep_cols -> dep_rows
    dep_cols = ent[dep_mask].astype(np.int64)
    indeg = np.bincount(dep_rows, minlength=n)
    # reverse adjacency (dependents grouped by producer column)
    order = np.argsort(dep_cols, kind="stable")
    out_rows = dep_rows[order]
    out_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dep_cols, minlength=n), out=out_ptr[1:])
    levels = np.zeros(n, np.int64)
    frontier = np.nonzero(indeg == 0)[0]
    lv = 1
    while frontier.size:
        levels[frontier] = lv
        starts = out_ptr[frontier]
        lens = out_ptr[frontier + 1] - starts
        total = int(lens.sum())
        if total:
            base = np.repeat(starts, lens)
            within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            targets = out_rows[base + within]
            indeg = indeg - np.bincount(targets, minlength=n)
            cand = np.unique(targets)
            frontier = cand[indeg[cand] == 0]
        else:
            frontier = np.empty(0, np.int64)
        lv += 1
    return levels


@annotate("sptrsv_symbolic")
def sptrsv_symbolic(handle: SptrsvHandle, A: CsrMatrix):
    """Levels and the level-ordered plan of tri(A), on A's device."""
    check(A.nrows == A.ncols, "sptrsv: square matrix required")
    rm, ent, vals = A.host_row_map(), A.host_entries(), A.host_values()
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float32)  # bf16 widens, as at tpukk's plan time
    levels = _compute_levels(rm, ent, A.nrows, handle.lower)
    plan = build_level_plan(rm, ent, vals, A.nrows, levels, handle.lower, A.device)
    handle.plan = plan
    handle._plans = {plan.dtype: plan}
    handle.num_levels = plan.num_levels
    handle.order = np.argsort(levels, kind="stable").astype(np.int32)
    handle.inv_order = np.empty_like(handle.order)
    handle.inv_order[handle.order] = np.arange(A.nrows, dtype=np.int32)
    handle.is_symbolic_called = True


@annotate("sptrsv_solve")
def sptrsv_solve(handle: SptrsvHandle, A: CsrMatrix, b: torch.Tensor) -> torch.Tensor:
    """x with tri(A)·x = b, in b's dtype (values read from the handle's plan —
    rebuild the handle for new values).  Computed in the promotion of the
    plan's and b's dtypes, at least f32."""
    check(handle.is_symbolic_called, "sptrsv_solve: symbolic first")
    check(isinstance(b, torch.Tensor) and b.ndim == 1,
          "sptrsv_solve: b must be a rank-1 torch tensor")
    check(b.shape[0] == handle.plan.n, f"sptrsv_solve: b has {b.shape[0]} rows, "
          f"the matrix {handle.plan.n}")
    check(b.device == handle.plan.vals.device,
          f"sptrsv_solve: b on {b.device}, plan on {handle.plan.vals.device}")
    dt = torch.promote_types(torch.promote_types(handle.plan.dtype, b.dtype), torch.float32)
    plan = handle.plan_for(dt)
    bp = permute_gather(plan.order, b.to(dt).contiguous())
    xp = sptrsv_levels(plan, bp)
    return permute_gather(plan.inv_order, xp).to(b.dtype)
