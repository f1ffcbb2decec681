"""Sparse triangular solve — counterpart of ``tpukk/sparse/sptrsv.py`` (the
reference's sparse/src/KokkosSparse_sptrsv.hpp, symbolic :55,119 and solve
:270,407, with level-set scheduling, SPTRSVAlgorithm SEQLVLSCHD_*).

Symbolic computes the level of every row on the host (Kahn wavefronts, the
level_sched of spiluk_symbolic_impl.hpp:37-88) and builds one level-ordered
CSR plan of the strict triangle (``sptrsv_cuda.build_level_plan``).  Solve is
one launch of K4, which reads b through the level order and writes x back
through it (``src = dst = order``): the three steps of ``tpukk``'s
``fused_sptrsv_solve`` (sptrsv_pallas.py:646-680), permute, solve, permute,
in one kernel.  f32, f64, complex64 and complex128, 1-D b; the values keep
their dtype from symbolic on (only bf16 widens, to f32).

SUPERNODAL builds a supernodal plan instead (``sptrsv_supernodal``): the
expanded supernodal DAG, in the values' dtype, solved by the same one launch.  A
handle's ``sn_partition`` (set by ``sptrsv_cholmod``) imports the supernode
partition.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..common import check, result_dtype
from ..common.permute import permute_gather
from ..common.tracing import annotate
from ..containers import CsrMatrix
from .sptrsv_cuda import LevelPlan, build_level_plan, sptrsv_levels
from .sptrsv_supernodal import FusedSupernodalPlan, build_supernodal_plan, supernodal_solve

__all__ = ["SptrsvHandle", "SptrsvAlgorithm", "sptrsv_symbolic", "sptrsv_solve"]


class SptrsvAlgorithm(enum.Enum):
    """cf. SPTRSVAlgorithm, sptrsv_handle.hpp:42-51.  SEQLVLSCHD covers the
    SEQLVLSCHD_RP/TP1/TP1CHAIN family; SUPERNODAL covers
    SUPERNODAL_NAIVE/ETREE/DAG/SPMV (supernode-blocked solves,
    ``sptrsv_supernodal``)."""
    SEQLVLSCHD = "lvlsched"
    SUPERNODAL = "supernodal"


class SptrsvHandle:
    """cf. sptrsv_handle.hpp; one handle per (matrix, uplo)."""

    def __init__(self, lower: bool = True,
                 algorithm: SptrsvAlgorithm = SptrsvAlgorithm.SEQLVLSCHD,
                 supernode_max_size: int = 64):
        self.lower = lower
        self.algorithm = algorithm
        self.supernode_max_size = supernode_max_size
        self.is_symbolic_called = False
        self.plan: LevelPlan | None = None
        self.num_levels = 0
        self.order = None       # host (n,) int32: level-order position -> row
        self.inv_order = None   # host (n,) int32: row -> level-order position
        self.sn_plan = None     # SUPERNODAL: SupernodalPlan or FusedSupernodalPlan
        self.sn_partition = None  # SUPERNODAL: imported supernode id per column


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
    if vals.dtype not in (np.float32, np.float64, np.complex64, np.complex128):
        vals = vals.astype(np.float32)  # bf16 widens, as at tpukk's plan time
    if handle.algorithm is SptrsvAlgorithm.SUPERNODAL:
        handle.sn_plan = build_supernodal_plan(
            rm, ent, vals, A.nrows, lower=handle.lower, max_size=handle.supernode_max_size,
            sn_of_col=handle.sn_partition, device=A.device)
        handle.num_levels = handle.sn_plan.num_levels_sn
        handle.is_symbolic_called = True
        return
    levels = _compute_levels(rm, ent, A.nrows, handle.lower)
    plan = build_level_plan(rm, ent, vals, A.nrows, levels, handle.lower, A.device)
    handle.plan = plan
    handle.num_levels = plan.num_levels
    handle.order = np.argsort(levels, kind="stable").astype(np.int32)
    handle.inv_order = np.empty_like(handle.order)
    handle.inv_order[handle.order] = np.arange(A.nrows, dtype=np.int32)
    handle.is_symbolic_called = True


@annotate("sptrsv_solve")
def sptrsv_solve(handle: SptrsvHandle, A: CsrMatrix, b: torch.Tensor) -> torch.Tensor:
    """x with tri(A)·x = b, in b's dtype, or in the compute dtype where that
    is complex and b is real (values read from the handle's plan — rebuild
    the handle for new values).  Computed in the promotion of the plan's and
    b's dtypes, at least f32."""
    check(handle.is_symbolic_called, "sptrsv_solve: symbolic first")
    check(isinstance(b, torch.Tensor) and b.ndim == 1,
          "sptrsv_solve: b must be a rank-1 torch tensor")
    if handle.algorithm is SptrsvAlgorithm.SUPERNODAL:
        return supernodal_solve(handle.sn_plan, b)
    return _level_solve(handle, b, handle.plan.order, handle.plan.order)


def _level_solve(handle: SptrsvHandle, b: torch.Tensor, src, dst) -> torch.Tensor:
    """A SEQLVLSCHD solve's one K4 launch, b read through src and x written
    through dst."""
    check(isinstance(b, torch.Tensor) and b.ndim == 1,
          "sptrsv_solve: b must be a rank-1 torch tensor")
    check(b.shape[0] == handle.plan.n, f"sptrsv_solve: b has {b.shape[0]} rows, "
          f"the matrix {handle.plan.n}")
    check(b.device == handle.plan.vals.device,
          f"sptrsv_solve: b on {b.device}, plan on {handle.plan.vals.device}")
    dt = torch.promote_types(torch.promote_types(handle.plan.dtype, b.dtype), torch.float32)
    plan = handle.plan.astype(dt)
    x = sptrsv_levels(plan, b.to(dt).contiguous(), src=src, dst=dst)
    return x.to(result_dtype(b.dtype, dt))


def _compose(idx: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """perm[idx] where idx >= 0, and idx where it is -1 (the DAG's rows that
    read or write nothing), as int32."""
    i = idx.long()
    return torch.where(i >= 0, perm.long()[i.clamp_min(0)], i).to(torch.int32).contiguous()


def _permuted_solve(handle: SptrsvHandle, before=None, after=None):
    """The solve b -> y[after] with y = tri(A)⁻¹·b[before] (``before`` and
    ``after`` (n,) int32 gather indices on the plan's device, None for the
    identity), for the imported factors' outer permutations.

    K4 reads b through ``src`` and writes x through ``dst``, so the
    permutations are composed into the solve's own indices once, here: a
    solve stays one K4 launch, with no K5, and gives the bits of gather,
    solve, gather (the gathers move values; K4's sums do not depend on the
    indices).  The batched supernodal plan (``fused=False``), which K4 does
    not run, keeps its gathers."""
    check(handle.is_symbolic_called, "sptrsv: symbolic first")
    sp = handle.sn_plan
    if handle.algorithm is SptrsvAlgorithm.SUPERNODAL and not isinstance(sp, FusedSupernodalPlan):
        def gathered(b):
            check(isinstance(b, torch.Tensor) and b.ndim == 1 and b.shape[0] == sp.n,
                  f"supernodal_solve: b must be a rank-1 tensor of {sp.n} rows")
            bb = b if before is None else permute_gather(before, b.contiguous())
            y = supernodal_solve(sp, bb)
            return y if after is None else permute_gather(after, y)
        return gathered
    fused = handle.algorithm is SptrsvAlgorithm.SUPERNODAL
    src, dst = (sp.src, sp.dst) if fused else (handle.plan.order, handle.plan.order)
    if before is not None:
        src = _compose(src, before)
    if after is not None:
        inv = torch.empty_like(after)
        inv[after.long()] = torch.arange(after.shape[0], dtype=after.dtype, device=after.device)
        dst = _compose(dst, inv)
    if fused:
        folded = dataclasses.replace(sp, src=src, dst=dst)
        return lambda b: supernodal_solve(folded, b)
    return lambda b: _level_solve(handle, b, src, dst)
