"""Distributed SpMV and Krylov solvers — counterpart of
``tpukk/dist/spmv.py``: rows of A block-partitioned over the ranks, x
row-partitioned the same way.

Each call runs on one rank of a ``torch.distributed`` process group
(``group``, None meaning the default group) and takes and returns that
rank's shard: the rank's ``rows_per_part`` rows of the padded vector, on
the shard plan's device.  Scalars (``dist_dot``, iteration counts, relative
residuals) are the same on every rank.  ``tpukk`` runs the same schedules
from one process over a mesh and takes the whole padded vector.

* ``dist_spmv`` (``RowPartition``): the whole x by all-gather, then each
  rank's padded-row product (torch ops, as ``tpukk``'s are XLA ops).
* ``dist_spmv_halo`` (``HaloPlan``): the import lists by one
  ``all_to_all_single``, the interior rows on x_local, the boundary rows on
  x_ext = [x_local | halo].
* ``dist_spmv_gt`` (``gt_spmv.py``): the same exchange, then K3 on the
  rank's local CSR.
* ``dist_pcg`` and ``dist_gmres`` take any of the three plans; their inner
  products are ``dist_dot``: the rank's sum, then ``all_reduce``.  PCG tests
  convergence on the host every iteration by default, as ``tpukk``'s
  ``while_loop`` does on the device, so the iteration counts agree; with
  ``check_every`` it reads the residual once a block, as ``sparse/pcg.py``
  does, and takes any preconditioner (``prec``), the distributed
  Gauss-Seidel's ``DistGsPrec`` among them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import TpuKKError
from ..common.cuda_graph import block_state, entry, run_blocks
from ..common.tracing import annotate
from ..common.types import default_device
from .halo import HaloPlan
from .partition import RowPartition
from .ranks import all_gather, all_reduce_sum, exchange, world

__all__ = ["shard_partition", "dist_spmv", "dist_dot", "dist_cg_step",
           "shard_halo_plan", "dist_spmv_halo", "dist_pcg", "dist_gmres"]


def shard_rank(rank, group) -> int:
    """The rank a shard is taken for: ``rank``, or this process's in ``group``."""
    return world(group)[0] if rank is None else int(rank)


def to_dev(a, dev: torch.device, index: bool = False) -> torch.Tensor:
    """A host array on ``dev``: int64 indices when ``index``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev, torch.int64 if index else None)


def check_host(plan, name: str) -> None:
    if plan.rank is not None:
        raise TpuKKError(f"{name}: the plan is already a shard (of rank {plan.rank})")


def check_shard(plan, name: str) -> None:
    if plan.rank is None:
        raise TpuKKError(f"{name}: give a rank's shard of the plan (its shard_* function)")


@annotate("dist.shard_partition")
def shard_partition(plan: RowPartition, rank=None, device=None, group=None) -> RowPartition:
    """The rank's slice of the stacked plan on ``device`` (None: the CUDA
    device): the counterpart of placing it on the mesh."""
    check_host(plan, "shard_partition")
    r, dev = shard_rank(rank, group), default_device(device)
    return dataclasses.replace(plan, cols=to_dev(plan.cols[r], dev, True),
                               vals=to_dev(plan.vals[r], dev),
                               row_valid=to_dev(plan.row_valid[r], dev), rank=r)


@annotate("dist.dist_spmv")
def dist_spmv(plan: RowPartition, x_shard: torch.Tensor, group=None) -> torch.Tensor:
    """y = A·x on the rank's rows: x gathered whole from every rank, then a
    padded-row gather and row sum (no scatter, no atomics).  The plan's
    column ids index the unpadded global x; x's pad rows hold zeros."""
    check_shard(plan, "dist_spmv")
    x = all_gather(x_shard, group)
    y = torch.sum(plan.vals * x[plan.cols], dim=1)
    return y * plan.row_valid.to(y.dtype)


@annotate("dist.shard_halo_plan")
def shard_halo_plan(plan: HaloPlan, rank=None, device=None, group=None) -> HaloPlan:
    """The rank's slice of the halo plan on ``device``; its send list flat,
    rank by rank of destination."""
    check_host(plan, "shard_halo_plan")
    r, dev = shard_rank(rank, group), default_device(device)
    return dataclasses.replace(
        plan, send_idx=to_dev(plan.send_idx[r].reshape(-1), dev, True),
        int_cols=to_dev(np.minimum(plan.int_cols[r], plan.rows_per_part - 1), dev, True),
        int_vals=to_dev(plan.int_vals[r], dev), int_rows=to_dev(plan.int_rows[r], dev, True),
        bnd_cols=to_dev(plan.bnd_cols[r], dev, True), bnd_vals=to_dev(plan.bnd_vals[r], dev),
        bnd_rows=to_dev(plan.bnd_rows[r], dev, True), rank=r)


def halo_exchange(x: torch.Tensor, send: torch.Tensor, halo: int, n_parts: int,
                  group) -> torch.Tensor:
    """The padded all_to_all: x[send] out, H values to every rank; the (P·H)
    values received, rank by rank of source."""
    splits = [halo] * n_parts
    return exchange(x[send], splits, splits, group)


@annotate("dist.dist_spmv_halo")
def dist_spmv_halo(plan: HaloPlan, x_shard: torch.Tensor, group=None) -> torch.Tensor:
    """y = A·x with the import-list exchange (``all_to_all_single``): the
    interior rows need only x_local, the boundary rows x_ext."""
    check_shard(plan, "dist_spmv_halo")
    rpp = plan.rows_per_part
    recv = halo_exchange(x_shard, plan.send_idx, plan.halo, plan.n_parts, group)
    yi = torch.sum(plan.int_vals * x_shard[plan.int_cols], dim=1)
    x_ext = torch.cat([x_shard, recv])
    yb = torch.sum(plan.bnd_vals * x_ext[plan.bnd_cols], dim=1)
    y = torch.zeros(rpp + 1, dtype=x_shard.dtype, device=x_shard.device)
    y[plan.int_rows] = yi.to(y.dtype)
    y[plan.bnd_rows] = yb.to(y.dtype)
    return y[:rpp]


def _spmv_fn_for(plan):
    from .gt_spmv import DistGtPlan, DistGtPlan2, dist_spmv_gt

    if isinstance(plan, (DistGtPlan, DistGtPlan2)):
        return dist_spmv_gt
    return dist_spmv_halo if isinstance(plan, HaloPlan) else dist_spmv


@annotate("dist.dist_dot")
def dist_dot(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """<x, y> over row-partitioned vectors (unconjugated, as ``tpukk``'s):
    the rank's sum, then ``all_reduce``; a 0-d tensor, equal on every rank."""
    return all_reduce_sum(torch.sum(x * y), group)


def _dots(pairs, group) -> torch.Tensor:
    """Several ``dist_dot`` in one ``all_reduce``: the same values."""
    return all_reduce_sum(torch.stack([torch.sum(a * b) for a, b in pairs]), group)


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    """v, with 1 where v is 0 (``jnp.where(v == 0, 1.0, v)``)."""
    return v + (v == 0)


@annotate("dist.dist_cg_step")
def dist_cg_step(plan, state, group=None):
    """One CG iteration on the rank's shards of (x, r, p, rz)."""
    x, r, p, rz = state
    Ap = _spmv_fn_for(plan)(plan, p, group)
    pAp = dist_dot(p, Ap, group)
    rz = torch.as_tensor(rz, dtype=pAp.dtype, device=pAp.device)
    alpha = rz / _nonzero(pAp)
    x = x + alpha * p
    r = r - alpha * Ap
    rz_new = dist_dot(r, r, group)
    beta = rz_new / _nonzero(rz)
    p = r + beta * p
    return (x, r, p, rz_new)


@annotate("dist_pcg")
def dist_pcg(plan, b_shard: torch.Tensor, tol: float = 1e-8, max_iters: int = 200,
             inv_diag=None, group=None, prec=None, check_every: int = 1, graphs=None):
    """Preconditioned CG from x = 0 on the rank's shard of b.  The
    preconditioner is ``prec`` (an object whose ``apply`` maps the rank's
    shard of r to its shard of z, such as ``DistGsPrec``), or Jacobi by
    ``inv_diag`` (the rank's shard of 1/diag, 0 on pad rows), or none.
    Returns (x shard, iterations, ‖r‖/‖b‖).  r·r is read on the host before
    the first iteration and after every ``check_every`` iterations, and the
    solve stops once r·r ≤ tol²·b·b or the iterations reach ``max_iters``;
    iterations count in whole blocks.  At ``check_every`` 1 this is
    ``tpukk``'s loop, iteration for iteration.  Each iteration reduces p·Ap,
    then r·z and r·r together.

    ``graphs``: a dict that the caller keeps between solves with this plan
    and preconditioner.  On a CUDA device the blocks then run as ``pcg``'s
    do (``common.cuda_graph.run_blocks``): after the first solve's first
    block, each is a replay of a CUDA graph captured after it, where every
    rank's capture succeeds: the same kernels and collectives on the same
    values, issued by one launch a block, with ``pcg``'s rule for when a
    graph is stale; the counters are ``dist_pcg.blocks`` and the like.
    Empty the dict before the process group is destroyed: NCCL destroys a
    communicator only once no CUDA graph that captured its collectives is
    left, and waits for that until then."""
    check_shard(plan, "dist_pcg")
    if prec is not None and inv_diag is not None:
        raise TpuKKError("dist_pcg: give prec or inv_diag, not both")
    if check_every < 1:
        raise TpuKKError(f"dist_pcg: check_every must be at least 1, got {check_every}")
    spmv = _spmv_fn_for(plan)
    if prec is None:
        prec = _NO_PREC if inv_diag is None else _Jacobi(inv_diag)
    # a fresh _Jacobi would die with the solve: its entry goes by inv_diag
    owner = prec if inv_diag is None else inv_diag

    bb = dist_dot(b_shard, b_shard, group)
    bb = float(bb) if float(bb) != 0 else 1.0
    tol2 = tol * tol * bb
    g = entry(graphs, (id(plan), id(group), check_every), b_shard, owner, ("rz", "rr"))
    if g is None:
        st = block_state(b_shard, ("rz", "rr"))
    else:
        st = g
        g.pinned = (plan, inv_diag, group)  # so that the key's ids stay theirs
    st.x.zero_()
    st.r.copy_(b_shard)
    z = prec.apply(st.r)
    st.p.copy_(z)
    rz, rr = _dots(((st.r, z), (st.r, st.r)), group)
    st.rz.copy_(rz)
    st.rr.copy_(rr)

    def block(st):
        for _ in range(check_every):
            Ap = spmv(plan, st.p, group)
            pAp = dist_dot(st.p, Ap, group)
            alpha = st.rz / _nonzero(pAp)
            st.x.add_(alpha * st.p)
            st.r.sub_(alpha * Ap)
            z = prec.apply(st.r)
            rz_new, rr = _dots(((st.r, z), (st.r, st.r)), group)
            beta = rz_new / _nonzero(st.rz)
            torch.add(z, beta * st.p, out=st.p)
            st.rz.copy_(rz_new)
            st.rr.copy_(rr)

    def check(st):
        rr = float(st.rr)
        return rr, not rr > tol2  # a NaN r·r ends the solve, as tpukk's loop does

    def agree(ok: bool) -> bool:
        n = all_reduce_sum(torch.tensor(float(ok), device=b_shard.device), group)
        return int(n) == world(group)[1]

    k, rr = run_blocks("dist_pcg", block, check, st, g is not None, check_every, max_iters,
                       first=check(st), agree=agree)
    return (st.x if g is None else st.x.clone()), k, float(np.sqrt(rr / bb))


class _Jacobi:
    def __init__(self, inv_diag):
        self.inv_diag = inv_diag

    def apply(self, r):
        return r if self.inv_diag is None else self.inv_diag * r


# the preconditioner of neither prec nor inv_diag: one object, so that its entry is found again
_NO_PREC = _Jacobi(None)


@annotate("dist.dist_gmres")
def dist_gmres(plan, b_shard: torch.Tensor, m: int = 30, tol: float = 1e-8,
               max_restarts: int = 10, inv_diag=None, group=None):
    """Restarted GMRES(m) with CGS2 on the rank's shard of b: the port's
    Arnoldi cycle (``sparse.gmres._arnoldi_cycle``) with the distributed
    SpMV and every inner product and norm reduced over the ranks (the psums
    that GSPMD inserts in ``tpukk``).  ``inv_diag`` (the rank's shard)
    enables Jacobi.  Returns (x shard, iterations, relative residual)."""
    from ..sparse.gmres import Ortho, _arnoldi_cycle

    check_shard(plan, "dist_gmres")
    spmv = _spmv_fn_for(plan)

    def Ah(v):
        return spmv(plan, v, group)

    def reduce(t):
        return all_reduce_sum(t, group)

    prec = _Jacobi(inv_diag)
    m = min(m, plan.padded_rows - 1)
    bnorm = float(torch.sqrt(dist_dot(b_shard, b_shard, group))) or 1.0
    x = torch.zeros_like(b_shard)
    iters, rel = 0, float("inf")
    for _ in range(max_restarts):
        x = _arnoldi_cycle(Ah, prec, b_shard, x, m, Ortho.CGS2, reduce=reduce)
        iters += m
        r = b_shard - Ah(x)
        rel = float(torch.sqrt(dist_dot(r, r, group))) / bnorm
        if rel <= tol:
            break
    return x, iters, rel
