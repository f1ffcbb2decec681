"""Distributed layer — counterpart of ``tpukk/dist``: row partitions, halo
exchange, the distributed SpMV (all-gather, halo and K3 schedules), PCG and
GMRES, colored Gauss-Seidel (K6) and the ring SpGEMM (K8), over
``torch.distributed``.

Execution model.  ``tpukk`` is single-controller: one process drives a
``jax.sharding.Mesh`` through ``shard_map`` and passes whole padded vectors
(``dist_spmv(plan, x_padded, mesh)``).  ``torch.distributed`` runs one
process a rank, so here:

* the plan builders take the whole matrix and return host (numpy) plans,
  stacked on a parts axis, with no process group, as in ``tpukk``;
* each ``shard_*`` function (``shard_partition``, ``shard_halo_plan``,
  ``shard_dist_gt_plan``, ``shard_dist_gs_plan``,
  ``shard_ring_spgemm_plan``) is the counterpart of ``device_put`` onto the
  mesh: it takes one rank's slice of the plan onto an explicit device (the
  CUDA device unless the caller asks for the CPU);
* the entry points run on every rank of a process group (``group``, None:
  the default group) and take and return that rank's shard of each vector:
  its ``rows_per_part`` rows of the padded vector.  Scalars (``dist_dot``,
  iteration counts, relative residuals) are the same on every rank;
  ``ring_spgemm_numeric`` returns the whole C on every rank.

``ranks.RankPool`` starts P ranks of a new process group and runs functions
on them (the counterpart of building a ``Mesh``); ``ranks.call_sharded``
runs one entry point on whole padded vectors from the controlling process.
"""
from .gauss_seidel import (
    DistGsGtPlan,
    DistGsPlan,
    build_dist_gs_gt_plan,
    build_dist_gs_plan,
    dist_gs_sweep,
    shard_dist_gs_plan,
)
from .gt_spmv import (DistGtPlan, DistGtPlan2, build_dist_gt_plan,
                      build_dist_gt_plan2, dist_plan_accounting,
                      dist_spmv_gt, shard_dist_gt_plan)
from .halo import HaloPlan, build_halo_plan, import_lists
from .partition import RowPartition, partition_rows
from .spgemm import (
    RingSpgemmPlan,
    build_ring_spgemm_plan,
    ring_spgemm_numeric,
    shard_ring_spgemm_plan,
)
from .spmv import (
    dist_cg_step,
    dist_gmres,
    dist_pcg,
    dist_dot,
    dist_spmv,
    dist_spmv_halo,
    shard_halo_plan,
    shard_partition,
)

__all__ = [
    "DistGsGtPlan", "DistGsPlan", "DistGtPlan", "DistGtPlan2", "HaloPlan", "RingSpgemmPlan",
    "RowPartition", "build_dist_gs_gt_plan", "build_dist_gs_plan",
    "build_dist_gt_plan", "build_dist_gt_plan2", "build_halo_plan", "build_ring_spgemm_plan",
    "dist_cg_step", "dist_dot", "dist_gmres", "dist_gs_sweep", "dist_pcg",
    "dist_spmv", "dist_spmv_gt", "dist_spmv_halo", "import_lists",
    "partition_rows", "ring_spgemm_numeric", "shard_dist_gs_plan",
    "shard_dist_gt_plan", "shard_halo_plan", "shard_partition",
    "shard_ring_spgemm_plan",
]

_SHARD = ((RowPartition, shard_partition), (HaloPlan, shard_halo_plan),
          ((DistGtPlan, DistGtPlan2), shard_dist_gt_plan),
          ((DistGsPlan, DistGsGtPlan), shard_dist_gs_plan),
          (RingSpgemmPlan, shard_ring_spgemm_plan))


def shard_plan(plan, rank=None, device=None, group=None):
    """The ``shard_*`` function of the plan's type, applied."""
    for kind, fn in _SHARD:
        if isinstance(plan, kind):
            return fn(plan, rank=rank, device=device, group=group)
    raise TypeError(f"shard_plan: not a dist plan: {type(plan).__name__}")


def plan_device(shard):
    """The device a shard's arrays live on."""
    import torch

    for name in ("to_perm_idx", "send_idx", "send", "cols", "a_vals_pad"):
        v = getattr(shard, name, None)
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"plan_device: not a shard: {type(shard).__name__}")
