"""PCG with the distributed multicolor symmetric Gauss-Seidel through
``tpukk_torch.dist``, HPCG's solve over several ranks, one a card:
``dist_pcg`` on the distributed K3 plan (``build_dist_gt_plan``: the halo
exchange, then K3 on the rank's block), preconditioned by ``DistGsPrec`` on
the distributed Gauss-Seidel plan (``build_dist_gs_gt_plan`` with the mix's
coloring of the whole matrix: one symmetric sweep from zero, the halo
exchanged before each color, K6's color step on the rank's rows), the
residual read every ``check_every`` iterations, each block of iterations
a replay of a CUDA graph of it (``dist_pcg``'s ``graphs``, kept in the
state).  It keeps the multi-rank contract of ``kkbench/drivers``.

The port's plan builders take the whole matrix, so a set-up gathers every
rank's part onto the host once, builds the plans there and keeps the
rank's shards, which hold the rank's rows alone: the whole matrix and the
other ranks' parts are gone when it returns.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch.distributed as dist

from tpukk_torch.containers import CsrMatrix
from tpukk_torch.dist import (build_dist_gs_gt_plan, build_dist_gt_plan, dist_pcg, dist_spmv_gt,
                              shard_plan)
from tpukk_torch.dist.gauss_seidel import DistGsPrec
from tpukk_torch.graph import ColoringAlgorithm


def build(device) -> None:
    if device.type == "cuda":
        from tpukk_torch import _kernels

        _kernels.build_all()


def load(arrays: dict, device) -> CsrMatrix:
    return CsrMatrix.from_arrays(arrays["row_map"], arrays["entries"], arrays["values"],
                                 nrows=arrays["nrows"], ncols=arrays["ncols"], device=device)


def _shards(A: CsrMatrix, mix: dict, spmv: bool, gs: bool) -> tuple:
    """The rank's shards of the K3 plan and of the Gauss-Seidel plan of the
    whole matrix (each None where not asked for), from one gather of every
    rank's part."""
    if mix.get("gs_algorithm", "POINT") != "POINT":
        raise ValueError(f"dist_symgs_pcg: the distributed sweep is POINT, not "
                         f"{mix['gs_algorithm']}")
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (A.host_row_map(), A.host_entries(), A.host_values()))
    ends = np.cumsum([int(rm[-1]) for rm, _, _ in parts])
    row_map = np.concatenate([parts[0][0][:1]] + [rm[1:] + int(end - rm[-1])
                                                  for (rm, _, _), end in zip(parts, ends)])
    whole = CsrMatrix.from_arrays(row_map, np.concatenate([p[1] for p in parts]),
                                  np.concatenate([p[2] for p in parts]),
                                  nrows=row_map.shape[0] - 1, ncols=A.ncols, device="cpu")
    del parts, row_map
    plans = (build_dist_gt_plan(whole, dist.get_world_size()) if spmv else None,
             build_dist_gs_gt_plan(whole, dist.get_world_size(),
                                   coloring=ColoringAlgorithm[mix.get("coloring", "SERIAL")])
             if gs else None)
    del whole
    shards = []
    for plan in plans:
        if plan is not None and plan.rows_per_part != A.nrows:
            raise ValueError(f"dist_symgs_pcg: the plan's row blocks ({plan.rows_per_part}) "
                             f"are not the ranks' parts ({A.nrows} rows)")
        shards.append(None if plan is None else
                      shard_plan(plan, rank=dist.get_rank(), device=A.device))
    return tuple(shards)


def make_spmv(A: CsrMatrix):
    shard, _ = _shards(A, {}, spmv=True, gs=False)
    return lambda x: dist_spmv_gt(shard, x)


def make_prec(A: CsrMatrix, mix: dict) -> DistGsPrec:
    _, gs = _shards(A, mix, spmv=False, gs=True)
    return DistGsPrec(gs, sweeps=int(mix.get("sweeps", 1)))


def _colors(state) -> np.ndarray:
    """The table ``colors``; its read also lets the cached CUDA graphs go.
    The harness reads the tables once, after every solve of the run (the
    window, the traced stretches, the rooflines) and before the ranks leave
    their groups, while a traced run's context still holds the state: NCCL
    destroys its communicator only once no CUDA graph that captured its
    collectives is left, so a graph alive then would hang the run."""
    state.graphs.clear()
    return state.prec.colors()


def prepare(A: CsrMatrix, cfg: dict, mix: dict):
    """The port's set-up on every rank: the two plans' shards, the
    preconditioner and the cache of ``dist_pcg``'s graphs; the table
    ``colors`` is the rank's rows of the whole matrix's coloring, in their
    natural order."""
    shard, gs = _shards(A, mix, spmv=True, gs=True)
    prec = DistGsPrec(gs, sweeps=int(mix.get("sweeps", 1)))
    state = SimpleNamespace(shard=shard, Ah=lambda x: dist_spmv_gt(shard, x), prec=prec,
                            tol=float(cfg["rtol"]), max_iters=int(mix["max_iters"]),
                            check_every=int(mix.get("check_every", 10)), graphs={})
    state.tables = {"colors": lambda: _colors(state)}
    return state


def solve(state, b):
    """(x, iterations, converged) on the rank's rows."""
    x, its, rel = dist_pcg(state.shard, b, tol=state.tol, max_iters=state.max_iters,
                           prec=state.prec, check_every=state.check_every,
                           graphs=state.graphs)
    return x, its, rel <= state.tol
