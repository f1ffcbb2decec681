"""A driver over several ranks, for the benchmark's tests and its check on
four cards: PCG with Jacobi through ``tpukk_torch.dist``, ``dist_pcg`` on
the distributed K3 plan (``build_dist_gt_plan``: the halo exchange, then K3
on the rank's block).  It keeps the multi-rank contract of
``kkbench/drivers``.

The port's plans are made from the whole matrix, so each set-up gathers
every rank's part onto the host, builds the plan there and keeps the
rank's shard; the whole matrix is gone when ``prepare`` returns.

``KKBENCH_TEST_FAULT=<fault>:<rank>`` plants a fault on one rank, for the
tests: ``x`` alters the rank's rows of every answer, ``raise`` raises in
its third solve, ``kill`` kills its process there, ``forbidden`` loads a
module named ``jax`` into it.
"""
from __future__ import annotations

import os
import signal
import sys
import types
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from tpukk_torch.containers import CsrMatrix
from tpukk_torch.dist import build_dist_gt_plan, dist_pcg, dist_spmv_gt, shard_plan


def _fault():
    """The fault planted on this rank, or None."""
    kind, _, rank = os.environ.get("KKBENCH_TEST_FAULT", "").partition(":")
    return kind if kind and int(rank) == dist.get_rank() else None


def build(device) -> None:
    if device.type == "cuda":
        from tpukk_torch import _kernels

        _kernels.build_all()


def load(arrays: dict, device) -> CsrMatrix:
    if _fault() == "forbidden":
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    return CsrMatrix.from_arrays(arrays["row_map"], arrays["entries"], arrays["values"],
                                 nrows=arrays["nrows"], ncols=arrays["ncols"], device=device)


def _parts(A: CsrMatrix) -> list:
    """Every rank's (row_map, entries, values) on the host, in rank order."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (A.host_row_map(), A.host_entries(), A.host_values()))
    return parts


def _shard(A: CsrMatrix):
    """The rank's shard of the distributed K3 plan of the whole matrix."""
    parts = _parts(A)
    ends = np.cumsum([int(rm[-1]) for rm, _, _ in parts])
    row_map = np.concatenate([parts[0][0][:1]] + [rm[1:] + int(end - rm[-1])
                                                  for (rm, _, _), end in zip(parts, ends)])
    whole = CsrMatrix.from_arrays(row_map, np.concatenate([p[1] for p in parts]),
                                  np.concatenate([p[2] for p in parts]),
                                  nrows=row_map.shape[0] - 1, ncols=A.ncols, device="cpu")
    plan = build_dist_gt_plan(whole, len(parts))
    del whole, parts
    if plan.rows_per_part != A.nrows:
        raise ValueError(f"dist_pcg: the plan's row blocks ({plan.rows_per_part}) are not the "
                         f"ranks' parts ({A.nrows} rows)")
    return shard_plan(plan, rank=dist.get_rank(), device=A.device)


class Jacobi:
    """z = D⁻¹r on the rank's rows (its diagonal: column row0 + i)."""

    def __init__(self, A: CsrMatrix):
        rm, ent, vals = A.host_row_map(), A.host_entries(), A.host_values()
        row0 = dist.get_rank() * A.nrows
        rows = np.repeat(np.arange(A.nrows), np.diff(rm))
        on = ent == rows + row0
        d = np.zeros(A.nrows, vals.dtype)
        d[rows[on]] = vals[on]
        self.inv_diag = torch.from_numpy(np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
                                         ).to(A.device, A.dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * r


def make_spmv(A: CsrMatrix):
    shard = _shard(A)
    return lambda x: dist_spmv_gt(shard, x)


def make_prec(A: CsrMatrix, mix: dict) -> Jacobi:
    return Jacobi(A)


def prepare(A: CsrMatrix, cfg: dict, mix: dict):
    shard = _shard(A)
    return SimpleNamespace(A=A, shard=shard, Ah=lambda x: dist_spmv_gt(shard, x),
                           prec=Jacobi(A), tables={}, tol=float(cfg["rtol"]),
                           max_iters=int(mix["max_iters"]), solves=0)


def solve(state, b):
    state.solves += 1
    fault = _fault()
    if fault in ("raise", "kill") and state.solves == 3:
        if fault == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError("dist_pcg: a fault planted on this rank")
    x, its, rel = dist_pcg(state.shard, b, tol=state.tol, max_iters=state.max_iters,
                           inv_diag=state.prec.inv_diag)
    if fault == "x":
        x = x.clone()
        x[0] += 1.0
    return x, its, rel <= state.tol
