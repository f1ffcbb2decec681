"""Starting ranks, and the collectives of the distributed layer.

``tpukk`` drives a ``jax.sharding.Mesh`` from one process.  Here each part
of a plan is one rank of a ``torch.distributed`` process group, one process
a rank: ``RankPool`` (or ``run_ranks`` for one call) is the counterpart of
building a ``Mesh``.  It spawns P processes, joins them into a new process
group (the ranks meet through a ``file://`` rendezvous in a new temporary
directory, never a fixed port), and runs on every rank the functions it is
given, returning each rank's result in rank order::

    from tpukk_torch.dist import ranks
    with ranks.RankPool(4) as pool:                   # gloo, CPU tensors
        ys = pool.run(ranks.call_sharded, "dist_spmv_halo", plan, [x_padded],
                      device="cpu")
    y = np.concatenate(ys)

A job is a picklable function of the package (the children import only
torch, numpy, scipy and ``tpukk_torch``).  ``init_process_group`` gets the
pool's timeout: a rank that fails or hangs makes ``run`` raise within it,
with the failing rank's traceback, and the pool is then closed.  On a CUDA
device, build the kernels first (``_kernels.build_all()``): the ranks then
only load the libraries.

The collectives are the ones NCCL and gloo both implement:
``all_gather_into_tensor``, ``all_to_all_single`` (with uneven splits) and
``all_reduce``; ``jax.lax.all_to_all`` and ``ppermute`` map to
``all_to_all_single`` (zero splits to the ranks a rank does not send to),
``psum`` to ``all_reduce``.  ``exchange``, the halo exchange, is the
``all_to_all`` that the tracing region and counters see.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..common import TpuKKError
from ..common.tracing import count, profile_region
from ..common.types import default_device

__all__ = ["RankPool", "run_ranks", "call_sharded", "world", "all_reduce_sum", "all_gather",
           "all_to_all", "exchange"]

HALO_REGION = "tpukk::dist.halo_exchange"


# ---- collectives ------------------------------------------------------------

def world(group=None) -> tuple:
    """(rank, size) of this process in ``group`` (None: the default group)."""
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """psum: ``t`` (a temporary: it is reduced in place) summed over the
    ranks, on every rank."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' 1-D ``t`` (one length on every rank) concatenated in rank
    order (``all_gather(..., tiled=True)``)."""
    _, size = world(group)
    out = t.new_empty(size * t.numel())
    with warnings.catch_warnings():  # newer torch renames it all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_to_all(sends: torch.Tensor, send_splits, recv_splits, group=None) -> torch.Tensor:
    """``all_to_all_single``: ``sends`` holds, rank by rank, send_splits[r]
    values for rank r; the result holds, rank by rank, recv_splits[r] values
    from rank r."""
    out = sends.new_empty(int(sum(recv_splits)))
    dist.all_to_all_single(out, sends.contiguous(), list(recv_splits), list(send_splits),
                           group=group)
    return out


def exchange(sends: torch.Tensor, send_splits, recv_splits, group=None) -> torch.Tensor:
    """A halo exchange, the one ``all_to_all`` of the SpMV plans and the
    Gauss-Seidel sweep: inside the region ``tpukk::dist.halo_exchange``,
    counted in ``dist.halo_exchanges`` (one) and ``dist.halo_bytes`` (the
    bytes this rank sends to the other ranks)."""
    with profile_region(HALO_REGION):
        count("dist.halo_exchanges")
        own = send_splits[dist.get_rank(group)]
        count("dist.halo_bytes", (int(sum(send_splits)) - int(own)) * sends.element_size())
        return all_to_all(sends, send_splits, recv_splits, group)


# ---- starting ranks ---------------------------------------------------------

def _rank_main(rank, size, init, backend, timeout, jobs, results):
    try:
        torch.set_num_threads(1)  # P ranks share the host's cores
        if backend == "nccl":  # a card a rank
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``size`` spawned ranks of one new process group (``backend`` gloo or
    nccl), each running the jobs ``run`` gives it; a context manager."""

    def __init__(self, size: int, backend: str = "gloo", timeout: float = 120.0):
        self.size, self.timeout = int(size), float(timeout)
        self._dir = tempfile.mkdtemp(prefix="tpukk_ranks_")
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(self.size)]
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.size, init, backend, self.timeout,
                                         self._jobs[r], self._results))
                       for r in range(self.size)]
        for p in self._procs:
            p.start()
        try:
            self._collect()
        except BaseException:
            self.close()
            raise

    def _collect(self) -> list:
        out, deadline = [None] * self.size, time.monotonic() + self.timeout
        pending = set(range(self.size))
        while pending:
            try:
                rank, ok, value = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r in pending if self._procs[r].exitcode is not None]
                if dead:
                    raise TpuKKError(f"rank {dead[0]} exited with code "
                                     f"{self._procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TpuKKError(f"ranks {sorted(pending)} did not answer within "
                                     f"{self.timeout} s")
                continue
            if not ok:
                raise TpuKKError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if self._procs is None:
            raise TpuKKError("RankPool: the pool is closed")
        for q in self._jobs:
            q.put((fn, args, kwargs))
        try:
            return self._collect()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop the ranks (waiting briefly for a clean exit) and remove the
        rendezvous directory."""
        if self._procs is None:
            return
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        end = time.monotonic() + 10.0
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, size: int, *args, backend: str = "gloo", timeout: float = 120.0,
              **kwargs) -> list:
    """fn(*args, **kwargs) on each of ``size`` new ranks; the results in rank
    order."""
    with RankPool(size, backend, timeout) as pool:
        return pool.run(fn, *args, **kwargs)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy() if v.ndim else v.item()
    if isinstance(v, (tuple, list)):
        return type(v)(_host(u) for u in v)
    if hasattr(v, "to_scipy"):  # a CsrMatrix: its scipy form
        return v.to_scipy()
    return v


def call_sharded(entry: str, plan, vectors=(), device=None, group=None, **kwargs):
    """On one rank: shard ``plan`` onto ``device``, take this rank's slice of
    each whole padded vector in ``vectors`` (the single-controller inputs
    of ``tpukk``), call ``tpukk_torch.dist.<entry>`` on them, and return its
    result on the host (tensors as numpy arrays, a matrix as scipy).

    The vectors are cut into ``plan.n_parts`` equal slices, the layout of
    the plan's padded rows (its permuted rows when ``permuted=True`` is
    passed to ``dist_gs_sweep``); a tuple of vectors (``dist_cg_step``'s
    state) is sliced entry by entry, numbers passed as they are."""
    from .. import dist as pkg

    rank, size = world(group)
    if plan is None:  # dist_dot: vectors cut into one slice a rank
        parts, lead = size, ()
        dev = default_device(device)
    else:
        shard = pkg.shard_plan(plan, rank=rank, device=device, group=group)
        parts, lead, dev = plan.n_parts, (shard,), pkg.plan_device(shard)

    def local(v):
        if isinstance(v, (tuple, list)):
            return type(v)(local(u) for u in v)
        if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) == 1:
            v = torch.as_tensor(v)
            n = v.shape[0] // parts
            return v[rank * n:(rank + 1) * n].to(dev).contiguous()
        return v

    args = [local(v) for v in vectors]
    if kwargs.get("inv_diag") is not None:
        kwargs["inv_diag"] = local(kwargs["inv_diag"])
    return _host(getattr(pkg, entry)(*lead, *args, group=group, **kwargs))
