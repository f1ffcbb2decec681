"""The ranks of a cell that runs over several cards: one process a card.

The process of ``run.py`` is rank 0 on card 0.  ``start`` spawns ranks
1..c−1, each on its own card (``cuda:r``; the CPU in tests), and joins all c
into one ``torch.distributed`` process group: NCCL on the cards, gloo on the
CPU, through a ``file://`` rendezvous in a new temporary directory (never a
fixed port).  That group is the program's, for its collectives.  The harness
speaks over a second group of its own, gloo on the host, so that its words
(when the window closes, whether every rank finished its solve, what each
rank hands rank 0) put nothing on the cards.

Faults end the run without a result, within ``TIMEOUT_S`` and a few seconds
more:

- a rank that raises or is killed: rank 0 watches its ranks, and on the
  first that ends with a non-zero code it kills the others, waits for them
  and leaves the process at once (``os._exit``, code 4), whatever its main
  thread was waiting for (or its main thread raises first, as a gloo
  collective does when a peer's connection closes);
- a rank that hangs: every collective of both groups gives up after
  ``TIMEOUT_S`` and raises on the ranks that wait (NCCL's watchdog ends the
  process), which ends those ranks;
- rank 0 that raises or ends: ``start`` kills its ranks on the way out, and
  each rank dies with the process that started it (``PR_SET_PDEATHSIG``).
"""
from __future__ import annotations

import contextlib
import ctypes
import datetime
import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

# the longest a rank waits in a collective before it gives up
TIMEOUT_S = 120.0
# the longest rank 0 waits for the ranks to end once the run is over
END_S = 30.0
EXIT_RANK_FAILED = 4


def _log(msg: str) -> None:
    sys.stderr.write(f"kkbench: {msg}\n")
    sys.stderr.flush()


class Team:
    """This process's place among the ranks, and the harness's collectives
    (host tensors over the gloo group)."""

    def __init__(self, rank: int, size: int, device: torch.device, control):
        self.rank, self.size, self.device, self._control = rank, size, device, control
        self._joined = True

    def leave(self) -> None:
        """Leave both groups, all ranks together after their last collective
        (NCCL's teardown waits for every rank's)."""
        if self._joined:
            self._joined = False
            dist.destroy_process_group()

    def go(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self._control)
        return bool(t.item())

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._control)
        return bool(t.item())

    def max(self, value: float) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._control)
        return float(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self._control)

    def gather(self, obj):
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self._control)
        return out


def _join(rank: int, size: int, init: str, device: torch.device) -> Team:
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank,
                            timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    return Team(rank, size, device, control)


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent ends (Linux)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:  # the parent ended before the line above
        os._exit(EXIT_RANK_FAILED)


def _rank_main(rank, size, init, device_type, parent, job, args) -> None:
    _die_with(parent)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    team = _join(rank, size, init, device)
    job(team, *args)
    # after a fault the rank ends without leaving: a teardown could wait on
    # a rank that is gone
    team.leave()


class _Watch(threading.Thread):
    """Rank 0's watch over its ranks: the first that ends with a non-zero
    code ends the run."""

    def __init__(self, procs):
        super().__init__(name="kkbench-ranks", daemon=True)
        self.procs, self.stopped = procs, threading.Event()

    def run(self) -> None:
        while not self.stopped.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    _log(f"rank {r} ended with exit code {p.exitcode}: no result")
                    _kill(self.procs)
                    os._exit(EXIT_RANK_FAILED)


def _kill(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join()


@contextlib.contextmanager
def start(size: int, device: torch.device, job, args=()):
    """Spawn ranks 1..size−1, each running ``job(team, *args)`` (a function
    of a module, as spawn pickles it), join the group as rank 0 and yield
    rank 0's ``Team``.  On the way out rank 0 leaves the groups (the ranks
    leave them after their last collective), waits for the ranks to end and
    kills any left."""
    # NCCL's watchdog ends a process whose collective outlived the timeout
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    tmp = tempfile.mkdtemp(prefix="kkbench_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"kkbench-rank{r}",
                         args=(r, size, init, device.type, os.getpid(), job, args))
             for r in range(1, size)]
    watch = _Watch(procs)
    team = None
    try:
        for p in procs:
            p.start()
        _log("ranks " + ", ".join(f"{r} pid {p.pid}" for r, p in enumerate(procs, 1)))
        watch.start()
        team = _join(0, size, init, device)
        yield team
        team.leave()
        deadline = time.monotonic() + END_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs, 1) if p.exitcode is None]
        if late:
            _log(f"ranks {late} had not ended {END_S} s after the run: killed")
    except BaseException:
        # rank 0 may see a rank's end (a connection closed) before the watch
        # does: name the rank that failed, if one did
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and all(p.exitcode in (None, 0) for p in procs):
            time.sleep(0.05)
        for r, p in enumerate(procs, 1):
            if p.exitcode not in (None, 0):
                _log(f"rank {r} ended with exit code {p.exitcode}: no result")
        raise
    finally:
        watch.stopped.set()
        if watch.is_alive():
            watch.join()
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
