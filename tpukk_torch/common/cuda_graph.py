"""The solvers' block loop and its CUDA graphs: a block of ``check_every``
iterations recorded once and replayed by one launch
(``sparse/pcg.py::pcg``, ``dist/spmv.py::dist_pcg``).

A solver passes ``run_blocks`` its block, its residual read and its state:
a namespace of the buffers the block updates in place (``block_state``).
Where the caller keeps graphs, that state is a cache entry (``entry``) in the
caller's dict, which decides where a solve's graph lives and when it is
stale; the loop captures the block once, after the first block run as it is,
notes the counters its host code added, and replays it from then on, adding
them again, so that ``launches.*`` and the other counters read as if the
block had run as it is."""
from __future__ import annotations

import inspect
import threading
import weakref
from types import SimpleNamespace

import torch

from .tracing import count, counters, profile_region

__all__ = ["GRAPH_DEVICES", "block_state", "capture", "entry", "run_blocks"]

# the devices on which the solvers replay their blocks as CUDA graphs
GRAPH_DEVICES = ("cuda",)

# a capture that other threads' CUDA calls leave alone (NCCL's watchdog
# queries its events meanwhile), where torch has it
_THREAD_LOCAL = ({"capture_error_mode": "thread_local"}
                 if "capture_error_mode" in inspect.signature(torch.cuda.graph).parameters else {})


def block_state(b: torch.Tensor, scalars=("rz",)) -> SimpleNamespace:
    """x, r and p shaped as b and a 0-d buffer for each name in ``scalars``,
    that a block updates in place; no replay yet, and no capture tried."""
    st = SimpleNamespace(x=torch.empty_like(b), r=torch.empty_like(b), p=torch.empty_like(b),
                         replay=None, tried=False, counts={})
    for name in scalars:
        setattr(st, name, b.new_empty(()))
    return st


def entry(entries, key: tuple, b: torch.Tensor, prec, scalars=("rz",)):
    """The cache entry of a solve in the caller's dict ``entries``: a
    ``block_state`` of b, kept for (``key``, the solve's ids; ``prec``; b's
    dtype, shape and device; the thread and its stream on b's device).  None
    where ``entries`` is None or b's device is not one of ``GRAPH_DEVICES``.

    ``prec`` is what the block's apply reads.  The entry holds it weakly,
    and an entry whose ``prec`` is gone is dropped: its graph may read what
    died with it.  A captured entry whose ``_operands(prec)`` are no longer
    the captured objects (a new numeric phase, a replaced plan or count) is
    made anew."""
    if entries is None or b.device.type not in GRAPH_DEVICES:
        return None
    for k in [k for k, g in entries.items() if g.prec() is None]:
        del entries[k]
    stream = torch.cuda.current_stream(b.device).cuda_stream if b.device.type == "cuda" else None
    key = (*key, id(prec), b.dtype, tuple(b.shape), b.device, threading.get_ident(), stream)
    g = entries.get(key)
    if g is None or g.prec() is not prec or (g.replay is not None and not _same(g.held, prec)):
        g = entries[key] = block_state(b, scalars)
        g.prec, g.held = weakref.ref(prec), None
    return g


def _operands(prec) -> tuple:
    """What a graph of ``prec.apply`` is replayed on: ``prec.operands()``
    (a ``Preconditioner``), or the attributes of an object that has
    ``apply`` alone (``CholmodSolve``, ``SuperLUSolve``, ``DistGsPrec``)."""
    if hasattr(prec, "operands"):
        return prec.operands()
    return tuple(getattr(prec, "__dict__", {}).values())


def _same(held, prec) -> bool:
    now = _operands(prec)
    return len(now) == len(held) and all(o is h for o, h in zip(now, held))


def capture(block, st, device: torch.device):
    """The replay of a CUDA graph of ``block(st)``'s device work (its host
    code runs once, now, and launches nothing), or None off CUDA or where
    the capture fails.  The capture records on a stream of ``device``'s own
    with ``device`` current, whichever card the caller has current; the
    replay launches on the caller's stream of ``device``."""
    if device.type != "cuda":
        return None
    g = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        try:
            with torch.cuda.graph(g, stream=torch.cuda.Stream(), **_THREAD_LOCAL):
                block(st)
        except RuntimeError:
            _after_failed_capture(g, stream)
            return None
    return g.replay


def _capture_block(st: SimpleNamespace, block, agree) -> None:
    """``st.replay``: ``capture`` of ``block``, where it succeeds (on every
    rank, where ``agree`` says so); ``st.counts``: the counters the block's
    host code added at the capture, which are taken back; ``st.held``: what
    the graph reads of ``st.prec()``; ``st.tried`` set."""
    before = counters()
    st.replay = capture(block, st, st.x.device)
    st.counts = {n: v - before.get(n, 0) for n, v in counters().items()
                 if isinstance(v, (int, float)) and v != before.get(n, 0)}
    for n, v in st.counts.items():
        count(n, -v)
    if agree is not None and not agree(st.replay is not None):
        st.replay = None
    st.held = _operands(st.prec()) if st.replay is not None else None
    st.tried = True


def run_blocks(solver: str, block, check, st: SimpleNamespace, cached: bool,
               check_every: int, max_iters: int, first=(float("inf"), False), agree=None):
    """Blocks of ``check_every`` iterations, ``block(st)``, until ``check(st)``
    (the block's one host sync: the residual and whether it is small
    enough) says so or the iterations reach ``max_iters``; returns (the
    iterations, the last residual).  ``first``: the check before the first
    block (the default runs at least one).

    Where ``st`` is a cache entry (``cached``), the first block run on it
    runs as it is and is captured after it; the next ones, in this solve and
    the later ones, replay that graph.  ``agree(ok)``, for a solver over
    ranks, tells whether every rank's capture succeeded.  Where the capture
    fails, the entry's blocks run as they are.  Each replay adds to the
    counters what the block's host code added.  The counters
    ``<solver>.blocks``, ``.graph_replays``, ``.graph_captures`` and
    ``.graph_fallbacks`` say how often that happens.  The regions
    ``tpukk::<solver>.block`` and ``.check`` wrap every block and residual
    read; the regions inside a block are entered only where it runs as it
    is and at the capture, not in a replay."""
    iters = 0
    res, done = first
    while iters < max_iters and not done:
        with profile_region(f"tpukk::{solver}.block"):
            if cached and st.replay is not None:
                st.replay()
                for n, v in st.counts.items():
                    count(n, v)
                count(f"{solver}.graph_replays")
            else:
                block(st)
                if cached and not st.tried:
                    _capture_block(st, block, agree)
                    count(f"{solver}.graph_captures" if st.replay is not None
                          else f"{solver}.graph_fallbacks")
            count(f"{solver}.blocks")
            iters += check_every
            with profile_region(f"tpukk::{solver}.check"):
                res, done = check(st)
    return iters, res


def _after_failed_capture(g: torch.cuda.CUDAGraph, stream: torch.cuda.Stream) -> None:
    """Undo what a failed capture leaves: torch's ``capture_end`` raises
    before it makes the caller's stream current again and before it ends the
    allocator's routing of the capture stream's allocations into the
    graph's pool (the few blocks allocated before the failure stay there)."""
    torch.cuda.set_stream(stream)
    try:
        torch._C._cuda_endAllocateToPool(stream.device_index, g.pool())
    except RuntimeError:
        pass  # the routing had ended: the capture failed after capture_end ended it
