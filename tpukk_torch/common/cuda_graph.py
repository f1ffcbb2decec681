"""CUDA graphs of the solvers' blocks: a block of device work recorded once
and replayed by one launch (``sparse/pcg.py::pcg``, ``dist/spmv.py::dist_pcg``).

A block's state is a namespace of the buffers it updates in place
(``block_state``); ``capture_block`` records the block on them and notes the
counters its host code added, and ``replay_block`` replays it and adds them
again, so that ``launches.*`` and the other counters read as if the block
had run as it is."""
from __future__ import annotations

import inspect
from types import SimpleNamespace

import torch

from .tracing import count, counters

__all__ = ["block_state", "capture", "capture_block", "replay_block"]

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


def capture_block(st: SimpleNamespace, block, device: torch.device, capture_fn=capture) -> None:
    """``st.replay``: ``capture_fn(block, st, device)`` (``capture``, or
    what a solver's module names so); ``st.counts``: the counters the
    block's host code added at the capture, which are taken back;
    ``st.tried`` set."""
    before = counters()
    st.replay = capture_fn(block, st, device)
    st.counts = {n: v - before.get(n, 0) for n, v in counters().items()
                 if isinstance(v, (int, float)) and v != before.get(n, 0)}
    for n, v in st.counts.items():
        count(n, -v)
    st.tried = True


def replay_block(st: SimpleNamespace) -> None:
    """Replay ``st``'s graph and add the counters its capture noted."""
    st.replay()
    for n, v in st.counts.items():
        count(n, v)


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
