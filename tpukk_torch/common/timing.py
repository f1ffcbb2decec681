"""Device timing — counterpart of ``tpukk/common/timing.py``.

The same slope estimator: time K1 and K2 back-to-back runs of the workload
and take per-iteration time = (t(K2) - t(K1)) / (K2 - K1), so any fixed
per-measurement cost cancels.  On the GPU the runs are timed with
``torch.cuda.Event``s after a warm-up, and each run of K launches is one
CUDA graph replay: a Python loop would measure the host's launch rate, not
the device, for kernels of a few microseconds.  ``tpukk``'s relay/fetch
workaround has no counterpart here.

The workload's inputs stay the same across iterations, so a working set that
fits the 50 MB L2 is read partly from L2: report the working set beside any
time taken with this.
"""
from __future__ import annotations

import torch

from .errors import check

__all__ = ["sync_fetch", "chain_time_slope"]


def sync_fetch(y) -> float:
    """Wait for ``y``'s computation and read its first element to the host,
    as f32 (``tpukk``'s sync by fetching bytes).  ``y`` is a tensor, or a
    tuple, list or dict whose first leaf (keys sorted, as JAX orders a
    pytree's) is one."""
    while isinstance(y, (tuple, list, dict)):
        y = y[sorted(y)[0]] if isinstance(y, dict) else y[0]
    if y.is_cuda:
        torch.cuda.synchronize(y.device)
    return float(y.reshape(-1)[:1].to(torch.float32).cpu()[0])


def chain_time_slope(fn, k1: int = 50, k2: int = 250, reps: int = 7) -> float:
    """Seconds per call of ``fn()`` on the current CUDA device.

    ``fn`` takes no arguments and enqueues its work on the current stream.
    Its launches are captured into two CUDA graphs of k1 and k2 calls; each
    graph is replayed ``reps`` times and the best replay of each enters the
    slope.
    """
    check(torch.cuda.is_available(), "chain_time_slope: needs a CUDA device")
    check(0 < k1 < k2, "chain_time_slope: need 0 < k1 < k2")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: lazy module loads, allocator
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    graphs = []
    for k in (k1, k2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(k):
                fn()
        graphs.append(g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def best(g) -> float:
        g.replay()  # one untimed replay: first-replay upload of the graph
        t = float("inf")
        for _ in range(reps):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            t = min(t, start.elapsed_time(end) * 1e-3)
        return t

    b1, b2 = best(graphs[0]), best(graphs[1])
    del graphs
    if b2 <= b1:  # slope lost in noise: the biased-but-bounded estimate
        return b2 / k2
    return (b2 - b1) / (k2 - k1)
