"""The yardstick of the per-layer roofline metrics: the card's published
peak, each operation's compulsory bytes, and a copy of the slope timer.

Compulsory bytes are one rule for every operation, whatever implements it:
each stored value of the operator once, each input vector once and each
output vector once, at the value's width.  Index arrays and row pointers
are not counted, since a DIA or stencil route reads none.  The functions
take the matrix (a SciPy CSR matrix), never the route.
"""
from __future__ import annotations

import inspect
import math

import numpy as np
import scipy.sparse as sps
import torch

# Published HBM bandwidth (NVIDIA's H100 SXM data sheet), at 700 W.
PEAK_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}
L2_BYTES = 50 * 2**20
COLD_RING_BYTES = 3 * L2_BYTES
MAX_RING = 96


def peak_bytes_per_s(device_name: str):
    """The published bandwidth of a card, or None for a card not in the table."""
    for key, peak in PEAK_BYTES_PER_S.items():
        if key in device_name:
            return peak
    return None


def _w(A: sps.csr_matrix) -> int:
    return A.dtype.itemsize


def spmv_bytes(A: sps.csr_matrix) -> int:
    """y = A·x: nnz values, x read, y written."""
    return (A.nnz + A.shape[0] + A.shape[1]) * _w(A)


def symgs_bytes(A: sps.csr_matrix) -> int:
    """One symmetric Gauss-Seidel sweep from zero: A's values once (though a
    sweep reads them twice), the right-hand side read, x written."""
    return (A.nnz + 2 * A.shape[0]) * _w(A)


def jacobi_bytes(A: sps.csr_matrix) -> int:
    """z = D⁻¹r: the inverse diagonal, r read, z written."""
    return 3 * A.shape[0] * _w(A)


def ilu0_bytes(A: sps.csr_matrix) -> int:
    """Two triangular solves with ILU(0)'s factors, whose pattern is A's:
    L's strict lower values (its unit diagonal is no value), U's values with
    its diagonal, r read, z written."""
    coo = A.tocoo()
    lower = int(np.count_nonzero(coo.col < coo.row))
    upper = int(np.count_nonzero(coo.col > coo.row)) + A.shape[0]
    return (lower + upper + 2 * A.shape[0]) * _w(A)


PREC_BYTES = {"symgs": symgs_bytes, "jacobi": jacobi_bytes, "ilu0": ilu0_bytes}


def ring_size(input_bytes: int) -> int:
    """Copies of an operation's inputs that keep the L2 cold: enough to pass
    three times the L2 where one copy is smaller."""
    return max(1, min(MAX_RING, math.ceil(COLD_RING_BYTES / max(1, input_bytes))))


def slope_seconds(calls, k1: int = 50, k2: int = 250, reps: int = 7) -> float:
    """Seconds per call, the calls taken from the ring ``calls`` in turn.

    The arithmetic of the port's ``chain_time_slope``, copied so that the
    port cannot move it: k1 and k2 calls are captured into two CUDA graphs,
    each replayed ``reps`` times, the best replay of each enters the slope
    (t(k2) − t(k1)) / (k2 − k1), so a fixed cost per replay cancels.  Every
    call in the ring has run once before, outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for fn in calls:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for k in (k1, k2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(k):
                calls[i % len(calls)]()
        graphs.append(g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def best(g) -> float:
        g.replay()
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
    torch.cuda.synchronize()
    if b2 <= b1:
        return b2 / k2
    return (b2 - b1) / (k2 - k1)


# a capture that other threads' CUDA calls leave alone, where torch has it
_THREAD_LOCAL = ({"capture_error_mode": "thread_local"}
                 if "capture_error_mode" in inspect.signature(torch.cuda.graph).parameters else {})


def slope_seconds_ranks(calls, team, k1: int = 50, k2: int = 250, reps: int = 7) -> tuple:
    """``slope_seconds`` for a call that every rank of ``team`` makes in
    step, its collectives waiting for the other ranks: (seconds per call on
    this rank, the method).

    Each rank captures k1 and k2 calls into two CUDA graphs, in the same
    order on every rank ("graphs"), where every rank's capture succeeds
    (NCCL's collectives can be captured; the capture is thread-local, so
    NCCL's watchdog thread may query its events meanwhile); otherwise the
    k1 and k2 calls run eagerly between CUDA events ("events").
    Every replay or run starts after a barrier of the ranks, and the best of
    ``reps`` enters the slope, as in ``slope_seconds``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for fn in calls:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = {}
    try:
        for k in (k1, k2):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, **_THREAD_LOCAL):
                for i in range(k):
                    calls[i % len(calls)]()
            graphs[k] = g
    except RuntimeError:
        graphs = {}
    torch.cuda.synchronize()
    captured = team.all(len(graphs) == 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def once(k: int) -> None:
        if captured:
            graphs[k].replay()
        else:
            for i in range(k):
                calls[i % len(calls)]()

    def best(k: int) -> float:
        team.barrier()
        once(k)
        torch.cuda.synchronize()
        t = float("inf")
        for _ in range(reps):
            team.barrier()
            start.record()
            once(k)
            end.record()
            end.synchronize()
            t = min(t, start.elapsed_time(end) * 1e-3)
        return t

    b1, b2 = best(k1), best(k2)
    del graphs
    torch.cuda.synchronize()
    method = "graphs" if captured else "events"
    if b2 <= b1:
        return b2 / k2, method
    return (b2 - b1) / (k2 - k1), method
