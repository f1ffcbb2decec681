"""Tracing — counterpart of ``tpukk/common/tracing.py``: the port's one
tracing system, regions (spans) and counters.

The reference names every kernel and wraps each public API in a profiling
region with an algorithm-labelled string (sparse/src/KokkosSparse_spmv.hpp:
261-266).  A region here costs one flag check while nothing records.  While
a ``torch.profiler`` session is active it is a ``record_function`` (host
and device time in the profiler's trace); while :func:`recording` is on it
also appends a :class:`Span` to the recorder and pushes an NVTX range where
a CUDA device is present.

Spans carry the profiler's host clock (Unix time in ns, ``time.time_ns``),
so recorded spans and a profiler's device events lie on one timeline.  The
solvers' root spans (``tpukk::pcg``, ``tpukk::gmres``, ``tpukk::dist_pcg``)
open a new solve id; the spans nested in them carry it.

Counters are one registry for the process: ``count`` adds, ``set`` holds a
gauge.  The kernels' launches are ``launches.<kernel>``; ``graph_color``
sets ``graph.colors`` and ``graph.color_s`` on every call; each halo
exchange of ``dist`` adds to ``dist.halo_exchanges`` and ``dist.halo_bytes``;
``common.cuda_graph.run_blocks`` counts a PCG's blocks in ``pcg.blocks``,
those run by a CUDA graph's replay in ``pcg.graph_replays``, and its
captures in ``pcg.graph_captures`` (succeeded) and ``pcg.graph_fallbacks``
(failed); ``dist_pcg``'s under ``dist_pcg.`` alike.

:func:`trace` is the opt-in ``torch.profiler`` session around a block of
user code, written as a Chrome trace: the one file exporter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch

# ``set`` (the gauge setter) is left out of ``__all__``: a star import would
# shadow the builtin; call it as ``tracing.set``
__all__ = ["profile_region", "annotate", "trace", "region_name", "recording", "Recorder",
           "Span", "SOLVE_ROOTS", "count", "counters", "reset_counters",
           "launch_counts", "reset_launch_counts"]

# spans that open a new solve id
SOLVE_ROOTS = frozenset({"tpukk::pcg", "tpukk::gmres", "tpukk::dist_pcg"})

_recorder = None  # the Recorder that is on, or None
_counters: dict = {}
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def region_name(api: str, *labels) -> str:
    """``region_name('spmv', 'N', 'DIA') == 'tpukk::spmv<N,DIA>'`` — the same
    strings ``tpukk`` uses, so traces of both packages line up."""
    labels = [str(x) for x in labels if x is not None and str(x)]
    return f"tpukk::{api}" + (f"<{','.join(labels)}>" if labels else "")


@functools.cache
def _nvtx_on() -> bool:
    return torch.cuda.is_available()


@dataclasses.dataclass(slots=True)
class Span:
    """One region entered while recording: its name, host start and end (ns,
    the profiler's clock), the index of its parent in ``Recorder.spans``
    (None at the top) and its solve id (None outside a solve)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    solve: Optional[int]


class Recorder:
    """The spans of the thread that turned :func:`recording` on, in the
    order they were entered (so by start), kept in memory."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []
        self._solves = 0
        self._thread = threading.get_ident()

    def _enter(self, name: str) -> None:
        parent = self._open[-1] if self._open else None
        if name in SOLVE_ROOTS:
            self._solves += 1
            solve = self._solves
        else:
            solve = None if parent is None else self.spans[parent].solve
        self._open.append(len(self.spans))
        self.spans.append(Span(name, time.time_ns(), None, parent, solve))

    def _exit(self) -> None:
        self.spans[self._open.pop()].end_ns = time.time_ns()

    def self_s(self, name: str) -> float:
        """Seconds of the closed spans named ``name`` less the time their
        children cover (children of one thread never overlap)."""
        covered = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None and s.end_ns is not None:
                covered[s.parent] += s.end_ns - s.start_ns
        return sum(s.end_ns - s.start_ns - covered[i] for i, s in enumerate(self.spans)
                   if s.name == name and s.end_ns is not None) * 1e-9


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` — every region entered on this thread
    inside the block appends a span to ``rec.spans``.  Off by default; one
    recorder at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("tracing.recording: a recorder is already on")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


class _Region:
    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _recorder
        self._rec = rec if rec is not None and rec._thread == threading.get_ident() else None
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._rec is not None:
            if _nvtx_on():
                torch.cuda.nvtx.range_push(self.name)
            self._rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._exit()
            if _nvtx_on():
                torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def profile_region(name: str):
    """Analog of Kokkos::Profiling::pushRegion/popRegion: a context manager
    that does nothing while neither a profiler nor a recorder is on."""
    if _recorder is None and not _profiling():
        return _NULL
    return _Region(name)


def annotate(api: str, *labels):
    """Decorator putting a function body inside :func:`profile_region`; the
    wrapper carries ``_tpukk_region`` so coverage is testable."""
    name = region_name(api, *labels)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _recorder is None and not _profiling():
                return fn(*args, **kwargs)
            with _Region(name):
                return fn(*args, **kwargs)

        wrapper._tpukk_region = name
        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace (host, and the device where there
    is one) of the enclosed block into ``log_dir`` as a Chrome trace
    ``tpukk_torch-<pid>-<ms>.pt.trace.json`` (chrome://tracing, Perfetto).
    The counterpart of ``tpukk``'s ``jax.profiler`` session."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    name = f"tpukk_torch-{os.getpid()}-{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.export_chrome_trace(str(out / name))


# ----------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------

def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (a kernel's launches: one a call,
    or a CUDA graph's captured launches times its replays)."""
    _counters[name] = _counters.get(name, 0) + n


def set(name: str, value) -> None:  # noqa: A001 - the registry's gauge setter
    """Hold ``value`` as the gauge ``name``."""
    _counters[name] = value


def counters() -> dict:
    """A copy of every counter and gauge."""
    return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with ``prefix`` (all by default)."""
    for name in [k for k in _counters if k.startswith(prefix)]:
        del _counters[name]


def launch_counts(kernels) -> dict:
    """``{kernel.__name__: launches}`` of the given kernel functions."""
    return {k.__name__: _counters.get(f"launches.{k.__name__}", 0) for k in kernels}


def reset_launch_counts(kernels) -> None:
    for k in kernels:
        _counters[f"launches.{k.__name__}"] = 0
