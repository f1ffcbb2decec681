"""Tracing — counterpart of ``tpukk/common/tracing.py``.

The reference names every kernel and wraps each public API in a profiling
region with an algorithm-labelled string (sparse/src/KokkosSparse_spmv.hpp:
261-266).  Here a region is a ``torch.profiler.record_function`` (host and
device time in a ``torch.profiler`` trace) plus an NVTX range when a CUDA
device is present (seen by any NVTX-aware tool).  :func:`trace` is the
opt-in ``torch.profiler`` session around a block of user code, written as a
Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path

import torch

__all__ = ["profile_region", "annotate", "trace", "region_name"]


def region_name(api: str, *labels) -> str:
    """``region_name('spmv', 'N', 'DIA') == 'tpukk::spmv<N,DIA>'`` — the same
    strings ``tpukk`` uses, so traces of both packages line up."""
    labels = [str(x) for x in labels if x is not None and str(x)]
    return f"tpukk::{api}" + (f"<{','.join(labels)}>" if labels else "")


@functools.cache
def _nvtx_on() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def profile_region(name: str):
    """Analog of Kokkos::Profiling::pushRegion/popRegion."""
    with torch.profiler.record_function(name):
        if not _nvtx_on():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def annotate(api: str, *labels):
    """Decorator putting a function body inside :func:`profile_region`; the
    wrapper carries ``_tpukk_region`` so coverage is testable."""
    name = region_name(api, *labels)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with profile_region(name):
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
