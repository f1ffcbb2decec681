"""Reads a ``torch.profiler`` trace of a stretch of whole solves: the
seconds in which a kernel or a copy ran on the device, the operations
launched, the device operations that took most time, and the idle gaps
by what the host was doing."""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

MARK = "kkbench::traced_stretch"
# device activities that occupy the card; the profiler also puts each
# record_function region on the device's timeline (gpu_user_annotation)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# the profiler's own host events
PROFILER_HOST = ("Activity Buffer Request",)


def _is_work(e, host_names: set) -> bool:
    """A kernel, copy or fill, not a host region drawn on the device's
    timeline.  Where the event carries no activity type (older torch), a
    region is known by its name, which a host event also has."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_WORK
    return e.name() not in host_names


def _top(totals: dict, k: int = 10) -> list:
    return [[name, float(s)] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def traced(run, device) -> dict:
    """Run ``run()`` under the profiler; returns window_s, busy_s, device
    operations (kernels, copies, fills) and the breakdown, or only window_s
    where the trace holds no device operation (the CPU)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_cuda = device.type == "cuda"
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            if on_cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = run()
            if on_cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
    evs = prof.profiler.kineto_results.events()
    mark = [e for e in evs if e.name() == MARK]
    host_names = {e.name() for e in evs if e.device_type() == DeviceType.CPU}
    res = {"result": out, "window_s": wall}
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in evs
           if e.device_type() == DeviceType.CUDA and _is_work(e, host_names)]
    if not mark or not dev:
        return res
    t0, t1 = mark[0].start_ns(), mark[0].start_ns() + mark[0].duration_ns()
    dev = [(max(s, t0), min(f, t1), n) for s, f, n in dev if f > t0 and s < t1]
    if not dev:
        return res
    dev.sort()
    ops = defaultdict(float)
    for s, f, n in dev:
        ops[n] += (f - s) * 1e-9
    # the union of the device intervals, and the gaps between them
    busy, gaps = 0, []
    cur_s, cur_f = dev[0][0], dev[0][1]
    if cur_s > t0:
        gaps.append((t0, cur_s))
    for s, f, _ in dev[1:]:
        if s > cur_f:
            busy += cur_f - cur_s
            gaps.append((cur_f, s))
            cur_s, cur_f = s, f
        else:
            cur_f = max(cur_f, f)
    busy += cur_f - cur_s
    if cur_f < t1:
        gaps.append((cur_f, t1))
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in evs
                  if e.device_type() == DeviceType.CPU and e.name() != MARK
                  and e.name() not in PROFILER_HOST)
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    idle = defaultdict(float)
    for s, f in gaps:
        mid = (s + f) // 2
        j = int(np.searchsorted(hs, mid, side="right")) - 1
        name = "(no host event)"
        for k in range(j, max(-1, j - 400), -1):
            if he[k] >= mid:  # the latest-starting host event over the gap: the innermost
                name = host[k][2]
                break
        idle[name] += (f - s) * 1e-9
    span = (t1 - t0) * 1e-9
    res.update(trace_window_s=span, busy_s=busy * 1e-9, device_ops=len(dev),
               breakdown={"device_ops": _top(ops), "idle_gaps": _top(idle)})
    return res
