"""Per-layer readings from the port's own spans and counters
(``tpukk_torch.common.tracing``): the host time a solver takes to issue an
iteration and the time it waits at its checks, the device's idle gaps put
down to the innermost program span over each, and the coloring's gauges.

``read(ctx)`` runs the mix's ``trace_solves`` whole solves through the
cell's driver and state twice, after the window: once with the recorder on
and no profiler (issue and wait), once with both on (the idle gaps).  It
caches what it found on the context.  Off the card it reads nothing (CPU
kernels run synchronously: no idle, no wait); a port without the recorder
or the registry reads nothing, and each metric is then left out.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from kkbench import devtrace

ROOTS = ("tpukk::pcg", "tpukk::gmres")
BLOCKS = tuple(f"{r}.block" for r in ROOTS)
CHECKS = tuple(f"{r}.check" for r in ROOTS)
# the solvers' own spans: an idle gap under one of them (as the innermost)
# is the solver's own host work or wait, not a layer below it
OWN = ROOTS + BLOCKS + CHECKS
MARK = "kkbench::spans_stretch"


def port_tracing():
    """The port's tracing module where it has the recorder and the counter
    registry, else None."""
    try:
        from tpukk_torch.common import tracing
    except ImportError:
        return None
    return tracing if hasattr(tracing, "recording") and hasattr(tracing, "counters") else None


def issue_wait(spans, iters: int) -> dict:
    """From ``(name, start_ns, end_ns)`` spans of whole solves: the host µs
    an iteration spends issuing (blocks less their checks) and waiting (the
    checks), and the solve spans' seconds."""
    block = sum(e - s for n, s, e in spans if n in BLOCKS)
    check = sum(e - s for n, s, e in spans if n in CHECKS)
    solve = sum(e - s for n, s, e in spans if n in ROOTS)
    return {"issue_us": (block - check) / iters * 1e-3, "wait_us": check / iters * 1e-3,
            "solve_s": solve * 1e-9, "iters": iters}


def idle_gaps(intervals, t0: int, t1: int) -> list:
    """The gaps in [t0, t1] that no device interval ``(start, end)`` covers."""
    dev = sorted((max(s, t0), min(f, t1)) for s, f in intervals if f > t0 and s < t1)
    gaps, cur = [], t0
    for s, f in dev:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, f)
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def innermost(spans, starts, t: int):
    """Index of the innermost of ``(name, start_ns, end_ns, parent)`` spans
    (sorted by start, nested as one thread's are) that holds ``t``, or None.
    The span that starts last at or before t holds it, or one of its
    ancestors does."""
    j = bisect.bisect_right(starts, t) - 1
    while j is not None and j >= 0:
        if spans[j][2] >= t:
            return j
        j = spans[j][3]
    return None


def idle_by_span(spans, intervals, t0: int, t1: int) -> dict:
    """Idle ns in [t0, t1] by the innermost span over each gap's midpoint
    (``None``: no span)."""
    starts = [s[1] for s in spans]
    out = defaultdict(int)
    for s, f in idle_gaps(intervals, t0, t1):
        j = innermost(spans, starts, (s + f) // 2)
        out[None if j is None else spans[j][0]] += f - s
    return dict(out)


def own_idle_pct(idle: dict):
    total = sum(idle.values())
    return 100.0 * sum(v for k, v in idle.items() if k in OWN) / total if total else None


def _rows(rec) -> list:
    return [(s.name, s.start_ns, s.end_ns, s.parent) for s in rec.spans]


def _measure(ctx) -> dict:
    tracing = port_tracing()
    if tracing is None or ctx._dev.type != "cuda":
        return {}
    driver, state, inputs = ctx._driver, ctx._state, ctx._inputs
    k, first = int(ctx._mix.get("trace_solves", 1)), len(ctx.window)

    def stretch():
        its = 0
        for j in range(k):
            _, it, _ = driver.solve(state, inputs.rhs(first + j))
            its += it
        return its

    torch.cuda.synchronize()
    with tracing.recording() as rec:
        its = stretch()
        torch.cuda.synchronize()
    out = issue_wait([r[:3] for r in _rows(rec)], its)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.recording() as rec:
            with tracing.profile_region(MARK):
                torch.cuda.synchronize()
                stretch()
                torch.cuda.synchronize()
    rows = _rows(rec)
    mark = [r for r in rows if r[0] == MARK]
    evs = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in evs if e.device_type() == DeviceType.CPU}
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
           if e.device_type() == DeviceType.CUDA and devtrace._is_work(e, host_names)]
    if mark and dev:
        idle = idle_by_span(rows, dev, mark[0][1], mark[0][2])
        out["idle_own_pct"] = own_idle_pct(idle)
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:8]
        _log("idle by innermost span (ms): "
             + ", ".join(f"{n}={v * 1e-6:.3f}" for n, v in top))
    _log(f"{its} iterations, issue {out['issue_us']:.2f} us, wait {out['wait_us']:.2f} us an "
         f"iteration; solve spans {out['solve_s'] * 1e3:.3f} ms, (issue + wait) x iterations "
         f"{(out['issue_us'] + out['wait_us']) * its * 1e-3:.3f} ms")
    return out


def _log(msg: str) -> None:
    print("kkbench: spans:", msg, file=sys.stderr, flush=True)


def read(ctx) -> dict:
    """What the stretches found, measured once per context."""
    if not hasattr(ctx, "_kkbench_spans"):
        ctx._kkbench_spans = _measure(ctx)
    return ctx._kkbench_spans


def gauge(ctx, name: str):
    """A gauge of the port's registry after the run's set-ups, for a mix
    whose preconditioner colors its matrix (a gauge from another cell of
    the process is never read); else None."""
    tracing = port_tracing()
    if tracing is None or ctx._mix.get("prec") != "symgs":
        return None
    return tracing.counters().get(name)
