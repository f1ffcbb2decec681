"""Per-layer readings of a cell over several ranks from the spans and
counters inside ``tpukk_torch.dist``: the halo exchanges of a ``dist_pcg``
iteration, the host time it takes to issue an iteration and to wait at its
residual checks, and the share of the device's idle time that lies under a
halo exchange.

``read(ctx)`` runs the mix's ``trace_solves`` whole solves through the
cell's driver and state after the window, on every rank in step (each rank
runs the readers on a context of its own; rank 0's values are kept): once
with the recorder on and no profiler (the counters, issue and wait), and on
the card once more with the profiler on too (the idle gaps).  It caches what
it found on the context.  A port without these spans or counters reads
nothing, and each metric is then left out; off the card the idle share is.
"""
from __future__ import annotations

import torch
from torch.autograd import DeviceType

from kkbench import devtrace, spans

ROOT = "tpukk::dist_pcg"
BLOCK = "tpukk::dist_pcg.block"
CHECK = "tpukk::dist_pcg.check"
HALO = "tpukk::dist.halo_exchange"
EXCHANGES = "dist.halo_exchanges"
MARK = "kkbench::dist_spans_stretch"


def issue_wait(rows, iters: int) -> dict:
    """From ``(name, start_ns, end_ns)`` spans of whole solves: the host µs
    an iteration spends issuing (blocks less their checks) and waiting (the
    checks)."""
    block = sum(e - s for n, s, e in rows if n == BLOCK)
    check = sum(e - s for n, s, e in rows if n == CHECK)
    return {"issue_us": (block - check) / iters * 1e-3, "wait_us": check / iters * 1e-3}


def halo_idle_pct(idle: dict):
    """The share of idle ns (by innermost span) under a halo exchange."""
    total = sum(idle.values())
    return 100.0 * idle.get(HALO, 0) / total if total else None


def _rows(rec) -> list:
    return [(s.name, s.start_ns, s.end_ns, s.parent) for s in rec.spans]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(ctx) -> dict:
    tracing = spans.port_tracing()
    if tracing is None:
        return {}
    driver, state, inputs, dev = ctx._driver, ctx._state, ctx._inputs, ctx._dev
    k, first = int(ctx._mix.get("trace_solves", 1)), len(ctx.window)

    def stretch():
        its = 0
        for j in range(k):
            _, it, _ = driver.solve(state, inputs.rhs(first + j))
            its += it
        return its

    _sync(dev)
    before = tracing.counters().get(EXCHANGES)
    with tracing.recording() as rec:
        its = stretch()
        _sync(dev)
    after = tracing.counters().get(EXCHANGES)
    rows = _rows(rec)
    if not its or not any(r[0] == ROOT for r in rows):
        return {}
    out = issue_wait([r[:3] for r in rows], its)
    if after is not None:
        out["exchanges_per_iter"] = (after - (before or 0)) / its
    if dev.type != "cuda":
        return out
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.recording() as rec:
            with tracing.profile_region(MARK):
                _sync(dev)
                stretch()
                _sync(dev)
    rows = _rows(rec)
    mark = [r for r in rows if r[0] == MARK]
    evs = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in evs if e.device_type() == DeviceType.CPU}
    busy = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
            if e.device_type() == DeviceType.CUDA and devtrace._is_work(e, host_names)]
    if mark and busy:
        idle = spans.idle_by_span(rows, busy, mark[0][1], mark[0][2])
        out["halo_idle_pct"] = halo_idle_pct(idle)
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:8]
        if ctx._team is None or ctx._team.rank == 0:
            spans._log("dist: idle by innermost span (ms): "
                       + ", ".join(f"{n}={v * 1e-6:.3f}" for n, v in top))
    if ctx._team is None or ctx._team.rank == 0:
        spans._log(f"dist: {its} iterations, {out.get('exchanges_per_iter')} exchanges an "
                   f"iteration, issue {out['issue_us']:.2f} us, wait {out['wait_us']:.2f} us")
    return out


def read(ctx) -> dict:
    """What the stretches found, measured once per context."""
    if not hasattr(ctx, "_kkbench_dist_spans"):
        ctx._kkbench_dist_spans = _measure(ctx)
    return ctx._kkbench_dist_spans
