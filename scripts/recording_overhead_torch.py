"""What the port's tracing costs on the card's host, and whether its spans
line up with the profiler's events, on HPCG's 27-point problem (the
benchmark's ``hpcg104.symgs_pcg`` set-up: PCG with one symmetric
Gauss-Seidel sweep, ``check_every`` 10):

* a region's host cost: idle (nothing records), under the recorder, and the
  ``record_function`` plus NVTX pair that every region paid before;
* ``solve_ms`` with the recorder off and on, in turns in one process
  (``--pairs`` pairs of ``--solves`` solves each, the order alternating);
* the recorded solves' host µs to issue an iteration and to wait at the
  checks, and their sum against the solve spans;
* the recorded spans against the profiler's host events of the same
  regions (one profiled solve with the recorder on);
* a recorded second set-up: seconds and self seconds by span, and the
  coloring's gauges.

    python3 scripts/recording_overhead_torch.py [--nx 104] [--pairs 3] [--solves 20]

Prints one JSON line last (the card's name and power limit in it)."""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kkbench import spans  # noqa: E402
from kkbench.drivers import pcg as driver  # noqa: E402
from kkbench.matrices import stencil27  # noqa: E402
from tpukk_torch.common import tracing  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=20)
    return out.stdout.strip()


def region_us(n: int, on: bool) -> float:
    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with tracing.profile_region("tpukk::probe"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    if not on:
        return loop()
    with tracing.recording():
        return loop()


def old_region_us(n: int) -> float:
    """The region every call paid before: record_function, then NVTX."""
    t = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function("tpukk::probe"):
            torch.cuda.nvtx.range_push("tpukk::probe")
            torch.cuda.nvtx.range_pop()
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nx", type=int, default=104)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--solves", type=int, default=20)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    cfg = {"nx": args.nx, "ny": args.nx, "nz": args.nx, "diagonal": 26.0, "offdiagonal": -1.0,
           "dtype": "float64", "rtol": 1e-8}
    mix = {"prec": "symgs", "gs_algorithm": "POINT", "coloring": "SERIAL", "sweeps": 1,
           "check_every": 10, "max_iters": 5000}
    A = driver.load(stencil27.build(cfg, dev), dev)
    state = driver.prepare(A, cfg, mix)
    g = torch.Generator(device=dev)
    g.manual_seed(20261018)
    # b = A·x̂, four x̂ drawn from a fixed seed, solved in turn
    B = [state.Ah(torch.randn(A.nrows, generator=g, device=dev, dtype=torch.float64))
         for _ in range(4)]
    for b in B:
        driver.solve(state, b)
    torch.cuda.synchronize()

    def run(k):
        its = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for j in range(k):
            _, it, _ = driver.solve(state, B[j % len(B)])
            its += it
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / k * 1e3, its

    out = {"card": card(), "n": A.nrows,
           "region_us": {"idle": region_us(200_000, False), "recording": region_us(50_000, True),
                         "record_function_nvtx": old_region_us(50_000)}}
    pairs = []
    for i in range(args.pairs):
        row = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with tracing.recording() as rec:
                    row["on_ms"], its = run(args.solves)
                rows = [(s.name, s.start_ns, s.end_ns) for s in rec.spans]
                row.update(spans.issue_wait(rows, its))
                row["solve_span_ms"] = row.pop("solve_s") * 1e3
                row["issue_plus_wait_ms"] = (row["issue_us"] + row["wait_us"]) * its * 1e-3
            else:
                row["off_ms"], _ = run(args.solves)
        pairs.append(row)
        print(json.dumps(row), flush=True)
    out["pairs"] = pairs
    out["median_off_ms"] = statistics.median(r["off_ms"] for r in pairs)
    out["median_on_ms"] = statistics.median(r["on_ms"] for r in pairs)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.recording() as rec:
            driver.solve(state, B[0])
            torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CPU]
    gaps = {}
    for name in sorted({s.name for s in rec.spans}):
        ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs if e.name() == name)
        sp = [(s.start_ns, s.end_ns) for s in rec.spans if s.name == name]
        if len(ev) != len(sp):
            gaps[name] = f"{len(ev)} events, {len(sp)} spans"
            continue
        d = [max(abs(a[0] - b[0]), abs(a[1] - b[1])) * 1e-3 for a, b in zip(ev, sp)]
        gaps[name] = {"median_us": statistics.median(d), "max_us": max(d), "n": len(d)}
    out["span_vs_event"] = gaps

    with tracing.recording() as rec:
        t = time.perf_counter()
        driver.prepare(A, cfg, mix)
        torch.cuda.synchronize()
        setup = {"prepare_s": time.perf_counter() - t}
    for name in sorted({s.name for s in rec.spans}):
        total = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == name) * 1e-9
        setup[name] = {"s": total, "self_s": rec.self_s(name)}
    setup.update({k: v for k, v in tracing.counters().items() if k.startswith("graph.")})
    out["setup"] = setup
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
