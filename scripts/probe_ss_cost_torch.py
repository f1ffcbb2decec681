#!/usr/bin/env python3
"""Probe the per-super-step cost of the gather-table layout on a CUDA GPU,
through kernel K9 (``tpukk_torch/common/probe_cuda.py``, ``csrc/probe.cu``):
the counterpart of ``scripts/probe_ss_cost.py``, with the same synthetic
plans (random tables from seed 0), variants, step counts and chains.

Variants: "base" streams gt, lo and v per chunk; "packed_opt" streams
pk = gt << 13 | lo and v; "mt4" is packed with 4-tile output blocks.  For
each, per_ss(B) is measured at B = 4 and 16 chunks per super-step over
n_ss = 1024 super-steps, from chains of K = 10 and 50 steps of
x <- 0.5·x + 1e-6·y (y = K9(x)), each chain one CUDA graph timed with CUDA
events (best of 5 replays): per call = (t(50) - t(10)) / 40, per_ss = per
call / n_ss, per_chunk = per_ss / B, and per_ss(B) = FIX + B·VAR fitted
through the two B.

    python3 scripts/probe_ss_cost_torch.py

It needs a CUDA device, and prints the card's name and power limit first.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpukk_torch.common.probe_cuda import (SRC_ROWS, VARIANTS, build_probe_plan,  # noqa: E402
                                           probe_gather_acc)

ND, NS = 64, 16        # output tiles and source blocks: 512 rows of y and of x
N_SS, BS, KS = 1024, (4, 16), (10, 50)


@functools.lru_cache(maxsize=None)
def make_plan(variant: str, n_ss: int, B: int, device):
    """The probe's synthetic plan and its x (``probe_ss_cost.run_one``'s
    draws, in its order); built once per argument set (K9 and the chain
    leave both unchanged)."""
    S = n_ss * B
    rng = np.random.default_rng(0)
    gt = rng.integers(0, SRC_ROWS, (S * 8, 128), dtype=np.int32)
    lo = rng.integers(0, 128, (S * 8, 128), dtype=np.int32)
    pk = (gt << 13) | lo
    vals = rng.standard_normal((S * 8, 128)).astype(np.float32) * 1e-3
    x0 = rng.standard_normal((NS * SRC_ROWS, 128)).astype(np.float32)
    src = rng.integers(0, NS, S, dtype=np.int32)
    nd = ND // 4 if variant == "mt4" else ND
    dst, first = np.arange(n_ss) % nd, (np.arange(n_ss) < nd).astype(np.int32)
    kw = dict(n_blocks=nd, n_src=NS, device=device)
    if variant == "mt4":
        sub = rng.integers(0, 4, S, dtype=np.int32)
        plan = build_probe_plan("mt4", dst, (src << 2) | sub, first, vals, pk=pk, **kw)
    elif variant == "base":
        plan = build_probe_plan("base", dst, src, first, vals, gt=gt, lo=lo, **kw)
    else:
        plan = build_probe_plan("packed_opt", dst, src, first, vals, pk=pk, **kw)
    return plan, torch.from_numpy(x0).to(device)


def chain_seconds(plan, x0, K: int, reps: int = 5) -> float:
    """Best replay time (s) of one CUDA graph of the K-step chain
    x <- 0.5·x + 1e-6·K9(x) from x0 (``probe_ss_cost.run_one``'s chain).
    Every tensor the graph reads is either x0, held here, or made inside it."""
    def chain():
        x = x0
        for _ in range(K):
            x = torch.add(x * 0.5, probe_gather_acc(plan, x), alpha=1e-6)
        return x

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the graph
        chain()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = chain()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    del g, out
    return best


def per_call_seconds(variant: str, n_ss: int, B: int, device) -> float:
    """Seconds per chain step: (t(50) - t(10)) / 40."""
    plan, x0 = make_plan(variant, n_ss, B, device)
    t1, t2 = (chain_seconds(plan, x0, K) for K in KS)
    return (t2 - t1) / (KS[1] - KS[0])


def probe(n_ss: int = N_SS, device=None) -> dict:
    """per_ss and per_chunk (µs) at each B, and FIX and VAR, per variant."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    out = {}
    for variant in VARIANTS:
        per_ss = {B: per_call_seconds(variant, n_ss, B, device) / n_ss for B in BS}
        var = (per_ss[BS[1]] - per_ss[BS[0]]) / (BS[1] - BS[0])
        out[variant] = dict(
            per_ss_us={B: t * 1e6 for B, t in per_ss.items()},
            per_chunk_us={B: t / B * 1e6 for B, t in per_ss.items()},
            fix_us=(per_ss[BS[0]] - BS[0] * var) * 1e6, var_us=var * 1e6)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_ss_cost_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)} ({smi.stdout.strip()})", flush=True)
    res = probe()
    for variant, r in res.items():
        for B in BS:
            print(f"{variant} B={B}: per_ss={r['per_ss_us'][B]:7.4f}us "
                  f"per_chunk={r['per_chunk_us'][B]:7.4f}us", flush=True)
        print(f"{variant}: FIX={r['fix_us']:.4f}us VAR={r['var_us']:.4f}us", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
