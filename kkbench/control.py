"""The control of ``correct``: the plain reference put in the program's
place and computed in float32, one precision below the configurations'
float64, on the cell's own matrix and right-hand sides.  It solves as many
systems as a run compares and prints each number beside its limit; every
cell's control has to come out not correct.  The benchmark's own runs do
not run it.

    python3 kkbench/control.py --workload hpcg104.symgs_pcg --seed 11 [--seed 12 ...]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(workload: str, seed: int, reg=None, device=None) -> dict:
    import torch

    from kkbench import harness
    from kkbench.reference import csr
    from kkbench.registry import Registry

    reg = reg or Registry()
    w = reg.workload(workload)
    cfg, mix, limits = reg.config(w["config"]), reg.mix(w["traffic"]), reg.limits(workload)
    dev = torch.device(device or "cuda")
    inputs = harness.Inputs(reg, cfg, mix, seed, dev)
    inputs.arrays = None
    low = torch.float32
    pm = reg.reference(f"prec_{mix['prec']}")
    tables = pm.control_tables(inputs.A, low, seed)
    prec = pm.Reference(inputs.A, tables, dev, low)
    At = csr.to_torch(inputs.A, dev, low)
    solver = reg.reference(mix["driver"])
    samples = []
    t = time.perf_counter()
    for i in range(int(mix.get("samples", 8))):
        x, its, _ = solver.solve(At, inputs.rhs(i).to(low), prec.apply, float(cfg["rtol"]), mix)
        samples.append((i, x.to(inputs.dtype), its))
    solve_s = time.perf_counter() - t
    probes = {"spmv": torch.mv(At, inputs.x_probe.to(low)),
              "prec": prec.apply(inputs.r_probe.to(low))}
    del prec, At
    numbers = harness.judge(reg, inputs, mix, cfg, samples, probes, tables, dev, limits)
    failing = sorted(k for k, lim in limits.items() if not numbers[k] <= lim)
    return {"workload": workload, "seed": seed, "iters": [s[2] for s in samples],
            "solve_s": solve_s, "numbers": numbers, "limits": limits, "fails": failing,
            "control_fails": bool(failing)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    ok = True
    for seed in args.seed:
        r = control(args.workload, seed)
        ok &= r["control_fails"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
