#!/usr/bin/env python3
"""K6's fused Gauss-Seidel sweep (tpukk_torch's ``gs_cuda.gs_sweep``) across
its one launch choice, the rows a chunk ticket covers (1, 2 or 3 passes of a
CUDA block's 256 / G rows), on the sweeps the solver paths run: fem2d_30k
POINT and CLUSTER and lap1000 POINT, f64, a symmetric sweep from x = 0 (a
GsPrec apply), a forward sweep from 0 and a forward sweep from a given x;
beside it the per-color path it replaces (K5, a fill, one ``gs_color_step``
launch per color step, K5) and one color step of the old kernel.  Every
configuration is first held to the per-color path bit for bit.  Times are the
CUDA-event slope over CUDA graphs of 20 and 100 calls
(``common.chain_time_slope``); the step floor (a lower-bidiagonal matrix of
16,384 rows, each row its own color block, so a forward sweep is 16,384
one-row steps) is a CUDA-event mean over three calls.

    python3 scripts/k6_sweep_torch.py      # on a CUDA GPU; one JSON line per case

The plan's own choice is ``gs_cuda.chunk_passes``; the sweep overrides it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import generate_structured_laplacian, read_mtx
    from tpukk_torch.sparse import (GsAlgorithm, GsHandle, gauss_seidel_numeric,
                                    gauss_seidel_symbolic)
    from tpukk_torch.sparse import gs_cuda as kg
    from tpukk_torch.sparse.gauss_seidel import _plan_in

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    b_rng = np.random.default_rng(3)

    def us(fn):
        return chain_time_slope(fn, 20, 100) * 1e6

    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)
    lap = generate_structured_laplacian(1000, 1000, dtype=np.float64, device=dev)
    for label, A, alg in (("fem2d_30k POINT", fem, GsAlgorithm.POINT),
                          ("fem2d_30k CLUSTER", fem, GsAlgorithm.CLUSTER),
                          ("lap1000 POINT", lap, GsAlgorithm.POINT)):
        h = GsHandle(alg)
        gauss_seidel_symbolic(h, A)
        gauss_seidel_numeric(h, A)
        plan = _plan_in(h, torch.float64)
        b = torch.from_numpy(b_rng.standard_normal(plan.n)).to(dev)
        row = dict(case=label, dtype="float64", nvidia_smi=smi, lanes=plan.csr.group,
                   colors=len(plan.offsets) - 1,
                   steps=int(plan.steps("symmetric", 1, False).host.shape[0]),
                   plan_chunk_rows=plan.chunk_rows,
                   per_color_path_us=us(lambda: kg.gs_sweep_per_color(plan, None, b, h.omega)))
        for passes in (1, 2, 3):
            p = dataclasses.replace(plan, chunk_rows=passes * (256 // plan.csr.group), _steps={},
                                    _bufs={})
            for x0, direction, key in ((None, "symmetric", "symmetric"),
                                       (None, "forward", "forward"),
                                       (b, "forward", "forward_x_given")):
                got = kg.gs_sweep(p, x0, b, h.omega, direction)
                if not torch.equal(got, kg.gs_sweep_per_color(p, x0, b, h.omega, direction)):
                    print(f"k6_sweep_torch: {label} {passes} passes {key} differs from the "
                          "per-color path", file=sys.stderr)
                    return 1
                row[f"{key}_us_{passes}_passes"] = us(
                    lambda: kg.gs_sweep(p, x0, b, h.omega, direction))
        blk = dataclasses.replace(plan.blocks[0], csr=dataclasses.replace(
            plan.blocks[0].csr, group=plan.csr.group))
        xx = b.clone()
        scratch = torch.empty(blk.nrows, dtype=b.dtype, device=dev)
        row["gs_color_step_block0_us"] = us(lambda: kg.gs_color_step(blk, xx, b, h.omega, scratch))
        print(json.dumps(row), flush=True)

    n = 16_384
    fl = kg.build_gs_sweep_plan(np.r_[0, np.arange(n)], np.arange(n - 1), np.full(n - 1, -0.5),
                                np.ones(n), np.arange(n + 1), np.arange(n), dev)
    b = torch.from_numpy(b_rng.standard_normal(n)).to(dev)
    if not torch.equal(kg.gs_sweep(fl, None, b, 1.0, "forward"),
                       kg.gs_sweep_plain(fl, None, b, 1.0, "forward")):
        print("k6_sweep_torch: the step-floor plan differs from its plain version",
              file=sys.stderr)
        return 1
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        kg.gs_sweep(fl, None, b, 1.0, "forward")
    e1.record()
    e1.synchronize()
    print(json.dumps(dict(case=f"step floor: lower-bidiagonal, {n} one-row steps, f64",
                          nvidia_smi=smi, us_per_step=e0.elapsed_time(e1) / 3 * 1e3 / n)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
