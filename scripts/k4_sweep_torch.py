#!/usr/bin/env python3
"""K4 (tpukk_torch's level-scheduled triangular solve) across its two launch
choices, lanes per row (16, 32) and blocks per SM (1, 2, 4, 8), on the
plans the solver paths run: the unit lower-bidiagonal floor (262,144 rows, one
per level), lap1000's ILU(0) L, fem2d_30k's ILU(0) L and U, and the supernodal
DAGs of fem2d_30k's SuperLU factors, each through the folded call a solve
makes, f32 and f64.  Every configuration is held to K4's plain version first
(M(T)^-1 (40 eps |T||x|)); times are the CUDA-event slope over CUDA graphs of
10 and 50 calls (``common.chain_time_slope``), so the host's launch rate does
not enter; the 262,144-level floor, 0.1 s a call, is a CUDA-event mean over
three calls.

    python3 scripts/k4_sweep_torch.py      # on a CUDA GPU; one JSON line per plan

The plan's own choice is ``LevelPlan.lanes`` and 2 blocks per SM
(``sptrsv_cuda._blocks_cap``); the sweep overrides both.
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
        print("k4_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import scipy.sparse.linalg as spla

    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import generate_structured_laplacian, read_mtx
    from tpukk_torch.sparse import SpilukHandle, spiluk_numeric, spiluk_symbolic
    from tpukk_torch.sparse import sptrsv_cuda as ks
    from tpukk_torch.sparse.sptrsv import SptrsvHandle, sptrsv_symbolic
    from tpukk_torch.sparse.sptrsv_supernodal import build_supernodal_plan

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def vec(n, dt, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dev, dt)

    def ilu0(A):
        h = SpilukHandle(0)
        spiluk_symbolic(h, A)
        return spiluk_numeric(h, A)

    def event_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    plans = {}  # label -> (plan, src, dst, rows of b)
    nfl = 262_144
    rm = np.r_[0, np.arange(1, 2 * nfl, 2)]
    ent = np.r_[0, np.stack([np.arange(nfl - 1), np.arange(1, nfl)], 1).ravel()]
    val = np.r_[1.0, np.tile([-0.5, 1.0], nfl - 1)]
    for dt in (np.float64, np.float32):
        p = ks.build_level_plan(rm, ent, val.astype(dt), nfl, np.arange(1, nfl + 1), True, dev)
        plans[f"bidiagonal {nfl} {dt.__name__}"] = (p, None, None, nfl)
    lap = generate_structured_laplacian(1000, 1000, dtype=np.float64, device=dev)
    L, _ = ilu0(lap)
    for dt in (torch.float64, torch.float32):
        h = SptrsvHandle(lower=True)
        sptrsv_symbolic(h, L.astype(dt))
        plans[f"lap1000 ILU(0) L {dt}"] = (h.plan, h.plan.order, h.plan.order, h.plan.n)
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)
    for tri, lower, T in zip("LU", (True, False), ilu0(fem)):
        h = SptrsvHandle(lower=lower)
        sptrsv_symbolic(h, T)
        plans[f"fem2d_30k ILU(0) {tri} f64"] = (h.plan, h.plan.order, h.plan.order, h.plan.n)
    lu = spla.splu(fem.to_scipy().tocsc())
    for tri, lower, F in (("L", True, lu.L), ("U", False, lu.U)):
        for dt in (np.float32, np.float64):
            T = F.tocsr().astype(dt)
            T.sort_indices()
            fp = build_supernodal_plan(T.indptr, T.indices, T.data, T.shape[0], lower, device=dev)
            plans[f"fem2d_30k SuperLU DAG {tri} {dt.__name__}"] = (fp.plan, fp.src, fp.dst, fp.n)

    for label, (plan, src, dst, nb) in plans.items():
        b = vec(nb, plan.dtype, 11)
        deep = plan.num_levels > 5000
        if not deep:  # the bidiagonal's plain version is a Python loop of 262,144 levels
            xl = ks.sptrsv_plain(plan, b, src)
            ref = ks.scatter_dst(xl, dst, nb)
            tol = ks.scatter_dst(ks.solve_error_bound(plan, xl), dst, nb)
        ms = {}
        worst = 0.0
        for lanes in (16, 32):
            p = dataclasses.replace(plan, lanes=lanes)
            for k in (1, 2, 4, 8):
                ks._blocks_cap = lambda i, k=k: k * sms
                if not deep:
                    got = ks.sptrsv_levels(p, b, src, dst)
                    torch.cuda.synchronize()
                    ratio = float(((got - ref).abs().double() / tol.clamp_min(1e-300)).max())
                    worst = max(worst, ratio)
                    if ratio > 1:
                        raise SystemExit(f"k4_sweep_torch: {label} lanes {lanes}, {k}/SM: "
                                         f"error {ratio} of the bound")
                call = lambda: ks.sptrsv_levels(p, b, src, dst)  # noqa: E731
                ms[f"{lanes} lanes, {k}/SM"] = (event_ms(call, 3) if deep else
                                                chain_time_slope(call, 10, 50, reps=3) * 1e3)
        best = min(ms, key=ms.get)
        print(json.dumps(dict(case=label, levels=plan.num_levels, rows=plan.n,
                              plan_lanes=plan.lanes, ms=ms, best=best,
                              best_us_per_level=ms[best] * 1e3 / plan.num_levels,
                              chosen_us_per_level=ms[f"{plan.lanes} lanes, 2/SM"] * 1e3
                              / plan.num_levels,
                              max_err_over_tol=None if deep else worst)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
