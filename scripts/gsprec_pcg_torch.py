#!/usr/bin/env python3
"""GsPrec-preconditioned PCG end to end on the H100, for comparing two trees
of the repository on one card: fem2d_30k and lap1000, f64, a POINT handle,
tol 1e-8, x0 = 0, b from a seed.  Prints one JSON line per matrix: the
iterations, the host residual, the wall µs per iteration of each of three
solves (host clock around a synchronised solve, the SpMV plan built before
it), and the K5 and K6 launches of the last solve.

    python3 scripts/gsprec_pcg_torch.py                 # this tree
    python3 scripts/gsprec_pcg_torch.py --root DIR      # the tree unpacked in DIR

Run two trees in turns (A, B, B, A) inside one call to the card: wall times
move between machines (PERF.md §2).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gsprec_pcg_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from tpukk_torch.containers import generate_structured_laplacian, read_mtx
    from tpukk_torch.sparse import (GsHandle, GsPrec, SpmvAlgorithm, SpmvHandle,
                                    gauss_seidel_numeric, gauss_seidel_symbolic, pcg)
    from tpukk_torch.sparse import gs_cuda as kg
    from tpukk_torch.sparse import sptrsv_cuda as ks

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cases = (("fem2d_30k", read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)),
             ("lap1000", generate_structured_laplacian(1000, 1000, dtype=np.float64, device=dev)))
    for label, A in cases:
        h = GsHandle()
        gauss_seidel_symbolic(h, A)
        gauss_seidel_numeric(h, A)
        Ah = SpmvHandle(A)
        Ah._plan("dia" if Ah.algorithm == SpmvAlgorithm.DIA else "csr", torch.float64)
        b = torch.from_numpy(np.random.default_rng(7).standard_normal(A.nrows)).to(dev)
        prec = GsPrec(h, A)
        pcg(Ah, b, tol=1e-8, max_iters=10, prec=prec)  # kernels built, caches filled
        us, iters = [], None
        for _ in range(3):
            kg.reset_launch_counts()
            ks.reset_launch_counts()  # K4's and K5's
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, st = pcg(Ah, b, tol=1e-8, max_iters=5000, prec=prec)
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t) / st.num_iters * 1e6)
            iters = st.num_iters
        bh = b.cpu().numpy()
        rel = float(np.linalg.norm(bh - A.to_scipy() @ x.cpu().numpy()) / np.linalg.norm(bh))
        print(json.dumps(dict(root=str(root), case=f"{label} f64 GsPrec(POINT)-PCG, tol 1e-8",
                              nvidia_smi=smi, iters=iters, converged=bool(st.converged),
                              rel_res_host=rel, us_per_iter=us,
                              k6_launches=kg.launch_counts(),
                              k5_launches=ks.launch_counts()["permute_gather"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
