#!/usr/bin/env python3
"""Hold tpukk_torch's GMRES against tpukk's on the CPU where their iteration
counts differ, and show that rounding, not the algorithm, makes them differ.

    JAX_PLATFORMS=cpu python scripts/compare_gmres_torch.py

1. ILU(0)-GMRES(50) on data/fem2d_30k.mtx.gz with b = default_rng(0)
   standard normal (the port's chip check, chip_smoke.py): both packages get
   the same factors; the script prints, after 1, 2, 5, 10 and 20 restart
   cycles, the relative difference of the two iterates and both residuals,
   then both converged iteration counts at tol 1e-8.
2. Plain GMRES(40), tol 1e-6, on fem2d_30k + 4·I in f32 with
   reorder="none" and "rcm" (b = default_rng(7)), and the port in f64.

One JSON line per measurement.  It takes a few minutes (tpukk's CPU GMRES
is the slow part).
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps
    import torch

    import tpukk.containers as jkc
    import tpukk.sparse as jsp
    import tpukk_torch.sparse as tsp
    from tpukk_torch.interop import csr_from_numpy, csr_pair_from_numpy

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    def port(M):
        return csr_from_numpy(M.host_row_map(), M.host_entries(), M.host_values_full(),
                              nrows=M.nrows, ncols=M.ncols, device="cpu")

    Aj = jkc.read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz")
    At = port(Aj)
    hk = jsp.SpilukHandle(0)
    jsp.spiluk_symbolic(hk, Aj)
    L, U = jsp.spiluk_numeric(hk, Aj)
    Lt, Ut = csr_pair_from_numpy(
        *[(M.host_row_map(), M.host_entries(), M.host_values_full()) for M in (L, U)],
        device="cpu")
    pj, pt = jsp.LUPrec(L, U), tsp.LUPrec(Lt, Ut)
    b = np.random.default_rng(0).standard_normal(Aj.nrows)
    for cycles in (1, 2, 5, 10, 20, 150):
        t = time.perf_counter()
        xj, sj = jsp.gmres(jsp.GmresHandle(m=50, tol=1e-8, max_restarts=cycles), Aj,
                           jnp.asarray(b), prec=pj)
        xt, st = tsp.gmres(tsp.GmresHandle(m=50, tol=1e-8, max_restarts=cycles), At,
                           torch.from_numpy(b), prec=pt)
        xj = np.asarray(xj)
        emit(case="fem2d_30k f64 ILU(0)-GMRES(50)", max_cycles=cycles,
             iters={"tpukk": sj.num_iters, "port": st.num_iters},
             rel_res={"tpukk": sj.end_rel_res, "port": st.end_rel_res},
             iterate_rel_diff=float(np.abs(xj - xt.numpy()).max() / np.abs(xj).max()),
             seconds=time.perf_counter() - t)

    sp4 = (Aj.to_scipy() + 4.0 * sps.identity(Aj.nrows, format="csr")).astype(np.float32)
    b4 = np.random.default_rng(7).standard_normal(Aj.nrows).astype(np.float32)
    A4j = jkc.CsrMatrix.from_scipy(sp4)
    A4t = port(A4j)
    for mode in ("none", "rcm"):
        _, sj = jsp.gmres(jsp.GmresHandle(m=40, tol=1e-6, reorder=mode), A4j, jnp.asarray(b4))
        _, st = tsp.gmres(tsp.GmresHandle(m=40, tol=1e-6, reorder=mode), A4t,
                          torch.from_numpy(b4))
        emit(case="fem2d_30k + 4I f32 GMRES(40) tol 1e-6", reorder=mode,
             iters={"tpukk": sj.num_iters, "port": st.num_iters})
    _, st = tsp.gmres(tsp.GmresHandle(m=40, tol=1e-6, reorder="none"), A4t.astype(torch.float64),
                      torch.from_numpy(b4.astype(np.float64)))
    emit(case="fem2d_30k + 4I f64 GMRES(40) tol 1e-6", reorder="none",
         iters={"port": st.num_iters})
    return 0


if __name__ == "__main__":
    sys.exit(main())
