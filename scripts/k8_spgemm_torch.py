#!/usr/bin/env python3
"""SpGEMM's set-up and K8 on the four A·A cases of ``chip_smoke.py`` (lap1000
f32 and f64, rand100k f32, fem2d_30k f64), for one tree of ``tpukk_torch``:
the host symbolic (``native.spgemm_symbolic``) and the whole
``spgemm_symbolic`` in seconds, the handle's device memory
(``torch.cuda.memory_allocated`` around ``spgemm_symbolic``), and K8's time
L2-warm (CUDA-event slope over CUDA graphs of 10 and 50 calls,
``common.chain_time_slope``) beside cuSPARSE's whole SpGEMM on the same
operands (a host loop of 3 calls between CUDA events: it is not
graph-capturable).  K8 is the row-wise kernel (``spgemm_cuda.spgemm_rows``) or, in a
tree before it, the pair kernel (``spgemm_cuda.spgemm_pairs``); each is first
held to its plain version (the row-wise kernel bit for bit, the pair kernel
within (n_c + 1)·eps of its products' absolute sum).

    python3 scripts/k8_spgemm_torch.py                 # this tree
    python3 scripts/k8_spgemm_torch.py --root DIR      # the tree unpacked in DIR

Run two trees in turns (A, B, B, A) inside one call to the card.  One JSON
line per case.
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
        print("k8_spgemm_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import tpukk_torch.containers as tkc
    from tpukk_torch import native
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.sparse import SpgemmHandle, spgemm_symbolic
    from tpukk_torch.sparse import spgemm_cuda as ksg

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rows = hasattr(ksg, "spgemm_rows")
    lap = tkc.generate_structured_laplacian(1000, 1000, dtype=np.float32, device=dev)
    cases = [("lap1000 f32", lap),
             ("lap1000 f64", lap.astype(np.float64)),
             ("rand100k_deg16 f32", tkc.generate_random_csr(100_000, 100_000, 16, seed=3,
                                                            dtype=np.float32, device=dev)),
             ("fem2d_30k f64", tkc.read_mtx(root / "data" / "fem2d_30k.mtx.gz", device=dev))]
    for label, A in cases:
        t = time.perf_counter()
        native.spgemm_symbolic(A.host_row_map(), A.host_entries(), A.nrows, A.ncols,
                               A.host_row_map(), A.host_entries())
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        h = SpgemmHandle()
        spgemm_symbolic(h, A, A)
        torch.cuda.synchronize()
        sym_s = time.perf_counter() - t
        handle_MB = (torch.cuda.memory_allocated(dev) - mem0) / 1e6
        a = A.values
        if rows:
            plan = h.row_plan
            kern = lambda: ksg.spgemm_rows(plan, a, a)  # noqa: E731
            got, plain = kern(), ksg.spgemm_rows_plain(plan, a, a)
            ok = bool(torch.equal(got, plain))
            extra = dict(kernel="spgemm_rows", bins=plan.bins)
        else:
            plan = h.pair_plan
            kern = lambda: ksg.spgemm_pairs(plan, a, a)  # noqa: E731
            got, plain = kern(), ksg.spgemm_pairs_plain(plan, a, a)
            bound = ksg.spgemm_pairs_plain(plan, a.abs(), a.abs())
            tol = (torch.diff(plan.c_ptr).to(a.dtype) + 1) * torch.finfo(a.dtype).eps * bound
            ok = bool(((got - plain).abs() <= tol).all())
            extra = dict(kernel="spgemm_pairs", lanes=plan.group)
        if not ok:
            raise SystemExit(f"k8_spgemm_torch: {label}: K8 differs from its plain version")
        del plain
        us = chain_time_slope(kern, 10, 50) * 1e6
        S = torch.sparse_csr_tensor(A.row_map, A.entries, a, A.shape, check_invariants=False)
        S @ S
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            S @ S
        e1.record()
        e1.synchronize()
        cusparse_us = e0.elapsed_time(e1) / 3 * 1e3
        print(json.dumps(dict(root=str(root), case=label, nvidia_smi=smi, nnz_c=int(got.numel()),
                              host_symbolic_s=host_s, spgemm_symbolic_s=sym_s,
                              handle_device_MB=handle_MB, k8_us=us, cusparse_us=cusparse_us,
                              **extra)), flush=True)
        del h, plan, kern, got, S
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
