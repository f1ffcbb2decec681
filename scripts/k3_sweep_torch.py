#!/usr/bin/env python3
"""K3 (tpukk_torch's ``spmv_cuda.csr_spmv``) across its launch choices, on the
shapes the solver and graph paths give it: lap1000 f32 (ONEHOT pinned),
rand100k f32 (the AUTO route), fem2d_30k f64 (PCG, GMRES), fem2d_30k + 4·I f32
(the f32 GMRES), MIS2's max on fem2d_30k's distance-2 pattern, and the floor
(256 rows of one entry: the launch's fixed cost).  Beside each, cuSPARSE's
``torch.sparse_csr_tensor @ x`` on the same inputs.

The plan's choice first (``build_csr_plan``: direct, or stream past
``STREAM_BYTES``).  Then the sweep, through variants that this script builds
from ``scripts/k3_variants.cu`` (nvcc, into the git-ignored ``build/``): the
tile cap (256·E entries for E = 1, 2, 4, the ring's for E = 2, 4; 256 rows)
times how a tile reaches the
threads: ``direct`` (each thread loads its own entries through L1),
``stream`` (the same, past L1), ``bulk`` (a two-stage ring in shared memory
filled by one thread's cp.async.bulk) or ``cp.async`` (the ring filled 16
bytes a thread).  The package's kernel is the direct variant at 512 and the
stream variant at 1024.  Every configuration is first held to ``csr_plain``
(sum within 20·eps·(|A||x|)_i, max exactly).  Times: CUDA-event slope over
CUDA graphs of 50 and 250 calls (``common.chain_time_slope``), L2-warm, µs.

    python3 scripts/k3_sweep_torch.py                    # this tree, the sweep
    python3 scripts/k3_sweep_torch.py --plan-only        # this tree, its plans' choice only
    python3 scripts/k3_sweep_torch.py --root DIR --plan-only   # the tree unpacked in DIR

Run two trees in turns (A, B, B, A) inside one call to the card; a tree whose
plan has no tile table (the vector-CSR K3 before it) is timed at its own
choice only.  One JSON line per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ROOT / "scripts" / "k3_variants.cu"
COPY_CODE = {"bulk": 0, "cp.async": 1, "direct": 2, "stream": 3}


def shapes(kc, tkc, read_mtx, dev):
    """(label, CsrMatrix on dev, dtype, reduce, x) of every K3 shape."""
    import scipy.sparse as sps
    import torch

    rng = np.random.default_rng(0)
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device="cpu").to_scipy()
    pat = fem.copy()
    pat.data[:] = 1.0
    a2 = (pat @ pat + pat).tocsr()
    a2.setdiag(0)
    a2.eliminate_zeros()
    a2.data[:] = 1.0
    n = fem.shape[0]
    cases = [
        ("lap1000 f32 (pinned ONEHOT)",
         tkc.generate_structured_laplacian(1000, 1000, dtype=np.float32, device=dev).to_scipy(),
         torch.float32, "sum"),
        ("rand100k f32 (AUTO route)",
         tkc.generate_random_csr(100_000, 100_000, 16, seed=3, dtype=np.float32,
                                 device=dev).to_scipy(), torch.float32, "sum"),
        ("fem2d_30k f64 (PCG, GMRES)", fem, torch.float64, "sum"),
        ("fem2d_30k + 4I f32 (f32 GMRES)", (fem + 4 * sps.identity(n)).tocsr(), torch.float32,
         "sum"),
        ("fem2d_30k A2 pattern f32 max (MIS2)", a2, torch.float32, "max"),
        ("floor: 256 rows of one entry f32", sps.identity(256, format="csr"), torch.float32,
         "sum"),
    ]
    out = []
    for label, sp, dt, red in cases:
        A = tkc.CsrMatrix.from_scipy(sp.astype(np.float64), device=dev)
        x = rng.standard_normal(A.ncols)
        if red == "max":
            x = rng.permutation(A.ncols) + 1.0
        out.append((label, A, dt, red, torch.from_numpy(x).to(dev, dt)))
    return out


def variants_library():
    """k3_variant_spmv from scripts/k3_variants.cu, built with the package's
    nvcc flags into build/k3_variants/, once per version of its sources."""
    from tpukk_torch import _kernels

    csrc = ROOT / "tpukk_torch" / "csrc"
    text = b"".join(f.read_bytes() for f in (VARIANTS, csrc / "csr.cu"))
    out = ROOT / "build" / "k3_variants" / f"libk3_variants-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                           / "bin" / "nvcc")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        done = subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-o", str(tmp), str(VARIANTS)],
                              capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"k3_sweep_torch: nvcc failed on {VARIANTS}:\n{done.stderr[-4000:]}")
        os.replace(tmp, out)
    fn = ctypes.CDLL(str(out)).k3_variant_spmv
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, I, I, I, P, I, P, P, P, P, P, I, I, P]
    fn.restype = I
    return fn


def variant_call(fn, kc, plan, copy, cap, x, red):
    """A call of one variant on plan's arrays (copied where they start off the
    16 bytes the ring's copies need), with a tile table of cap entries."""
    import torch

    def on16(t):
        return t if t.data_ptr() % 16 == 0 else t.clone()

    rm, ent, val = on16(plan.row_map), on16(plan.entries), on16(plan.values)
    tiles = kc.build_csr_tiles(rm, cap)
    long_rows = int((tiles[:, 3] > cap).any())
    dtype, reduce = int(x.dtype == torch.float64), int(red == "max")

    def call():
        y = torch.empty(plan.nrows, dtype=x.dtype, device=x.device)
        err = fn(dtype, reduce, COPY_CODE[copy], cap, long_rows, tiles.data_ptr(), tiles.shape[0],
                 rm.data_ptr(), ent.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(),
                 plan.nrows, plan.entries.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k3_sweep_torch: {copy} {cap} failed to launch (cudaError {err})")
        return y
    return call


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    ap.add_argument("--plan-only", action="store_true", help="time the plans' own choice only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import tpukk_torch.containers as tkc
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import read_mtx
    from tpukk_torch.sparse import spmv_cuda as kc

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tiled = "tiles" in {f.name for f in dataclasses.fields(kc.CsrPlan)}

    def us(fn):
        return chain_time_slope(fn) * 1e6

    fn = variants_library() if root == ROOT and not args.plan_only else None
    for label, A, dt, red, x in shapes(kc, tkc, read_mtx, dev):
        base = kc.build_csr_plan(A, dt)
        eps = torch.finfo(dt).eps
        ref = kc.csr_plain(base, x, red)
        bound = kc.csr_plain(dataclasses.replace(base, values=base.values.abs()), x.abs())

        def timed(key, call):
            got = call()
            ok = torch.equal(got, ref) if red == "max" else bool(
                ((got - ref).abs() <= 20 * eps * bound).all())
            if not ok:
                raise SystemExit(f"k3_sweep_torch: {label} {key} differs from csr_plain")
            return us(call)

        S = torch.sparse_csr_tensor(A.row_map, A.entries, A.values.to(dt), A.shape,
                                    check_invariants=False)
        row = dict(root=str(root), case=label, nvidia_smi=smi, nrows=A.nrows, nnz=A.nnz,
                   plan_us=timed("plan", lambda: kc.csr_spmv(base, x, red)),
                   cusparse_us=us(lambda: S.matmul(x)) if red == "sum" else None)
        if tiled:
            row.update(plan="stream 1024" if base.streamed else "direct 512",
                       ntiles=int(base.tiles.shape[0]))
        else:
            row.update(plan=f"vector CSR G={base.group}")
        if fn is not None:
            sweep = {}
            for copy in COPY_CODE:
                for cap in ((256, 512, 1024) if copy in ("direct", "stream") else (512, 1024)):
                    sweep[f"{copy} {cap}"] = timed(f"{copy} {cap}",
                                                   variant_call(fn, kc, base, copy, cap, x, red))
            row["sweep_us"] = sweep
            row["best"] = min(sweep, key=sweep.get)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
