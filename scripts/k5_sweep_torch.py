#!/usr/bin/env python3
"""K5 (``common.permute.permute_gather``) at the shapes the port's paths give
it, for one tree of ``tpukk_torch``:

- a random permutation of 1,000,000 values, f64 and f32;
- SuperLU's row permutation of fem2d_30k (``argsort(splu(A).perm_r)``), f64;
- fem2d_30k's RCM permutation (the RCM SpMV route's gather), f64 and f32;
- lap1000's RCM permutation (1,000,000 rows), f32;
- the ILU(1) refresh's ``invL`` permutation on fem2d_30k, f64;
- a random permutation of 1,000,000 rows of 8 f32 columns (the RCM ``spmm``
  shape);
- the launch floor: one value, f32.

Each case is first held to ``permute_plain`` (``index_select``), exactly,
then timed: CUDA-event slope over CUDA graphs (``common.chain_time_slope``),
µs, L2-warm (the same inputs call after call) and L2-cold (a ring of src and
x copies three times the 50 MB L2; none for the floor), beside
``torch.index_select``'s time and three bounds at 3.35 TB/s: bytes (src and x read once, out written once),
sectors (src and out once, and for x the distinct 32-byte sectors the
gathers of each 32 consecutive outputs touch, at 32 B each; for k > 1 the
sectors each row spans) and the launch floor (the floor case's time).

    python3 scripts/k5_sweep_torch.py                   # this tree
    python3 scripts/k5_sweep_torch.py --root DIR        # the tree unpacked in DIR
    python3 scripts/k5_sweep_torch.py --ablate k5-v1

The permutations are computed once, with the tree's own host planners, and
kept in the git-ignored ``build/k5_sweep_perms.npz`` for later runs, so that
every tree times the same ones.  ``--ablate`` times an edited copy of this
tree's package, made under ``build/``: ``k5-v1`` (one value a thread at
k = 1 for every n, where a thread takes 16 bytes of out once the threads
fill ``permute.FILL_THREADS``), ``k5-wide`` (16 bytes a thread for every n),
``k5-vec-cs`` (src and out with the evict-first hint at k = 1, where they go
the default way), ``k5-rows-plain`` (at k > 1 src through the read-only path
and out stored plainly, where both carry the hint), ``k5-rows1`` (one row a lane group each
trip of the k > 1 loop, where it is two), ``k5-block64`` (blocks of 64
threads, where they are 256) and ``k5-x-l2`` (x's gathers cached in L2 only,
past L1, where they go through the read-only path).  Run trees in turns
(A, B, B, A) inside one call to the card.  One JSON line per case, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
L2_BYTES = 50e6
HBM = 3.35e12
PERMS = ROOT / "build" / "k5_sweep_perms.npz"

CU, PY = "csrc/permute.cu", "common/permute.py"
ABLATIONS = {  # name: [(file under tpukk_torch, its text, the replacement), ...]
    "k5-v1": [(PY, "        return vec, 1\n", "        return 1, 1\n")],
    "k5-wide": [(PY, "\n                           or n < vec * FILL_THREADS):", "):")],
    "k5-vec-cs": [(CU, "    const S s = __ldg(reinterpret_cast<const S*>(src) + v);",
                   "    const S s = stream_load(reinterpret_cast<const S*>(src) + v);"),
                  (CU, "    reinterpret_cast<O*>(out)[v] = o;",
                   "    stream_store(reinterpret_cast<O*>(out) + v, o);")],
    "k5-rows-plain": [(CU, "  return __ldcs(p);\n", "  return __ldg(p);\n"),
                      (CU, "  __stcs(p, v);\n", "  *p = v;\n")],
    "k5-rows1": [(CU, "constexpr int kRows = 2;", "constexpr int kRows = 1;")],
    "k5-block64": [(CU, "constexpr int kThreads = 256;", "constexpr int kThreads = 64;")],
    "k5-x-l2": [(CU, "  return __ldg(p);\n", "  return __ldcg(p);\n")],
}


def ablated_copy(variant: str) -> Path:
    """A copy of this tree's tpukk_torch with K5 edited, under build/."""
    dest = ROOT / "build" / "k5_ablate" / variant
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "tpukk_torch", dest / "tpukk_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in ABLATIONS[variant]:
        path = dest / "tpukk_torch" / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"k5_sweep_torch: {name} is not the code that --ablate {variant} "
                             f"edits")
        path.write_text(text.replace(old, new))
    return dest


def make_perms(dev) -> dict:
    """The paths' permutations, from the imported tree's host planners."""
    import scipy.sparse.linalg as spla
    import torch
    from tpukk_torch.containers import generate_structured_laplacian, read_mtx
    from tpukk_torch.graph import rcm
    from tpukk_torch.sparse import SpilukHandle, build_iluk_refresh, spiluk_symbolic

    rng = np.random.default_rng(0)
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)
    lap = generate_structured_laplacian(1000, 1000, dtype=np.float32, device=dev)
    h1 = SpilukHandle(1)
    spiluk_symbolic(h1, fem)
    rplan = build_iluk_refresh(h1, fem)
    if rplan.levels is None:
        raise SystemExit("k5_sweep_torch: fem2d_30k's ILU(1) refresh has no level schedule")
    return dict(
        random_1m=rng.permutation(1_000_000),
        superlu_fem2d_30k=np.argsort(spla.splu(fem.to_scipy().tocsc()).perm_r),
        rcm_fem2d_30k=np.asarray(rcm(fem)),
        rcm_lap1000=np.asarray(rcm(lap)),
        iluk_invL_fem2d_30k=rplan.levels["invL"].cpu().numpy(),
        random_1m_rows=rng.permutation(1_000_000),
        floor=np.zeros(1, np.int64),
    )


def x_sectors(src: np.ndarray, k: int, itemsize: int) -> int:
    """32-byte sectors of x the gathers need: for k = 1 the distinct sectors
    among the sources of each 32 consecutive outputs; for k > 1 the sectors
    each source row spans."""
    src = src.astype(np.int64)
    if k > 1:
        rb = k * itemsize
        return int(((src * rb + rb - 1) // 32 - src * rb // 32 + 1).sum())
    sec = src * itemsize // 32
    pad = (-len(sec)) % 32
    blk = np.sort(np.r_[sec, np.full(pad, -1)].reshape(-1, 32), axis=1)
    distinct = 1 + (np.diff(blk, axis=1) != 0).sum(axis=1)
    return int(distinct.sum()) - (pad > 0)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS), help="an edited copy of this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    if args.ablate and root != ROOT:
        raise SystemExit("k5_sweep_torch: --ablate edits this tree, not --root")
    sys.path.insert(0, str(ablated_copy(args.ablate) if args.ablate else root))
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.common import permute as kperm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    common = dict(root=str(root), variant=args.ablate or "package", nvidia_smi=smi)
    if PERMS.is_file():
        perms = dict(np.load(PERMS))
    else:
        perms = make_perms(dev)
        PERMS.parent.mkdir(parents=True, exist_ok=True)
        np.savez(PERMS, **perms)

    rng = np.random.default_rng(1)
    cases = [("floor: 1 value", "floor", torch.float32, 1),
             ("random permutation of 1,000,000", "random_1m", torch.float64, 1),
             ("random permutation of 1,000,000", "random_1m", torch.float32, 1),
             ("SuperLU row permutation of fem2d_30k", "superlu_fem2d_30k", torch.float64, 1),
             ("RCM of fem2d_30k", "rcm_fem2d_30k", torch.float64, 1),
             ("RCM of fem2d_30k", "rcm_fem2d_30k", torch.float32, 1),
             ("RCM of lap1000", "rcm_lap1000", torch.float32, 1),
             ("ILU(1) refresh invL of fem2d_30k", "iluk_invL_fem2d_30k", torch.float64, 1),
             ("random permutation of 1,000,000 rows", "random_1m_rows", torch.float32, 8)]
    floor_us = None
    for label, key, dt, k in cases:
        p = perms[key]
        n, sz = len(p), torch.finfo(dt).bits // 8
        src = torch.from_numpy(p.astype(np.int32)).to(dev)
        shape = (max(int(p.max()) + 1, n),) + ((k,) if k > 1 else ())
        x = torch.from_numpy(rng.standard_normal(shape)).to(dev, dt)
        if not torch.equal(kperm.permute_gather(src, x), kperm.permute_plain(src, x)):
            raise SystemExit(f"k5_sweep_torch: K5 {label} {dt} k={k} differs from index_select")
        nbytes = n * 4 + 2 * n * k * sz
        # the floor has no cold time: its ring would be millions of copies
        copies = 1 if key == "floor" else max(2, math.ceil(3 * L2_BYTES / nbytes))
        ring = [(src, x)] + [(src.clone(), x.clone()) for _ in range(copies - 1)]
        it = iter(range(1 << 62))

        def cold(fn):
            if len(ring) == 1:
                return None
            return chain_time_slope(lambda: fn(*ring[next(it) % len(ring)])) * 1e6

        us = chain_time_slope(lambda: kperm.permute_gather(src, x)) * 1e6
        us_cold = cold(kperm.permute_gather)
        lib = chain_time_slope(lambda: torch.index_select(x, 0, src)) * 1e6
        lib_cold = cold(lambda s, v: torch.index_select(v, 0, s))
        if key == "floor":
            floor_us = us
        row = dict(common, kernel="K5", case=label, dtype=str(dt)[6:], n=n, k=k, us=us,
                   us_l2_cold=us_cold, index_select_us=lib, index_select_us_l2_cold=lib_cold,
                   bound_us=nbytes / HBM * 1e6,
                   sectors_bound_us=(n * 4 + n * k * sz + 32 * x_sectors(p, k, sz)) / HBM * 1e6,
                   launch_floor_us=floor_us, working_set_MB=nbytes / 1e6)
        if hasattr(kperm, "permute_geometry"):
            row["vec"], row["lanes"] = kperm.permute_geometry(
                n, k, sz, src.data_ptr() % 16, x.data_ptr() % 16, 0)
        print(json.dumps(row), flush=True)
        del ring, src, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
