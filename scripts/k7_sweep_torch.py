#!/usr/bin/env python3
"""K7 (``spmv_cuda.csr_spmm``) on the shapes the solver paths give it, for one
tree of ``tpukk_torch``: rand100k f32 k=8 (the ``spmm`` path), fem2d_30k f64
k=4, and fem2d_30k's strict lower triangle f64 k=8 (TWOSTAGE's inner SpMM).
Each is first held to ``csr_spmm_plain`` (within 20·eps·(|A||X|)_ij), then
timed L2-warm: CUDA-event slope over CUDA graphs of 50 and 250 calls
(``common.chain_time_slope``), µs, beside the bytes bound (rowmap, colidx,
vals, X and Y once at 3.35 TB/s) and cuSPARSE's ``torch.sparse_csr_tensor @ X``.

    python3 scripts/k7_sweep_torch.py                      # this tree
    python3 scripts/k7_sweep_torch.py --geometries         # and every slot count
    python3 scripts/k7_sweep_torch.py --root DIR           # the tree unpacked in DIR
    python3 scripts/k7_sweep_torch.py --root DIR --ablate no-shuffle

``--geometries`` (a tree with ``spmm_geometry``) also times the kernel at every
other slot count its vector width and column lanes allow.  ``--ablate`` times an edited copy of DIR's package, made
in the git-ignored ``build/``.  On a tree whose K7 is the register panel of
``csrc/csr_panel.cuh`` (the design before the slots): ``no-shuffle`` drops
the group's shuffle tree from ``csr_row_panel`` (each lane stores its own
partial sums, so the result is not held: a timing only); ``vector-x`` reads
X's row in ``panel_add`` with 16-byte vector loads where k fills the panel.
On a tree with the slotted K7: ``u8`` gives each lane twice the entries a
step (8 rows of X in flight); ``own-loads`` has each lane load its slot's
entries itself in place of the shuffles (the same sums).  Run trees in
turns (A, B, B, A) inside one call to the card.  One JSON line per shape and
geometry, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# the edits of --ablate: on the register-panel K7's csr_panel.cuh, and on the
# slotted K7's csr.cu
PANEL_REDUCE = "  }\n  panel_reduce<T, G, KMAX>(k, acc);\n}\n"
PANEL_ADD = "  const T* xr = x + static_cast<int64_t>(c) * k;\n"
VECTOR_X = PANEL_ADD + """\
  if constexpr (kReadOnlyX && KMAX * sizeof(T) % 16 == 0) {
    if (k == KMAX && !zero) {
      using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
      constexpr int per = 16 / sizeof(T);
#pragma unroll
      for (int j = 0; j < KMAX; j += per) {
        const Vec q = __ldg(reinterpret_cast<const Vec*>(xr + j));
        const T* t = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int u = 0; u < per; ++u) acc[j + u] = fma(v, t[u], acc[j + u]);
      }
      return;
    }
  }
"""
SHUFFLED = """    int col[U];
    T val[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = first + u * W;
      col[u] = j < p1 ? Mat::load(colidx + j) : -1;
      val[u] = j < p1 ? Mat::load(vals + j) : T(0);
    }
    T xv[U * C][V];
    T vv[U * C];
#pragma unroll
    for (int i = 0; i < U * C; ++i) {
      // the step's entry s + S·i: loaded by lane S·(i % C) + s, as its entry i / C
      int ci;
      if constexpr (C == 1) {
        ci = col[i];
        vv[i] = val[i];
      } else {
        ci = __shfl_sync(kFull, col[i / C], src0 + S * (i % C));
        vv[i] = __shfl_sync(kFull, val[i / C], src0 + S * (i % C));
      }
"""
OWN_LOADS = """    T xv[U * C][V];
    T vv[U * C];
#pragma unroll
    for (int i = 0; i < U * C; ++i) {
      const int j = first - g + g / C + S * i;  // the step's entry s + S·i
      const int ci = j < p1 ? Mat::load(colidx + j) : -1;
      vv[i] = j < p1 ? Mat::load(vals + j) : T(0);
"""
U4 = "constexpr int U = C >= 4 ? 1 : 4 / C;"
PANEL, CSR = "csr_panel.cuh", "csr.cu"
ABLATIONS = {"no-shuffle": (PANEL, PANEL_REDUCE, "  }\n}\n"),
             "vector-x": (PANEL, PANEL_ADD, VECTOR_X),
             "u8": (CSR, U4, "constexpr int U = C >= 8 ? 1 : 8 / C;"),
             "own-loads": (CSR, SHUFFLED, OWN_LOADS)}


def ablated_copy(root: Path, variant: str) -> Path:
    """A copy of root's tpukk_torch with K7 edited, under build/."""
    name, old, new = ABLATIONS[variant]
    dest = ROOT / "build" / "k7_ablate" / variant
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "tpukk_torch", dest / "tpukk_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dest / "tpukk_torch" / "csrc" / name
    text = src.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"k7_sweep_torch: {root}'s {name} is not the K7 that --ablate "
                         f"{variant} edits")
    src.write_text(text.replace(old, new))
    return dest


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS), help="an edited copy of --root's K7")
    ap.add_argument("--geometries", action="store_true", help="time every slot count too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(ablated_copy(root, args.ablate) if args.ablate else root))
    import scipy.sparse as sps

    import tpukk_torch.containers as tkc
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.sparse import spmv_cuda as kc

    warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    fem = tkc.read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device="cpu").to_scipy()
    cases = [("rand100k f32 k=8 (spmm)",
              tkc.generate_random_csr(100_000, 100_000, 16, seed=3, dtype=np.float32,
                                      device="cpu").to_scipy(), torch.float32, 8),
             ("fem2d_30k f64 k=4", fem, torch.float64, 4),
             ("fem2d_30k strict lower f64 k=8 (TWOSTAGE)", sps.tril(fem, k=-1).tocsr(),
              torch.float64, 8)]
    new_k7 = hasattr(kc, "spmm_geometry")
    for label, sp, dt, k in cases:
        A = tkc.CsrMatrix.from_scipy(sp, device=dev)
        plan = kc.build_csr_plan(A, dt)
        aplan = dataclasses.replace(plan, values=plan.values.abs())
        X = torch.from_numpy(rng.standard_normal((A.ncols, k))).to(dev, dt)
        sz = torch.finfo(dt).bits // 8
        nbytes = (A.nrows + 1) * 4 + A.nnz * (4 + sz) + (A.ncols + A.nrows) * k * sz
        S = torch.sparse_csr_tensor(plan.row_map, plan.entries, plan.values, A.shape,
                                    check_invariants=False)
        common = dict(root=str(root), variant=args.ablate or "package", case=label,
                      nvidia_smi=smi, nnz=A.nnz, bound_us=nbytes / 3.35e12 * 1e6,
                      cusparse_us=chain_time_slope(lambda: S @ X) * 1e6)
        if new_k7:
            chosen = kc.spmm_geometry(A.nnz / A.nrows, A.nrows, k, sz, X.data_ptr() % 16)
            geoms = [chosen]
            if args.geometries:
                geoms += [dataclasses.replace(chosen, slots=s) for s in (1, 2, 4, 8, 16, 32)
                          if s != chosen.slots and s * chosen.cols <= 32]
        else:
            chosen, geoms = None, [None]
        for g in geoms:
            run = (lambda: kc.csr_spmm(plan, X)) if g is None else (lambda: kc.csr_spmm(plan, X, g))
            got, plain = run(), kc.csr_spmm_plain(plan, X)
            tol = 20 * torch.finfo(dt).eps * kc.csr_spmm_plain(aplan, X.abs())
            over = float(((got - plain).abs() / tol.clamp_min(torch.finfo(dt).tiny)).max())
            if args.ablate != "no-shuffle" and over > 1:
                raise SystemExit(f"k7_sweep_torch: {label} {g}: K7 differs from its plain "
                                 f"version ({over} of the bound)")
            geo = (dict(lanes_per_row=plan.group) if g is None else
                   dict(vec=g.vec, cols=g.cols, slots=g.slots, chosen=g == chosen))
            print(json.dumps(dict(common, **geo, k7_us=chain_time_slope(run) * 1e6,
                                  max_err_over_tol=over)), flush=True)
        del S, plan, aplan, A
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
