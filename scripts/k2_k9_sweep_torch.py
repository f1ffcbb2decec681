#!/usr/bin/env python3
"""K1, K2 and K9 at the shapes ``chip_smoke.py`` gives them, for one tree of
``tpukk_torch``: K1 (``spmv_cuda.dia_spmv``) and K2 (``dia_spmm``, the same
file) on lap1000 (``generate_structured_laplacian(1000, 1000)``, 5 diagonals)
in f32 and f64, K2 at k = 3, 8, 11 and 16; and K9 (``probe_cuda.probe_gather_acc``)
on the probe's six cases (base, packed_opt and mt4 at B = 4 and 16, n_ss
1,024, ``scripts/probe_ss_cost_torch.py``'s plans).

Each K2 and K9 case is first held to its plain version (K2 within
20·eps·(|A||X|)_ij, K9 within 1e-5 absolute, its exactness reported), then
every case is timed: CUDA-event slope over CUDA graphs
(``common.chain_time_slope``), µs, L2-warm (the same inputs call after call)
and L2-cold (a ring of input copies three times the 50 MB L2), beside the
bytes bound at 3.35 TB/s (K1 and K2: the diagonals, x or X and y or Y once;
K9: the streamed rows, src, dst and first, x and y once) and, for K2,
cuSPARSE's ``torch.sparse_csr_tensor @ X``.

    python3 scripts/k2_k9_sweep_torch.py                   # this tree
    python3 scripts/k2_k9_sweep_torch.py --root DIR        # the tree unpacked in DIR
    python3 scripts/k2_k9_sweep_torch.py --probe           # and the probe's FIX/VAR
    python3 scripts/k2_k9_sweep_torch.py --ablate k9-ahead3
    python3 scripts/k2_k9_sweep_torch.py --only k9 --bs 4 --ablate k9-through-l1 --turns 3

``--probe`` also runs DIR's ``scripts/probe_ss_cost_torch.py`` (the per-step
FIX and VAR µs of each variant).  ``--ablate`` times an edited copy of this
tree's package, made in the git-ignored ``build/``: ``k2-shuffle-diag`` (the
row's first column lane loads the diagonal value and shuffles it to the
others, where each lane loads it; only where a lane is one vector and k / V
divides 32, so with ``--k 8 16``), ``k2-panelN`` (N = 1, 4, 8, 16: a lane a
panel of N columns where a row's values are read one at a time, odd k, in
place of 32 bytes: 8 in f32, 4 in f64), ``k9-group8`` (rounds of 8 chunks, where a
round is 4), ``k9-ahead3`` (rows loaded 3 rounds ahead of the sum, where they
are 2), ``k9-through-l1`` (the streamed rows read through L1, where they are
read past it), ``k9-coalesced-x`` (x read at row 0 of the source block in
place of row gt[r, c]: a wrong result, so a timing only, which shows what the
gather costs) and ``k9-default-carveout`` (the runtime's default
shared-memory carve-out, in place of the one that leaves the rest to L1).
Run trees in turns (A, B, B, A) inside one call to the card.  ``--turns N``
with a K9 ablation times this tree's K9 and the edited copy's (its
``probe.cu`` built alone and called through its C entry point) in turns in
one process, package, ablation, ablation, package, N times, on the same
inputs.  One JSON line per case and timing, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
L2_BYTES = 50e6
HBM = 3.35e12

# the edits of --ablate, on this tree's dia.cu and probe.cu
K2_LOAD = """    if (c < 0 || c >= ncols) continue;
    const T d = __ldg(diags + j * nrows + i);
    const T* xr = X + c * k + c0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (W == 1 || c0 + w * V < k) {
        T xv[V];
        load_vec(xr + w * V, xv);
"""
K2_SHUFFLE = """    const bool in = c >= 0 && c < ncols;
    const int first = c0 / (W * V);
    const T d = __shfl_sync(0xffffffffu, in && first == 0 ? __ldg(diags + j * nrows + i) : T(0),
                            (threadIdx.x & 31) - first);
    const T* xr = X + c * k + c0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (W == 1 || c0 + w * V < k) {
        T xv[V];
        if (in) {
          load_vec(xr + w * V, xv);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) xv[q] = T(0);
        }
"""
K2_PANEL = "constexpr int W = V == 1 ? 32 / static_cast<int>(sizeof(T)) : 1;"
K9_GATHER = "* kSrcRows + gi) * kCols + c);"
K9_CARVE = "  const cudaError_t err = prefer_l1(kernel, grid, state);"
K9_PAST_L1 = """  {t} v;
  asm("ld.global.nc.L1::no_allocate.{s} %0, [%1];" : "={r}"(v) : "l"(p));
  return v;
"""
ABLATIONS = {  # name: (source, [(text, its replacement), ...])
    "k2-shuffle-diag": ("dia.cu", [(K2_LOAD, K2_SHUFFLE)]),
    **{f"k2-panel{w}": ("dia.cu", [(K2_PANEL, f"constexpr int W = V == 1 ? {w} : 1;")])
       for w in (1, 4, 8, 16)},
    "k9-group8": ("probe.cu", [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")]),
    "k9-ahead3": ("probe.cu", [("constexpr int kAhead = 2;", "constexpr int kAhead = 3;")]),
    "k9-through-l1": ("probe.cu", [(K9_PAST_L1.format(t=t, s=s_, r=r), "  return __ldg(p);\n")
                                   for t, s_, r in (("int", "b32", "r"), ("float", "f32", "f"))]),
    "k9-coalesced-x": ("probe.cu", [(K9_GATHER, "* kSrcRows + 0 * gi) * kCols + c);")]),
    "k9-default-carveout": ("probe.cu", [(K9_CARVE, "  const cudaError_t err = cudaSuccess;")]),
}
TIMING_ONLY = {"k9-coalesced-x"}


def ablated_copy(variant: str) -> Path:
    """A copy of this tree's tpukk_torch with one kernel edited, under build/."""
    name, edits = ABLATIONS[variant]
    dest = ROOT / "build" / "k2_k9_ablate" / variant
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "tpukk_torch", dest / "tpukk_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dest / "tpukk_torch" / "csrc" / name
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k2_k9_sweep_torch: {name} is not the kernel that --ablate "
                             f"{variant} edits")
        text = text.replace(old, new)
    src.write_text(text)
    return dest


def edited_k9(variant: str):
    """K9 of the edited copy: its probe.cu built alone with the package's nvcc
    flags, called as ``probe_gather_acc`` calls this tree's (no launch count)."""
    import ctypes

    import torch
    from tpukk_torch import _kernels

    src = ablated_copy(variant) / "tpukk_torch" / "csrc" / "probe.cu"
    out = src.with_name("libprobe.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).tpukk_probe_gather_acc
    fn.argtypes = _kernels.SOURCES["probe"]["tpukk_probe_gather_acc"]
    fn.restype = ctypes.c_int

    def k9(plan, x):
        y = torch.empty(plan.out_rows, 128, dtype=torch.float32, device=x.device)
        _kernels.check_launch(fn(int(plan.packed), x.data_ptr(), plan.lane_ptr.data_ptr(),
                                 plan.lane_rec.data_ptr(), plan.gt.data_ptr(),
                                 None if plan.lo is None else plan.lo.data_ptr(),
                                 plan.v.data_ptr(), y.data_ptr(), plan.n_blocks * plan.tiles,
                                 _kernels.stream_of(x)), variant)
        return y
    return k9


def load_probe_script(root: Path):
    """``scripts/probe_ss_cost_torch.py`` of the tree in root."""
    spec = importlib.util.spec_from_file_location("probe_ss_cost_torch",
                                                  root / "scripts" / "probe_ss_cost_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS), help="an edited copy of this tree")
    ap.add_argument("--only", choices=("k2", "k9"), help="one kernel's cases only")
    ap.add_argument("--probe", action="store_true", help="also the probe's FIX/VAR")
    ap.add_argument("--k", type=int, nargs="+", default=[3, 8, 11, 16], help="K2's column counts")
    ap.add_argument("--bs", type=int, nargs="+", help="K9's chunks a step (default 4 and 16)")
    ap.add_argument("--turns", type=int, default=0, metavar="N",
                    help="with a K9 ablation: this tree's K9 and the ablation's in turns, "
                         "in one process, N times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_k9_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    if args.ablate and root != ROOT:
        raise SystemExit("k2_k9_sweep_torch: --ablate edits this tree, not --root")
    if args.turns and (root != ROOT or not args.ablate or ABLATIONS[args.ablate][0] != "probe.cu"
                       or args.only != "k9"):
        raise SystemExit("k2_k9_sweep_torch: --turns pairs this tree's K9 with a K9 ablation "
                         "(--only k9)")
    pkg = ablated_copy(args.ablate) if args.ablate and not args.turns else root
    sys.path.insert(0, str(pkg))
    import tpukk_torch.containers as tkc
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.common import probe_cuda as kp
    from tpukk_torch.sparse import spmv_cuda as kc
    from tpukk_torch.sparse.spmv_impl import build_dia_plan

    warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    common = dict(root=str(root), variant=args.ablate or "package", nvidia_smi=smi)

    def ring_of(nbytes, copy, *args):
        """The arguments, then copies of them: three times the L2 in all."""
        return [args] + [tuple(copy(a) for a in args)
                         for _ in range(max(2, math.ceil(3 * L2_BYTES / nbytes)) - 1)]

    def times(call, ring):
        """L2-warm µs on the ring's first arguments, L2-cold µs around it."""
        warm = chain_time_slope(lambda: call(*ring[0])) * 1e6
        it = iter(range(1 << 62))
        cold = chain_time_slope(lambda: call(*ring[next(it) % len(ring)])) * 1e6
        return warm, cold

    def copy(a):
        """A DIA or probe plan with fresh streamed arrays, or a tensor's clone."""
        if isinstance(a, torch.Tensor):
            return a.clone()
        if hasattr(a, "diags"):
            return dataclasses.replace(a, diags=a.diags.clone())
        return dataclasses.replace(a, gt=a.gt.clone(), lo=None if a.lo is None else a.lo.clone(),
                                   v=a.v.clone(), src=a.src.clone())

    rng = np.random.default_rng(0)
    if args.only != "k9":
        lap = tkc.generate_structured_laplacian(1000, 1000, device=dev)
        for dt in (torch.float32, torch.float64):
            plan = build_dia_plan(lap, dtype=dt)
            aplan = dataclasses.replace(plan, diags=plan.diags.abs())
            S = torch.sparse_csr_tensor(lap.row_map, lap.entries, lap.values.to(dt), lap.shape,
                                        check_invariants=False)
            sz = torch.finfo(dt).bits // 8
            x = torch.from_numpy(rng.standard_normal(lap.ncols)).to(dev, dt)
            nbytes = (len(plan.offsets) + 2) * lap.nrows * sz

            warm, cold = times(kc.dia_spmv, ring_of(nbytes, copy, plan, x))
            print(json.dumps(dict(common, kernel="K1", case=f"lap1000 {str(dt)[6:]}", us=warm,
                                  us_l2_cold=cold, bound_us=nbytes / HBM * 1e6)), flush=True)
            for k in args.k:
                X = torch.from_numpy(rng.standard_normal((lap.ncols, k))).to(dev, dt)
                got, plain = kc.dia_spmm(plan, X), kc.dia_plain(plan, X)
                tol = 20 * torch.finfo(dt).eps * kc.dia_plain(aplan, X.abs())
                over = float(((got - plain).abs() / tol.clamp_min(torch.finfo(dt).tiny)).max())
                if over > 1:
                    raise SystemExit(f"k2_k9_sweep_torch: K2 {dt} k={k} differs from its plain "
                                     f"version ({over} of the bound)")
                nbytes = len(plan.offsets) * lap.nrows * sz + 2 * k * lap.nrows * sz
                warm, cold = times(kc.dia_spmm, ring_of(nbytes, copy, plan, X))
                row = dict(common, kernel="K2", case=f"lap1000 {str(dt)[6:]} k={k}", us=warm,
                           us_l2_cold=cold, bound_us=nbytes / HBM * 1e6,
                           max_err_over_tol=over)
                if hasattr(kc, "vector_width"):
                    row["vec"] = kc.vector_width(k, sz, X.data_ptr() % 16)
                if not args.ablate:
                    row["cusparse_us"] = chain_time_slope(lambda: S @ X) * 1e6
                print(json.dumps(row), flush=True)
            del S, plan, aplan
        del lap
        torch.cuda.empty_cache()

    if args.only != "k2":
        drv = load_probe_script(root)
        k9 = {"package": kp.probe_gather_acc}
        if args.turns:
            k9[args.ablate] = edited_k9(args.ablate)
            order = ["package", args.ablate, args.ablate, "package"] * args.turns
        else:
            order = ["package"]
        for variant in drv.VARIANTS:
            for B in args.bs or drv.BS:
                plan, x0 = drv.make_plan(variant, drv.N_SS, B, dev)
                plain = kp.probe_plain(plan, x0)
                err = {}
                for name, fn in k9.items():
                    got = fn(plan, x0)
                    torch.cuda.synchronize()
                    err[name] = (float((got - plain).abs().max()), bool(torch.equal(got, plain)))
                    if err[name][0] > 1e-5 and (args.ablate or name) not in TIMING_ONLY:
                        raise SystemExit(f"k2_k9_sweep_torch: K9 {name} {variant} B={B} differs "
                                         f"from its plain version by {err[name][0]}")
                    del got
                nbytes = (plan.stream_bytes() + 4 * (plan.src.numel() + 2 * plan.n_ss)
                          + 4 * x0.numel() + 4 * plan.out_rows * 128)
                ring = ring_of(nbytes, copy, plan, x0)
                for turn, name in enumerate(order):
                    warm, cold = times(k9[name], ring)
                    row = dict(common, kernel="K9", case=f"{variant} B={B} n_ss={drv.N_SS}",
                               us=warm, us_l2_cold=cold, bound_us=nbytes / HBM * 1e6,
                               stream_MB=plan.stream_bytes() / 1e6, max_abs_err=err[name][0],
                               exact=err[name][1])
                    if args.turns:
                        row.update(variant=name, turn=turn)
                    print(json.dumps(row), flush=True)
                del plan, x0, plain, ring
                drv.make_plan.cache_clear()
                torch.cuda.empty_cache()
        if args.probe:
            res = drv.probe(device=dev)
            print(json.dumps(dict(common, kernel="K9", case="probe FIX/VAR", **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
