#!/usr/bin/env python3
"""Drive tpukk_torch's main paths once on one CUDA GPU: SpMV + PCG,
ILU(0)-preconditioned GMRES with the RCM route, the Gauss-Seidel path
(coloring, MIS2, sweeps, GsPrec-PCG), the SpGEMM path (SpgemmHandle
symbolic/numeric with reuse, banded DIA SpGEMM, a smoothed-aggregation set-up
through spgemm_jacobi, SpADD, triangle counting), the factor-and-solve path
(supernodal and imported-factor triangular solves, PAR_ILUT, MDF, the ILU(k)
device refresh) and the gather-table probe.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpukk_torch/csrc`` (nvcc, sm_90a) and the host
planners (``csrc/host.cpp``, g++), all in parallel, holds each kernel against
its plain torch version on the card, drives the paths a user runs
(SpmvHandle AUTO SpMV and SpMM on the 1M-row 2-D Laplacian, AUTO SpMV on a
random 100k-row CSR, PCG on the Laplacian and on the FEM matrix; SpILUK →
LUPrec → GMRES on the FEM matrix to convergence and two restart cycles on the
Laplacian; GMRES with reorder="rcm" / "none" / "auto"; SERIAL and VB coloring,
MIS2, POINT / CLUSTER / TWOSTAGE sweeps, GsPrec-PCG on both matrices, SpMM
on the ONEHOT route; A·A through SpgemmHandle(KK) on the Laplacian, the random
matrix and the FEM matrix, DIA SpGEMM on a 1M-row band, P = (I - ωD⁻¹A)·P_tent
and Pᵀ·A·P on the FEM matrix, SpADD, triangles of the FEM graph; SUPERNODAL
(the DAG, f32 and f64, held in f64 to the batched plan) against SEQLVLSCHD
solves of the FEM matrix's SuperLU factors, superlu_import in GMRES, an
imported CHOLMOD-format Cholesky factor in PCG, PAR_ILUT and MDF factors in
GMRES, the ILU(1) refresh; the probe's three variants), checks every result
on the host with scipy, asserts that a triangular solve is one K4 launch, an
LUPrec apply two, an imported factor's apply two and no K5 (its outer
permutations folded into K4, the bits of K5, K4, K4, K5 kept) and a
Gauss-Seidel apply (GsPrec's too) one K6 launch (the
fused sweep, held bit for bit to the per-color path it replaces), times each kernel, its plain version and the torch call
that computes the same function (K4 also per level, beside the chain's floor
on a bidiagonal triangle), profiles one PCG and one GMRES iteration, and
prints one JSON line per phase.  The last two lines are the
card's name and power limit as nvidia-smi reports them, and the result line.  Any failed check exits
non-zero.  Without a CUDA device it exits 1 and prints no result.  It imports
nothing of JAX or of tpukk.
"""
from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 rates (NVIDIA data sheets): device-memory bytes/s by part,
# and peak non-tensor-core flop/s by dtype (SXM part at 700 W)
HBM_BYTES_PER_S = (("h100 pcie", 2.0e12), ("h100 nvl", 3.9e12), ("h100", 3.35e12))
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
L2_BYTES = 50e6

SOURCES = {"dia_spmv": "tpukk_torch/csrc/dia.cu", "dia_spmm": "tpukk_torch/csrc/dia.cu",
           "csr_spmv": "tpukk_torch/csrc/csr.cu", "sptrsv_levels": "tpukk_torch/csrc/sptrsv.cu",
           "permute_gather": "tpukk_torch/csrc/permute.cu",
           "gs_sweep": "tpukk_torch/csrc/gs.cu", "csr_spmm": "tpukk_torch/csrc/csr.cu",
           "spgemm_rows": "tpukk_torch/csrc/spgemm.cu",
           "probe_gather_acc": "tpukk_torch/csrc/probe.cu"}
REPLACES = {"dia_spmv": "tpukk/sparse/spmv_pallas.py:41",
            "dia_spmm": "tpukk/sparse/spmv_pallas.py:180",
            "csr_spmv": "tpukk/sparse/spmv_pallas.py:2053",
            "sptrsv_levels": "tpukk/sparse/sptrsv_pallas.py:515",
            "permute_gather": "tpukk/common/permute.py:91",
            "gs_sweep": "tpukk/sparse/spmv_pallas.py:2125",
            "csr_spmm": "tpukk/sparse/spmv_pallas.py:1074",
            "spgemm_rows": "tpukk/sparse/spgemm_pallas.py:1063",
            "probe_gather_acc": "scripts/probe_ss_cost.py:40"}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; t_s is the run's host seconds so far (where the time goes)."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - _T0}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    low = name.lower()
    for key, rate in HBM_BYTES_PER_S:
        if key in low:
            return rate
    fail(f"no published memory rate for {name!r}")


def selection_matrix(sp):
    """The VB coloring's selection matrix of a graph (tpukk_torch.graph.coloring's
    _vb_selection): row i·w + j holds a 1 at column cols[i, j], the j-th
    neighbour of i other than i, or nothing where i has fewer."""
    import numpy as np
    import scipy.sparse as sps

    n = sp.shape[0]
    deg = np.diff(sp.indptr)
    w = int(deg.max())
    cols = np.full((n, w), -1, np.int64)
    slot = np.arange(sp.nnz) - np.repeat(sp.indptr[:-1], deg)
    cols[np.repeat(np.arange(n), deg), slot] = sp.indices
    valid = ((cols >= 0) & (cols != np.arange(n)[:, None])).reshape(-1)
    rm = np.r_[0, np.cumsum(valid)]
    return sps.csr_matrix((np.ones(rm[-1]), cols.reshape(-1)[valid], rm), shape=(n * w, n))


def csr_bytes(A, itemsize: int) -> int:
    """Useful-CSR byte model of one SpMV (bench.py:65-67)."""
    return A.nnz * (itemsize + 4) + (A.nrows + 1) * 4 + (A.ncols + A.nrows) * itemsize


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import numpy as np
    import scipy.sparse as sps
    from torch.autograd import DeviceType

    from tpukk_torch import _kernels
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.common import probe_cuda as kp
    from tpukk_torch.containers import (CsrMatrix, generate_banded_csr, generate_random_csr,
                                        generate_structured_laplacian, read_mtx, transpose)
    from tpukk_torch.graph import (ColoringAlgorithm, build_triangle_plan, graph_color,
                                   graph_mis2, graph_mis2_aggregate, triangle_count,
                                   triangle_count_device, verify_coloring)
    from tpukk_torch.sparse import (ClusteringAlgorithm, GmresHandle, GsAlgorithm, GsHandle,
                                    GsPrec, JacobiPrec, LUPrec, Ortho, SpilukHandle,
                                    SpmvAlgorithm, SpmvHandle, SptrsvHandle, forward_sweep,
                                    gauss_seidel_apply, gauss_seidel_numeric,
                                    gauss_seidel_symbolic, gmres, pcg, spiluk_numeric,
                                    spiluk_symbolic, spmm, sptrsv_solve, sptrsv_symbolic,
                                    SpaddHandle, SpgemmAlgorithm, SpgemmHandle, spadd_numeric,
                                    spadd_symbolic, spgemm_jacobi, spgemm_numeric,
                                    spgemm_symbolic, SptrsvAlgorithm, build_iluk_refresh,
                                    cholmod_import, mdf_numeric, mdf_symbolic, MdfHandle,
                                    ParIlutHandle, par_ilut_numeric, par_ilut_symbolic,
                                    refresh_to_csr, spiluk_refresh, superlu_import)
    from tpukk_torch.sparse import gs_cuda as kg
    from tpukk_torch.sparse import spgemm_cuda as ksg
    from tpukk_torch.sparse import spmv_cuda as kc
    from tpukk_torch.sparse import sptrsv_cuda as ks
    from tpukk_torch.sparse.gauss_seidel import _plan_in
    from tpukk_torch.sparse.gmres import _arnoldi_cycle, _rcm_reorder
    from tpukk_torch.sparse.pcg import pcg_initial_state, pcg_iteration
    from tpukk_torch.sparse.spmv_impl import build_dia_plan

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    gpu = torch.cuda.get_device_name(0)
    bw = hbm_rate(gpu)
    rng = np.random.default_rng(0)

    def vec(n, dtype, k=None):
        shape = (n,) if k is None else (n, k)
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    rng2 = np.random.default_rng(1)  # the GMRES slice's inputs; rng keeps the SpMV slice's

    def vec2(n, dtype):
        return torch.from_numpy(rng2.standard_normal(n)).to(dev, dtype)

    def launch_counts() -> dict:
        return {**kc.launch_counts(), **ks.launch_counts(), **kg.launch_counts(),
                **ksg.launch_counts(), **kp.launch_counts()}

    def reset_launch_counts() -> None:
        for mod in (kc, ks, kg, ksg, kp):
            mod.reset_launch_counts()

    # ---- 1. device and build ------------------------------------------------
    build_s = _kernels.build_all()
    ptxas = [ln.strip() for name in _kernels.SOURCES for ln in _kernels.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    emit("device", nvidia_smi=smi, name=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s)

    t0 = time.perf_counter()
    lap = generate_structured_laplacian(1000, 1000, dtype=np.float32, device=dev)
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)
    rnd = generate_random_csr(100_000, 100_000, 16, seed=3, dtype=np.float32, device=dev)
    emit("matrices", seconds=time.perf_counter() - t0,
         lap1000=[lap.nrows, lap.nnz], fem2d_30k=[fem.nrows, fem.nnz, str(fem.dtype)],
         rand100k=[rnd.nrows, rnd.nnz])

    # ---- 2. each kernel against its plain version, on the card ----------------
    errs = {k.__name__: 0.0 for k in (*kc.KERNELS, *ks.KERNELS, *kg.KERNELS, *ksg.KERNELS,
                                       *kp.KERNELS)}

    def hold(kernel: str, label: str, got, plain, bound, dtype) -> None:
        """|got - plain| <= 20·eps·(|A|·|x|) elementwise."""
        torch.cuda.synchronize()
        eps = torch.finfo(dtype).eps
        err = (got - plain).abs()
        tol = 20 * eps * bound
        ok = bool((err <= tol).all())
        errs[kernel] = max(errs[kernel], float(err.max()))
        emit("check", kernel=kernel, case=label, dtype=str(dtype), max_abs_err=float(err.max()),
             max_err_over_tol=float((err / tol.clamp_min(torch.finfo(dtype).tiny)).max()),
             tol="20*eps*(|A||x|)_i", ok=ok)
        require(ok, f"{kernel} {label} disagrees with its plain version")

    before = kc.launch_counts()
    for dt in (torch.float32, torch.float64):
        plan = build_dia_plan(lap, dtype=dt)
        aplan = dataclasses.replace(plan, diags=plan.diags.abs())
        x = vec(lap.ncols, dt)
        hold("dia_spmv", "lap1000", kc.dia_spmv(plan, x), kc.dia_plain(plan, x),
             kc.dia_plain(aplan, x.abs()), dt)
        if dt == torch.float32:
            X = vec(lap.ncols, dt, 8)
            hold("dia_spmm", "lap1000 k=8", kc.dia_spmm(plan, X), kc.dia_plain(plan, X),
                 kc.dia_plain(aplan, X.abs()), dt)
        for label, A in (("lap1000 (pinned ONEHOT)", lap), ("fem2d_30k", fem),
                         ("rand100k_deg16", rnd)):
            cp = kc.build_csr_plan(A, dt)
            acp = dataclasses.replace(cp, values=cp.values.abs())
            x = vec(A.ncols, dt)
            hold("csr_spmv", f"{label} sum G={cp.group}", kc.csr_spmv(cp, x),
                 kc.csr_plain(cp, x), kc.csr_plain(acp, x.abs()), dt)
            if label != "lap1000 (pinned ONEHOT)":
                xa = x.abs()
                hold("csr_spmv", f"{label} max on |vals|,|x|", kc.csr_spmv(acp, xa, "max"),
                     kc.csr_plain(acp, xa, "max"), kc.csr_plain(acp, xa, "max"), dt)
    # K3's tiling at its edges, in both of its modes (tiles of 512 entries
    # through L1, of 1024 past it): rows longer than a tile (read in pieces),
    # nnz % 4 != 0 (the arrays end off 16 bytes), and the VB coloring's
    # selection matrix of fem2d_30k (0/1 entry a row, runs of empty rows); its
    # own generator, so that the later phases draw the inputs they drew before
    er = np.random.default_rng(11)
    long_rows = sps.random(64, 5000, density=0.0006, random_state=2, format="lil")
    long_rows[5, :] = er.standard_normal(5000)
    long_rows[40, :700] = er.standard_normal(700)
    odd = sps.random(1001, 900, density=0.0113, random_state=3, format="coo")
    keep = odd.nnz - (odd.nnz - 3) % 4
    edge = {"long rows": long_rows.tocsr(),
            "nnz % 4 == 3": sps.csr_matrix((odd.data[:keep], (odd.row[:keep], odd.col[:keep])),
                                           shape=odd.shape),
            "fem2d_30k VB selection matrix": selection_matrix(fem.to_scipy())}
    for label, sp in edge.items():
        A = CsrMatrix.from_scipy(sp, device=dev)
        for dt in (torch.float32, torch.float64):
            x = torch.from_numpy(er.standard_normal(A.ncols)).to(dev, dt)
            for mode, streamed in (("direct", False), ("stream", True)):
                cp = kc.build_csr_plan(A, dt, streamed)
                acp = dataclasses.replace(cp, values=cp.values.abs())
                hold("csr_spmv", f"{label} sum {mode}", kc.csr_spmv(cp, x), kc.csr_plain(cp, x),
                     kc.csr_plain(acp, x.abs()), dt)
                xa = x.abs()
                hold("csr_spmv", f"{label} max {mode}", kc.csr_spmv(acp, xa, "max"),
                     kc.csr_plain(acp, xa, "max"), kc.csr_plain(acp, xa, "max"), dt)
                require(torch.equal(kc.csr_spmv(acp, xa, "max"), kc.csr_plain(acp, xa, "max")),
                        f"csr_spmv {label} max {mode} is not exact")
    # K7 at the main path's shapes: rand100k f32 k=8 (spmm), fem2d_30k f64 k=4,
    # and fem2d_30k's strict lower triangle f64 k=8 (TWOSTAGE's inner SpMM),
    # whose X comes from a generator of its own, so that the later phases draw
    # the inputs they drew before
    fem_lower = CsrMatrix.from_scipy(sps.tril(fem.to_scipy(), k=-1).tocsr(), device=dev)
    X_lower = torch.from_numpy(np.random.default_rng(12).standard_normal((fem.ncols, 8))).to(dev)
    for label, A, dt, k in (("rand100k_deg16", rnd, torch.float32, 8),
                            ("fem2d_30k", fem, torch.float64, 4),
                            ("fem2d_30k strict lower (TWOSTAGE)", fem_lower, torch.float64, 8)):
        cp = kc.build_csr_plan(A, dt)
        acp = dataclasses.replace(cp, values=cp.values.abs())
        X = X_lower if A is fem_lower else vec(A.ncols, dt, k)
        g = kc.spmm_geometry(A.nnz / A.nrows, A.nrows, k, X.element_size(), X.data_ptr() % 16)
        hold("csr_spmm", f"{label} k={k} vec={g.vec} cols={g.cols} slots={g.slots}",
             kc.csr_spmm(cp, X), kc.csr_spmm_plain(cp, X), kc.csr_spmm_plain(acp, X.abs()), dt)
    after = kc.launch_counts()
    require(all(after[k] > before[k] for k in after), f"a launch counter did not rise: {after}")
    emit("kernels_checked", launches=after)

    # ---- 3. the main path, each part with the counts set to 0 around it --------
    total = {k: 0 for k in launch_counts()}

    def counted(part: str, fn, needs: tuple):
        reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        for k, v in counts.items():
            total[k] += v
        require(all(counts[k] > 0 for k in needs), f"{part}: {needs} not launched: {counts}")
        return out, counts, wall

    def host_check(A, x, got, label):
        """Against scipy in f64 on the host: |got - A·x| <= 20·eps·(|A||x|)."""
        sp = A.to_scipy().astype(np.float64)
        xh = x.double().cpu().numpy()
        ref = sp @ xh
        bound = abs(sp) @ np.abs(xh)
        eps = torch.finfo(got.dtype).eps
        err = np.abs(got.double().cpu().numpy() - ref)
        require(bool((err <= 20 * eps * bound + 1e-300).all()), f"{label}: wrong vs scipy")
        return float(err.max())

    h = SpmvHandle(lap, SpmvAlgorithm.AUTO)
    require(h.algorithm == SpmvAlgorithm.DIA, f"flagship routed to {h.algorithm}")
    x = vec(lap.ncols, torch.float32)
    y, counts, _ = counted("flagship spmv", lambda: h(x), ("dia_spmv",))
    emit("main_flagship_spmv", route=h.algorithm.name, launches=counts,
         max_abs_err_vs_scipy=host_check(lap, x, y, "flagship"))

    X = vec(lap.ncols, torch.float32, 8)
    Y, counts, _ = counted("spmm k=8", lambda: spmm(lap, X), ("dia_spmm",))
    errs_mm = [host_check(lap, X[:, j], Y[:, j], "spmm") for j in range(X.shape[1])]
    emit("main_spmm_k8", route="DIA", launches=counts, max_abs_err_vs_scipy=max(errs_mm))

    hr = SpmvHandle(rnd, SpmvAlgorithm.AUTO)
    require(hr.algorithm == SpmvAlgorithm.ONEHOT, f"rand100k routed to {hr.algorithm}")
    xr = vec(rnd.ncols, torch.float32)
    yr, counts, _ = counted("unstructured spmv", lambda: hr(xr), ("csr_spmv",))
    emit("main_unstructured_spmv", route=hr.algorithm.name, launches=counts,
         max_abs_err_vs_scipy=host_check(rnd, xr, yr, "rand100k"))

    def solve(label, A, b, prec, max_iters):
        Ah = SpmvHandle(A)  # plan built before the clock starts; it launches nothing
        Ah._plan("dia" if Ah.algorithm == SpmvAlgorithm.DIA else "csr", torch.float64)
        (xs, st), counts, wall = counted(
            label, lambda: pcg(Ah, b, tol=1e-8, max_iters=max_iters, prec=prec), ())
        sp = A.to_scipy()
        bh = b.cpu().numpy()
        rel = float(np.linalg.norm(bh - sp @ xs.cpu().numpy()) / np.linalg.norm(bh))
        require(st.converged and rel <= 1e-7, f"{label}: {st}, host residual {rel}")
        return st, rel, counts, wall

    lap64 = lap.astype(torch.float64)
    b = vec(lap64.nrows, torch.float64)
    st, rel, counts, wall = solve("pcg lap1000", lap64, b, JacobiPrec(lap64), 20_000)
    require(counts["dia_spmv"] > 0, f"pcg lap1000: K1 not launched: {counts}")
    emit("main_pcg_lap1000_f64_jacobi", iters=st.num_iters, rel_res_host=rel, seconds=wall,
         us_per_iter=wall / st.num_iters * 1e6, launches=counts)
    jacobi = {"lap1000": (b, st.num_iters)}  # the GsPrec phases reuse b and compare counts

    xt = torch.from_numpy(rng.standard_normal(fem.nrows)).to(dev)
    bf = torch.from_numpy(fem.to_scipy() @ xt.cpu().numpy()).to(dev)
    st, rel, counts, wall = solve("pcg fem2d_30k", fem, bf, JacobiPrec(fem), 4000)
    require(counts["csr_spmv"] > 0, f"pcg fem2d_30k: K3 not launched: {counts}")
    emit("main_pcg_fem2d30k_f64_jacobi", iters=st.num_iters, rel_res_host=rel, seconds=wall,
         us_per_iter=wall / st.num_iters * 1e6, launches=counts)
    jacobi["fem2d_30k"] = (bf, st.num_iters)
    # ---- 3b. K4 and K5 against their plain versions, on the card ---------------
    def ilu0(A):
        """L, U of ILU(0) through the entry points a user calls."""
        hk = SpilukHandle(0)
        spiluk_symbolic(hk, A)
        return spiluk_numeric(hk, A)

    t0 = time.perf_counter()
    ilu = {"lap1000 f64": ilu0(lap64), "lap1000 f32": ilu0(lap), "fem2d_30k f64": ilu0(fem)}
    emit("ilu0_factors", seconds=time.perf_counter() - t0,
         nnz={k: [L.nnz, U.nnz] for k, (L, U) in ilu.items()})

    def hold_trsv(label, plan, b, src=None, dst=None):
        """K4 through the folded call a solve makes (b read through src, x
        written through dst) against its plain version on the same inputs:
        |x - x_plain| <= M(T)⁻¹·(40·eps·|T||x|) elementwise, M(T) the
        comparison matrix (ks.solve_error_bound of the plain version's
        level-order x, carried through dst)."""
        got = ks.sptrsv_levels(plan, b, src, dst)
        xl = ks.sptrsv_plain(plan, b, src)
        torch.cuda.synchronize()
        dt = b.dtype
        plain = ks.scatter_dst(xl, dst, b.shape[0])
        tol = ks.scatter_dst(ks.solve_error_bound(plan, xl), dst, b.shape[0])
        err = (got - plain).abs().double()
        ok = bool((err <= tol).all())
        errs["sptrsv_levels"] = max(errs["sptrsv_levels"], float(err.max()))
        emit("check", kernel="sptrsv_levels", case=label, dtype=str(dt),
             max_abs_err=float(err.max()), max_err_over_tol=float((err / tol.clamp_min(torch.finfo(tol.dtype).tiny)).max()),
             tol="M(T)^-1 (40*eps*|T||x|)_i", ok=ok)
        require(ok, f"sptrsv_levels {label} disagrees with its plain version")

    def hold_perm(label, src, xv):
        """K5 against its plain version (index_select): exactly equal."""
        got, ref = ks.permute_gather(src, xv), ks.permute_plain(src, xv)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref)
        err = float((got - ref).abs().max())
        errs["permute_gather"] = max(errs["permute_gather"], err)
        emit("check", kernel="permute_gather", case=label, dtype=str(xv.dtype), max_abs_err=err,
             tol="exact", ok=ok)
        require(ok, f"permute_gather {label} disagrees with its plain version")
        return got

    def residual_check(label, T, x, b):
        """|T·x - b| <= 20·eps·(|T|·|x|) elementwise, f64 product by scipy."""
        sp = T.to_scipy().astype(np.float64)
        xh, bh = x.double().cpu().numpy(), b.double().cpu().numpy()
        err = np.abs(sp @ xh - bh)
        tol = 20 * torch.finfo(x.dtype).eps * (abs(sp) @ np.abs(xh))
        ok = bool((err <= tol).all())
        emit("check_residual", case=label, dtype=str(x.dtype), max_abs_res=float(err.max()),
             max_res_over_tol=float((err / np.maximum(tol, 1e-300)).max()),
             tol="20*eps*(|T||x|)_i", ok=ok)
        require(ok, f"{label}: residual of the triangular solve too large")

    before = ks.launch_counts()
    trsv_plans = {}
    for label, (L, U) in ilu.items():
        for tri, lower, T in (("L", True, L), ("U", False, U)):
            hs = SptrsvHandle(lower=lower)
            sptrsv_symbolic(hs, T)
            trsv_plans[f"{label} {tri}"] = (hs, T)
            bp = vec2(T.nrows, T.dtype)
            hold_trsv(f"{label} ILU(0) {tri}, {hs.num_levels} levels, src = dst = order",
                      hs.plan, bp, hs.plan.order, hs.plan.order)
    perm1m = torch.from_numpy(rng2.permutation(1_000_000).astype(np.int32)).to(dev)
    for dt in (torch.float32, torch.float64):
        hold_perm("random permutation of 1,000,000", perm1m, vec2(1_000_000, dt))
    after = ks.launch_counts()
    require(all(after[k] > before[k] for k in after), f"a launch counter did not rise: {after}")
    emit("kernels_checked_trsv", launches=after)
    # a triangular solve is one K4 launch: b and x go through the level order in it
    for key, (hs, T) in trsv_plans.items():
        bt = vec2(T.nrows, T.dtype)
        xt_, counts, _ = counted(f"sptrsv_solve {key}", lambda: sptrsv_solve(hs, T, bt),
                                 ("sptrsv_levels",))
        require(counts["sptrsv_levels"] == 1 and sum(counts.values()) == 1,
                f"sptrsv_solve {key}: {counts}, not one K4 launch")
        residual_check(f"sptrsv_solve {key} ILU(0)", T, xt_, bt)

    # ---- 3c. the ILU(0)-GMRES path and the RCM route ---------------------------
    def host_rel(A, x, b):
        sp = A.to_scipy().astype(np.float64)
        bh = b.double().cpu().numpy()
        return float(np.linalg.norm(bh - sp @ x.double().cpu().numpy()) / np.linalg.norm(bh))

    gmres_needs = ("sptrsv_levels",)
    t = time.perf_counter()
    prec_f = LUPrec(*ilu["fem2d_30k f64"])
    setup_s = time.perf_counter() - t
    # one apply is two K4 launches (L, then U), the level orders folded in
    _, counts, _ = counted("LUPrec apply", lambda: prec_f.apply(vec2(fem.nrows, torch.float64)),
                           ("sptrsv_levels",))
    require(counts["sptrsv_levels"] == 2 and sum(counts.values()) == 2,
            f"LUPrec apply: {counts}, not two K4 launches")
    emit("main_luprec_apply", matrix="fem2d_30k f64 ILU(0)", launches=counts)
    bg = torch.from_numpy(np.random.default_rng(0).standard_normal(fem.nrows)).to(dev)
    hg = GmresHandle(m=50, tol=1e-8, max_restarts=150)
    (xg, stg), counts, wall = counted("gmres fem2d_30k", lambda: gmres(hg, fem, bg, prec=prec_f),
                                      ("csr_spmv", *gmres_needs))
    rel = host_rel(fem, xg, bg)
    require(stg.converged and rel <= 2e-8, f"gmres fem2d_30k: {stg}, host residual {rel}")
    require(counts["permute_gather"] == 0, f"gmres fem2d_30k: K5 launched {counts}")
    emit("main_gmres_ilu0_fem2d_30k", iters=stg.num_iters, tpukk_cpu_iters=3950,
         within_one_cycle_of_tpukk=abs(stg.num_iters - 3950) <= 50,
         rel_res_reported=stg.end_rel_res, rel_res_host=rel, seconds=wall,
         us_per_iter=wall / stg.num_iters * 1e6, luprec_setup_s=setup_s, launches=counts)

    prec_l = LUPrec(*ilu["lap1000 f64"])
    bl = vec2(lap64.nrows, torch.float64)
    cycles = {}
    for nc in (1, 2):
        hl = GmresHandle(m=50, tol=1e-8, max_restarts=nc)
        (xl, stl), counts, wall = counted(f"gmres lap1000 {nc} cycles",
                                          lambda: gmres(hl, lap64, bl, prec=prec_l),
                                          ("dia_spmv", *gmres_needs))
        cycles[nc] = (stl, host_rel(lap64, xl, bl), counts, wall)
    (st1, rel1, _, _), (st2, rel2, counts, wall) = cycles[1], cycles[2]
    require(abs(st2.end_rel_res - rel2) <= 1e-10 * rel2,
            f"gmres lap1000: reported residual {st2.end_rel_res}, host {rel2}")
    require(rel2 < rel1, f"gmres lap1000: cycle 2 residual {rel2} not below cycle 1's {rel1}")
    emit("main_gmres_ilu0_lap1000", iters=st2.num_iters, rel_res_reported=st2.end_rel_res,
         rel_res_host=rel2, rel_res_host_after_cycle_1=rel1, seconds=wall,
         us_per_iter=wall / st2.num_iters * 1e6, launches=counts)

    sp4 = (fem.to_scipy() + 4.0 * sps.identity(fem.nrows, format="csr")).astype(np.float32)
    A4 = CsrMatrix.from_scipy(sp4, device=dev)
    b4 = torch.from_numpy(np.random.default_rng(7).standard_normal(A4.nrows)
                          .astype(np.float32)).to(dev)
    require(_rcm_reorder(SpmvHandle(A4)) is not None, "reorder='auto' does not engage")
    rcm_runs = {}
    for mode, needs in (("rcm", ("csr_spmv", "permute_gather")), ("none", ("csr_spmv",)),
                        ("auto", ("csr_spmv", "permute_gather"))):
        hr4 = GmresHandle(m=40, tol=1e-6, reorder=mode)
        (xr4, st4), counts, wall = counted(f"gmres reorder={mode}",
                                           lambda: gmres(hr4, A4, b4), needs)
        rel4 = host_rel(A4, xr4, b4)
        require(st4.converged and rel4 <= 1e-5, f"gmres reorder={mode}: {st4}, host {rel4}")
        rcm_runs[mode] = dict(x=xr4.cpu().numpy(), iters=st4.num_iters, rel_res_host=rel4,
                              seconds=wall, launches=counts)
    require(rcm_runs["none"]["launches"]["permute_gather"] == 0, "reorder='none' permuted")
    agree = np.allclose(rcm_runs["rcm"]["x"], rcm_runs["none"]["x"], rtol=2e-3, atol=2e-4)
    require(agree, "gmres reorder='rcm' and 'none' disagree beyond rtol 2e-3 / atol 2e-4")
    emit("main_gmres_rcm", matrix="fem2d_30k + 4I f32, m=40, tol 1e-6", rcm_none_agree=agree,
         **{mode: {k: v for k, v in r.items() if k != "x"} for mode, r in rcm_runs.items()})

    # ---- 3d. K6 against its plain version on every color block ----------------
    def gs_handle(A, alg=GsAlgorithm.POINT, **kw):
        hh = GsHandle(alg, **kw)
        gauss_seidel_symbolic(hh, A)
        gauss_seidel_numeric(hh, A)
        return hh

    t0 = time.perf_counter()
    gs = {}
    for mlabel, A in (("fem2d_30k f64", fem), ("lap1000", lap64)):
        for alg in (GsAlgorithm.POINT, GsAlgorithm.CLUSTER):
            t = time.perf_counter()
            gs[(mlabel, alg.name)] = gs_handle(A, alg)
            emit("gs_setup", matrix=mlabel, algorithm=alg.name, seconds=time.perf_counter() - t,
                 colors=len(gs[(mlabel, alg.name)].color_offsets) - 1)
    emit("gs_handles", seconds=time.perf_counter() - t0)

    def hold_gs(label, blk, x, b, omega):
        """Block rows: |x - x_plain| <= 20·eps·(|1-ω||x| + |ω·invd|(|b| + |A_off||x|));
        every other row unchanged, exactly."""
        plain = kg.gs_color_step_plain(blk, x.clone(), b, omega)
        got = kg.gs_color_step(blk, x.clone(), b, omega)
        torch.cuda.synchronize()
        tol = kg.step_error_bound(blk, x, b, omega)
        s0, s1 = blk.start, blk.start + blk.nrows
        err = (got[s0:s1] - plain[s0:s1]).abs()
        ok = bool((err <= tol).all()) and torch.equal(got[:s0], x[:s0]) \
            and torch.equal(got[s1:], x[s1:])
        errs["gs_color_step"] = max(errs["gs_color_step"], float(err.max()))
        return ok, float(err.max()), float((err / tol.clamp_min(torch.finfo(tol.dtype).tiny)).max())

    before = kg.launch_counts()
    for (mlabel, alg), hh in gs.items():
        dts = (torch.float64,) if mlabel.startswith("fem") else (torch.float32, torch.float64)
        for dt in dts:
            blocks = [blk.to(dt) for blk in next(iter(hh._blocks.values()))]
            # a symmetric pattern's POINT blocks are uncoupled: K6 runs them in place
            require(alg == "CLUSTER" or not any(blk.coupled for blk in blocks),
                    f"{mlabel} {alg}: a POINT block is coupled")
            for k in (None, 8):
                worst = [True, 0.0, 0.0]
                for blk in blocks:
                    ok, e, r = hold_gs(f"{mlabel} {alg}", blk, vec(hh.order.shape[0], dt, k),
                                       vec(hh.order.shape[0], dt, k), 1.0)
                    worst = [worst[0] and ok, max(worst[1], e), max(worst[2], r)]
                emit("check", kernel="gs_color_step", case=f"{mlabel} {alg} every block, "
                     f"k={1 if k is None else k}", dtype=str(dt), blocks=len(blocks),
                     coupled=sum(b.coupled for b in blocks), max_abs_err=worst[1],
                     max_err_over_tol=worst[2],
                     tol="20*eps*(|1-w||x| + |w*invd|(|b| + |A_off||x|))_i", ok=worst[0])
                require(worst[0], f"gs_color_step {mlabel} {alg} disagrees with its plain version")
    require(kg.launch_counts()["gs_color_step"] > before["gs_color_step"], "K6 never launched")

    def hold_sweep(label, hh, dt, k):
        """K6's fused sweep, a symmetric sweep from x = 0 (a GsPrec apply) and
        two forward sweeps from a given x: equal to the per-color path (K5,
        fill, a gs_color_step launch per color step at the sweep's lanes, K5)
        bit for bit, and within 1000·eps·max|plain| of its plain version."""
        plan = _plan_in(hh, dt)
        b_, x_ = vec(plan.n, dt, k), vec(plan.n, dt, k)
        eps = torch.finfo(dt).eps
        for x0, direction, sweeps in ((None, "symmetric", 1), (x_, "forward", 2)):
            got = kg.gs_sweep(plan, x0, b_, hh.omega, direction, sweeps)
            per = kg.gs_sweep_per_color(plan, x0, b_, hh.omega, direction, sweeps)
            plain = kg.gs_sweep_plain(plan, x0, b_, hh.omega, direction, sweeps)
            torch.cuda.synchronize()
            equal = torch.equal(got, per)
            err = float((got - plain).abs().max())
            tol = 1000 * eps * float(plain.abs().max())
            errs["gs_sweep"] = max(errs["gs_sweep"], err)
            emit("check", kernel="gs_sweep", case=f"{label} {direction} x sweeps={sweeps}, "
                 f"x0 {'given' if x0 is not None else 'zero'}, k={1 if k is None else k}",
                 dtype=str(dt), steps=int(plan.steps(direction, sweeps, x0 is not None).host.shape[0]),
                 lanes=plan.csr.group, equal_to_per_color=equal,
                 max_abs_diff_vs_per_color=float((got - per).abs().max()), max_abs_err=err,
                 max_err_over_tol=err / tol, tol="1000*eps*max|plain|", ok=equal and err <= tol)
            require(equal, f"gs_sweep {label} {direction}: differs from the per-color path")
            require(err <= tol, f"gs_sweep {label} {direction}: disagrees with its plain version")

    before = kg.launch_counts()
    for (mlabel, alg), hh in gs.items():
        for dt in (torch.float32, torch.float64):
            for k in (None, 8):
                hold_sweep(f"{mlabel} {alg}", hh, dt, k)
    require(kg.launch_counts()["gs_sweep"] > before["gs_sweep"], "K6's fused sweep never launched")

    # ---- 3e. the Gauss-Seidel path: coloring, MIS2, sweeps, GsPrec-PCG --------
    coloring = {}
    for mlabel, A in (("fem2d_30k", fem), ("lap1000", lap)):
        for alg in (ColoringAlgorithm.SERIAL, ColoringAlgorithm.VB):
            c, counts, wall = counted(f"coloring {mlabel} {alg.name}",
                                      lambda: graph_color(A, alg), ())
            valid = verify_coloring(A, c)
            require(valid, f"coloring {mlabel} {alg.name} is not a distance-1 coloring")
            coloring[f"{mlabel} {alg.name}"] = dict(colors=int(c.max()), seconds=wall,
                                                    valid=valid, launches=counts)
    require(coloring["fem2d_30k VB"]["launches"]["csr_spmv"] > 0,
            "VB coloring of fem2d_30k did not gather through K3")
    emit("main_coloring", **coloring)

    roots, counts, wall = counted("mis2 fem2d_30k", lambda: graph_mis2(fem), ("csr_spmv",))
    t = time.perf_counter()
    labels = graph_mis2_aggregate(fem)
    agg_s = time.perf_counter() - t
    pat = fem.to_scipy()
    pat.data[:] = 1.0
    A2 = (pat @ pat + pat).tocsr()
    sub = A2[roots][:, roots]
    independent = bool(abs(sub - sps.diags(sub.diagonal())).sum() == 0)
    ind = np.zeros(fem.nrows)
    ind[roots] = 1.0
    maximal = bool(((A2 @ ind) > 0).all())
    require(independent and maximal, "mis2 fem2d_30k: not a maximal distance-2 set")
    require(labels.min() >= 0 and int(labels.max()) + 1 == len(roots), "mis2 aggregates")
    # each Luby round is one max and one sum launch of K3
    emit("main_mis2_fem2d30k", roots=len(roots), aggregates=int(labels.max()) + 1,
         independent=independent, maximal=maximal, seconds=wall, aggregate_s=agg_s,
         k3_max_launches=counts["csr_spmv"] // 2, k3_sum_launches=counts["csr_spmv"] // 2,
         launches=counts)

    # a POINT forward sweep at ω = 1 is GS in the color order: held to scipy's
    # triangular solve x_p = (D + L_p)⁻¹ (b_p − U_p·x_p)
    from scipy.sparse.linalg import spsolve_triangular

    hp = gs[("fem2d_30k f64", "POINT")]
    bs = torch.from_numpy(np.random.default_rng(11).standard_normal(fem.nrows)).to(dev)
    xs0 = torch.from_numpy(np.random.default_rng(12).standard_normal(fem.nrows)).to(dev)
    xs, counts, wall = counted("gs forward sweep", lambda: forward_sweep(hp, fem, xs0, bs),
                               ("gs_sweep",))
    require(counts["gs_sweep"] == 1 and counts["gs_color_step"] == 0
            and counts["permute_gather"] == 0, f"gs forward sweep: not one K6 launch: {counts}")
    o = hp.order
    Ap = fem.to_scipy()[o][:, o].tocsr()
    bh, x0h = bs.cpu().numpy(), xs0.cpu().numpy()
    ref = np.empty(fem.nrows)
    ref[o] = spsolve_triangular(sps.tril(Ap, k=0).tocsr(), bh[o] - sps.triu(Ap, k=1) @ x0h[o],
                                lower=True)
    oracle_err = float(np.abs(xs.cpu().numpy() - ref).max() / np.abs(ref).max())
    require(oracle_err <= 1e-11, f"gs forward sweep vs the triangular-solve oracle: {oracle_err}")
    sweeps = dict(point_forward_vs_oracle=oracle_err, oracle_tol="1e-11 relative (max norm)",
                  point_forward_launches=counts)
    fem_cpu = CsrMatrix.from_scipy(fem.to_scipy(), device="cpu")
    sp_fem = fem.to_scipy()
    for label, alg, kw in (("POINT", GsAlgorithm.POINT, {}),
                           ("CLUSTER", GsAlgorithm.CLUSTER, {}),
                           ("CLUSTER_BALLOON", GsAlgorithm.CLUSTER,
                            dict(clustering=ClusteringAlgorithm.BALLOON)),
                           ("TWOSTAGE", GsAlgorithm.TWOSTAGE, {})):
        hh = gs.get(("fem2d_30k f64", label)) or gs_handle(fem, alg, **kw)
        needs = ("gs_sweep",) if alg != GsAlgorithm.TWOSTAGE else ("csr_spmv",)
        res, xk = [], None
        for _ in range(5):
            xk, counts, wall = counted(f"gs {label} sweep",
                                       lambda: gauss_seidel_apply(hh, fem, xk, bs, 1), needs)
            res.append(float(np.linalg.norm(bh - sp_fem @ xk.cpu().numpy()) / np.linalg.norm(bh)))
            require(alg == GsAlgorithm.TWOSTAGE or (counts["gs_sweep"] == 1 and sum(counts.values()) == 1),
                    f"gs {label} sweep: not one K6 launch: {counts}")
        require(all(math.isfinite(r) for r in res), f"gs {label}: non-finite residual")
        # Balloon clusters (8 vertices, 3 inner Jacobi sweeps) diverge on this
        # matrix, in tpukk too (0.370, 3.37, 90.3 after 1-3 sweeps on the CPU)
        if label != "CLUSTER_BALLOON":
            require(res[-1] < res[0], f"gs {label}: 5 sweeps did not reduce the residual {res}")
        entry = dict(rel_res_after_1_to_5_sweeps=res, launches_per_sweep=counts)
        if label == "CLUSTER":
            # the same sweeps through the plain version on the CPU: catches a race
            hc = gs_handle(fem_cpu, alg, **kw)
            require(np.array_equal(hc.order, hh.order), f"gs {label}: CPU order differs")
            xc = gauss_seidel_apply(hc, fem_cpu, None, bs.cpu(), 5)
            diff = float((xk.cpu() - xc).abs().max() / xc.abs().max())
            require(diff <= 1e-12, f"gs {label}: card and plain sweeps differ by {diff}")
            entry.update(vs_plain_on_cpu=diff, vs_plain_tol="1e-12 relative (max norm)")
        sweeps[label] = entry
    emit("main_gs_sweep_fem2d30k", **sweeps)

    def gs_pcg(label, A, key, hh, phase):
        b_, jac_iters = jacobi[key]
        prec = GsPrec(hh, A)
        _, apply_counts, _ = counted(f"{label} one apply", lambda: prec.apply(b_), ("gs_sweep",))
        require(apply_counts["gs_sweep"] == 1 and sum(apply_counts.values()) == 1,
                f"{label}: a GsPrec apply is not one K6 launch: {apply_counts}")
        st, rel, counts, wall = solve(label, A, b_, prec, 2 * jac_iters)
        require(counts["gs_sweep"] > 0 and counts["gs_color_step"] == 0
                and counts["permute_gather"] == 0, f"{label}: not on the fused sweep: {counts}")
        require(st.num_iters < jac_iters,
                f"{label}: {st.num_iters} iterations, Jacobi {jac_iters}")
        emit(phase, iters=st.num_iters, jacobi_iters=jac_iters, rel_res_host=rel,
             seconds=wall, us_per_iter=wall / st.num_iters * 1e6, colors=len(hh.color_offsets) - 1,
             launches=counts, launches_per_gsprec_apply=apply_counts)

    gs_pcg("pcg gsprec fem2d_30k", fem, "fem2d_30k", hp, "main_pcg_gs_fem2d30k_f64")
    gs_pcg("pcg gsprec lap1000", lap64, "lap1000", gs[("lap1000", "POINT")],
           "main_pcg_gs_lap1000_f64")

    Xr = vec(rnd.ncols, torch.float32, 8)
    hr8 = SpmvHandle(rnd)
    hr8._plan("csr", torch.float32)
    Yr, counts, _ = counted("spmm rand100k k=8", lambda: spmm(rnd, Xr), ("csr_spmm",))
    require(hr8.algorithm == SpmvAlgorithm.ONEHOT, f"rand100k routed to {hr8.algorithm}")
    errs_mm = [host_check(rnd, Xr[:, j], Yr[:, j], "spmm rand100k") for j in range(8)]
    emit("main_spmm_rand100k", route="ONEHOT", k=8, launches=counts,
         max_abs_err_vs_scipy=max(errs_mm))

    htw = gs_handle(fem, GsAlgorithm.TWOSTAGE)
    Bt = vec(fem.nrows, torch.float64, 8)
    Xt, counts, wall = counted("gs twostage k=8", lambda: gauss_seidel_apply(htw, fem, None, Bt, 2),
                               ("csr_spmm",))
    col_diff = 0.0
    for j in range(8):
        xj = gauss_seidel_apply(htw, fem, None, Bt[:, j].contiguous(), 2)
        col_diff = max(col_diff, float((Xt[:, j] - xj).abs().max() / xj.abs().max()))
    require(col_diff <= 1e-12, f"twostage k=8: a column differs from its single apply: {col_diff}")
    emit("main_gs_twostage_multivector", matrix="fem2d_30k f64", k=8, sweeps=2, seconds=wall,
         max_rel_diff_vs_single_column=col_diff, tol="1e-12 relative (max norm)",
         launches=counts)

    # ---- 3f. the SpGEMM path: K8, SpgemmHandle with reuse, DIA, SA-AMG set-up,
    # SpADD, triangles; every product held to scipy in f64 on the host -------------
    def abs_product(sa, sb):
        """|A|·|B| in f64: C's exact structural pattern (scipy drops entries that
        cancel to 0 in A·B, never in |A|·|B|) and each entry's Σ|a·b|."""
        m = (abs(sa) @ abs(sb)).tocsr()
        m.sort_indices()
        return m

    def hold_scipy(label, C, ref, bound, k, dtype):
        """C's pattern equals bound's exactly; |C - ref| <= k·eps·bound per entry
        (k an array over C's entries, or a scalar)."""
        rm, ent = C.host_row_map(), C.host_entries()
        pattern = bool(np.array_equal(rm, bound.indptr) and np.array_equal(ent, bound.indices))
        require(pattern, f"{label}: pattern differs from scipy's structural product")
        Cs = sps.csr_matrix((C.values.double().cpu().numpy(), ent, rm), shape=C.shape)
        diff = abs(Cs - ref).tocsr()
        inv_tol = bound.copy()
        inv_tol.data = 1.0 / np.maximum(k * torch.finfo(dtype).eps * bound.data, 1e-300)
        ratio = diff.multiply(inv_tol).tocsr()
        worst = float(ratio.data.max(initial=0.0))
        require(ratio.nnz == diff.nnz and worst <= 1.0,
                f"{label}: values differ from scipy beyond the tolerance ({worst})")
        return dict(pattern_equal=pattern, max_abs_err_vs_scipy=float(diff.data.max(initial=0.0)),
                    max_err_over_tol=worst)

    def n_products(plan):
        """Products per C entry (the plain version's expansion, cached on the plan)."""
        return np.bincount(plan.expand()[2].cpu().numpy(), minlength=plan.nnz_c)

    def hold_k8(label, plan, a, b):
        """K8 equals its plain version bit for bit: both add each C entry's
        products from 0 in (A entry, B entry) order."""
        got, plain = ksg.spgemm_rows(plan, a, b), ksg.spgemm_rows_plain(plan, a, b)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max()) if plan.nnz_c else 0.0
        ok = bool(torch.equal(got, plain))
        errs["spgemm_rows"] = max(errs["spgemm_rows"], err)
        emit("check", kernel="spgemm_rows", case=label, dtype=str(a.dtype), bins=plan.bins,
             max_abs_err=err, tol="bit for bit", ok=ok)
        require(ok, f"spgemm_rows {label} differs from its plain version")

    spgemm_cases = {}
    oracles = {}
    t0 = time.perf_counter()
    for label, A, okey in (("lap1000 f32", lap, "lap1000"), ("lap1000 f64", lap64, "lap1000"),
                           ("rand100k_deg16 f32", rnd, "rand100k"),
                           ("fem2d_30k f64", fem, "fem2d_30k")):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        hh = SpgemmHandle(SpgemmAlgorithm.KK)
        spgemm_symbolic(hh, A, A)
        torch.cuda.synchronize()
        sym_s = time.perf_counter() - t
        handle_MB = (torch.cuda.memory_allocated(dev) - mem0) / 1e6
        plan = hh.row_plan
        require(plan is not None and hh.dia_plan is None, f"spgemm {label}: not on the row plan")
        C, counts, wall = counted(f"spgemm_numeric {label}", lambda: spgemm_numeric(hh, A, A),
                                  ("spgemm_rows",))
        if okey not in oracles:
            sa = A.to_scipy().astype(np.float64)
            ab = (sa @ sa).tocsr()
            ab.sort_indices()
            oracles[okey] = (ab, abs_product(sa, sa))
        ref, bound = oracles[okey]
        n_c = n_products(plan)
        vs = hold_scipy(f"spgemm {label}", C, ref, bound, n_c + 1, A.dtype)
        hold_k8(label, plan, A.values, A.values)
        A2 = A.with_values(2 * A.values)
        C2, counts2, wall2 = counted(f"spgemm_numeric reuse {label}",
                                     lambda: spgemm_numeric(hh, A2, A2), ("spgemm_rows",))
        exact = bool(torch.equal(C2.values, 4 * C.values))
        require(exact, f"spgemm {label}: numeric reuse with 2A is not exactly 4C")
        spgemm_cases[label] = (hh, A, C, int(n_c.sum()))
        plan._expand = None  # the plain version's expansion, rebuilt where a hold needs it
        emit("main_spgemm", case=label, symbolic_s=sym_s, handle_device_MB=handle_MB,
             nnz_c=plan.nnz_c, products=int(n_c.sum()), max_products_per_entry=int(n_c.max()),
             bins=plan.bins, numeric_ms=wall * 1e3, numeric_reuse_ms=wall2 * 1e3,
             reuse_2A_gives_exactly_4C=exact, tol="(n_c+1)*eps*(|A||A|)_c", launches=counts,
             launches_reuse=counts2, **vs)
    emit("main_spgemm_total", seconds=time.perf_counter() - t0)

    band = generate_banded_csr(1_000_000, 3, dtype=np.float64, seed=5, device=dev)
    t = time.perf_counter()
    hd = SpgemmHandle(SpgemmAlgorithm.KK)
    spgemm_symbolic(hd, band, band)
    sym_s = time.perf_counter() - t
    require(hd.dia_plan is not None, "banded A·A did not route to DIA")
    Cd, counts, wall = counted("spgemm dia", lambda: spgemm_numeric(hd, band, band), ())
    band2 = band.with_values(2 * band.values)
    Cd2, _, wall2 = counted("spgemm dia reuse", lambda: spgemm_numeric(hd, band2, band2), ())
    require(torch.equal(Cd2.values, 4 * Cd.values), "spgemm dia: reuse with 2A is not 4C")
    sb = band.to_scipy()
    ref = (sb @ sb).tocsr()
    ref.sort_indices()
    vs = hold_scipy("spgemm dia", Cd, ref, abs_product(sb, sb), 8, torch.float64)
    emit("main_spgemm_dia", matrix="generate_banded_csr(1_000_000, 3) f64, A·A",
         route="DIA (AUTO from KK)", symbolic_s=sym_s, numeric_ms=wall * 1e3,
         numeric_reuse_ms=wall2 * 1e3, reuse_2A_gives_exactly_4C=True, nnz_c=Cd.nnz,
         tol="8*eps*(|A||A|)_c", launches=counts, **vs)

    # smoothed aggregation: P = (I - ω D⁻¹ A)·P_tent, then A_c = Pᵀ·(A·P)
    t = time.perf_counter()
    agg = graph_mis2_aggregate(fem)
    n_agg = int(agg.max()) + 1
    size = np.bincount(agg, minlength=n_agg)
    pt_sp = sps.csr_matrix((1.0 / np.sqrt(size[agg]), agg, np.arange(fem.nrows + 1)),
                           shape=(fem.nrows, n_agg))
    P_tent = CsrMatrix.from_scipy(pt_sp, device=dev)
    sa = fem.to_scipy()
    dinv = 1.0 / sa.diagonal()
    omega = 2.0 / 3.0

    def sa_setup():
        hj = SpgemmHandle()
        spgemm_symbolic(hj, fem, P_tent)
        P = spgemm_jacobi(hj, fem, P_tent, omega, dinv)
        hap = SpgemmHandle()
        spgemm_symbolic(hap, fem, P)
        AP = spgemm_numeric(hap, fem, P)
        Pt = transpose(P)
        hc = SpgemmHandle()
        spgemm_symbolic(hc, Pt, AP)
        return P, AP, Pt, spgemm_numeric(hc, Pt, AP), hj, hap, hc

    (P, AP, Pt, Ac, hj, hap, hc), counts, wall = counted("sa-amg setup", sa_setup,
                                                         ("spgemm_rows",))
    for label, hs, L, R in (("sa A·P_tent", hj, fem, P_tent), ("sa A·P", hap, fem, P),
                            ("sa Pt·(A·P)", hc, Pt, AP)):
        hold_k8(label, hs.row_plan, L.values, R.values)
    dsa = sps.diags(dinv)
    p_ref = (pt_sp - omega * (dsa @ (sa @ pt_sp))).tocsr()
    p_bound = (abs(pt_sp) + omega * (abs(dsa) @ abs_product(sa, pt_sp))).tocsr()
    p_bound.sort_indices()
    max_pairs = int(np.diff(sa.indptr).max())
    checks = {"P": hold_scipy("sa P", P, p_ref, p_bound, max_pairs + 3, torch.float64)}
    sp_p = P.to_scipy()
    checks["A·P"] = hold_scipy("sa A·P", AP, sa @ sp_p, abs_product(sa, sp_p),
                               n_products(hap.row_plan) + 1, torch.float64)
    sp_pt, sp_ap = Pt.to_scipy(), AP.to_scipy()
    checks["Pt·(A·P)"] = hold_scipy("sa Pt·(A·P)", Ac, sp_pt @ sp_ap, abs_product(sp_pt, sp_ap),
                                    n_products(hc.row_plan) + 1, torch.float64)
    emit("main_sa_amg_setup", matrix="fem2d_30k f64", aggregates=n_agg, omega=omega,
         P_shape=list(P.shape), P_nnz=P.nnz, Ac_shape=list(Ac.shape), Ac_nnz=Ac.nnz,
         seconds=wall, seconds_with_aggregation=time.perf_counter() - t, launches=counts,
         checks=checks)

    rb = generate_random_csr(fem.nrows, fem.ncols, 7, seed=5, dtype=np.float64, device=dev)
    t = time.perf_counter()
    hadd = SpaddHandle()
    spadd_symbolic(hadd, fem, rb)
    add_sym_s = time.perf_counter() - t
    Cadd, counts, wall = counted("spadd", lambda: spadd_numeric(hadd, 2.0, fem, -0.5, rb), ())
    _, _, wall2 = counted("spadd reuse", lambda: spadd_numeric(hadd, 2.0, fem, -0.5, rb), ())
    sr = rb.to_scipy()
    add_bound = (2.0 * abs(sa) + 0.5 * abs(sr)).tocsr()
    add_bound.sort_indices()
    vs = hold_scipy("spadd", Cadd, (2.0 * sa - 0.5 * sr).tocsr(), add_bound, 1, torch.float64)
    emit("main_spadd", case="2*fem2d_30k - 0.5*random(30000, 7/row) f64", symbolic_s=add_sym_s,
         numeric_ms=wall * 1e3, numeric_reuse_ms=wall2 * 1e3, nnz_c=Cadd.nnz, tol="eps*(2|A| + 0.5|B|)_c", launches=counts, **vs)

    t = time.perf_counter()
    n_host = triangle_count(fem)
    host_s = time.perf_counter() - t
    t = time.perf_counter()
    tplan = build_triangle_plan(fem)
    plan_s = time.perf_counter() - t
    n_dev, counts, wall = counted("triangles on the card", lambda: triangle_count_device(tplan), ())
    unit = sa.copy()
    unit.data[:] = 1.0
    Lu = sps.tril(unit, k=-1).tocsr()
    n_scipy = int(round(float((Lu @ Lu).multiply(Lu).sum())))
    counts_agree = n_host == tplan.num_triangles == n_scipy == int(round(float(n_dev)))
    require(counts_agree, f"triangles: host {n_host}, plan {tplan.num_triangles}, "
            f"card {float(n_dev)}, scipy {n_scipy}")
    Lw = Lu.copy()
    Lw.sort_indices()
    Lw.data = np.random.default_rng(13).uniform(0.5, 2.0, Lw.nnz)
    per_row, _, wall_w = counted("weighted triangles", lambda: triangle_count_device(
        tplan, torch.from_numpy(Lw.data).to(dev), per_row=True), ())
    ref_w = np.asarray((Lw @ Lw).multiply(Lw).sum(axis=1)).ravel()
    w_err = float(np.abs(per_row.cpu().numpy() - ref_w).max() / np.abs(ref_w).max())
    require(w_err <= 1e-13, f"weighted triangles per row differ from scipy by {w_err}")
    emit("main_triangle", graph="fem2d_30k", triangles=n_host, host_cpp_s=host_s,
         plan_s=plan_s, device_count_ms=wall * 1e3, weighted_per_row_ms=wall_w * 1e3,
         host_plan_scipy_card_agree=counts_agree, weighted_per_row_rel_err=w_err,
         weighted_tol="1e-13 relative (max norm) vs ((W@W).*W)·1 in scipy")

    # ---- 3g. the factor-and-solve path: SUPERNODAL and imported factors on K4
    # and K5, PAR_ILUT, MDF, the ILU(k) refresh; every solve held to scipy --------
    def event_ms(fn, iters: int) -> float:
        """Mean ms per call over a host loop, bracketed by CUDA events: for a
        call that is not graph-capturable, or slow enough that the host loop
        does not matter."""
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    import scipy.sparse.linalg as spla

    from tpukk_torch.graph import permute_matrix
    from tpukk_torch.sparse import cholmod_raw_to_csr
    from tpukk_torch.sparse.sptrsv_supernodal import (FusedSupernodalPlan, _detect_supernodes,
                                                      build_supernodal_plan, supernodal_solve)

    def solve_vs_scipy(label, Tsp, x, b, lower, ref=None, c=40):
        """|x - x_ref| <= M(T)⁻¹·(c·eps·|T||x|) elementwise (M(T) the
        comparison matrix), in f64 on the host; x_ref = spsolve_triangular
        (c = 40), or another solve, each within 40 of the exact one (c = 80)."""
        T64 = Tsp.astype(np.float64).tocsr()
        xh, bh = x.double().cpu().numpy(), b.double().cpu().numpy()
        against = "spsolve_triangular in f64" if ref is None else "the batched plan"
        ref = spla.spsolve_triangular(T64, bh, lower=lower) if ref is None \
            else ref.double().cpu().numpy()
        Ta = abs(T64).tocsr()
        M = -Ta                      # the diagonal is stored: setdiag keeps the pattern
        M.setdiag(Ta.diagonal())
        tol = spla.spsolve_triangular(M, c * torch.finfo(x.dtype).eps * (Ta @ np.abs(xh)),
                                      lower=lower)
        ratio = float((np.abs(xh - ref) / np.maximum(tol, 1e-300)).max())
        require(ratio <= 1.0, f"{label}: x differs from {against} beyond M(T)^-1({c} eps |T||x|)"
                f" ({ratio})")
        return dict(max_abs_err=float(np.abs(xh - ref).max()), max_err_over_tol=ratio,
                    tol=f"M(T)^-1 ({c}*eps*|T||x|)_i vs {against}")

    def hold_dag(label, fp, b):
        """A fused supernodal solve's one K4 launch against its plain version
        on the same inputs: b read through src into the z-rows (the x-rows
        read the zero slot, src -1), x written from the x-rows through dst."""
        hold_trsv(f"{label}: supernodal DAG, {fp.num_rows_dag} rows, {fp.num_levels} levels, "
                  f"b through src (zero slot), x through dst", fp.plan, b.to(fp.dtype),
                  fp.src, fp.dst)

    t = time.perf_counter()
    lu = spla.splu(fem.to_scipy().tocsc())
    splu_s = time.perf_counter() - t
    sn_handles = {}
    for dt in (np.float32, np.float64):
        for tri, lower, F in (("L", True, lu.L), ("U", False, lu.U)):
            Tsp = F.tocsr().astype(dt)
            Tsp.sort_indices()
            Tsn = CsrMatrix.from_scipy(Tsp, device=dev)
            hs = SptrsvHandle(lower=lower)
            sptrsv_symbolic(hs, Tsn)
            t = time.perf_counter()
            hn = SptrsvHandle(lower=lower, algorithm=SptrsvAlgorithm.SUPERNODAL)
            sptrsv_symbolic(hn, Tsn)
            plan_s = time.perf_counter() - t
            sp = hn.sn_plan
            require(isinstance(sp, FusedSupernodalPlan) and sp.dtype == Tsn.dtype,
                    f"supernodal {tri} {dt}: not the DAG in {dt.__name__}")
            case = f"fem2d_30k SuperLU {tri} {dt.__name__}"
            bp = vec2(Tsn.nrows, Tsn.dtype)
            hold_trsv(f"{case} SEQLVLSCHD, {hs.num_levels} levels, src = dst = order", hs.plan, bp,
                      hs.plan.order, hs.plan.order)
            hold_dag(case, sp, vec2(Tsn.nrows, Tsn.dtype))
            bsn = vec2(Tsn.nrows, Tsn.dtype)
            xsn, counts, wall = counted(f"supernodal {tri} {dt.__name__}",
                                        lambda: sptrsv_solve(hn, Tsn, bsn), ("sptrsv_levels",))
            require(counts["sptrsv_levels"] == 1 and sum(counts.values()) == 1,
                    f"supernodal {tri}: {counts}, not one K4 launch")
            vs = solve_vs_scipy(f"supernodal {tri} {dt.__name__}", Tsp, xsn, bsn, lower)
            vq = solve_vs_scipy(f"seqlvlschd {tri} {dt.__name__}", Tsp,
                                sptrsv_solve(hs, Tsn, bsn), bsn, lower)
            entry = dict(case=case, nnz=Tsn.nnz,
                         point_levels=hs.num_levels, supernodes=sp.num_supernodes,
                         supernode_levels=sp.num_levels_sn, max_block=sp.max_block,
                         route="fused DAG, one K4 launch", plan_host_s=plan_s, splu_s=splu_s,
                         dag_rows=sp.num_rows_dag, dag_k4_levels=sp.num_levels,
                         dag_nnz_strict=int(sp.plan.cols.shape[0]),
                         us_per_solve=event_ms(lambda: sptrsv_solve(hn, Tsn, bsn), 20) * 1e3,
                         seqlvlschd_us_per_solve=event_ms(lambda: sptrsv_solve(hs, Tsn, bsn), 20)
                         * 1e3, seqlvlschd_max_err_over_tol=vq["max_err_over_tol"],
                         launches=counts, vs_scipy=vs)
            if dt == np.float64:
                # the batched plan (fused=False): the plain reference the f64 DAG is held to
                t = time.perf_counter()
                bpl = build_supernodal_plan(Tsp.indptr, Tsp.indices, Tsp.data, Tsn.nrows, lower,
                                            device=dev, fused=False)
                batched_s = time.perf_counter() - t
                xb = supernodal_solve(bpl, bsn)
                entry.update(batched_plan_host_s=batched_s, batched_levels=bpl.num_levels_sn,
                             batched_us_per_solve=event_ms(lambda: supernodal_solve(bpl, bsn), 3)
                             * 1e3,
                             batched_vs_scipy=solve_vs_scipy(f"batched {tri}", Tsp, xb, bsn, lower),
                             vs_batched=solve_vs_scipy(f"supernodal {tri} vs batched", Tsp, xsn,
                                                       bsn, lower, ref=xb, c=80))
                del bpl
            emit("main_supernodal_fem2d30k", **entry)
            sn_handles[(tri, dt)] = (hn, Tsn)

    t = time.perf_counter()
    slu = superlu_import(lu, SptrsvAlgorithm.SUPERNODAL, device=dev)
    import_s = time.perf_counter() - t
    # K5 at a 30,000-row permutation: the inverse of SuperLU's row pivoting,
    # which the imported solve no longer gathers (folded into K4's src)
    perm30k = torch.from_numpy(np.argsort(lu.perm_r).astype(np.int32)).to(dev)
    hold_perm("superlu row permutation of 30,000", perm30k, vec2(fem.nrows, torch.float64))

    fold_rng = np.random.default_rng(13)  # leaves rng2's later draws as they were

    def imported_apply(label, solver, first, second, before, after):
        """One apply: two K4 launches, no K5, and the bits of the K5, K4, K4,
        K5 composition it replaces."""
        bq = torch.from_numpy(fold_rng.standard_normal(fem.nrows)).to(dev)
        xq, counts, _ = counted(label, lambda: solver(bq), ("sptrsv_levels",))
        require(counts["sptrsv_levels"] == 2 and sum(counts.values()) == 2,
                f"{label}: {counts}, not two K4 launches")
        y = sptrsv_solve(*first, ks.permute_gather(before, bq))
        same = torch.equal(xq, ks.permute_gather(after, sptrsv_solve(*second, y)))
        require(same, f"{label}: differs from gather, solve, solve, gather")
        emit("main_imported_apply", case=label, launches=counts,
             equal_to_gathers_around_solves=same)

    imported_apply("superlu apply fem2d_30k f64", slu, (slu.Lh, slu.L), (slu.Uh, slu.U),
                   slu.inv_perm_r, slu.perm_c)
    hg2 = GmresHandle(m=2, tol=1e-8, max_restarts=5)
    (xs_, st_), counts, wall = counted("gmres superlu", lambda: gmres(hg2, fem, bg, prec=slu),
                                       ("csr_spmv", "sptrsv_levels"))
    rel = host_rel(fem, xs_, bg)
    require(st_.converged and st_.num_iters <= 2 and rel <= 1e-8
            and counts["permute_gather"] == 0,
            f"gmres with superlu_import: {st_}, host residual {rel}, {counts}")
    emit("main_supernodal_superlu_gmres", matrix="fem2d_30k f64", algorithm="SUPERNODAL",
         m=2, iters=st_.num_iters, rel_res_host=rel, import_s=import_s, seconds=wall,
         launches=counts)

    # a Cholesky factor L·√D of P·A·Pᵀ (SuperLU without pivoting, P a minimum
    # degree order of A + Aᵀ), packed in CHOLMOD's supernodal raw arrays on its
    # exact supernodes; (P·b)[i] = b[p_chol[i]], CHOLMOD's Perm
    t = time.perf_counter()
    sym = dict(diag_pivot_thresh=0.0, options=dict(SymmetricMode=True))
    p_chol = np.argsort(spla.splu(fem.to_scipy().tocsc(), permc_spec="MMD_AT_PLUS_A",
                                  **sym).perm_c)
    luc = spla.splu(fem.to_scipy()[p_chol][:, p_chol].tocsc(), permc_spec="NATURAL", **sym)
    n = fem.nrows
    require(np.array_equal(luc.perm_r, np.arange(n)) and np.array_equal(luc.perm_c, np.arange(n)),
            "cholesky: SuperLU pivoted")
    dpiv = luc.U.diagonal()
    require(bool((dpiv > 0).all()), "cholesky: a pivot is not positive")
    Lc = (luc.L @ sps.diags(np.sqrt(dpiv))).tocsc()
    Lc.sort_indices()
    chol_s = time.perf_counter() - t
    ccols = np.repeat(np.arange(n), np.diff(Lc.indptr))
    strict = Lc.indices > ccols
    sn_c = _detect_supernodes(Lc.indices[strict].astype(np.int64), ccols[strict], n, 64)
    super_ = np.r_[np.nonzero(np.r_[True, sn_c[1:] != sn_c[:-1]])[0], n]
    s_parts, x_parts, pi, px = [], [], [0], [0]
    for c0, c1 in zip(super_[:-1], super_[1:]):
        tail = Lc.indices[Lc.indptr[c0]:Lc.indptr[c0 + 1]]
        rows_k = np.r_[np.arange(c0, c1), tail[tail >= c1]]
        panel = np.zeros((c1 - c0, len(rows_k)))
        e0, e1 = Lc.indptr[c0], Lc.indptr[c1]
        panel[ccols[e0:e1] - c0, np.searchsorted(rows_k, Lc.indices[e0:e1])] = Lc.data[e0:e1]
        s_parts.append(rows_k)
        x_parts.append(panel.ravel())
        pi.append(pi[-1] + len(rows_k))
        px.append(px[-1] + panel.size)
    raw = dict(n=n, super_=super_, pi=np.array(pi), px=np.array(px),
               s=np.concatenate(s_parts), x=np.concatenate(x_parts))
    Lback, _ = cholmod_raw_to_csr(**raw)
    require(abs(Lback - Lc).max() == 0, "cholesky: the raw arrays do not give L back")
    for dt in (np.float32, np.float64):
        t = time.perf_counter()
        chol = cholmod_import(**raw, perm=p_chol, algorithm=SptrsvAlgorithm.SUPERNODAL,
                              value_dtype=dt, device=dev)
        import_s = time.perf_counter() - t
        require(isinstance(chol.Lh.sn_plan, FusedSupernodalPlan),
                f"cholmod {dt.__name__}: not on the DAG")
        for which, hh in (("L", chol.Lh), ("L^T", chol.Lth)):
            hold_dag(f"fem2d_30k Cholesky {which} {dt.__name__}", hh.sn_plan,
                     vec2(n, torch.float64))
        imported_apply(f"cholmod apply fem2d_30k {dt.__name__}", chol, (chol.Lh, chol.L),
                       (chol.Lth, chol.Lt), chol.perm, chol.inv_perm)
        st, rel, counts, wall = solve(f"pcg cholmod {dt.__name__}", fem, bf, chol, 200)
        require(counts["permute_gather"] == 0 and counts["sptrsv_levels"] > 0,
                f"pcg cholmod {dt.__name__}: {counts}")
        emit("main_cholmod_fem2d30k", case=f"MMD(A+A^T) + Cholesky L·sqrt(D), {dt.__name__}",
             nnz_L=Lc.nnz, supernodes=len(super_) - 1,
             supernode_levels=[chol.Lh.sn_plan.num_levels_sn, chol.Lth.sn_plan.num_levels_sn],
             route="fused DAG on K4", factor_s=chol_s,
             import_s=import_s, pcg_iters=st.num_iters, jacobi_iters=jacobi["fem2d_30k"][1],
             rel_res_host=rel, seconds=wall, launches=counts)

    # PAR_ILUT's synchronous Chow sweeps do not converge on this matrix (not
    # diagonally dominant), in tpukk as here, so GMRES says nothing of the
    # factors: the card's are held to the same numeric phase on the CPU (the
    # path the tests hold to tpukk), pattern exactly and values and residual
    # within 1e-8 (the card's segment sums add their terms in another order),
    # and the residual the device reports to the host's ‖A - L·U‖ on A's
    # pattern; two GMRES(50) cycles report that the factors do not precondition
    hpi = ParIlutHandle(fill_factor=2.0)
    t = time.perf_counter()
    par_ilut_symbolic(hpi, fem)
    Lp, Up = par_ilut_numeric(hpi, fem)
    ilut_s = time.perf_counter() - t
    hpc = ParIlutHandle(fill_factor=2.0)
    par_ilut_symbolic(hpc, fem_cpu)
    Lpc, Upc = par_ilut_numeric(hpc, fem_cpu)
    vs_cpu = {}
    for which, G, W in (("L", Lp, Lpc), ("U", Up, Upc)):
        g, w = G.to_scipy(), W.to_scipy()
        same = bool(np.array_equal(g.indptr, w.indptr) and np.array_equal(g.indices, w.indices))
        rel_v = float(abs(g - w).max() / abs(w).max())
        require(same and rel_v <= 1e-8,
                f"par_ilut {which}: card and CPU differ (pattern equal {same}, values {rel_v})")
        vs_cpu[which] = dict(nnz=g.nnz, pattern_equal=same, max_rel_err=rel_v)
    res_rel = abs(hpi.final_residual - hpc.final_residual) / hpc.final_residual
    require(hpi.num_iters == hpc.num_iters and res_rel <= 1e-8,
            f"par_ilut: card residual {hpi.final_residual} after {hpi.num_iters}, "
            f"CPU {hpc.final_residual} after {hpc.num_iters}")
    sa_ = fem.to_scipy()
    pat_ = sa_.copy()
    pat_.data[:] = 1.0
    res_host = float(sps.linalg.norm((sa_ - Lp.to_scipy() @ Up.to_scipy()).multiply(pat_))
                     / sps.linalg.norm(sa_))
    require(abs(res_host - hpi.final_residual) <= 1e-8 * hpi.final_residual,
            f"par_ilut: device residual {hpi.final_residual}, host {res_host}")
    hp2 = GmresHandle(m=50, tol=1e-8, max_restarts=2)
    (xp_, stp), counts, wall = counted("gmres par_ilut", lambda: gmres(hp2, fem, bg, prec=LUPrec(
        Lp, Up)), ("csr_spmv", *gmres_needs))
    rel = host_rel(fem, xp_, bg)
    require(math.isfinite(rel), f"gmres par_ilut: residual {rel}")
    emit("main_ilut_mdf_fem2d30k", part="PAR_ILUT fill_factor 2 -> LUPrec -> GMRES(50), 2 cycles",
         nnz_L=Lp.nnz, nnz_U=Up.nnz, factor_s=ilut_s, ilut_iters=hpi.num_iters,
         ilut_residual_device=hpi.final_residual, ilut_residual_host=res_host,
         ilut_residual_cpu=hpc.final_residual, residual_rel_err_vs_cpu=res_rel,
         factors_vs_cpu=vs_cpu, vs_cpu_tol="patterns equal, 1e-8 relative (max norm)",
         gmres_converged=stp.converged, iters=stp.num_iters, ilu0_iters=stg.num_iters,
         rel_res_host=rel, seconds=wall, us_per_iter=wall / stp.num_iters * 1e6,
         launches=counts)

    t = time.perf_counter()
    hm = MdfHandle()
    mdf_symbolic(hm, fem)
    order_s = time.perf_counter() - t
    Lm, Um = mdf_numeric(hm, fem)
    Bm = permute_matrix(fem, hm.permutation)
    bm = bg[torch.from_numpy(hm.permutation.astype(np.int64)).to(dev)]
    hm2 = GmresHandle(m=50, tol=1e-8, max_restarts=200)
    (xm_, stm), counts, wall = counted("gmres mdf", lambda: gmres(hm2, Bm, bm, prec=LUPrec(
        Lm, Um)), ("csr_spmv", *gmres_needs))
    rel = host_rel(Bm, xm_, bm)
    require(stm.converged and rel <= 2e-8, f"gmres mdf: {stm}, host residual {rel}")
    emit("main_ilut_mdf_fem2d30k", part="MDF order -> ILU(0) of A[p][:, p] -> LUPrec -> GMRES(50)",
         order_host_s=order_s, iters=stm.num_iters, ilu0_iters=stg.num_iters, rel_res_host=rel,
         seconds=wall, us_per_iter=wall / stm.num_iters * 1e6, launches=counts)

    h1 = SpilukHandle(1)
    spiluk_symbolic(h1, fem)
    t = time.perf_counter()
    rplan = build_iluk_refresh(h1, fem)
    rbuild_s = time.perf_counter() - t
    fem2 = fem.with_values(2 * fem.values)
    (lv, uv), counts, wall = counted("iluk refresh", lambda: spiluk_refresh(rplan, fem2.values),
                                     ("permute_gather",))
    Lr, Ur = refresh_to_csr(rplan, lv, uv)
    L2, U2 = spiluk_numeric(h1, fem2)
    rerr = max(float(abs(Lr.to_scipy() - L2.to_scipy()).max() / abs(L2.to_scipy()).max()),
               float(abs(Ur.to_scipy() - U2.to_scipy()).max() / abs(U2.to_scipy()).max()))
    require(rerr <= 1e-12, f"iluk refresh differs from spiluk_numeric(2A) by {rerr}")
    emit("main_ilut_mdf_fem2d30k", part="spiluk_refresh of ILU(1) with 2A", depth=h1.depth,
         level_schedule=rplan.levels is not None, build_s=rbuild_s, refresh_ms=wall * 1e3,
         refresh_ms_again=event_ms(lambda: spiluk_refresh(rplan, fem2.values), 5),
         max_rel_err_vs_spiluk_numeric=rerr, tol="1e-12 relative (max norm)", launches=counts)

    # ---- 3h. the gather-table probe (K9) ----------------------------------------
    import importlib.util

    spec = importlib.util.spec_from_file_location("probe_ss_cost_torch",
                                                  ROOT / "scripts" / "probe_ss_cost_torch.py")
    probe_drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_drv)
    res, counts, wall = counted("probe", lambda: probe_drv.probe(device=dev), ("probe_gather_acc",))
    emit("main_probe_ss_cost", n_ss=probe_drv.N_SS, B=list(probe_drv.BS),
         chain_steps=list(probe_drv.KS), seconds=wall, launches=counts, **res)
    probe_plans = {}
    for variant in probe_drv.VARIANTS:
        for B in probe_drv.BS:
            plan, x0 = probe_drv.make_plan(variant, probe_drv.N_SS, B, dev)
            got, plain = kp.probe_gather_acc(plan, x0), kp.probe_plain(plan, x0)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            errs["probe_gather_acc"] = max(errs["probe_gather_acc"], err)
            emit("check", kernel="probe_gather_acc", case=f"{variant} B={B} n_ss={probe_drv.N_SS}",
                 dtype="torch.float32", max_abs_err=err, max_abs_y=float(plain.abs().max()),
                 tol="1e-5 absolute", ok=err <= 1e-5)
            require(err <= 1e-5, f"probe_gather_acc {variant} B={B} disagrees with its plain version")
            probe_plans[(variant, B)] = (plan, x0)

    # K6's two entries are one kernel: the path runs the fused sweep, the
    # per-color step is its yardstick (and the distributed sweep's step)
    path = {k: v for k, v in total.items() if k != "gs_color_step"}
    path["gs_sweep"] += total["gs_color_step"]
    require(all(v > 0 for v in path.values()), f"a kernel of the path never ran: {total}")
    emit("main_path_launches", launches=total)

    # ---- 4. timing: kernel, plain version, cuSPARSE, bound --------------------
    def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
        tb, tf = nbytes / bw, flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    def rotating(fns):
        ring = itertools.cycle(fns)
        return lambda: next(ring)()

    def sparse_csr(A, dt, copy: bool):
        arrs = [A.row_map, A.entries, A.values.to(dt)]
        return torch.sparse_csr_tensor(*[a.clone() if copy else a for a in arrs], A.shape,
                                       check_invariants=False)

    def timed(label, A, make, nbytes, flops, dt, spmv=True, **extra):
        """make(i) -> (kernel, plain, library) calls on copy i of the inputs.
        Copy 0 alone, called again and again, is read partly from L2 when it
        fits there; a ring of copies three times the L2 gives the cold time."""
        kern, plain, lib = make(0)
        ms = chain_time_slope(kern) * 1e3
        plain_ms = chain_time_slope(plain) * 1e3
        library_ms = chain_time_slope(lib) * 1e3
        ring = [make(i) for i in range(max(2, math.ceil(3 * L2_BYTES / nbytes)))]
        ms_cold = chain_time_slope(rotating([r[0] for r in ring])) * 1e3
        library_ms_cold = chain_time_slope(rotating([r[2] for r in ring])) * 1e3
        del ring
        b_ms, by = bound_ms(nbytes, flops, dt)
        row = dict(case=label, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                   bound_by=by, working_set_MB=nbytes / 1e6, ms_l2_cold=ms_cold,
                   library_ms_l2_cold=library_ms_cold, **extra)
        if spmv:
            row["useful_csr_GBps"] = csr_bytes(A, torch.finfo(dt).bits // 8) / (ms * 1e-3) / 1e9
            row["useful_csr_GBps_l2_cold"] = (csr_bytes(A, torch.finfo(dt).bits // 8)
                                              / (ms_cold * 1e-3) / 1e9)
        emit("timing", **row)
        return row

    def dia_make(A, plan, xx, fn):
        def make(i):
            p = plan if i == 0 else dataclasses.replace(plan, diags=plan.diags.clone())
            xi = xx if i == 0 else xx.clone()
            S = sparse_csr(A, plan.diags.dtype, i > 0)
            return (lambda: fn(p, xi)), (lambda: kc.dia_plain(p, xi)), (lambda: S.matmul(xi))
        return make

    def csr_make(A, cp, xx):
        def make(i):
            c = cp if i == 0 else dataclasses.replace(
                cp, row_map=cp.row_map.clone(), entries=cp.entries.clone(),
                values=cp.values.clone(), tiles=cp.tiles.clone())
            xi = xx if i == 0 else xx.clone()
            S = sparse_csr(A, cp.values.dtype, i > 0)
            return (lambda: kc.csr_spmv(c, xi)), (lambda: kc.csr_plain(c, xi)), \
                (lambda: S.matmul(xi))
        return make

    isz = 4
    plan = h._plan("dia", torch.float32)
    ndg = len(plan.offsets)
    t_k1 = timed("K1 dia_spmv lap1000 f32 (flagship)", lap, dia_make(lap, plan, x, kc.dia_spmv),
                 (ndg + 2) * lap.nrows * isz, 2 * lap.nnz, torch.float32)
    # the handle call as a user makes it, Python and all, with no graph
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(10):
        h(x)
    ev0.record()
    for _ in range(200):
        h(x)
    ev1.record()
    ev1.synchronize()
    emit("timing_handle_call", case="SpmvHandle(lap1000, AUTO)(x), host loop, no graph",
         us_per_call=ev0.elapsed_time(ev1) / 200 * 1e3)

    plan64 = build_dia_plan(lap, dtype=torch.float64)
    timed("K1 dia_spmv lap1000 f64 (PCG route)", lap,
          dia_make(lap, plan64, x.double(), kc.dia_spmv), (ndg + 2) * lap.nrows * 8,
          2 * lap.nnz, torch.float64)

    t_k2 = timed("K2 dia_spmm lap1000 f32 k=8", lap, dia_make(lap, plan, X, kc.dia_spmm),
                 ndg * lap.nrows * isz + 2 * 8 * lap.nrows * isz, 2 * 8 * lap.nnz,
                 torch.float32, spmv=False)

    def k3_row(label, A, dt):
        cp = kc.build_csr_plan(A, dt)
        sz = torch.finfo(dt).bits // 8
        nbytes = (A.nrows + 1) * 4 + A.nnz * (4 + sz) + (A.ncols + A.nrows) * sz
        return timed(f"K3 csr_spmv {label}", A, csr_make(A, cp, vec(A.ncols, dt)),
                     nbytes, 2 * A.nnz, dt, tiles=int(cp.tiles.shape[0]),
                     tile_entries=kc.csr_tile_entries(cp.streamed), tile_rows=kc.TILE_ROWS,
                     mode="stream" if cp.streamed else "direct", long_rows=cp.long_rows)

    t_k3 = k3_row("rand100k_deg16 f32 (AUTO route)", rnd, torch.float32)
    k3_row("lap1000 f32 (pinned ONEHOT)", lap, torch.float32)
    k3_row("fem2d_30k f64 (PCG route)", fem, torch.float64)
    k3_row("fem2d_30k + 4I f32 (f32 GMRES route)",
           CsrMatrix.from_scipy((fem.to_scipy() + 4 * sps.identity(fem.nrows)).tocsr(),
                                device=dev), torch.float32)
    # K3's floor: 256 rows of one entry, the fixed cost of a launch
    k3_row("floor: 256 rows of one entry f32",
           CsrMatrix.from_scipy(sps.identity(256, format="csr"), device=dev), torch.float32)

    # K4 / K5: CUDA-event slope over CUDA graphs like K1-K3; K4's plain version
    # launches a few kernels per level, so its graphs hold fewer calls
    def timed_kernel(label, make, nbytes, flops, dt, kk, plain_kk, library_ms, **extra):
        """make(i) -> (kernel, plain) calls on copy i of the inputs; L2-warm
        on copy 0, L2-cold on a ring of copies three times the L2."""
        kern, plain = make(0)
        ms = chain_time_slope(kern, *kk) * 1e3
        plain_ms = chain_time_slope(plain, *plain_kk, reps=3) * 1e3
        ring = [make(i)[0] for i in range(max(2, math.ceil(3 * L2_BYTES / nbytes)))]
        ms_cold = chain_time_slope(rotating(ring), *kk) * 1e3
        del ring
        b_ms, by = bound_ms(nbytes, flops, dt)
        row = dict(case=label, ms=ms, ms_l2_cold=ms_cold, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=b_ms, bound_by=by,
                   working_set_MB=nbytes / 1e6, **extra)
        emit("timing", **row)
        return row

    # the chain's floor: a unit lower-bidiagonal triangle of 262,144 rows has
    # one row per level, so K4's time over its rows is one level's cost
    nfl = 262_144
    rm_fl = np.r_[0, np.arange(1, 2 * nfl, 2)]
    ent_fl = np.r_[0, np.stack([np.arange(nfl - 1), np.arange(1, nfl)], 1).ravel()]
    val_fl = np.r_[1.0, np.tile([-0.5, 1.0], nfl - 1)]
    floor_us = {}
    for dt in (torch.float64, torch.float32):
        fl = ks.build_level_plan(rm_fl, ent_fl, val_fl.astype(str(dt).replace("torch.", "")), nfl,
                                 np.arange(1, nfl + 1), True, dev)
        bfl = vec2(nfl, dt)
        ms = event_ms(lambda: ks.sptrsv_levels(fl, bfl), 3)
        floor_us[dt] = ms * 1e3 / nfl
        emit("timing_k4_floor", case=f"K4 unit lower-bidiagonal, {nfl} rows = levels, {dt}",
             ms=ms, us_per_level=floor_us[dt])
        del fl

    def k4_row(label, plan, src, dst, n_out, kk, plain_kk, lib_T, upper, solve, **extra):
        """K4 through the folded call a solve makes (b read through src, x
        written through dst).  Bound: rowptr, cols, vals, invd, src and dst
        read once, b read and x written once; chain_bound_ms: levels x the
        bidiagonal floor."""
        dt = plan.dtype
        sz, N, nnz = torch.finfo(dt).bits // 8, plan.n, plan.cols.shape[0]
        bp = vec2(n_out, dt)

        def make(i):
            if i == 0:
                return (lambda: ks.sptrsv_levels(plan, bp, src, dst)), \
                    (lambda: ks.sptrsv_plain(plan, bp, src, dst))
            p = dataclasses.replace(
                plan, rowptr=plan.rowptr.clone(), cols=plan.cols.clone(),
                vals=plan.vals.clone(), invd=plan.invd.clone(), words=plan.words.clone(),
                state=plan.state.clone(), _rows=None)
            si, di = (None if a is None else a.clone() for a in (src, dst))
            bi = bp.clone()
            return (lambda: ks.sptrsv_levels(p, bi, si, di)), \
                (lambda: ks.sptrsv_plain(p, bi, si, di))

        # torch's one call for x = T⁻¹b (sparse CSR T, cuSPARSE), natural order
        tri = torch.sparse_csr_tensor(lib_T.row_map, lib_T.entries, lib_T.values, lib_T.shape)
        b2 = vec2(lib_T.nrows, dt).reshape(-1, 1)
        try:
            lib_ms, lib_err = event_ms(lambda: torch.triangular_solve(b2, tri, upper=upper), 3), \
                None
        except (RuntimeError, NotImplementedError) as e:  # the yardstick only
            lib_ms, lib_err = None, str(e)[:200]
        nbytes = ((N + 1) * 4 + nnz * (4 + sz) + N * sz + 2 * n_out * sz
                  + 4 * N * ((src is not None) + (dst is not None)))
        lv = plan.num_levels
        row = timed_kernel(label, make, nbytes, 2 * nnz + 2 * N, dt, kk, plain_kk, lib_ms,
                           levels=lv, rows=N, nnz_strict=nnz,
                           chain_bound_ms=lv * floor_us[dt] * 1e-3,
                           library="torch.triangular_solve(b, T_csr), natural order",
                           library_error=lib_err, solve_ms=event_ms(solve, 20), **extra)
        row.update(us_per_level=row["ms"] * 1e3 / lv,
                   us_per_level_l2_cold=row["ms_l2_cold"] * 1e3 / lv)
        emit("timing_k4_per_level", case=label, levels=lv, us_per_level=row["us_per_level"],
             us_per_level_l2_cold=row["us_per_level_l2_cold"], solve_ms=row["solve_ms"],
             floor_us_per_level=floor_us[dt])
        return row

    def ilu_row(key, kk, plain_kk):
        hs, T = trsv_plans[key]
        return k4_row(f"K4 sptrsv_levels {key} ILU(0), src = dst = order", hs.plan,
                      hs.plan.order, hs.plan.order, T.nrows, kk, plain_kk, T, not hs.lower,
                      lambda: sptrsv_solve(hs, T, vec_solve[key]))

    vec_solve = {k: vec2(T.nrows, T.dtype) for k, (_, T) in trsv_plans.items()}
    t_k4 = ilu_row("lap1000 f64 L", (2, 6), (1, 3))
    for key in ("lap1000 f64 U", "lap1000 f32 L", "lap1000 f32 U"):
        ilu_row(key, (2, 6), (1, 3))
    for key in ("fem2d_30k f64 L", "fem2d_30k f64 U"):
        ilu_row(key, (20, 100), (5, 25))
    for (tri, ndt), (hn, T) in sn_handles.items():
        fp = hn.sn_plan
        bn = vec2(T.nrows, T.dtype)
        k4_row(f"K4 sptrsv_levels fem2d_30k SuperLU {tri} {ndt.__name__}, supernodal DAG, b "
               f"through src, x through dst", fp.plan, fp.src, fp.dst, fp.n, (10, 50), (2, 6), T,
               tri == "U", lambda: sptrsv_solve(hn, T, bn), dag_rows=fp.num_rows_dag,
               supernode_levels=fp.num_levels_sn)

    def k5_row(label, src, dt):
        n, sz = src.shape[0], torch.finfo(dt).bits // 8
        xx = vec2(n, dt)

        def make(i):
            si = src if i == 0 else src.clone()
            xi = xx if i == 0 else xx.clone()
            return (lambda: ks.permute_gather(si, xi)), (lambda: ks.permute_plain(si, xi))

        lib = lambda: torch.index_select(xx, 0, src)  # noqa: E731
        return timed_kernel(f"K5 permute_gather {label}", make, n * (4 + 2 * sz), 0, dt,
                            (50, 250), (50, 250), chain_time_slope(lib) * 1e3,
                            library="torch.index_select(x, 0, src)")

    t_k5 = k5_row("random permutation of 1,000,000, f64", perm1m, torch.float64)
    k5_row("random permutation of 1,000,000, f32", perm1m, torch.float32)
    k5_row("superlu row permutation of 30,000, f64", perm30k, torch.float64)

    def k6_row(label, blk, n):
        cp = blk.csr
        dt, sz = cp.values.dtype, torch.finfo(cp.values.dtype).bits // 8
        xx, bb = vec(n, dt), vec(n, dt)
        nnz = cp.entries.shape[0]
        gathered = int(torch.unique(cp.entries).shape[0])
        nbytes = (blk.nrows + 1) * 4 + nnz * (4 + sz) + 4 * blk.nrows * sz + gathered * sz

        def make(i):
            bi = blk if i == 0 else dataclasses.replace(
                blk, inv_diag=blk.inv_diag.clone(), csr=dataclasses.replace(
                    cp, row_map=cp.row_map.clone(), entries=cp.entries.clone(),
                    values=cp.values.clone(), _rows=None))
            xi, b_i = (xx, bb) if i == 0 else (xx.clone(), bb.clone())
            # a coupled block writes into a buffer kept across steps, as a sweep does
            si = torch.empty(blk.nrows, dtype=dt, device=dev) if blk.coupled else None
            return (lambda: kg.gs_color_step(bi, xi, b_i, 1.0, si)), \
                (lambda: kg.gs_color_step_plain(bi, xi, b_i, 1.0))

        return timed_kernel(f"K6 gs_color_step {label}", make, nbytes, 2 * nnz + 5 * blk.nrows,
                            dt, (50, 250), (10, 50), None,
                            library="none: no single torch call computes the fused step",
                            rows=blk.nrows, nnz=nnz, lanes=cp.group, in_place=not blk.coupled)

    lap_blocks = next(iter(gs[("lap1000", "POINT")]._blocks.values()))
    fem_blocks = next(iter(hp._blocks.values()))
    k6_row("lap1000 f64 POINT color 1 (in place)", lap_blocks[0], lap64.nrows)
    k6_row("fem2d_30k f64 POINT color 1 (in place)", fem_blocks[0], fem.nrows)
    cl_blocks = next(iter(gs[("fem2d_30k f64", "CLUSTER")]._blocks.values()))
    k6_row("fem2d_30k f64 CLUSTER largest color (out of place)",
           max(cl_blocks, key=lambda b: b.nrows), fem.nrows)

    # K6's step floor: a lower-bidiagonal matrix of 16,384 rows, each row its
    # own color block, swept forward: one row a step, so the time over the
    # steps is one step's publish-and-observe cost
    nfl6 = 16_384
    fl6 = kg.build_gs_sweep_plan(np.r_[0, np.arange(nfl6)], np.arange(nfl6 - 1),
                                 np.full(nfl6 - 1, -0.5), np.ones(nfl6), np.arange(nfl6 + 1),
                                 np.arange(nfl6), dev)
    bfl6 = vec(nfl6, torch.float64)
    require(torch.equal(kg.gs_sweep(fl6, None, bfl6, 1.0, "forward"),
                        kg.gs_sweep_plain(fl6, None, bfl6, 1.0, "forward")),
            "gs_sweep on the step-floor plan disagrees with its plain version")
    floor6_us = event_ms(lambda: kg.gs_sweep(fl6, None, bfl6, 1.0, "forward"), 3) * 1e3 / nfl6
    emit("timing_k6_floor", case=f"K6 gs_sweep, lower-bidiagonal, {nfl6} one-row steps, f64",
         us_per_step=floor6_us)
    del fl6

    def k6_sweep_row(label, hh):
        """One symmetric sweep from x = 0, as GsPrec applies it, f64.  Bound:
        the matrix's CSR, 1/diag, b and order read once, x written once;
        sweep_bytes_ms: what the step chain moves (each step's block CSR,
        1/diag, b rows, x rows read and written, and its distinct neighbour
        values); step_bound_ms: steps x the floor."""
        plan = _plan_in(hh, torch.float64)
        n, nnz, sz = plan.n, plan.csr.entries.shape[0], 8
        host = plan.steps("symmetric", 1, False).host
        bb = vec(n, torch.float64)
        sweep_bytes = 0
        for begin, end, mode, *_ in host.tolist():
            if mode in (kg.IN_PLACE, kg.TO_SCRATCH):
                p0, p1 = int(plan.csr.row_map[begin]), int(plan.csr.row_map[end])
                gathered = int(torch.unique(plan.csr.entries[p0:p1]).shape[0])
                sweep_bytes += ((end - begin + 1) * 4 + (p1 - p0) * (4 + sz) + 4 * (end - begin) * sz
                                + gathered * sz)
            else:
                sweep_bytes += 3 * (end - begin) * sz
        nbytes = (n + 1) * 4 + nnz * (4 + sz) + 3 * n * sz + 4 * n

        def make(i):
            p = plan if i == 0 else dataclasses.replace(
                plan, csr=dataclasses.replace(plan.csr, row_map=plan.csr.row_map.clone(),
                                              entries=plan.csr.entries.clone(),
                                              values=plan.csr.values.clone(), _rows=None),
                inv_diag=plan.inv_diag.clone(), order=plan.order.clone(), _blocks=None,
                _steps={}, _bufs={})
            bi = bb if i == 0 else bb.clone()
            kg.gs_sweep(p, None, bi, hh.omega)  # the copy's step list and buffers, before capture
            return (lambda: kg.gs_sweep(p, None, bi, hh.omega)), \
                (lambda: kg.gs_sweep_plain(p, None, bi, hh.omega))

        per_color_ms = chain_time_slope(
            lambda: kg.gs_sweep_per_color(plan, None, bb, hh.omega), 10, 50) * 1e3
        steps = host.shape[0]
        return timed_kernel(f"K6 gs_sweep {label}, symmetric sweep from x = 0", make, nbytes,
                            4 * nnz + 10 * n, torch.float64, (20, 100), (2, 6), None,
                            library="none: no single torch call computes a Gauss-Seidel sweep",
                            steps=steps, colors=len(plan.offsets) - 1, lanes=plan.csr.group,
                            chunk_rows=plan.chunk_rows, sweep_bytes_MB=sweep_bytes / 1e6,
                            sweep_bytes_ms=sweep_bytes / bw * 1e3,
                            step_bound_ms=steps * floor6_us * 1e-3, floor_us_per_step=floor6_us,
                            per_color_path_ms=per_color_ms,
                            per_color_path="K5, fill, a gs_color_step launch per step, K5")

    t_k6 = k6_sweep_row("lap1000 f64 POINT", gs[("lap1000", "POINT")])
    k6_sweep_row("fem2d_30k f64 POINT", hp)
    k6_sweep_row("fem2d_30k f64 CLUSTER", gs[("fem2d_30k f64", "CLUSTER")])

    def k7_row(label, A, dt, k, XX=None):
        cp = kc.build_csr_plan(A, dt)
        sz = torch.finfo(dt).bits // 8
        XX = vec(A.ncols, dt, k) if XX is None else XX

        def make(i):
            c = cp if i == 0 else dataclasses.replace(
                cp, row_map=cp.row_map.clone(), entries=cp.entries.clone(),
                values=cp.values.clone(), _rows=None)
            Xi = XX if i == 0 else XX.clone()
            S = sparse_csr(A, dt, i > 0)
            return (lambda: kc.csr_spmm(c, Xi)), (lambda: kc.csr_spmm_plain(c, Xi)), \
                (lambda: S.matmul(Xi))

        nbytes = (A.nrows + 1) * 4 + A.nnz * (4 + sz) + (A.ncols + A.nrows) * k * sz
        g = kc.spmm_geometry(A.nnz / A.nrows, A.nrows, k, sz, XX.data_ptr() % 16)
        return timed(f"K7 csr_spmm {label} k={k}", A, make, nbytes, 2 * A.nnz * k, dt,
                     spmv=False, vec=g.vec, cols=g.cols, slots=g.slots)

    t_k7 = k7_row("rand100k_deg16 f32 (spmm, ONEHOT route)", rnd, torch.float32, 8)
    k7_row("fem2d_30k f64", fem, torch.float64, 4)
    k7_row("fem2d_30k strict lower f64 (TWOSTAGE inner SpMM)", fem_lower, torch.float64, 8,
           X_lower)

    def k8_row(key, kk, plain_kk):
        """Bound: the compulsory bytes of C = A·A (A's CSR read once, C's row map
        and columns read once, C's values written once); own_MB: what K8's
        design moves (A once, the B row of each A entry once, its two row-map
        words included, C's pattern and values once, the row order)."""
        hh, A, C, products = spgemm_cases[key]
        plan, dt = hh.row_plan, A.dtype
        sz = torch.finfo(dt).bits // 8
        nbytes = (A.nrows + 1) * 4 + A.nnz * (4 + sz) + (C.nrows + 1) * 4 + C.nnz * (4 + sz)
        own_bytes = ((A.nrows + 1) * 4 + A.nnz * (4 + sz) + A.nnz * 8 + products * (4 + sz)
                     + (C.nrows + 1) * 4 + C.nnz * (4 + sz) + plan.order.numel() * 4)

        def make(i):
            p = plan if i == 0 else dataclasses.replace(
                plan, **{f: getattr(plan, f).clone() for f in (
                    "a_row_map", "a_entries", "b_row_map", "b_entries", "c_row_map",
                    "c_entries", "order")}, _expand=None)
            ai = A.values if i == 0 else A.values.clone()
            return (lambda: ksg.spgemm_rows(p, ai, ai)), (lambda: ksg.spgemm_rows_plain(p, ai, ai))

        S = sparse_csr(A, dt, False)
        try:
            lib_ms, lib_err = event_ms(lambda: S @ S, 3), None
        except (RuntimeError, NotImplementedError) as e:  # the yardstick only
            lib_ms, lib_err = None, str(e)[:200]
        row = timed_kernel(f"K8 spgemm_rows {key} A·A", make, nbytes, 2 * products, dt, kk,
                           plain_kk, lib_ms,
                           library="torch.sparse_csr_tensor(A) @ torch.sparse_csr_tensor(A) "
                                   "(cuSPARSE SpGEMM, its symbolic phase included)",
                           library_error=lib_err, compulsory_MB=nbytes / 1e6,
                           own_MB=own_bytes / 1e6, own_bound_ms=own_bytes / bw * 1e3,
                           nnz_c=plan.nnz_c, products=products, bins=plan.bins)
        plan._expand = None
        return row

    t_k8 = k8_row("lap1000 f32", (10, 50), (2, 6))
    k8_row("lap1000 f64", (10, 50), (2, 6))
    k8_row("rand100k_deg16 f32", (10, 50), (2, 6))
    k8_row("fem2d_30k f64", (50, 250), (5, 25))
    del spgemm_cases

    def k9_row(variant, B):
        """Bound: the streamed index and value rows, src, dst and first read
        once, x read once and y written once."""
        plan, x0 = probe_plans[(variant, B)]
        nbytes = (plan.stream_bytes() + 4 * (plan.src.numel() + 2 * plan.n_ss)
                  + 4 * x0.numel() + 4 * plan.out_rows * 128)

        def make(i):
            p = plan if i == 0 else dataclasses.replace(
                plan, gt=plan.gt.clone(), lo=None if plan.lo is None else plan.lo.clone(),
                v=plan.v.clone(), src=plan.src.clone())
            xi = x0 if i == 0 else x0.clone()
            return (lambda: kp.probe_gather_acc(p, xi)), (lambda: kp.probe_plain(p, xi))

        return timed_kernel(f"K9 probe_gather_acc {variant} B={B} n_ss={plan.n_ss}", make, nbytes,
                            2 * plan.v.numel() + plan.n_ss * plan.tiles * 1024, torch.float32,
                            (20, 100), (1, 3), None,
                            library="none: no single torch call computes the probe's "
                                    "gather-accumulate", stream_MB=plan.stream_bytes() / 1e6)

    t_k9 = k9_row("base", 4)
    for variant, B in (("base", 16), ("packed_opt", 4), ("packed_opt", 16), ("mt4", 4),
                       ("mt4", 16)):
        k9_row(variant, B)

    # ---- 5. where a PCG and a GMRES iteration's time goes (torch.profiler) -----
    for label, A, iters, prec in (("lap1000 f64 Jacobi", lap64, 20, JacobiPrec(lap64)),
                                  ("fem2d_30k f64 Jacobi", fem, 50, JacobiPrec(fem)),
                                  ("fem2d_30k f64 GsPrec", fem, 50, GsPrec(hp, fem)),
                                  ("lap1000 f64 GsPrec", lap64, 20,
                                   GsPrec(gs[("lap1000", "POINT")], lap64))):
        Ah = SpmvHandle(A)
        state = pcg_initial_state(Ah, prec, vec(A.nrows, torch.float64), torch.zeros(
            A.nrows, dtype=torch.float64, device=dev))
        for _ in range(5):
            state = pcg_iteration(Ah, prec, state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            state = pcg_iteration(Ah, prec, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) / iters * 1e6
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                state = pcg_iteration(Ah, prec, state)
            torch.cuda.synchronize()
        # device-side events only (kernels, memsets): CPU ops carry their kernels'
        # time too, and each tpukk:: region shows again as a device-side range
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.key.startswith("tpukk::")]
        dev_us = sum(e.self_device_time_total for e in kern) / iters
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        emit("profile_pcg_iteration", case=label, wall_us_per_iter=wall_us,
             device_busy_us_per_iter=dev_us, device_idle_share=1 - dev_us / wall_us,
             launches_per_iter=sum(e.count for e in kern) / iters,
             top=[[e.key[:60], e.self_device_time_total / iters, e.count // iters] for e in top])

    # one Arnoldi step of the ILU(0)-GMRES on fem2d_30k: a whole cycle of m=50
    # steps (its one host least-squares solve included), per step
    Ah, m = SpmvHandle(fem), 50
    x0 = torch.zeros(fem.nrows, dtype=torch.float64, device=dev)
    _arnoldi_cycle(Ah, prec_f, bg, x0, m, Ortho.CGS2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _arnoldi_cycle(Ah, prec_f, bg, x0, m, Ortho.CGS2)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) / m * 1e6
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _arnoldi_cycle(Ah, prec_f, bg, x0, m, Ortho.CGS2)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith("tpukk::")]
    dev_us = sum(e.self_device_time_total for e in kern) / m
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile_gmres_iteration", case="fem2d_30k f64 ILU(0) LUPrec, m=50 CGS2",
         wall_us_per_iter=wall_us, device_busy_us_per_iter=dev_us,
         device_idle_share=1 - dev_us / wall_us,
         launches_per_iter=sum(e.count for e in kern) / m,
         top=[[e.key[:60], e.self_device_time_total / m, e.count / m] for e in top])

    total_k = []
    for name, row in (("dia_spmv", t_k1), ("dia_spmm", t_k2), ("csr_spmv", t_k3),
                      ("sptrsv_levels", t_k4), ("permute_gather", t_k5),
                      ("gs_sweep", t_k6), ("csr_spmm", t_k7), ("spgemm_rows", t_k8),
                      ("probe_gather_acc", t_k9)):
        total_k.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name], launches=path[name],
                            max_abs_err=errs[name], ms=row["ms"], plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                            library_ms=row["library_ms"]))
    print(json.dumps({"kernels": total_k}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
