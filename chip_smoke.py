#!/usr/bin/env python3
"""Drive tpukk_torch's SpMV + PCG main path once on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpukk_torch/csrc`` (nvcc, sm_90a), holds each
kernel against its plain torch version on the card, drives the main path a
user runs (SpmvHandle AUTO SpMV and SpMM on the 1M-row 2-D Laplacian, AUTO
SpMV on a random 100k-row CSR, PCG on the Laplacian and on the FEM matrix),
checks every result on the host with scipy, times each kernel, its plain
version and the cuSPARSE call that computes the same product, and prints one
JSON line per phase.  The last two lines are the card's name and power limit
as nvidia-smi reports them, and the result line.  Any failed check exits
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
           "csr_spmv": "tpukk_torch/csrc/csr.cu"}
REPLACES = {"dia_spmv": "tpukk/sparse/spmv_pallas.py:41",
            "dia_spmm": "tpukk/sparse/spmv_pallas.py:180",
            "csr_spmv": "tpukk/sparse/spmv_pallas.py:2053"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    from torch.autograd import DeviceType

    from tpukk_torch import _kernels
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import (generate_random_csr,
                                        generate_structured_laplacian, read_mtx)
    from tpukk_torch.sparse import JacobiPrec, SpmvAlgorithm, SpmvHandle, pcg, spmm
    from tpukk_torch.sparse import spmv_cuda as kc
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
    errs = {k.__name__: 0.0 for k in kc.KERNELS}

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
    after = kc.launch_counts()
    require(all(after[k] > before[k] for k in after), f"a launch counter did not rise: {after}")
    emit("kernels_checked", launches=after)

    # ---- 3. the main path, each part with the counts set to 0 around it --------
    total = {k: 0 for k in after}

    def counted(part: str, fn, needs: tuple):
        kc.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kc.launch_counts()
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

    xt = torch.from_numpy(rng.standard_normal(fem.nrows)).to(dev)
    bf = torch.from_numpy(fem.to_scipy() @ xt.cpu().numpy()).to(dev)
    st, rel, counts, wall = solve("pcg fem2d_30k", fem, bf, JacobiPrec(fem), 4000)
    require(counts["csr_spmv"] > 0, f"pcg fem2d_30k: K3 not launched: {counts}")
    emit("main_pcg_fem2d30k_f64_jacobi", iters=st.num_iters, rel_res_host=rel, seconds=wall,
         us_per_iter=wall / st.num_iters * 1e6, launches=counts)
    require(all(v > 0 for v in total.values()), f"a kernel of the path never ran: {total}")
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

    def timed(label, A, make, nbytes, flops, dt, spmv=True):
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
                   library_ms_l2_cold=library_ms_cold)
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
                values=cp.values.clone())
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
        return timed(f"K3 csr_spmv {label} G={cp.group}", A, csr_make(A, cp, vec(A.ncols, dt)),
                     nbytes, 2 * A.nnz, dt)

    t_k3 = k3_row("rand100k_deg16 f32 (AUTO route)", rnd, torch.float32)
    k3_row("lap1000 f32 (pinned ONEHOT)", lap, torch.float32)
    k3_row("fem2d_30k f64 (PCG route)", fem, torch.float64)

    # ---- 5. where a PCG iteration's time goes (torch.profiler) ---------------
    for label, A, iters in (("lap1000 f64 Jacobi", lap64, 20), ("fem2d_30k f64 Jacobi", fem, 50)):
        Ah, prec = SpmvHandle(A), JacobiPrec(A)
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

    total_k = []
    for name, row in (("dia_spmv", t_k1), ("dia_spmm", t_k2), ("csr_spmv", t_k3)):
        total_k.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name], launches=total[name],
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
