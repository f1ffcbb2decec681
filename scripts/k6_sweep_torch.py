#!/usr/bin/env python3
"""K6's fused Gauss-Seidel sweep (tpukk_torch's ``gs_cuda.gs_sweep``) on both
of its operand layouts, on the sweeps the solver paths run: hpcg104 POINT
(HPCG's 27 points on 104³, the benchmark's matrix), lap1000 POINT and
fem2d_30k POINT and CLUSTER, f64, a symmetric sweep from x = 0 (a GsPrec
apply), a forward sweep from 0 and a forward sweep from a given x.

* The CSR route across its one launch choice, the rows a chunk ticket covers
  (1, 2 or 3 passes of a CUDA block's 256 / G rows), each first held to the
  per-color path it replaces (K5, a fill, one ``gs_color_step`` launch per
  color step, K5) bit for bit; the per-color path's time and one color
  step's beside it.
* The DIA route (``gs_sweep_dia``), where the plan has the layout, at its
  rows a chunk (``gs_cuda.DIA_CHUNK_ROWS``, one pass of a CUDA block), each
  first held to the CSR route within 1000·eps·max|CSR| (the steps' 20·eps
  bounds, chained); on hpcg104 both routes also L2-cold (a ring of two
  copies of the plan, each 2.4× the L2).
* The plan's set-up: ``gauss_seidel_numeric``'s seconds, the second of two
  calls, synchronised (``numeric_s``), and where the plan has the layout the
  layout's build alone (``dia_layout_s``).

Times are the CUDA-event slope over CUDA graphs of 20 and 100 calls
(``common.chain_time_slope``); the step floor (a lower-bidiagonal matrix of
16,384 rows, each row its own color block, so a forward sweep is 16,384
one-row steps, on the plan's route and on the CSR) is a CUDA-event mean over
three calls.  ``bound_us``: the sweep's compulsory bytes, (nnz + 2n)·8
(``kkbench/yardstick.symgs_bytes``), over 3.35 TB/s.

    python3 scripts/k6_sweep_torch.py                 # on a CUDA GPU; one JSON line per case
    python3 scripts/k6_sweep_torch.py --root DIR      # the tree unpacked in DIR (paired runs)

A tree without the DIA layout (before it) gives the CSR rows alone.  The
CSR route's own choice is ``gs_cuda.chunk_passes``; the sweep overrides it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM bandwidth


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree whose tpukk_torch runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import CsrMatrix, generate_structured_laplacian, read_mtx
    from tpukk_torch.sparse import (GsAlgorithm, GsHandle, gauss_seidel_numeric,
                                    gauss_seidel_symbolic)
    from tpukk_torch.sparse import gs_cuda as kg
    from tpukk_torch.sparse.gauss_seidel import _plan_in

    sys.path.insert(1, str(ROOT))
    from kkbench.matrices import stencil27

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    b_rng = np.random.default_rng(3)
    eps = torch.finfo(torch.float64).eps

    def us(fn):
        return chain_time_slope(fn, 20, 100) * 1e6

    def without_dia(plan):
        if getattr(plan, "dia", None) is None:
            return plan
        return dataclasses.replace(plan, dia=None, _steps={}, _bufs={})

    def copy_of(plan):
        """The plan on copies of its arrays, for a ring that keeps the L2 cold."""
        dia = getattr(plan, "dia", None)
        kw = {} if dia is None else dict(dia=dataclasses.replace(
            dia, values=dia.values.clone(), mask=dia.mask.clone()))
        return dataclasses.replace(
            plan, csr=dataclasses.replace(plan.csr, row_map=plan.csr.row_map.clone(),
                                          entries=plan.csr.entries.clone(),
                                          values=plan.csr.values.clone(), _rows=None),
            inv_diag=plan.inv_diag.clone(), order=plan.order.clone(), _blocks=None, _steps={},
            _bufs={}, **kw)

    def cold_us(plan, b, omega):
        ring = [(plan, b), (copy_of(plan), b.clone())]
        for p, bb in ring:
            kg.gs_sweep(p, None, bb, omega)  # each copy's step list and buffers, before capture
        turn = [0]

        def call():
            p, bb = ring[turn[0] % 2]
            turn[0] += 1
            kg.gs_sweep(p, None, bb, omega)
        return us(call)

    hp = stencil27.build(dict(nx=104, ny=104, nz=104, dtype="float64", diagonal=26.0,
                              offdiagonal=-1.0), dev)
    hpcg = CsrMatrix.from_arrays(hp["row_map"], hp["entries"], hp["values"], nrows=hp["nrows"],
                                 ncols=hp["ncols"], device=dev)
    del hp
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", device=dev)
    lap = generate_structured_laplacian(1000, 1000, dtype=np.float64, device=dev)
    for label, A, alg in (("hpcg104 POINT", hpcg, GsAlgorithm.POINT),
                          ("fem2d_30k POINT", fem, GsAlgorithm.POINT),
                          ("fem2d_30k CLUSTER", fem, GsAlgorithm.CLUSTER),
                          ("lap1000 POINT", lap, GsAlgorithm.POINT)):
        h = GsHandle(alg)
        gauss_seidel_symbolic(h, A)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gauss_seidel_numeric(h, A)
            torch.cuda.synchronize()
            numeric_s = time.perf_counter() - t0
        plan = _plan_in(h, torch.float64)
        dia = getattr(plan, "dia", None)
        csr = without_dia(plan)
        b = torch.from_numpy(b_rng.standard_normal(plan.n)).to(dev)
        row = dict(case=label, dtype="float64", nvidia_smi=smi, tree=str(args.root),
                   route="dia" if dia is not None else "csr", lanes=plan.csr.group,
                   colors=len(plan.offsets) - 1,
                   steps=int(plan.steps("symmetric", 1, False).host.shape[0]),
                   plan_chunk_rows=plan.chunk_rows, numeric_s=numeric_s,
                   bound_us=(A.nnz + 2 * A.nrows) * 8 / PEAK_BYTES_PER_S * 1e6,
                   per_color_path_us=us(lambda: kg.gs_sweep_per_color(csr, None, b, h.omega)))
        passes_all = (1, 2, 3) if A is not hpcg else (plan.chunk_rows * plan.csr.group // 256,)
        for passes in passes_all:
            p = dataclasses.replace(csr, chunk_rows=passes * (256 // plan.csr.group), _steps={},
                                    _bufs={})
            for x0, direction, key in ((None, "symmetric", "symmetric"),
                                       (None, "forward", "forward"),
                                       (b, "forward", "forward_x_given")):
                got = kg.gs_sweep(p, x0, b, h.omega, direction)
                if not torch.equal(got, kg.gs_sweep_per_color(p, x0, b, h.omega, direction)):
                    print(f"k6_sweep_torch: {label} {passes} passes {key} differs from the "
                          "per-color path", file=sys.stderr)
                    return 1
                row[f"{key}_us_{passes}_passes"] = us(
                    lambda: kg.gs_sweep(p, x0, b, h.omega, direction))
        if A is hpcg:
            row["symmetric_us_cold"] = cold_us(csr, b, h.omega)
        if dia is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kg.dia_layout(plan.csr, plan.offsets, plan.coupled)
            torch.cuda.synchronize()
            row.update(offsets_per_block=dia.ndiag.tolist(), slots=int(dia.values.numel()),
                       stored=int(plan.csr.values.numel()), dia_chunk_rows=kg.DIA_CHUNK_ROWS,
                       dia_layout_s=time.perf_counter() - t0)
            for x0, direction, key in ((None, "symmetric", "symmetric"),
                                       (None, "forward", "forward"),
                                       (b, "forward", "forward_x_given")):
                got = kg.gs_sweep(plan, x0, b, h.omega, direction)
                ref = kg.gs_sweep(csr, x0, b, h.omega, direction)
                err = float((got - ref).abs().max()) / float(ref.abs().max()) / eps
                if not err <= 1000:
                    print(f"k6_sweep_torch: {label} DIA {key} is {err} eps from the CSR route",
                          file=sys.stderr)
                    return 1
                row[f"dia_{key}_eps_from_csr"] = err
                row[f"dia_{key}_us"] = us(lambda: kg.gs_sweep(plan, x0, b, h.omega, direction))
            if A is hpcg:
                row["dia_symmetric_us_cold"] = cold_us(plan, b, h.omega)
        blk = dataclasses.replace(plan.blocks[0], csr=dataclasses.replace(
            plan.blocks[0].csr, group=plan.csr.group))
        xx = b.clone()
        scratch = torch.empty(blk.nrows, dtype=b.dtype, device=dev)
        row["gs_color_step_block0_us"] = us(lambda: kg.gs_color_step(blk, xx, b, h.omega, scratch))
        print(json.dumps(row), flush=True)
        del h, plan, csr, dia

    n = 16_384
    fl = kg.build_gs_sweep_plan(np.r_[0, np.arange(n)], np.arange(n - 1), np.full(n - 1, -0.5),
                                np.ones(n), np.arange(n + 1), np.arange(n), dev)
    b = torch.from_numpy(b_rng.standard_normal(n)).to(dev)
    floors = [("csr", without_dia(fl))]
    if getattr(fl, "dia", None) is not None:
        floors.insert(0, ("dia", fl))
    for route, p in floors:
        if not torch.equal(kg.gs_sweep(p, None, b, 1.0, "forward"),
                           kg.gs_sweep_plain(p, None, b, 1.0, "forward")):
            print("k6_sweep_torch: the step-floor plan differs from its plain version",
                  file=sys.stderr)
            return 1
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            kg.gs_sweep(p, None, b, 1.0, "forward")
        e1.record()
        e1.synchronize()
        print(json.dumps(dict(case=f"step floor: lower-bidiagonal, {n} one-row steps, f64",
                              route=route, nvidia_smi=smi, tree=str(args.root),
                              us_per_step=e0.elapsed_time(e1) / 3 * 1e3 / n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
