#!/usr/bin/env python3
"""The parts of the BSR route (``sparse.spmv_impl.apply_bsr``) and the torch
calls each part could be made of, timed on the card, for two matrices:
lap1000 as ``crs2bsr(·, 4)`` (1,247,500 blocks, 5 a block row) and
``generate_random_bsr(25_000, 25_000, 4, 16)`` (400,000 blocks), f32 and f64.

- the gather of x's blocks: rows of b values (``index_select``, advanced
  indexing, ``F.embedding``, ``gather``) against single values through a flat
  index (the route's);
- the block products for a vector: broadcast product and row sum (the
  route's), ``torch.bmm``, column-wise ``addcmul``;
- the block-row sums: ``segment_reduce`` over each row's run (the route's)
  against ``index_add_`` (atomics: not the same bits every call);
- the whole route;

and the parts of ``sparse.spgemm.bspgemm_numeric`` on A·A for lap1000 b=4
f32 and fem2d_30k as ``crs2bsr(·, 2)`` f64: the gathers of the pair plan's
operand blocks (single values through the plan's flat index, the numeric's;
rows of b·b values through ``index_select``; a flat index made on each
call), the block products (broadcast product and sum, the numeric's for
b <= 4; ``torch.bmm``, its form for larger blocks), the sums into C's
blocks (``segment_reduce``) and the whole numeric phase.

Each alternative is checked against the route's part (gathers exactly,
products and sums within 1e-5 / 1e-12 relative), then timed by CUDA-event
slope over CUDA graphs (``common.chain_time_slope``), L2-warm, in µs.

    python3 scripts/bsr_parts_torch.py

One JSON line per matrix and dtype, then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bsr_parts_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpukk_torch.common import chain_time_slope
    from tpukk_torch.containers import (crs2bsr, generate_random_bsr,
                                        generate_structured_laplacian, read_mtx)
    from tpukk_torch.sparse import SpgemmHandle, bspgemm_numeric, bspgemm_symbolic
    from tpukk_torch.sparse.spmv_impl import apply_bsr, build_bsr_rows

    dev = torch.device("cuda", 0)
    mats = {"lap1000 b=4": crs2bsr(generate_structured_laplacian(1000, 1000, device=dev), 4),
            "random 25k b=4": generate_random_bsr(25_000, 25_000, 4, 16, device=dev)}
    for name, A in mats.items():
        for dt in (torch.float32, torch.float64):
            p = build_bsr_rows(A, dt)
            b = A.block_size
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.ncols)).to(dev, dt)
            e = A.entries.long()
            xr = x.view(-1, b)
            xg = x.index_select(0, p.cols).view(-1, b)
            prod = (p.values * xg[:, None, :]).sum(-1)
            Vt = p.values.transpose(1, 2).contiguous()
            rows = torch.repeat_interleave(torch.arange(A.n_block_rows, device=dev), p.lengths)
            tol = 1e-5 if dt == torch.float32 else 1e-12

            def cols():
                acc = Vt[:, 0, :] * xg[:, :1]
                for j in range(1, b):
                    acc = torch.addcmul(acc, Vt[:, j, :], xg[:, j:j + 1])
                return acc

            parts = {
                "gather: single values, flat index (route)": (
                    lambda: x.index_select(0, p.cols), xg, 0.0),
                "gather: index_select of b-value rows": (lambda: xr.index_select(0, e), xg, 0.0),
                "gather: advanced indexing of rows": (lambda: xr[e], xg, 0.0),
                "gather: F.embedding": (lambda: F.embedding(e, xr), xg, 0.0),
                "gather: torch.gather": (
                    lambda: torch.gather(xr, 0, e[:, None].expand(-1, b)), xg, 0.0),
                "product: broadcast and row sum (route)": (
                    lambda: (p.values * xg[:, None, :]).sum(-1), prod, 0.0),
                "product: torch.bmm": (lambda: torch.bmm(p.values, xg[:, :, None]), prod, tol),
                "product: addcmul by columns": (cols, prod, tol),
                "row sums: segment_reduce (route)": (
                    lambda: torch.segment_reduce(prod, "sum", lengths=p.lengths, axis=0,
                                                 unsafe=True), None, 0.0),
                "row sums: index_add_ (atomics)": (
                    lambda: torch.zeros(A.n_block_rows, b, dtype=dt, device=dev)
                    .index_add_(0, rows, prod), None, tol),
                "whole route": (lambda: apply_bsr(p, x), None, 0.0),
            }
            ref_sums = parts["row sums: segment_reduce (route)"][0]()
            us = {}
            for label, (fn, ref, rtol) in parts.items():
                got = fn().reshape(-1)
                want = (ref if ref is not None else ref_sums).reshape(-1)
                if label != "whole route":
                    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))
                    if err > rtol:
                        raise SystemExit(f"bsr_parts_torch: {name} {dt} {label}: off by {err}")
                us[label] = chain_time_slope(fn) * 1e3 * 1e3
            print(json.dumps({"matrix": name, "dtype": str(dt), "blocks": A.nnz_blocks,
                              "us_l2_warm": us}), flush=True)
    lap = generate_structured_laplacian(1000, 1000, device=dev)
    fem = read_mtx(ROOT / "data" / "fem2d_30k.mtx.gz", value_dtype=np.float64, device=dev)
    for name, A in (("lap1000 b=4 f32", crs2bsr(lap, 4)), ("fem2d_30k b=2 f64", crs2bsr(fem, 2))):
        h = SpgemmHandle()
        bspgemm_symbolic(h, A, A)
        plan, b = h.block_plan, A.block_size
        dt = torch.promote_types(A.dtype, torch.float32)
        bb = torch.arange(b * b, device=dev)
        blk = {s: f.view(-1, b * b)[:, 0].long() // (b * b)
               for s, f in (("a", plan.a_flat), ("b", plan.b_flat))}
        V, Vf = A.values.to(dt), A.values.to(dt).reshape(-1)
        pa, pb = V.index_select(0, blk["a"]), V.index_select(0, blk["b"])
        prod = (pa[:, :, :, None] * pb[:, None, :, :]).sum(2)
        sums = torch.segment_reduce(prod, "sum", lengths=plan.c_len, axis=0, unsafe=True)
        tol = 1e-5 if dt == torch.float32 else 1e-12
        parts = {
            "gather A, B: index_select of b*b-value blocks": (
                lambda: torch.stack((V.index_select(0, blk["a"]), V.index_select(0, blk["b"]))),
                torch.stack((pa, pb)), 0.0),
            "gather A, B: single values, flat index made once (numeric)": (
                lambda: torch.stack((Vf.index_select(0, plan.a_flat),
                                     Vf.index_select(0, plan.b_flat))),
                torch.stack((pa, pb)), 0.0),
            "gather A, B: single values, flat index made each call": (
                lambda: torch.stack(tuple(Vf.index_select(0, (i[:, None] * (b * b) + bb)
                                                          .reshape(-1))
                                          for i in (blk["a"], blk["b"]))),
                torch.stack((pa, pb)), 0.0),
            "product: torch.bmm (numeric for b > 4)": (lambda: torch.bmm(pa, pb), prod, tol),
            "product: broadcast and sum (numeric for b <= 4)": (
                lambda: (pa[:, :, :, None] * pb[:, None, :, :]).sum(2), prod, 0.0),
            "C sums: segment_reduce (numeric)": (
                lambda: torch.segment_reduce(prod, "sum", lengths=plan.c_len, axis=0,
                                             unsafe=True), sums, 0.0),
            "whole numeric": (lambda: bspgemm_numeric(h, A, A).values, sums.to(A.dtype), 0.0),
        }
        ms = {}
        for label, (fn, want, rtol) in parts.items():
            got, want = fn().reshape(-1), want.reshape(-1)
            err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))
            if err > rtol:
                raise SystemExit(f"bsr_parts_torch: bspgemm {name} {label}: off by {err}")
            ms[label] = chain_time_slope(fn, 3, 13, reps=3) * 1e3
        print(json.dumps({"bspgemm": name, "blocks_a": A.nnz_blocks,
                          "block_products": plan.n_products,
                          "blocks_c": int(plan.c_len.numel()), "ms_l2_warm": ms}), flush=True)
        del h, plan, blk, V, Vf, pa, pb, prod, sums, parts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
