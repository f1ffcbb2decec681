#!/usr/bin/env python3
"""K8's complex128 instance against the order of its A-entry fields and the
compiler's settings.  Builds variants of ``csrc/spgemm.cu`` with nvcc (all at
once, one process each), runs each on complex128 (and, as controls,
complex64 and f64) SpGEMM cases that between them reach every bin of the
kernel (each lane count in shared memory, the global accumulator, rows of B
that repeat a column) and holds it bit for bit to ``spgemm_rows_plain``.

Variants, each made from this tree's ``spgemm.cu`` by a text substitution:
  value-last              the source as it is (AEntry = {bs, be, a})
  value-first             AEntry = {a, bs, be}
  value-first-noinline    value-first, a_entry ``__noinline__``
  value-first-ptxas-O0    value-first, ``-Xptxas -O0`` (PTX assembled unoptimised)
  value-first-G           value-first, ``-G`` (device code unoptimised throughout)

For value-last and value-first it also writes the PTX (``nvcc -ptx``) and the
SASS (``cuobjdump -sass``) to ``chiprun_out/k8_layout/`` (gzipped) and counts,
in the PTX of the complex128 instance, the 16-byte value loads
(``ld.global.nc.v2.f64``) whose result is never read; for every variant, the
local-memory loads and stores (LDL/STL) and the instructions of each kernel
instance in the SASS, with ptxas's report.

    python3 scripts/k8_complex_layout_torch.py
    python3 scripts/k8_complex_layout_torch.py --ptx A.ptx[.gz] ...   # count only, no card

One JSON line per variant and case, then one summary line.
"""
from __future__ import annotations

import ctypes
import gzip
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "k8_layout"

STRUCT_LAST = """struct AEntry {
  int bs, be;
  T a;
};"""
STRUCT_FIRST = """struct AEntry {
  T a;
  int bs, be;
};"""
RETURNS_LAST = ("  if (p >= a1) return {0, 0, T(0)};",
                "  return {__ldg(o.brm + k), __ldg(o.brm + k + 1), ldg(o.aval + p)};")
RETURNS_FIRST = ("  if (p >= a1) return {T(0), 0, 0};",
                 "  return {ldg(o.aval + p), __ldg(o.brm + k), __ldg(o.brm + k + 1)};")
A_ENTRY = "__device__ __forceinline__ AEntry<T> a_entry("

VARIANTS = {  # name -> (value first, a_entry noinline, extra nvcc flags)
    "value-last": (False, False, []),
    "value-first": (True, False, []),
    "value-first-noinline": (True, True, []),
    "value-first-ptxas-O0": (True, False, ["-Xptxas", "-O0"]),
    "value-first-G": (True, False, ["-G"]),
}
DUMPED = ("value-last", "value-first")


def variant_source(text: str, first: bool, noinline: bool) -> str:
    for old in (STRUCT_LAST, A_ENTRY, *RETURNS_LAST):
        if old not in text:
            raise SystemExit(f"k8_complex_layout_torch: spgemm.cu no longer has {old!r}")
    if first:
        text = text.replace(STRUCT_LAST, STRUCT_FIRST)
        for old, new in zip(RETURNS_LAST, RETURNS_FIRST):
            text = text.replace(old, new)
    if noinline:
        text = text.replace(A_ENTRY, "__device__ __noinline__ AEntry<T> a_entry(")
    return text


def instance(name: str) -> str | None:
    """The dtype of a spgemm_rows_kernel instance from its mangled name."""
    for tag, dt in (("cplxIdE", "cplx<double>"), ("cplxIfE", "cplx<float>"),
                    ("kernelIdE", "double"), ("kernelIfE", "float")):
        if "spgemm_rows_kernel" in name and tag in name:
            return dt
    return None


def sass_counts(sass: str) -> dict:
    """Instructions, LDL and STL of each kernel instance, by its dtype."""
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = instance(m.group(1))
            if key:
                out[key] = {"instructions": 0, "LDL": 0, "STL": 0}
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            c = out[key]
            c["instructions"] += 1
            c["LDL"] += " LDL" in line
            c["STL"] += " STL" in line
    return out


def spills(report: str) -> dict:
    """ptxas's stack frame and spill line of each kernel instance."""
    out, key = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            key = instance(line)
        elif key and "stack frame" in line:
            out[key] = line.strip()
            key = None
    return out


def dead_loads(ptx: str) -> dict:
    """In the complex128 instance's PTX: its 16-byte value loads and those
    whose two registers are never read afterwards (line numbers)."""
    lines = ptx.splitlines()
    first = next(i for i, l in enumerate(lines) if l.startswith(".entry") and "cplxIdE" in l)
    last = next((i for i in range(first + 1, len(lines)) if lines[i].startswith(".entry")),
                len(lines))
    loads, read = [], set()
    for i in range(first, last):
        s = re.sub(r"^@!?%p\d+\s+", "", lines[i].strip().rstrip(";"))
        m = re.match(r"ld\.global\.nc\.v2\.f64\s+\{(%fd\d+),\s*(%fd\d+)\}", s)
        if m:
            loads.append((i + 1, m.group(1), m.group(2)))
        parts = s.split(None, 1)
        if len(parts) < 2 or parts[0].startswith("//"):
            continue
        ops = parts[1]
        if not parts[0].startswith("st."):  # the first operand is written, not read
            ops = ops[ops.index("}") + 1:] if ops.startswith("{") else ops.partition(",")[2]
        read.update(re.findall(r"%fd\d+", ops))
    dead = [i for i, a, b in loads if a not in read or b not in read]
    return dict(value_loads=len(loads), never_read=len(dead), never_read_lines=dead)


def cases(dev):
    """(label, A, B) complex128 scipy matrices reaching every bin of K8."""
    import scipy.sparse as sps

    rng = np.random.default_rng(23)

    def crandom(nr, nc, density, seed):
        M = sps.random(nr, nc, density=density, random_state=np.random.default_rng(seed),
                       format="csr")
        M.data = rng.standard_normal(M.nnz) + 1j * rng.standard_normal(M.nnz)
        return M

    arrow = crandom(3000, 3000, 4.0 / 3000, 5).tolil()
    arrow[0, :] = rng.standard_normal(3000) + 0.5j
    arrow[:, 0] = rng.standard_normal((3000, 1)) - 0.5j
    rm, ent = [0], []
    for i in range(300):
        cols = list(rng.choice(300, size=6, replace=False))
        if i % 3 == 0:
            cols.insert(int(rng.integers(0, 6)), cols[-1])
        ent += cols
        rm.append(len(ent))
    rep = (np.array(rm), np.array(ent), rng.standard_normal(len(ent)) + 1j)
    out = [(f"random {n}", crandom(n, n, 4 / n, n), None) for n in (10_000, 20_000, 140_000)]
    out += [("arrow 3000", arrow.tocsr(), None), ("dense 40x40", crandom(40, 40, 1.0, 6), None),
            ("B repeats columns", crandom(200, 300, 5 / 300, 7), rep),
            ("200 x 200, 5% (the first failing case)", crandom(200, 200, 0.05, 9), None)]
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptx", nargs="+", type=Path, help="count dead value loads in these files")
    args = ap.parse_args()
    if args.ptx:
        for f in args.ptx:
            text = gzip.open(f, "rt").read() if f.suffix == ".gz" else f.read_text()
            print(json.dumps(dict(ptx=str(f), **dead_loads(text))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k8_complex_layout_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpukk_torch import _kernels
    from tpukk_torch.containers import CsrMatrix
    from tpukk_torch.sparse import SpgemmAlgorithm, SpgemmHandle, spgemm_symbolic
    from tpukk_torch.sparse import spgemm_cuda as ksg

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = _kernels._nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    src = (_kernels._CSRC / "spgemm.cu").read_text()
    work = _kernels.build_dir().parent / "k8_layout"
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (first, noinline, extra) in VARIANTS.items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(_kernels._CSRC / "cplx.cuh", d / "cplx.cuh")
        (d / "spgemm.cu").write_text(variant_source(src, first, noinline))
        cmds = [[nvcc, *_kernels.NVCC_FLAGS, *extra, "-o", str(d / "lib.so"), str(d / "spgemm.cu")]]
        if name in DUMPED:
            flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                                   "-Xptxas", "-v")]
            cmds.append([nvcc, *flags, *extra, "-ptx", "-o", str(d / "spgemm.ptx"),
                         str(d / "spgemm.cu")])
        jobs[name] = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True) for c in cmds]
    libs, builds = {}, {}
    for name, procs in jobs.items():
        outs = [p.communicate() for p in procs]
        rcs = [p.returncode for p in procs]
        report = outs[0][1] + outs[0][0]
        builds[name] = dict(rcs=rcs, spills=spills(report))
        if rcs[0] != 0:
            builds[name]["error"] = report[-2000:]
            continue
        d = work / name
        sass = subprocess.run(["cuobjdump", "-sass", str(d / "lib.so")], capture_output=True,
                              text=True).stdout
        builds[name]["sass"] = sass_counts(sass)
        if name in DUMPED:
            with gzip.open(OUT / f"{name}.sass.gz", "wt") as f:
                f.write(sass)
            if (d / "spgemm.ptx").is_file():
                ptx = (d / "spgemm.ptx").read_text()
                builds[name]["ptx_complex128"] = dead_loads(ptx)
                with gzip.open(OUT / f"{name}.ptx.gz", "wt") as f:
                    f.write(ptx)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.tpukk_spgemm_rows
        fn.argtypes, fn.restype = _kernels.SOURCES["spgemm"]["tpukk_spgemm_rows"], ctypes.c_int
        libs[name] = lib

    plans = []
    for label, a, b in cases(dev):
        A = CsrMatrix.from_scipy(a, device=dev)
        B = A if b is None else CsrMatrix.from_arrays(*b, nrows=300, ncols=300, device=dev)
        h = SpgemmHandle(SpgemmAlgorithm.KK)
        spgemm_symbolic(h, A, B)
        plans.append((label, h.row_plan, A.values, B.values))
    summary = {}
    saved = _kernels._libs.get("spgemm")
    try:
        for name, lib in libs.items():
            _kernels._libs["spgemm"] = lib
            wrong = []
            for label, plan, av, bv in plans:
                for dt in (torch.complex128, torch.complex64, torch.float64):
                    a_, b_ = (av, bv) if dt.is_complex else (av.real, bv.real)
                    a_, b_ = a_.to(dt).contiguous(), b_.to(dt).contiguous()
                    got = ksg.spgemm_rows(plan, a_, b_)
                    ref = ksg.spgemm_rows_plain(plan, a_, b_)
                    torch.cuda.synchronize()
                    bad = int((got != ref).sum())
                    row = dict(variant=name, case=label, dtype=str(dt), bins=plan.bins,
                               dups=plan.dups, equal=bad == 0, n_differ=bad,
                               nnz_c=plan.nnz_c, max_abs_err=float((got - ref).abs().max()))
                    print(json.dumps(row), flush=True)
                    if bad:
                        wrong.append(f"{label} {dt}")
            summary[name] = dict(build=builds[name], wrong=wrong)
    finally:
        if saved is not None:
            _kernels._libs["spgemm"] = saved
    for name in VARIANTS:
        summary.setdefault(name, dict(build=builds[name], wrong=None))
    print(json.dumps(dict(nvidia_smi=smi, nvcc=version.strip().splitlines()[-1],
                          torch=torch.__version__, variants=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
