"""Kernel loader: builds ``csrc/*.cu`` with nvcc at first use on a CUDA device
and binds the plain C entry points with ctypes.

Nothing is built when the package is imported.  Each source becomes its own
shared library under ``build/tpukk_torch/`` beside the package, named by a
hash of the source and the compiler flags, so an edited source rebuilds and
an unchanged one is reused.  The compiler writes to a temporary name that is
``os.replace``d into place, so concurrent first uses are safe.  Sources build
in parallel: one nvcc process per source, all started together.

Build by hand (the same command)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/tpukk_torch/libdia.so tpukk_torch/csrc/dia.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .common import TpuKKError

__all__ = ["SOURCES", "library", "build_all", "build_dir", "build_log"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signatures of every entry point, by source stem
SOURCES = {
    "dia": {
        "tpukk_dia_spmv": [_I, _P, _P, _I, _P, _P, _I64, _I64, _P],
        "tpukk_dia_spmm": [_I, _P, _P, _I, _P, _P, _I64, _I64, _I, _P],
    },
    "csr": {
        "tpukk_csr_spmv": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def build_dir() -> Path:
    return _PKG.parent / "build" / "tpukk_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise TpuKKError("tpukk_torch: nvcc not found on PATH or under CUDA_HOME; "
                     "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp path, final path) or
    None when the library is already built."""
    out = _target(name)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its error report, or "" on success."""
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{stderr}{stdout}"
    # keep ptxas's register/spill report beside the library
    out.with_suffix(".log").write_text(stderr + stdout)
    os.replace(tmp, out)
    return ""


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> float:
    """Build (in parallel) and load every source not yet loaded; returns the
    seconds spent.  Raises with the compiler's stderr on failure."""
    t0 = time.perf_counter()
    with _lock:
        names = [n for n in SOURCES if n not in _libs]
        jobs = {n: _start(n) for n in names}
        # wait for every compiler before reporting, so none is left running
        errors = [_finish(n, job) for n, job in jobs.items() if job is not None]
        errors = [e for e in errors if e]
        if errors:
            raise TpuKKError("tpukk_torch: " + "\n".join(errors))
        for n in names:
            _libs[n] = _bind(n)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of a built source."""
    return _target(name).with_suffix(".log").read_text()
