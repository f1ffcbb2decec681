"""Kernel loader: builds ``csrc/*.cu`` with nvcc at first use on a CUDA device,
and the host planners ``csrc/host.cpp`` with g++ at first use anywhere, and
binds their plain C entry points with ctypes.

Nothing is built when the package is imported.  Each source becomes its own
shared library under ``build/tpukk_torch/`` beside the package, named by a
hash of the source, the shared headers ``csrc/*.cuh`` (for nvcc) and the
compiler flags, so an edited source or header rebuilds and an unchanged one
is reused.  The compiler writes to a temporary name that is
``os.replace``d into place, so concurrent first uses are safe.  Sources build
in parallel: one compiler process per source, all started together.

Build by hand (the same commands)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/tpukk_torch/libdia.so tpukk_torch/csrc/dia.cu
    g++ -O3 -shared -fPIC -std=c++17 -o build/tpukk_torch/libhost.so \\
         tpukk_torch/csrc/host.cpp

The launch helpers at the end are shared by every kernel wrapper.
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

import torch

from .common import TpuKKError, check

__all__ = ["SOURCES", "HOST_SOURCES", "library", "build_all", "build_dir", "build_log",
           "DTYPE_CODE", "COMPLEX_DTYPE_CODE", "dtype_code", "stream_of", "check_launch",
           "check_operand", "on_cuda"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signatures of every CUDA entry point, by source stem (returns cudaError_t)
SOURCES = {
    "dia": {
        "tpukk_dia_spmv": [_I, _P, _P, _I, _P, _P, _I64, _I64, _P],
        "tpukk_dia_spmm": [_I, _I, _P, _P, _I, _P, _P, _I64, _I64, _I, _P],
    },
    "csr": {
        "tpukk_csr_spmv": [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P],
        "tpukk_csr_spmm": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "gs": {
        "tpukk_gs_color_step": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                                ctypes.c_double, _P],
        "tpukk_gs_sweep": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, ctypes.c_double, _P],
        "tpukk_gs_sweep_dia": [_I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P, _P, ctypes.c_double, _P],
    },
    "sptrsv": {
        "tpukk_sptrsv_levels": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "permute": {
        "tpukk_permute_gather": [_I, _I, _I, _P, _P, _P, _I64, _I64, _P],
    },
    "spgemm": {
        "tpukk_spgemm_rows": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "probe": {
        "tpukk_probe_gather_acc": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
}
# C signatures and return types of the host planners (csrc/host.cpp)
HOST_SOURCES = {
    "host": {
        "tpukk_iluk_symbolic": ([_I64, ctypes.c_int32, _P, _P, _P, _P], ctypes.c_int64),
        "tpukk_ilu_numeric": ([_I64, _P, _P, _P, _P, _P, _P], ctypes.c_int32),
        "tpukk_iluk_depth": ([_I64, _P, _P], ctypes.c_int32),
        "tpukk_rcm": ([_I64, _P, _P, _P], None),
        "tpukk_d1_greedy_color": ([_I64, _P, _P, _P], ctypes.c_int32),
        "tpukk_d2_greedy_color": ([_I64, _P, _P, _I64, _P, _P, ctypes.c_int32, _P],
                                  ctypes.c_int32),
        "tpukk_spgemm_symbolic_count": ([_I64, _P, _P, _I64, _P, _P, _P], ctypes.c_int64),
        "tpukk_spgemm_columns": ([_I64, _P, _P, _I64, _P, _P, _P, _P], None),
        "tpukk_triangle_count": ([_I64, _P, _P, _P], ctypes.c_int64),
        "tpukk_mdf_order": ([_I64, _P, _P, _P, _P], None),
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


def _source(name: str) -> Path:
    return _CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        gxx = shutil.which("g++")
        if gxx is None:
            raise TpuKKError("tpukk_torch: g++ not found on PATH; the host planners "
                             "cannot be built")
        return [gxx, *GXX_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def _target(name: str) -> Path:
    flags = GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    headers = [] if name in HOST_SOURCES else sorted(_CSRC.glob("*.cuh"))
    text = b"".join(f.read_bytes() for f in [_source(name), *headers])
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start the compiler for one source; returns (popen, tmp path, final
    path) or None when the library is already built."""
    out = _target(name)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one compiler; returns its error report, or "" on success."""
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"{Path(proc.args[0]).name} failed on csrc/{_source(name).name} "
                f"(exit {proc.returncode}):\n{stderr}{stdout}")
    # keep the compiler's report (ptxas registers/spills) beside the library
    out.with_suffix(".log").write_text(stderr + stdout)
    os.replace(tmp, out)
    return ""


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    if name in HOST_SOURCES:
        for fn, (argtypes, restype) in HOST_SOURCES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        return lib
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _build(names) -> None:
    """Build (in parallel) and load the named sources not yet loaded.
    Raises with the compilers' stderr on failure."""
    with _lock:
        names = [n for n in names if n not in _libs]
        jobs = {}
        try:
            for n in names:
                jobs[n] = _start(n)
        finally:
            # wait for every compiler started before reporting, so none is left running
            errors = [_finish(n, job) for n, job in jobs.items() if job is not None]
        errors = [e for e in errors if e]
        if errors:
            raise TpuKKError("tpukk_torch: " + "\n".join(errors))
        for n in names:
            _libs[n] = _bind(n)


def build_all() -> float:
    """Build every CUDA source and the host planners, in parallel; returns
    the seconds spent."""
    t0 = time.perf_counter()
    _build([*SOURCES, *HOST_SOURCES])
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``host.cpp``), built on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        _build([name])
        lib = _libs[name]
    return lib


def build_log(name: str) -> str:
    """The compiler's report (for nvcc: ptxas registers, shared memory,
    spills) of a built source."""
    return _target(name).with_suffix(".log").read_text()


# ----------------------------------------------------------------------
# launch helpers shared by the kernel wrappers
# ----------------------------------------------------------------------

# The dtypes each kernel takes, as its C entry point's dtype code: every
# kernel takes f32 and f64; K1-K4 and K6-K8 also complex64 and complex128
# (K3's sum only: its max reduction takes real values).  K5 and K9 keep
# DTYPE_CODE: K5 moves complex values as real views (common/permute.py), and
# K9's probe is real, as tpukk's is.
DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
COMPLEX_DTYPE_CODE = {**DTYPE_CODE, torch.complex64: 2, torch.complex128: 3}


def dtype_code(dtype: torch.dtype, codes: dict, name: str) -> int:
    """The code of ``dtype`` in a kernel's table ``codes``; a dtype the
    kernel does not take raises TpuKKError."""
    if dtype in codes:
        return codes[dtype]
    kinds = "f32/f64/complex64/complex128" if len(codes) > 2 else "f32/f64"
    raise TpuKKError(f"{name}: dtype {dtype} not {kinds}")


def stream_of(t: torch.Tensor) -> int:
    """The current stream, which must belong to t's device: the kernels
    launch into the thread's current CUDA context."""
    check(t.device.index == torch.cuda.current_device(),
          f"tensor on {t.device}, but the current CUDA device is "
          f"{torch.cuda.current_device()}: use torch.cuda.device(...)")
    return torch.cuda.current_stream().cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"tpukk_torch: {name} launch failed with cudaError_t {err}")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device):
    check(t.device == device, f"{name}: tensor on {t.device}, plan on {device}")
    check(t.dtype == dtype, f"{name}: dtype {t.dtype}, plan dtype {dtype}")
    check(t.is_contiguous(), f"{name}: tensor must be contiguous")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    check(t.device.type in ("cpu", "cuda"), f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"
