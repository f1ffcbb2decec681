"""What the drivers share: the port's matrix, SpMV handle and
preconditioners, built through its public entry points as a user builds
them.  The benchmark takes from the port only the system under test."""
from __future__ import annotations

import numpy as np
import torch

from tpukk_torch.containers import CsrMatrix
from tpukk_torch.graph import ColoringAlgorithm
from tpukk_torch.sparse import (GsAlgorithm, GsHandle, GsPrec, JacobiPrec, LUPrec, SpilukHandle,
                                SpmvHandle, gauss_seidel_numeric, gauss_seidel_symbolic,
                                spiluk_numeric, spiluk_symbolic)


def load(arrays: dict, device) -> CsrMatrix:
    return CsrMatrix.from_arrays(arrays["row_map"], arrays["entries"], arrays["values"],
                                 nrows=arrays["nrows"], ncols=arrays["ncols"], device=device)


def spmv_handle(A: CsrMatrix) -> SpmvHandle:
    """``SpmvHandle(A)`` with its plan built (the plan is made at the first
    product)."""
    h = SpmvHandle(A)
    h(torch.zeros(A.ncols, dtype=A.dtype, device=A.device))
    return h


def _host_csr(M: CsrMatrix) -> tuple:
    return (M.host_row_map().copy(), M.host_entries().copy(), M.host_values().copy())


def make_prec(A: CsrMatrix, mix: dict):
    """(preconditioner, the tables its set-up derived).  The tables are what
    the reference judges (the coloring of Gauss-Seidel, ILU's factors), as
    functions that copy them to the host when the run has ended."""
    kind = mix["prec"]
    if kind == "symgs":
        h = GsHandle(GsAlgorithm[mix.get("gs_algorithm", "POINT")],
                     coloring=ColoringAlgorithm[mix.get("coloring", "SERIAL")])
        gauss_seidel_symbolic(h, A)
        gauss_seidel_numeric(h, A)
        prec = GsPrec(h, A, sweeps=int(mix.get("sweeps", 1)))
        tables = {"colors": lambda: np.asarray(h.colors).copy()}
    elif kind == "jacobi":
        prec, tables = JacobiPrec(A), {}
    elif kind == "ilu0":
        hk = SpilukHandle(int(mix.get("fill_level", 0)))
        spiluk_symbolic(hk, A)
        L, U = spiluk_numeric(hk, A)
        prec = LUPrec(L, U)
        tables = {"L": lambda: _host_csr(L), "U": lambda: _host_csr(U)}
    else:
        raise KeyError(f"kkbench: no preconditioner {kind!r}")
    # the first apply builds what the port builds lazily (a sweep's step list)
    prec.apply(torch.zeros(A.nrows, dtype=A.dtype, device=A.device))
    return prec, tables


def prec_only(A: CsrMatrix, mix: dict):
    return make_prec(A, mix)[0]
