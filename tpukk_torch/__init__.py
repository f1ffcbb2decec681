"""tpukk_torch — the PyTorch/CUDA port of ``tpukk`` for NVIDIA Hopper (H100).

The same public layout as ``tpukk`` (int32 row maps and column ids, f32/f64
values, multivectors of shape (ncols, k)), on torch tensors.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the CPU every
hand-written kernel runs as its plain torch version.  Kernels are built with
nvcc at first use on a CUDA device, never at import (``_kernels.py``).
"""
__version__ = "0.1.0"

from . import batched, blas, common, containers, dist, graph, interop, lapack, native, ode, sparse
from .containers import BsrMatrix, CcsMatrix, CooMatrix, CsrMatrix
from .sparse import SpmvAlgorithm, SpmvHandle, spmm, spmv

__all__ = ["batched", "blas", "common", "containers", "dist", "graph", "interop", "lapack",
           "native", "ode",
           "sparse", "BsrMatrix",
           "CcsMatrix", "CooMatrix", "CsrMatrix", "SpmvAlgorithm", "SpmvHandle", "spmm", "spmv"]
