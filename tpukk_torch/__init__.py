"""tpukk_torch — the PyTorch/CUDA port of ``tpukk`` for NVIDIA Hopper (H100).

The same public layout as ``tpukk`` (int32 row maps and column ids, f32/f64
values, multivectors of shape (ncols, k)), on torch tensors.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the CPU every
hand-written kernel runs as its plain torch version.  Kernels are built with
nvcc at first use on a CUDA device, never at import (``_kernels.py``).
"""
from . import common, containers, graph, interop, sparse
from .containers import CsrMatrix
from .sparse import SpmvAlgorithm, SpmvHandle, spmm, spmv

__all__ = ["common", "containers", "graph", "interop", "sparse", "CsrMatrix", "SpmvAlgorithm",
           "SpmvHandle", "spmm", "spmv"]
