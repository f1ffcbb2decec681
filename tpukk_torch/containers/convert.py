"""Format converters — counterpart of ``tpukk/containers/convert.py``
(sparse/src/KokkosSparse_coo2crs.hpp:42-66, crs2coo, ccs2crs, crs2ccs, and
crs↔bsr: sparse/impl/KokkosSparse_crs_to_bsr_impl.hpp, _bsr_to_crs_impl.hpp,
_crs_detect_block_size.hpp).

A conversion changes the arrays' shapes, so it is symbolic work and runs on
the host in numpy/scipy, as in ``tpukk``; the result lies on the input's
device, in its value dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import check
from .bsr import BsrMatrix
from .ccs import CcsMatrix
from .coo import CooMatrix
from .csr import CsrMatrix, csr_like

__all__ = [
    "coo2crs",
    "crs2coo",
    "ccs2crs",
    "crs2ccs",
    "crs2bsr",
    "bsr2crs",
    "detect_block_size",
    "expand_row_indices",
]


def expand_row_indices(row_map) -> np.ndarray:
    """CSR row_map -> per-nnz row index (host; a tensor is read back)."""
    row_map = row_map.cpu().numpy() if isinstance(row_map, torch.Tensor) else np.asarray(row_map)
    lengths = row_map[1:] - row_map[:-1]
    return np.repeat(np.arange(len(lengths), dtype=row_map.dtype), lengths)


def coo2crs(coo: CooMatrix, sum_duplicates: bool = True) -> CsrMatrix:
    """cf. KokkosSparse_coo2crs.hpp:42-66 (duplicates are merged)."""
    sp = coo.to_scipy().tocsr()
    if sum_duplicates:
        sp.sum_duplicates()
    return csr_like(sp, coo)


def crs2coo(csr: CsrMatrix) -> CooMatrix:
    return CooMatrix.from_scipy(csr.to_scipy().tocoo(), device=csr.device)


def ccs2crs(ccs: CcsMatrix) -> CsrMatrix:
    return csr_like(ccs.to_scipy().tocsr(), ccs)


def crs2ccs(csr: CsrMatrix) -> CcsMatrix:
    return CcsMatrix.from_scipy(csr.to_scipy().tocsc(), device=csr.device)


def detect_block_size(csr: CsrMatrix) -> int:
    """Largest b for which EVERY nonempty b×b block of the pattern is fully
    dense — the reference contract of
    sparse/impl/KokkosSparse_crs_detect_block_size.hpp (BlockPopulations::
    all_dense): trial sizes run from 2 to min(sqrt(nnz), rows, cols,
    shortest nonempty row); dims must divide evenly; multiples of a
    rejected size are skipped (a 2N block contains a non-dense N block)."""
    rm = np.asarray(csr.host_row_map(), np.int64)
    ent = np.asarray(csr.host_entries(), np.int64)
    nnz = len(ent)
    if nnz == 0:
        return 1
    row_len = np.diff(rm)
    nonempty = row_len[row_len > 0]
    upper = int(min(np.sqrt(nnz), csr.nrows, csr.ncols,
                    nonempty.min() if len(nonempty) else 1))
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), row_len)
    best = 1
    rejected = []
    for b in range(2, upper + 1):
        if csr.nrows % b or csr.ncols % b:
            continue
        if any(b % r == 0 for r in rejected):
            continue
        key = (rows // b) * (csr.ncols // b) + ent // b
        _, counts = np.unique(key, return_counts=True)
        if (counts == b * b).all():
            best = b
        else:
            rejected.append(b)
    return best


def crs2bsr(csr: CsrMatrix, block_size: int) -> BsrMatrix:
    check(csr.nrows % block_size == 0 and csr.ncols % block_size == 0,
          "crs2bsr: block_size must divide both dims")
    sp = csr.to_scipy().tobsr(blocksize=(block_size, block_size))
    out = BsrMatrix.from_scipy_bsr(sp, device=csr.device)
    return out if out.dtype == csr.dtype else out.with_values(out.values.to(csr.dtype))


def bsr2crs(bsr: BsrMatrix, prune_zeros: bool = False) -> CsrMatrix:
    sp = bsr.to_scipy().tocsr()
    if prune_zeros:
        sp.eliminate_zeros()
    return csr_like(sp, bsr)
