"""CRS transforms — counterpart of ``tpukk/containers/sort_crs.py``
(sparse/src/KokkosSparse_SortCrs.hpp, KokkosSparse_Utils.hpp:1799
removeCrsMatrixZeros, :338-392 transpose, :1045-1155 kk_sort_by_row_size,
:1867+ kk_extract_diagonal_blocks_crsmatrix_sequential).

Shape-changing transforms are symbolic, so they run on the host in scipy, as
in ``tpukk``; each result lies on the input's device, in its value dtype.
"""
from __future__ import annotations

import numpy as np

from .csr import CsrMatrix, csr_like

__all__ = ["sort_crs", "sort_and_merge_crs", "remove_zeros", "transpose",
           "is_sorted", "extract_diagonal_blocks", "sort_by_row_size",
           "symmetrize_pattern"]


def sort_crs(csr: CsrMatrix) -> CsrMatrix:
    sp = csr.to_scipy()
    sp.sort_indices()
    return csr_like(sp, csr)


def sort_and_merge_crs(csr: CsrMatrix) -> CsrMatrix:
    sp = csr.to_scipy()
    sp.sum_duplicates()  # also sorts
    return csr_like(sp, csr)


def remove_zeros(csr: CsrMatrix) -> CsrMatrix:
    sp = csr.to_scipy()
    sp.eliminate_zeros()
    return csr_like(sp, csr)


def transpose(csr: CsrMatrix, sorted_cols: bool = True) -> CsrMatrix:
    """Materialised Aᵀ on the same device (KokkosSparse_Utils.hpp:338-392)."""
    sp = csr.to_scipy().T.tocsr()
    if sorted_cols:
        sp.sort_indices()
    return CsrMatrix.from_scipy(sp, device=csr.device)


def is_sorted(csr: CsrMatrix) -> bool:
    """Whether every row's column ids ascend."""
    rm = csr.host_row_map()
    ent = csr.host_entries().astype(np.int64)
    if ent.size < 2:
        return True
    descents = np.nonzero(np.diff(ent) < 0)[0] + 1  # positions p with ent[p] < ent[p-1]
    # a descent is allowed only where p starts a new row
    row_starts = rm[1:-1]
    return bool(np.isin(descents, row_starts).all())


def extract_diagonal_blocks(csr: CsrMatrix, n_blocks: int):
    """Split the square matrix into n_blocks diagonal CRS blocks (equal row
    ranges; remainder rows go to the last block)."""
    n = csr.nrows
    if csr.ncols != n:
        raise ValueError("extract_diagonal_blocks: square matrix required")
    if n_blocks < 1 or n_blocks > max(1, n):
        raise ValueError("extract_diagonal_blocks: bad n_blocks")
    sp = csr.to_scipy()
    size = n // n_blocks
    blocks = []
    for b in range(n_blocks):
        r0 = b * size
        r1 = n if b == n_blocks - 1 else (b + 1) * size
        blk = sp[r0:r1, r0:r1].tocsr()
        blk.sort_indices()
        blocks.append(csr_like(blk, csr))
    return blocks


def sort_by_row_size(csr: CsrMatrix, ascending: bool = False) -> np.ndarray:
    """Permutation ordering rows by nnz (stable), for load-balanced
    scheduling.  Returns the new-order row indices (host int32)."""
    lens = np.diff(csr.host_row_map())
    key = lens if ascending else -lens
    return np.argsort(key, kind="stable").astype(np.int32)


def symmetrize_pattern(csr: CsrMatrix) -> CsrMatrix:
    """Pattern/value symmetrization A + Aᵀ (role of kk_symmetrize_graph,
    common/src/KokkosKernels_Utils.hpp)."""
    sp = csr.to_scipy()
    out = (sp + sp.T).tocsr()
    out.sort_indices()
    return csr_like(out, csr)
