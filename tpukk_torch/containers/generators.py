"""Matrix generators — counterpart of ``tpukk/containers/generators.py``
(kk_generate_diagonally_dominant_sparse_matrix and kk_generate_sparse_matrix,
sparse/src/KokkosSparse_IOUtils.hpp:229,333, and the structured stencils of
test_common/KokkosKernels_Test_Structured_Matrix.hpp).

Each generator builds its matrix on the host with the same numpy/scipy calls
as ``tpukk``, so the same arguments and seed give the same arrays; only the
final container differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..common import default_device
from .bsr import BsrMatrix
from .csr import CsrMatrix

__all__ = [
    "generate_structured_laplacian",
    "generate_random_csr",
    "generate_diag_dominant_csr",
    "generate_banded_csr",
    "generate_fem2d_csr",
    "generate_random_bsr",
]


def generate_structured_laplacian(nx: int, ny: int = 1, nz: int = 1,
                                  dtype=np.float32, device=None) -> CsrMatrix:
    """FD Laplacian on an nx(×ny(×nz)) grid with Dirichlet boundaries —
    5-point stencil in 2D, 7-point in 3D, 3-point in 1D."""
    def lap1d(n):
        return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")

    eye = sps.identity
    if ny == 1 and nz == 1:
        A = lap1d(nx)
    elif nz == 1:
        A = sps.kron(eye(ny), lap1d(nx)) + sps.kron(lap1d(ny), eye(nx))
    else:
        A = (
            sps.kron(eye(nz), sps.kron(eye(ny), lap1d(nx)))
            + sps.kron(eye(nz), sps.kron(lap1d(ny), eye(nx)))
            + sps.kron(lap1d(nz), sps.kron(eye(ny), eye(nx)))
        )
    A = A.tocsr().astype(dtype)
    A.sort_indices()
    return CsrMatrix.from_scipy(A, device=device)


def _random_csr_scipy(nrows, ncols, nnz_per_row, dtype, seed, sorted_cols):
    rng = np.random.default_rng(seed)
    rows = []
    cols = []
    for i in range(nrows):
        k = min(ncols, max(1, int(rng.integers(max(1, nnz_per_row // 2), nnz_per_row * 2))))
        c = rng.choice(ncols, size=k, replace=False)
        rows.append(np.full(k, i))
        cols.append(c)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(len(rows)).astype(dtype)
    A = sps.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols)).tocsr()
    if sorted_cols:
        A.sort_indices()
    return A


def generate_random_csr(nrows: int, ncols: int, nnz_per_row: int, dtype=np.float32,
                        seed: int = 0, sorted_cols: bool = True, device=None) -> CsrMatrix:
    """Random CSR with ~nnz_per_row entries per row (kk_generate_sparse_matrix)."""
    return CsrMatrix.from_scipy(
        _random_csr_scipy(nrows, ncols, nnz_per_row, dtype, seed, sorted_cols),
        device=device)


def generate_diag_dominant_csr(n: int, nnz_per_row: int, dtype=np.float32, seed: int = 0,
                               device=None) -> CsrMatrix:
    """Diagonally dominant random CSR for solver tests
    (kk_generate_diagonally_dominant_sparse_matrix)."""
    A = _random_csr_scipy(n, n, nnz_per_row, np.float64, seed, True).tolil()
    A.setdiag(0.0)
    A = A.tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    A = A + sps.diags(rowsum + 1.0)
    A = A.tocsr().astype(dtype)
    A.sort_indices()
    return CsrMatrix.from_scipy(A, device=device)


def generate_banded_csr(n: int, bandwidth: int, dtype=np.float32, seed: int = 0,
                        device=None) -> CsrMatrix:
    rng = np.random.default_rng(seed)
    offsets = list(range(-bandwidth, bandwidth + 1))
    diags = [rng.standard_normal(n - abs(k)) for k in offsets]
    A = sps.diags(diags, offsets, shape=(n, n), format="csr").astype(dtype)
    A.sort_indices()
    return CsrMatrix.from_scipy(A, device=device)


def generate_fem2d_csr(n_nodes: int, dtype=np.float64, seed: int = 0,
                       device=None) -> CsrMatrix:
    """P1 finite-element stiffness matrix on an unstructured 2-D Delaunay
    triangulation of random points, plus 1e-3·I (symmetric positive
    definite).  Node numbering is random, so the pattern has no band; this is
    the generator behind ``data/fem2d_*.mtx.gz``
    (example/gmres/ex_real_A.cpp:36 reads such a matrix from a file)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    t = Delaunay(pts).simplices  # (ntri, 3)
    # per-triangle P1 stiffness: K_ij = (grad phi_i . grad phi_j) * area
    p0, p1, p2 = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
    e0, e1, e2 = p2 - p1, p0 - p2, p1 - p0  # edge vectors opposite each vertex
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = np.maximum(0.5 * np.abs(cross), 1e-14)
    E = np.stack([e0, e1, e2], axis=1)  # (ntri, 3, 2)
    K = np.einsum("tid,tjd->tij", E, E) / (4.0 * area)[:, None, None]
    rows = np.repeat(t, 3, axis=1).reshape(-1)
    cols = np.tile(t, (1, 3)).reshape(-1)
    A = sps.coo_matrix((K.reshape(-1), (rows, cols)), shape=(n_nodes, n_nodes)).tocsr()
    A.sum_duplicates()
    A = A + 1e-3 * sps.identity(n_nodes, format="csr")
    A.sort_indices()
    return CsrMatrix.from_scipy(A, value_dtype=dtype, device=device)


def generate_random_bsr(n_block_rows: int, n_block_cols: int, block_size: int,
                        blocks_per_row: int, dtype=np.float32, seed: int = 0, device=None):
    """Random BSR matrix with dense (b, b) blocks (the BSR overload of
    kk_generate_sparse_matrix, sparse/src/KokkosSparse_IOUtils.hpp:383-399):
    a random CSR pattern at block granularity, every stored block fully
    dense; the same draws as ``tpukk``'s."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    bpr = min(blocks_per_row, n_block_cols)
    cols = np.concatenate([
        np.sort(rng.choice(n_block_cols, size=bpr, replace=False))
        for _ in range(n_block_rows)]) if n_block_rows else np.empty(0, int)
    row_map = np.arange(n_block_rows + 1, dtype=np.int32) * bpr
    nnzb = n_block_rows * bpr
    vals = rng.standard_normal((nnzb, block_size, block_size)).astype(dtype)
    cols = cols.astype(np.int32)
    out = BsrMatrix(torch.from_numpy(row_map).to(dev), torch.from_numpy(cols).to(dev),
                    torch.from_numpy(vals).to(dev), n_block_rows * block_size,
                    n_block_cols * block_size, block_size)
    out._prefill(row_map=row_map, entries=cols, values=vals)
    return out
