"""The matrix builders against an independent construction."""
from __future__ import annotations

import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from conftest import ROOT
from kkbench.matrices import mtx, stencil27


def _kron27(nx, ny, nz):
    """27·I − T_z ⊗ T_y ⊗ T_x with T tridiagonal ones: 26 on the diagonal,
    −1 for each neighbour in the box."""
    T = [sps.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m)) for m in (nz, ny, nx)]
    K = sps.kron(T[0], sps.kron(T[1], T[2]))
    return (27.0 * sps.identity(nx * ny * nz) - K).tocsr()


@pytest.mark.parametrize("shape", [(3, 3, 3), (4, 4, 4), (5, 4, 3), (7, 2, 6)])
def test_stencil27_is_hpcgs_operator(shape):
    nx, ny, nz = shape
    a = stencil27.build({"nx": nx, "ny": ny, "nz": nz, "diagonal": 26.0, "offdiagonal": -1.0,
                         "dtype": "float64"}, torch.device("cpu"))
    A = sps.csr_matrix((a["values"].numpy(), a["entries"].numpy(), a["row_map"].numpy()),
                       shape=(a["nrows"], a["ncols"]))
    ref = _kron27(nx, ny, nz)
    ref.sort_indices()
    assert A.has_sorted_indices and a["entries"].dtype == torch.int32
    assert A.nnz == ref.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert np.array_equal(A.indptr, ref.indptr) and np.array_equal(A.indices, ref.indices)
    assert np.array_equal(A.data, ref.data)


def test_hpcg104_config_counts():
    cfg = json.loads((ROOT / "kkbench" / "configs" / "hpcg104.json").read_text())
    m = cfg["nx"]
    assert cfg["rows"] == m ** 3 == 1_124_864
    assert cfg["nnz"] == (3 * m - 2) ** 3 == 29_791_000


def test_fem2d_30k_file():
    cfg = json.loads((ROOT / "kkbench" / "configs" / "fem2d_30k.json").read_text())
    a = mtx.build(cfg, torch.device("cpu"))
    A = sps.csr_matrix((a["values"].numpy(), a["entries"].numpy(), a["row_map"].numpy()),
                       shape=(a["nrows"], a["ncols"]))
    assert A.shape == (cfg["rows"], cfg["rows"]) and A.nnz == cfg["nnz"]
    assert A.has_sorted_indices and abs(A - A.T).max() < 1e-12 * abs(A).max()
    assert (A.diagonal() > 0).all()
