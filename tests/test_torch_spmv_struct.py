"""tpukk_torch.sparse.spmv_struct (spmv_struct, structured_stencil_offsets)
against tpukk's on the same seeded inputs, with device="cpu".  Mirrors
tests/test_spmv.py's test_spmv_struct_api: the 1/2/3-D FD stencils and the
2/3-D FE stencils, alpha/beta/y, a multivector (the DIA route's K2), modes
N and T, and a grid that does not match the matrix.

Tolerance: 1e-12 relative (max norm) in f64 against tpukk (the same
products summed in another order), 1e-5 in f32; against the port's own
SpmvHandle(DIA) exactly (the same call).
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse as js
import tpukk_torch.containers as tkc
import tpukk_torch.sparse as ts
from tpukk.common import TpuKKError as JaxTpuKKError
from tpukk_torch.common import TpuKKError

CPU = "cpu"
GRIDS = [(50,), (25, 20), (8, 8, 8), (1, 30), (6, 1, 5)]


def _close(got, want, dtype):
    tol = 1e-12 if dtype == np.float64 else 1e-5
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(grid, dtype, stencil="FD", seed=0):
    if stencil == "FD":
        Aj = jkc.generate_structured_laplacian(*grid, dtype=dtype)
        At = tkc.generate_structured_laplacian(*grid, dtype=dtype, device=CPU)
        return Aj, At
    # an FE stencil: the offsets of structured_stencil_offsets(grid, "FE"),
    # filled with seeded values
    offs = js.structured_stencil_offsets(grid, "FE")
    n = int(np.prod(grid))
    rng = np.random.default_rng(seed)
    sp = sps.diags([rng.standard_normal(n - abs(int(o))) for o in offs], offs.tolist(),
                   shape=(n, n), format="csr").astype(dtype)
    sp.sort_indices()
    return jkc.CsrMatrix.from_scipy(sp), tkc.CsrMatrix.from_scipy(sp, device=CPU)


@pytest.mark.parametrize("stencil", ["FD", "FE"])
@pytest.mark.parametrize("grid", GRIDS, ids=["x".join(map(str, g)) for g in GRIDS])
def test_stencil_offsets_match_tpukk(grid, stencil):
    got = ts.structured_stencil_offsets(grid, stencil)
    want = js.structured_stencil_offsets(grid, stencil)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(50,), (25, 20), (8, 8, 8)], ids=["1d", "2d", "3d"])
def test_spmv_struct_matches_tpukk(grid, dtype):
    Aj, At = _pair(grid, dtype)
    rng = np.random.default_rng(len(grid))
    x = rng.standard_normal(At.ncols).astype(dtype)
    y0 = rng.standard_normal(At.nrows).astype(dtype)
    xt, y0t = torch.from_numpy(x), torch.from_numpy(y0)
    got = ts.spmv_struct(At, grid, xt)
    _close(got, js.spmv_struct(Aj, grid, x), dtype)
    assert torch.equal(got, ts.SpmvHandle(At, ts.SpmvAlgorithm.DIA)(xt))
    _close(ts.spmv_struct(At, grid, xt, alpha=2.5, beta=-0.5, y=y0t),
           js.spmv_struct(Aj, grid, x, alpha=2.5, beta=-0.5, y=y0), dtype)
    _close(ts.spmv_struct(At, grid, xt, mode="T"), js.spmv_struct(Aj, grid, x, mode="T"), dtype)
    X = rng.standard_normal((At.ncols, 3)).astype(dtype)
    _close(ts.spmv_struct(At, grid, torch.from_numpy(X)), js.spmv_struct(Aj, grid, X), dtype)


@pytest.mark.parametrize("grid", [(12, 9), (5, 4, 6)], ids=["9pt", "27pt"])
def test_spmv_struct_fe_matches_tpukk(grid):
    Aj, At = _pair(grid, np.float64, "FE", seed=3)
    x = np.random.default_rng(4).standard_normal(At.ncols)
    _close(ts.spmv_struct(At, grid, torch.from_numpy(x), stencil_type="FE"),
           js.spmv_struct(Aj, grid, x, stencil_type="FE"), np.float64)
    # the FE offsets lie outside the FD stencil
    with pytest.raises(TpuKKError):
        ts.spmv_struct(At, grid, torch.from_numpy(x))
    with pytest.raises(JaxTpuKKError):
        js.spmv_struct(Aj, grid, x)


def test_spmv_struct_refuses_what_tpukk_refuses():
    Aj, At = _pair((25, 20), np.float64)
    x = np.ones(At.ncols)
    with pytest.raises(TpuKKError, match="not within the declared"):
        ts.spmv_struct(At, (7, 11), torch.from_numpy(x))
    with pytest.raises(JaxTpuKKError):
        js.spmv_struct(Aj, (7, 11), x)
    # not a stencil matrix at all: more diagonals than the DIA plan takes
    R = tkc.generate_random_csr(400, 400, 40, seed=1, dtype=np.float64, device=CPU)
    with pytest.raises(TpuKKError, match="not a stencil matrix"):
        ts.spmv_struct(R, (20, 20), torch.ones(400, dtype=torch.float64))
