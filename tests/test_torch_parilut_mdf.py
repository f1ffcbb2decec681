"""tpukk_torch's PAR_ILUT, MDF and the ILU(k) device refresh against tpukk on
the CPU.

PAR_ILUT: L and U equal ``tpukk``'s on seeded matrices, patterns exactly and
values to 1e-12 of max|U| (the same sweeps in f64, with the segment sums in
another order; the prune is a sort, and on these matrices no two kept and
dropped magnitudes tie, so the patterns agree), with the same iteration
count; the quality oracles of tests/test_parilut_mdf.py (the residual on A's
pattern falls, the preconditioner helps GMRES, candidates regrow).  MDF: the
order equals ``tpukk``'s element for element, for the host C++ and for the
plain Python loop; its factors equal ``tpukk``'s to 1e-12.  Refresh: equal
to ``spiluk_numeric`` on new values to 1e-11 of max|U|, as
tests/test_solvers.py holds ``tpukk``'s, on both of its routes.
"""
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse.mdf  # noqa: F401  (the modules, not the re-exported functions)
import tpukk.sparse.par_ilut  # noqa: F401
import tpukk.sparse.spiluk as jsk
import tpukk_torch.containers as tkc
from tpukk.sparse.gmres import GmresHandle as JGmresHandle
from tpukk.sparse.gmres import gmres as jgmres
from tpukk_torch import native as tnative
from tpukk_torch.interop import csr_from_numpy
from tpukk_torch.sparse import (GmresHandle, LUPrec, MdfHandle, ParIlutHandle, SpilukHandle,
                                build_iluk_refresh, gmres, mdf_numeric, mdf_ordering,
                                mdf_symbolic, par_ilut, par_ilut_numeric, par_ilut_symbolic,
                                refresh_to_csr, spiluk_numeric, spiluk_refresh, spiluk_symbolic)
from tpukk_torch.sparse.mdf import mdf_order_plain
from tpukk_torch.sparse.par_ilut import _pattern

jpi = sys.modules["tpukk.sparse.par_ilut"]
jmdf = sys.modules["tpukk.sparse.mdf"]
CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _same_factor(got, want, scale):
    g, w = got.to_scipy().tocsr(), want.to_scipy().tocsr()
    g.sort_indices()
    w.sort_indices()
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    assert np.abs(g.data - w.data).max(initial=0.0) <= 1e-12 * scale


# ---------------------------------------------------------------------------
# PAR_ILUT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,fill", [(11, 4.0), (12, 3.0), (3, 2.0), (7, 1.5)])
def test_par_ilut_factors_equal_tpukk(seed, fill):
    Aj = jkc.generate_diag_dominant_csr(60, 5, dtype=np.float64, seed=seed)
    kw = dict(max_iters=6, residual_tol=1e-12, fill_factor=fill, sweeps_per_iter=2)
    hj = jpi.ParIlutHandle(**kw)
    jpi.par_ilut_symbolic(hj, Aj)
    Lj, Uj = jpi.par_ilut_numeric(hj, Aj)
    ht = ParIlutHandle(**kw)
    assert par_ilut_symbolic(ht, _port(Aj)) == Aj.nnz
    Lt, Ut = par_ilut_numeric(ht, _port(Aj))
    assert Lt.dtype == torch.float64 and Lt.device.type == "cpu"
    scale = np.abs(Uj.to_scipy().data).max()
    _same_factor(Lt, Lj, scale)
    _same_factor(Ut, Uj, scale)
    assert ht.num_iters == hj.num_iters
    assert abs(ht.final_residual - hj.final_residual) <= 1e-10 * max(hj.final_residual, 1e-30)


def test_par_ilut_reduces_residual():
    A = tkc.generate_diag_dominant_csr(60, 5, dtype=np.float64, seed=11, device=CPU)
    h = ParIlutHandle(max_iters=8, residual_tol=1e-8, fill_factor=4.0, sweeps_per_iter=2)
    par_ilut_symbolic(h, A)
    L, U = par_ilut_numeric(h, A)
    assert np.allclose(L.to_scipy().diagonal(), 1.0)
    Asp = A.to_scipy()
    r = sps.linalg.norm((Asp - L.to_scipy() @ U.to_scipy()).multiply(Asp != 0))
    assert r / sps.linalg.norm(Asp) < 0.05 and h.num_iters >= 1


def test_par_ilut_preconditioner_helps():
    Aj = jkc.generate_diag_dominant_csr(80, 5, dtype=np.float64, seed=12)
    A = _port(Aj)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    _, s0 = gmres(GmresHandle(m=8, tol=1e-9, max_restarts=50), A, torch.from_numpy(b))
    L, U = par_ilut(A, max_iters=5, fill_factor=3.0)
    _, s1 = gmres(GmresHandle(m=8, tol=1e-9, max_restarts=50), A, torch.from_numpy(b),
                  prec=LUPrec(L, U))
    assert s1.converged and s1.num_iters <= s0.num_iters
    # tpukk's factors precondition as well, with the same count
    Lj, Uj = jpi.par_ilut(Aj, max_iters=5, fill_factor=3.0)
    from tpukk.sparse.preconditioner import LUPrec as JLUPrec

    _, sj = jgmres(JGmresHandle(m=8, tol=1e-9, max_restarts=50), Aj, b, prec=JLUPrec(Lj, Uj))
    assert sj.num_iters == s1.num_iters


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_par_ilut_candidate_regrowth(dtype):
    """fill_factor 4 on a {0, ±1, ±10}-diagonal matrix whose ILU fill exceeds
    the level-2 candidates: the outer loop regrows them (as tpukk's does);
    the factors' sizes and iteration counts equal tpukk's in both dtypes."""
    n = 300
    offs = {0: 30.0, 1: -1.0, -1: -1.0, 10: -1.0, -10: -1.0}
    A = sps.diags(list(offs.values()), list(offs.keys()), (n, n)).tocsr().astype(dtype)
    A.sort_indices()
    cap = (_pattern(((_pattern(sps.tril(A, -1).tocsr()) + sps.identity(n))
                     @ _pattern(sps.triu(A, 0).tocsr())).tocsr()) + _pattern(A)).nnz
    kw = dict(max_iters=8, fill_factor=4.0, residual_tol=1e-10 if dtype == np.float64 else 1e-6,
              sweeps_per_iter=3)
    h = ParIlutHandle(**kw)
    M = tkc.CsrMatrix.from_scipy(A, device=CPU)
    par_ilut_symbolic(h, M)
    L, U = par_ilut_numeric(h, M)
    assert L.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    hj = jpi.ParIlutHandle(**kw)
    Mj = jkc.CsrMatrix.from_scipy(A)
    jpi.par_ilut_symbolic(hj, Mj)
    Lj, Uj = jpi.par_ilut_numeric(hj, Mj)
    assert (L.nnz, U.nnz, h.num_iters) == (Lj.nnz, Uj.nnz, hj.num_iters)
    if dtype == np.float64:      # f32 stops at its looser tolerance before the fill grows
        assert (L.nnz - n) + U.nnz > cap
        assert h.final_residual < 1e-10
        R = A - (L.to_scipy() @ U.to_scipy())
        assert sps.linalg.norm(R) / sps.linalg.norm(A) < 1e-4


# ---------------------------------------------------------------------------
# MDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["diagdom30", "diagdom120", "lap10", "fem300"])
def test_mdf_order_equals_tpukk(case):
    Aj = {"diagdom30": lambda: jkc.generate_diag_dominant_csr(30, 4, dtype=np.float64, seed=13),
          "diagdom120": lambda: jkc.generate_diag_dominant_csr(120, 6, dtype=np.float64, seed=2),
          "lap10": lambda: jkc.generate_structured_laplacian(10, 10, dtype=np.float64),
          "fem300": lambda: jkc.generate_fem2d_csr(300, seed=4)}[case]()
    A = _port(Aj)
    ref = jmdf.mdf_ordering(Aj)
    got = mdf_ordering(A)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(mdf_order_plain(A), ref)
    sp = A.to_scipy().astype(np.float64)
    np.testing.assert_array_equal(tnative.mdf_order(sp.indptr, sp.indices, sp.data, A.nrows), ref)


def test_mdf_numeric_equals_tpukk():
    Aj = jkc.generate_diag_dominant_csr(25, 3, dtype=np.float64, seed=14)
    hj = jmdf.MdfHandle()
    jmdf.mdf_symbolic(hj, Aj)
    Lj, Uj = jmdf.mdf_numeric(hj, Aj)
    A = _port(Aj)
    h = MdfHandle()
    mdf_symbolic(h, A)
    L, U = mdf_numeric(h, A)
    scale = np.abs(Uj.to_scipy().data).max()
    _same_factor(L, Lj, scale)
    _same_factor(U, Uj, scale)
    from tpukk_torch.graph import permute_matrix

    B = permute_matrix(A, h.permutation).to_scipy()
    diff = ((L.to_scipy() @ U.to_scipy()).tocsr() - B).multiply(B != 0)
    assert np.abs(diff.data).max(initial=0.0) < 1e-10


# ---------------------------------------------------------------------------
# the ILU(k) device refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill_k,route", [(0, "levels"), (1, "levels"), (0, "sweeps"),
                                          (1, "sweeps"), (2, "sweeps")])
def test_refresh_equals_spiluk_numeric(fill_k, route):
    """fill 2 on this matrix is deeper than 64 levels: the refresh sweeps."""
    Aj = jkc.generate_diag_dominant_csr(250, 5, dtype=np.float64, seed=9)
    A = _port(Aj)
    h = SpilukHandle(fill_k)
    spiluk_symbolic(h, A)
    plan = build_iluk_refresh(h, A)
    assert (plan.levels is None) == (fill_k == 2)
    if route == "sweeps":
        plan.levels = None     # the route a pattern deeper than 64 levels takes
    sp = A.to_scipy()
    new = sp.data * (1.0 + 0.1 * np.random.default_rng(fill_k).standard_normal(sp.nnz))
    A2 = A.with_values(new)
    L2, U2 = spiluk_numeric(h, A2)
    Ld, Ud = refresh_to_csr(plan, *spiluk_refresh(plan, torch.from_numpy(new)))
    scale = np.abs(U2.to_scipy().data).max()
    assert abs(Ld.to_scipy() - L2.to_scipy()).max() <= 1e-11 * scale
    assert abs(Ud.to_scipy() - U2.to_scipy()).max() <= 1e-11 * scale
    # and tpukk's refresh gives the same values
    hj = jsk.SpilukHandle(fill_k)
    jsk.spiluk_symbolic(hj, Aj)
    pj = jsk.build_iluk_refresh(hj, Aj)
    Lj, Uj = jsk.refresh_to_csr(pj, *jsk.spiluk_refresh(pj, new))
    assert abs(Ld.to_scipy() - Lj.to_scipy()).max() <= 1e-11 * scale


def test_refresh_level_schedule_equals_tpukk():
    Aj = jkc.generate_diag_dominant_csr(150, 4, dtype=np.float64, seed=4)
    hj = jsk.SpilukHandle(1)
    jsk.spiluk_symbolic(hj, Aj)
    pj = jsk.build_iluk_refresh(hj, Aj)
    h = SpilukHandle(1)
    spiluk_symbolic(h, _port(Aj))
    plan = build_iluk_refresh(h, _port(Aj))
    assert plan.depth == pj.depth and plan.levels is not None and pj.levels is not None
    assert plan.levels["depth"] == pj.levels["depth"]
    n_l, n_u = pj.sweep.nnzL_true, pj.sweep.nnzU_true
    assert plan.levels["cL"][-1] == n_l and plan.levels["cU"][-1] == n_u
    # the same count of entries at every level
    np.testing.assert_array_equal(np.diff(plan.levels["cL"])[1:],
                                  np.diff(pj.levels["cL"])[1:])
    np.testing.assert_array_equal(np.diff(plan.levels["cU"])[1:],
                                  np.diff(pj.levels["cU"])[1:])
