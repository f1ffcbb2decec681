"""tpukk_torch's ILU(k)-GMRES path and the RCM route against tpukk on the CPU.

Slice: ``SpilukHandle`` → ``spiluk_symbolic`` → ``spiluk_numeric`` →
``LUPrec`` → ``gmres``, in both packages on one matrix, with one
factorization handed to both through ``interop.csr_pair_from_numpy``;
``gmres`` with CGS2 and MGS, with and without ILU(0), the β = 0 case,
``reorder="rcm"`` and the RCM SpMV route; and the scenario of
examples/gmres_ex_real_A.py run through the port.

Tolerances: the preconditioner apply 1e-12 relative (two triangular solves,
sums in another order); the iterate after one restart cycle 1e-10 in f64
(both packages run the same Arnoldi steps; the least-squares solve is an SVD
in one and LAPACK gelsd in the other); converged iteration counts equal.
The RCM comparisons follow tests/test_spmv.py and tests/test_solvers.py
(f32: 1e-5 relative for the SpMV, rtol 2e-3 / atol 2e-4 between the two
orderings' solutions at tol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse as jsp
import tpukk_torch.containers as tkc
from tpukk_torch.interop import csr_from_numpy, csr_pair_from_numpy
from tpukk_torch.sparse import (GmresHandle, GsHandle, GsPrec, LUPrec, Ortho, SpilukHandle,
                                SpmvAlgorithm, SpmvHandle, gauss_seidel_numeric,
                                gauss_seidel_symbolic, gmres, spiluk_numeric, spiluk_symbolic)
from tpukk_torch.sparse import sptrsv_cuda as ks
from tpukk_torch.sparse.gmres import _rcm_reorder
from tpukk_torch.common import tracing


def _launches(kernel) -> int:
    """The registry's launch counter of a kernel function."""
    return tracing.launch_counts([kernel])[kernel.__name__]


CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _arrays(M):
    return (M.host_row_map(), M.host_entries(), M.host_values_full())


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _ilu(Aj, k=0):
    """tpukk's ILU(k) factors, and the same factors handed to the port."""
    h = jsp.SpilukHandle(k)
    jsp.spiluk_symbolic(h, Aj)
    Lj, Uj = jsp.spiluk_numeric(h, Aj)
    return (Lj, Uj), csr_pair_from_numpy(_arrays(Lj), _arrays(Uj), device=CPU)


@pytest.fixture(scope="module")
def dd120():
    return jkc.generate_diag_dominant_csr(120, 6, dtype=np.float64, seed=7)


@pytest.mark.parametrize("sweeps", [None, 3], ids=["exact", "jacobi3"])
def test_luprec_apply_matches_tpukk(dd120, sweeps, rng):
    (Lj, Uj), (Lt, Ut) = _ilu(dd120, k=1)
    b = rng.standard_normal(dd120.nrows)
    ref = np.asarray(jsp.LUPrec(Lj, Uj, jacobi_sweeps=sweeps).apply(jnp.asarray(b)))
    got = LUPrec(Lt, Ut, jacobi_sweeps=sweeps).apply(torch.from_numpy(b))
    assert got.dtype == torch.float64 and _launches(ks.sptrsv_levels) == 0
    assert _rel(got.numpy(), ref) <= 1e-12


def test_luprec_from_port_factors_matches_interop_factors(dd120, rng):
    """The port's own spiluk gives the same LUPrec as tpukk's factors."""
    _, (Lt, Ut) = _ilu(dd120)
    h = SpilukHandle(0)
    spiluk_symbolic(h, _port(dd120))
    L, U = spiluk_numeric(h, _port(dd120))
    b = torch.from_numpy(rng.standard_normal(dd120.nrows))
    assert _rel(LUPrec(L, U).apply(b).numpy(), LUPrec(Lt, Ut).apply(b).numpy()) <= 1e-14


@pytest.mark.parametrize("prec", [False, True], ids=["plain", "ilu0"])
@pytest.mark.parametrize("ortho", ["CGS2", "MGS"])
def test_gmres_matches_tpukk(dd120, ortho, prec, rng):
    (Lj, Uj), (Lt, Ut) = _ilu(dd120)
    At = _port(dd120)
    b = rng.standard_normal(dd120.nrows)
    pj = jsp.LUPrec(Lj, Uj) if prec else None
    pt = LUPrec(Lt, Ut) if prec else None
    # the iterate after one cycle
    xj, sj = jsp.gmres(jsp.GmresHandle(m=10, tol=0.0, max_restarts=1,
                                       ortho=jsp.Ortho[ortho]), dd120, jnp.asarray(b), prec=pj)
    xt, st = gmres(GmresHandle(m=10, tol=0.0, max_restarts=1, ortho=Ortho[ortho]), At,
                   torch.from_numpy(b), prec=pt)
    assert st.num_iters == sj.num_iters == 10
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    # to convergence: the same iteration count
    hj = jsp.GmresHandle(m=10, tol=1e-9, max_restarts=40, ortho=jsp.Ortho[ortho])
    ht = GmresHandle(m=10, tol=1e-9, max_restarts=40, ortho=Ortho[ortho])
    xj, sj = jsp.gmres(hj, dd120, jnp.asarray(b), prec=pj)
    xt, st = gmres(ht, At, torch.from_numpy(b), prec=pt)
    assert sj.converged and st.converged and st.num_iters == sj.num_iters
    assert (ht.num_iters, ht.converged) == (st.num_iters, True)
    r = b - dd120.to_scipy() @ xt.numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)


def test_gmres_zero_rhs_and_unported_prec():
    """β = 0 gives x = 0 in both packages; GsPrec (ported with the
    Gauss-Seidel slice) is a working preconditioner for GMRES too."""
    At = tkc.generate_diag_dominant_csr(30, 3, dtype=np.float64, seed=8, device=CPU)
    b = torch.zeros(At.nrows, dtype=torch.float64)
    x, st = gmres(GmresHandle(m=10, tol=1e-10, max_restarts=3), At, b)
    assert torch.equal(x, torch.zeros_like(b)) and torch.isfinite(x).all()
    assert st.converged and st.num_iters == 10
    xj, sj = jsp.gmres(jsp.GmresHandle(m=10, tol=1e-10, max_restarts=3),
                       jkc.generate_diag_dominant_csr(30, 3, dtype=np.float64, seed=8),
                       jnp.zeros(30))
    assert sj.num_iters == st.num_iters and np.allclose(np.asarray(xj), 0.0)
    h = GsHandle()
    gauss_seidel_symbolic(h, At)
    gauss_seidel_numeric(h, At)
    bg = torch.from_numpy(np.random.default_rng(8).standard_normal(At.nrows))
    xg, sg = gmres(GmresHandle(m=10, tol=1e-10, max_restarts=5), At, bg, prec=GsPrec(h, At))
    _, s0 = gmres(GmresHandle(m=10, tol=1e-10, max_restarts=5), At, bg)
    assert sg.converged and sg.num_iters <= s0.num_iters
    r = bg.numpy() - At.to_scipy() @ xg.numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(bg.numpy())


def test_rcm_route_matches_tpukk():
    Fs = jkc.generate_fem2d_csr(800, seed=3).to_scipy().astype(np.float32)
    Aj = jkc.CsrMatrix.from_scipy(Fs)
    At = tkc.CsrMatrix.from_scipy(Fs, device=CPU)
    hj = jsp.SpmvHandle(Aj, jsp.SpmvAlgorithm.RCM)
    ht = SpmvHandle(At, SpmvAlgorithm.RCM)
    x = np.random.default_rng(0).standard_normal(At.ncols).astype(np.float32)
    ref = Fs.astype(np.float64) @ x
    y = ht(torch.from_numpy(x))
    assert ht.algorithm == SpmvAlgorithm.RCM and _launches(ks.permute_gather) == 0
    assert _rel(y.numpy(), ref) < 1e-5
    np.testing.assert_array_equal(y.numpy(), np.asarray(hj.matvec(jnp.asarray(x))))
    ph, to_p, from_p = ht.rcm_permuted()
    phj, to_pj, from_pj = hj.rcm_permuted()
    xp = to_p(torch.from_numpy(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(to_pj(jnp.asarray(x))))
    assert abs(ph.A.to_scipy() - phj.A.to_scipy()).max() == 0
    yp = from_p(ph.matvec(xp))
    np.testing.assert_array_equal(yp.numpy(), y.numpy())
    # the permuted matrix is banded: its bandwidth shrinks
    def bw(s):
        return int(np.abs(np.repeat(np.arange(s.shape[0]), np.diff(s.indptr)) - s.indices).max())

    assert bw(ph.A.to_scipy().tocsr()) < bw(Fs.tocsr()) // 2


def test_gmres_rcm_reorder_matches_direct():
    sp = jkc.generate_fem2d_csr(900, seed=7).to_scipy().tocsr()
    sp = (sp + 4.0 * sps.eye(sp.shape[0], format="csr")).astype(np.float32)
    A = tkc.CsrMatrix.from_scipy(sp, device=CPU)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(A.nrows).astype(np.float32))
    x_d, st_d = gmres(GmresHandle(m=40, tol=1e-6, reorder="none"), A, b)
    x_r, st_r = gmres(GmresHandle(m=40, tol=1e-6, reorder="rcm"), A, b)
    assert st_d.converged and st_r.converged
    r = sp.astype(np.float64) @ x_r.double().numpy() - b.double().numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b.numpy()) < 1e-5
    np.testing.assert_allclose(x_r.numpy(), x_d.numpy(), rtol=2e-3, atol=2e-4)
    Aj = jkc.CsrMatrix.from_scipy(sp)
    xj, sj = jsp.gmres(jsp.GmresHandle(m=40, tol=1e-6, reorder="rcm"), Aj, jnp.asarray(b.numpy()))
    assert sj.num_iters == st_r.num_iters
    # "auto" leaves small or f64 matrices alone and engages on a large f32 one
    assert _rcm_reorder(SpmvHandle(A)) is None
    big = tkc.generate_fem2d_csr(5000, seed=1, dtype=np.float32, device=CPU)
    assert _rcm_reorder(SpmvHandle(big)) is not None
    assert _rcm_reorder(SpmvHandle(big.astype(torch.float64))) is None


def test_example_gmres_ex_real_a_scenario():
    """examples/gmres_ex_real_A.py's scenario through the port on the CPU:
    plain GMRES, then ILU(0)-GMRES, which takes no more iterations; both
    converge, with the iteration counts tpukk reports."""
    A = tkc.generate_diag_dominant_csr(400, 8, dtype=np.float64, seed=1, device=CPU)
    b = torch.ones(A.nrows, dtype=torch.float64)
    x, stats = gmres(GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b)
    kh = SpilukHandle(fill_level=0)
    spiluk_symbolic(kh, A)
    L, U = spiluk_numeric(kh, A)
    x2, stats2 = gmres(GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b, prec=LUPrec(L, U))
    assert stats.converged and stats2.converged
    assert stats2.num_iters <= stats.num_iters
    Aj = jkc.generate_diag_dominant_csr(400, 8, dtype=np.float64, seed=1)
    _, sj = jsp.gmres(jsp.GmresHandle(m=25, tol=1e-8, max_restarts=40), Aj, jnp.ones(400))
    assert sj.num_iters == stats.num_iters
    for xs in (x, x2):
        r = b.numpy() - A.to_scipy() @ xs.numpy()
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b.numpy())
