"""tpukk_torch's complex values (ROADMAP A3a) against tpukk on the CPU.

Mirrors tests/test_complex.py case by case: the same matrices, seeds and
sizes, the same numpy inputs handed to tpukk and to the port
(``device="cpu"``), compared at the reference's tolerances (1e-12 for the
SpMV modes, SpGEMM and SpADD; 1e-10 for SpTRSV; 1e-9 for GMRES; 1e-8 for
PCG).  Then:

- matrices large enough to leave the DENSE route (≤ 256²): a banded n = 400
  (DIA, K1's plain version) and an unstructured n = 600 (ONEHOT, K3's), with
  their SpGEMM (K8's plain version), SpADD and triangles (K4's);
- complex64 held to tpukk's four-real-product pair route within
  test_complex64_pair_route_matches_xla's 60·eps·max|ref|;
- the repairs: C7 (SEQLVLSCHD's symbolic kept complex values), C8 (the
  supernodal plans), C9 (GMRES conjugates), and a pinned DS on complex x;
- K5 on complex values, K8's complex product from its parts, K4's words;
- the conversions that carry complex values into the port;
- complex Gauss-Seidel, complex SpMM on DIA/ONEHOT and the K2/K6/K7
  wrappers (ROADMAP A3b, refused until PR 15 ported them; the sweeps in
  every direction are in tests/test_torch_complex_gs.py), and the refusals
  that stay (K3's max reduction, K9); tests/test_torch_cuda.py holds the
  kernels on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import tpukk.containers as jkc
import tpukk.sparse as jsp
import tpukk_torch.containers as tkc
import tpukk_torch.sparse as tsp
from tpukk.sparse.trsv import trsv as j_trsv
from tpukk_torch.common.permute import build_permute_plan, permute_gather, static_permute
from tpukk_torch.interop import csr_from_numpy, level_plan_from_numpy, spgemm_symbolic_from_numpy
from tpukk_torch.sparse import SpmvAlgorithm
from tpukk_torch.sparse import gs_cuda, spgemm_cuda
from tpukk_torch.sparse import spmv_cuda as kc
from tpukk_torch.sparse import sptrsv_cuda as ks
from tpukk_torch.sparse.gmres import _arnoldi_cycle, _norm
from tpukk_torch.sparse.spmv_impl import build_dia_plan
from tpukk_torch.sparse.sptrsv_supernodal import FusedSupernodalPlan, SupernodalPlan
from tpukk_torch.sparse.trsv import trsv as t_trsv

CPU = "cpu"


def _rand_complex_csr(rng, n, density=0.1, diag_boost=4.0, dtype=np.complex128):
    """tests/test_complex.py's matrix."""
    D = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    D = D * (rng.random((n, n)) < density)
    np.fill_diagonal(D, D.diagonal() + diag_boost)
    return sps.csr_matrix(D.astype(dtype)), D.astype(dtype)


def _banded(rng, n=400, dtype=np.complex128):
    """A complex banded matrix (5 diagonals): the DIA route."""
    offs = (-20, -1, 0, 1, 20)
    diags = [rng.standard_normal(n - abs(o)) + 1j * rng.standard_normal(n - abs(o)) for o in offs]
    diags[2] = diags[2] + 8.0
    sp = sps.diags(diags, offs, format="csr").astype(dtype)
    sp.sort_indices()
    return sp, sp.toarray()


def magnetic_laplacian(nx, ny, phi=0.01, shift=0.0):
    """4I − Σ e^{iθ} over grid neighbours in the Landau gauge: x-edges real,
    y-edges (i_x, i_y)–(i_x, i_y + 1) with θ = 2πφ·i_x; Hermitian, positive
    definite (the magnetic 2-D Laplacian of quantum and magnetic models)."""
    n = nx * ny
    ix = np.arange(n) % nx
    ex = np.r_[ix[:-1] < nx - 1].astype(float)      # (i, i+1) inside one row of x
    ey = np.exp(2j * np.pi * phi * ix[:-nx])         # (i, i+nx)
    H = sps.diags([-ey.conj(), -ex, np.full(n, 4.0 + shift), -ex, -ey],
                  [-nx, -1, 0, 1, nx], format="csr").astype(np.complex128)
    H.eliminate_zeros()
    H.sort_indices()
    return H


CASES = ("mirror50", "banded400", "random600")


def _case(name, dtype=np.complex128):
    rng = np.random.default_rng(42)
    if name == "mirror50":
        return _rand_complex_csr(rng, 50, dtype=dtype)
    if name == "banded400":
        return _banded(rng, dtype=dtype)
    if name == "random120":  # for tpukk's imported factors, whose solves it compiles by level
        return _rand_complex_csr(rng, 120, density=0.05, diag_boost=8.0, dtype=dtype)
    return _rand_complex_csr(rng, 600, density=0.02, diag_boost=8.0, dtype=dtype)


ROUTE = {"mirror50": SpmvAlgorithm.DENSE, "banded400": SpmvAlgorithm.DIA,
         "random600": SpmvAlgorithm.ONEHOT}


def _both(sp):
    sp = sp.tocsr()
    sp.sort_indices()
    return jkc.CsrMatrix.from_scipy(sp), tkc.CsrMatrix.from_scipy(sp, device=CPU)


def _cvec(rng, n, dtype=np.complex128):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


# ---------------------------------------------------------------------------
# SpMV: modes N/T/C/H (TestComplexSparse.test_spmv_modes)
# ---------------------------------------------------------------------------

def _op(D, mode):
    return {"N": D, "T": D.T, "C": D.conj(), "H": D.conj().T}[mode]


@pytest.mark.parametrize("mode", ["N", "T", "C", "H"])
@pytest.mark.parametrize("case", CASES)
def test_spmv_modes(case, mode):
    """C conjugates without transposing, H conjugate-transposes; the port
    equals tpukk and the dense product at 1e-12, on the DENSE, DIA and
    ONEHOT routes (the last two through K1's and K3's plain versions), with
    complex alpha and beta on the larger cases."""
    sp, D = _case(case)
    Aj, At = _both(sp)
    rng = np.random.default_rng(7)
    x = _cvec(rng, D.shape[0])
    assert tsp.SpmvHandle(At).algorithm == ROUTE[case]
    if case == "mirror50":
        got = tsp.spmv(At, torch.from_numpy(x), mode=mode).numpy()
        ref_j = np.asarray(jsp.spmv(Aj, jnp.asarray(x), mode=mode))
        ref = _op(D, mode) @ x
    else:
        alpha, beta, y0 = 0.5 - 1j, 2 + 0.25j, _cvec(rng, D.shape[0])
        got = tsp.spmv(At, torch.from_numpy(x), alpha, beta, torch.from_numpy(y0),
                       mode=mode).numpy()
        ref_j = np.asarray(jsp.spmv(Aj, jnp.asarray(x), alpha, beta, jnp.asarray(y0), mode=mode))
        ref = beta * y0 + alpha * (_op(D, mode) @ x)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, ref_j, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["random800 (the pair-route test's)", "banded400"])
def test_complex64_matches_tpukk_pair_route(case):
    """complex64 on K3's (ONEHOT) and K1's (DIA) plain versions, held to
    tpukk's pair route (four real f32 products of the (re, im) planes, its
    Pallas route on a TPU) within test_complex64_pair_route_matches_xla's
    60·eps·max|ref|."""
    if case.startswith("random800"):
        n = 800
        sp = sps.random(n, n, 0.01, random_state=5, dtype=np.float64).tocsr()
        sp = (sp + sps.identity(n)).tocsr()
        sp.sort_indices()
        spc = sp.astype(np.complex64)
        spc.data = (spc.data + 1j * np.random.default_rng(1).standard_normal(spc.nnz)
                    .astype(np.float32))
        x = (np.random.default_rng(2).standard_normal(n)
             + 1j * np.random.default_rng(3).standard_normal(n)).astype(np.complex64)
        route = SpmvAlgorithm.ONEHOT
    else:
        spc, _ = _case("banded400", np.complex64)
        x = _cvec(np.random.default_rng(2), spc.shape[0], np.complex64)
        route = SpmvAlgorithm.DIA
    Aj, At = _both(spc)
    h_pair = jsp.SpmvHandle(Aj)
    h_pair._force_complex_pair = True
    y_pair = np.asarray(h_pair(x))
    assert h_pair._cpair is not None
    ht = tsp.SpmvHandle(At)
    assert ht.algorithm == route
    got = ht(torch.from_numpy(x)).numpy()
    assert got.dtype == np.complex64
    ref = spc.astype(np.complex128) @ x.astype(np.complex128)
    tol = 60 * np.finfo(np.float32).eps * np.abs(ref).max()
    assert np.abs(got - y_pair).max() < tol
    assert np.abs(got - ref).max() < tol


def test_conjugated_handle_is_cached():
    """``SpmvHandle.conjugated``: a handle on conj(A) on the same route,
    built once; a real handle is its own conjugate."""
    sp, D = _case("random600")
    _, At = _both(sp)
    h = tsp.SpmvHandle(At)
    hc = h.conjugated()
    assert hc is h.conjugated() and hc.algorithm == h.algorithm
    np.testing.assert_array_equal(hc.A.values.numpy(), np.conj(At.values.numpy()))
    real = tsp.SpmvHandle(tkc.generate_random_csr(300, 300, 5, seed=4, dtype=np.float64,
                                                  device=CPU))
    assert real.conjugated() is real


def test_real_matrix_complex_vector():
    """A real matrix times a complex x is computed complex (the plans in the
    complex dtype) and keeps its imaginary part; a complex matrix times a
    real x likewise."""
    A = tkc.generate_random_csr(300, 300, 5, seed=4, dtype=np.float64, device=CPU)
    x = _cvec(np.random.default_rng(3), 300)
    y = tsp.spmv(A, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-12, atol=1e-12)
    sp, D = _case("random600")
    _, At = _both(sp)
    xr = np.random.default_rng(4).standard_normal(600)
    yr = tsp.spmv(At, torch.from_numpy(xr))
    assert yr.dtype == torch.complex128
    np.testing.assert_allclose(yr.numpy(), D @ xr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["banded400", "random600"])
def test_ds_on_complex_is_complex128(case):
    """A pinned DS computes in native f64, complex128 for complex operands:
    x's imaginary part is kept (no ``x.double()``), as tpukk's route keeps
    the matrix's (tpukk/sparse/spmv.py:330-343)."""
    sp, D = _case(case, np.complex64)
    _, At = _both(sp)
    x = _cvec(np.random.default_rng(5), D.shape[0], np.complex64)
    h = tsp.SpmvHandle(At, SpmvAlgorithm.DS)
    y = h(torch.from_numpy(x))
    assert y.dtype == torch.complex128
    ref = D.astype(np.complex128) @ x.astype(np.complex128)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(h.matvec_f64(x), ref, rtol=1e-12, atol=1e-12)
    # a real matrix pinned to DS with a complex x
    Ar = tkc.CsrMatrix.from_scipy(abs(sp).astype(np.float64), device=CPU)
    yr = tsp.SpmvHandle(Ar, SpmvAlgorithm.DS)(torch.from_numpy(x))
    assert yr.dtype == torch.complex128
    np.testing.assert_allclose(yr.numpy(), abs(sp).astype(np.float64) @ x.astype(np.complex128),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# SpGEMM and SpADD (TestComplexSparse.test_spgemm_spadd)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_spgemm_spadd(case):
    """A·A and (1+2i)·A + (3−i)·A against tpukk and the dense results at
    1e-12; the unstructured case runs K8's plain version, which forms each
    product from its parts, so numeric reuse with 2·A gives exactly 4·C."""
    sp, D = _case(case)
    Aj, At = _both(sp)
    C = tsp.spgemm(At, At)
    Cj = jsp.spgemm(Aj, Aj)
    assert C.dtype == torch.complex128
    np.testing.assert_allclose(C.to_scipy().toarray(), D @ D, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C.to_scipy().toarray(), Cj.to_scipy().toarray(), rtol=1e-12,
                               atol=1e-12)
    S = tsp.spadd(1 + 2j, At, 3 - 1j, At)
    Sj = jsp.spadd(1 + 2j, Aj, 3 - 1j, Aj)
    np.testing.assert_allclose(S.to_scipy().toarray(), (4 + 1j) * D, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(S.to_scipy().toarray(), Sj.to_scipy().toarray(), rtol=1e-12,
                               atol=1e-12)
    h = tsp.SpgemmHandle()
    tsp.spgemm_symbolic(h, At, At)
    C1 = tsp.spgemm_numeric(h, At, At)
    A2 = At.with_values(2 * At.values)
    assert torch.equal(tsp.spgemm_numeric(h, A2, A2).values, 4 * C1.values)


def test_k8_complex_product_from_parts():
    """K8's plain version forms a complex product as (ar·br − ai·bi,
    ar·bi + ai·br), each operation rounded on its own (the kernel's formula),
    and sums each C entry in pair order: within (n_c+1)·eps·(|A||B|) of the
    exact product, and equal to scipy's on a 1-term product."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_cvec(rng, 1000))
    b = torch.from_numpy(_cvec(rng, 1000))
    p = spgemm_cuda.product_rn(a, b)
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    assert torch.equal(p.real, ar * br - ai * bi) and torch.equal(p.imag, ar * bi + ai * br)
    assert torch.equal(spgemm_cuda.product_rn(a.real, b.real), a.real * b.real)
    sp, D = _case("random600")
    _, At = _both(sp)
    h = tsp.SpgemmHandle()
    tsp.spgemm_symbolic(h, At, At)
    got = spgemm_cuda.spgemm_rows(h.row_plan, At.values, At.values)
    C = (sp @ sp).tocsr()
    C.sort_indices()
    Cabs = (abs(sp) @ abs(sp)).tocsr()
    Cabs.sort_indices()
    nc = int(np.diff(C.indptr).max())
    assert np.all(np.abs(got.numpy() - C.data) <= (nc + 1) * np.finfo(np.float64).eps * Cabs.data)


def test_dia_spgemm_and_bsr_complex():
    """The banded DIA SpGEMM, bspgemm (reuse on 2·A gives exactly 4·C) and
    bspadd in torch ops on complex values, against tpukk and the dense
    results."""
    sp, D = _case("banded400")
    Aj, At = _both(sp)
    C = tsp.spgemm(At, At, tsp.SpgemmAlgorithm.DIA)
    np.testing.assert_allclose(C.to_scipy().toarray(), D @ D, rtol=1e-12, atol=1e-12)
    Bt = tkc.crs2bsr(At, 4)
    Bj = jkc.crs2bsr(Aj, 4)
    h = tsp.SpgemmHandle()
    tsp.bspgemm_symbolic(h, Bt, Bt)
    Cb = tsp.bspgemm_numeric(h, Bt, Bt)
    np.testing.assert_allclose(Cb.to_scipy().toarray(), D @ D, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Cb.to_scipy().toarray(), jsp.bspgemm(Bj, Bj).to_scipy().toarray(),
                               rtol=1e-12, atol=1e-12)
    B2 = Bt.with_values(2 * Bt.values)
    assert torch.equal(tsp.bspgemm_numeric(h, B2, B2).values, 4 * Cb.values)
    S = tsp.bspadd(1 - 1j, Bt, 0.5j, Bt)
    np.testing.assert_allclose(S.to_scipy().toarray(), (1 - 0.5j) * D, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# SpTRSV (TestComplexSparse.test_sptrsv) and the repairs C7, C8
# ---------------------------------------------------------------------------

ALGOS = {"SEQLVLSCHD": (tsp.SptrsvAlgorithm.SEQLVLSCHD, jsp.SptrsvAlgorithm.SEQLVLSCHD),
         "SUPERNODAL": (tsp.SptrsvAlgorithm.SUPERNODAL, jsp.SptrsvAlgorithm.SUPERNODAL)}


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("case,lower", [("mirror50", True), ("banded400", True),
                                        ("random600", False)])
def test_sptrsv(case, lower, algo):
    """x with tri(T)·x = b against tpukk and the residual at 1e-10 (K4's
    plain version; SUPERNODAL through the expanded DAG)."""
    sp, D = _case(case)
    T = sps.csr_matrix(np.tril(D) if lower else np.triu(D))
    Tj, Tt = _both(T)
    b = _cvec(np.random.default_rng(9), D.shape[0])
    ta, ja = ALGOS[algo]
    ht = tsp.SptrsvHandle(lower, algorithm=ta)
    tsp.sptrsv_symbolic(ht, Tt)
    x = tsp.sptrsv_solve(ht, Tt, torch.from_numpy(b)).numpy()
    hj = jsp.SptrsvHandle(lower, algorithm=ja)
    jsp.sptrsv_symbolic(hj, Tj)
    xj = np.asarray(jsp.sptrsv_solve(hj, Tj, jnp.asarray(b)))
    assert x.dtype == np.complex128
    np.testing.assert_allclose(T @ x, b, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_c7_seqlvlschd_keeps_complex_values(dtype):
    """C7: the level plan keeps the values' complex dtype and takes 1/diag in
    it (the parent cast them to f32, dropping the imaginary part: residual
    1.74 on tril of test_complex.py's matrix)."""
    sp, D = _case("mirror50", dtype)
    T = sps.csr_matrix(np.tril(D))
    _, Tt = _both(T)
    h = tsp.SptrsvHandle(True)
    tsp.sptrsv_symbolic(h, Tt)
    assert h.plan.dtype == tkc.torch_dtype(dtype) and h.plan.invd.dtype == h.plan.dtype
    assert h.plan.words.numel() == ks.words_per_value(h.plan.dtype) * 50
    b = _cvec(np.random.default_rng(9), 50, dtype)
    x = tsp.sptrsv_solve(h, Tt, torch.from_numpy(b)).numpy()
    tol = 1e-10 if dtype == np.complex128 else 1e-4
    assert np.abs(T.astype(np.complex128) @ x - b).max() < tol


@pytest.mark.parametrize("fused", [True, False], ids=["dag", "batched"])
def test_c8_supernodal_plans_keep_complex_values(fused):
    """C8: the fused DAG (block inverses in complex128, values in the
    input's dtype) and the batched plan stay complex (the parent's DAG cast
    to f64 and built a real diagonal: residual 1.83); the two agree."""
    sp, D = _case("random600")
    T = sps.csr_matrix(np.tril(D))
    _, Tt = _both(T)
    from tpukk_torch.sparse.sptrsv_supernodal import build_supernodal_plan

    plan = build_supernodal_plan(Tt.host_row_map(), Tt.host_entries(), Tt.host_values(), 600,
                                 lower=True, device=CPU, fused=fused)
    assert isinstance(plan, FusedSupernodalPlan if fused else SupernodalPlan)
    assert plan.dtype == torch.complex128
    if fused:
        assert plan.plan.vals.dtype == torch.complex128
    b = _cvec(np.random.default_rng(10), 600)
    x = tsp.sptrsv_supernodal.supernodal_solve(plan, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(T @ x, b, rtol=1e-10, atol=1e-10)
    ref = spla.spsolve_triangular(T, b, lower=True)
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-10)


def test_real_triangle_complex_rhs():
    """A real plan solves a complex b in complex (the plan's values cast
    once, K4's words widened): no imaginary part is dropped."""
    sp, D = _case("random600")
    T = sps.csr_matrix(np.tril(np.abs(D)))
    _, Tt = _both(T)
    b = _cvec(np.random.default_rng(11), 600)
    for algo in (tsp.SptrsvAlgorithm.SEQLVLSCHD, tsp.SptrsvAlgorithm.SUPERNODAL):
        h = tsp.SptrsvHandle(True, algorithm=algo)
        tsp.sptrsv_symbolic(h, Tt)
        x = tsp.sptrsv_solve(h, Tt, torch.from_numpy(b))
        assert x.dtype == torch.complex128
        np.testing.assert_allclose(T @ x.numpy(), b, rtol=1e-10, atol=1e-10)


def test_k4_words_per_value():
    """K4's publication words: one a row in f32, two in f64 and complex64,
    four in complex128; a plan cast to a wider dtype gets its own words."""
    assert [ks.words_per_value(d) for d in (torch.float32, torch.float64, torch.complex64,
                                            torch.complex128)] == [1, 2, 2, 4]
    sp, D = _case("mirror50")
    T = sps.csr_matrix(np.tril(np.abs(D)))
    _, Tt = _both(T)
    h = tsp.SptrsvHandle(True)
    tsp.sptrsv_symbolic(h, Tt)
    p64 = h.plan
    assert p64.words.numel() == 100
    pc = p64.astype(torch.complex128)
    assert pc.words.numel() == 200 and pc.words is not p64.words
    assert p64.astype(torch.float32).words is p64.words
    assert p64.astype(torch.complex64).words is p64.words


def test_plans_in_another_dtype_are_built_once_and_results_keep_imaginary_parts():
    """A level plan (the SEQLVLSCHD handle's and a fused supernodal DAG's) in
    another dtype is built once and reused; every solve, SpMV and SpGEMM
    returns the input's dtype unless that would drop a complex result's
    imaginary part (``common.result_dtype``)."""
    from tpukk_torch.common import result_dtype

    sp, D = _case("mirror50")
    T = sps.csr_matrix(np.tril(np.abs(D)))
    _, Tt = _both(T)
    for algo in (tsp.SptrsvAlgorithm.SEQLVLSCHD, tsp.SptrsvAlgorithm.SUPERNODAL):
        h = tsp.SptrsvHandle(True, algorithm=algo)
        tsp.sptrsv_symbolic(h, Tt)
        plan = h.plan if algo == tsp.SptrsvAlgorithm.SEQLVLSCHD else h.sn_plan.plan
        assert plan.astype(torch.complex128) is plan.astype(torch.complex128)
        assert plan.astype(plan.dtype) is plan
        b = torch.from_numpy(np.arange(50) + 1j * np.ones(50))
        x = tsp.sptrsv_solve(h, Tt, b)
        assert x.dtype == torch.complex128
        assert np.abs(T @ x.numpy() - b.numpy()).max() < 1e-10
    f64, f32, c64, c128 = torch.float64, torch.float32, torch.complex64, torch.complex128
    assert [result_dtype(g, c) for g, c in ((f32, f64), (f64, c128), (c64, c128), (f32, c64),
                                            (c128, c128))] == [f32, c128, c64, c64, c128]


def test_trsv_conjugate_transpose():
    """trsv's C mode solves conj(tri(A))ᵀ·x = b (tpukk/sparse/trsv.py:30),
    T mode the transpose."""
    sp, D = _case("random600")
    Aj, At = _both(sp)
    b = _cvec(np.random.default_rng(12), 600)
    for trans, op in (("T", np.tril(D).T), ("C", np.tril(D).conj().T)):
        x = t_trsv("L", trans, "N", At, torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(op @ x, b, rtol=1e-10, atol=1e-10)
        xj = np.asarray(j_trsv("L", trans, "N", Aj, jnp.asarray(b)))
        np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_superlu_import_complex(algo):
    """superlu_import of a complex ``splu`` keeps the factors complex (as
    tpukk/sparse/sptrsv_superlu.py:53-67 does) and solves A·x = b."""
    sp, D = _case("random120")
    lu = spla.splu(sp.tocsc())
    ta, ja = ALGOS[algo]
    s = tsp.superlu_import(lu, ta, device=CPU)
    assert s.L.dtype == torch.complex128 and s.U.dtype == torch.complex128
    b = _cvec(np.random.default_rng(13), 120)
    x = s(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(sp @ x, b, rtol=1e-10, atol=1e-10)
    xj = np.asarray(jsp.superlu_import(lu, ja)(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# Krylov solvers (TestComplexSparse.test_gmres, test_pcg_hermitian) and C9
# ---------------------------------------------------------------------------

def test_c9_norm_and_arnoldi_conjugate():
    """C9: ‖x‖ is sqrt(real(Σ conj(x)·x)), real; one Arnoldi cycle's basis
    is orthonormal under the conjugating inner product (the parent's
    unconjugated dots and real norm gave neither)."""
    x = torch.from_numpy(_cvec(np.random.default_rng(14), 100))
    nx = _norm(x)
    assert not nx.dtype.is_complex
    np.testing.assert_allclose(float(nx), np.linalg.norm(x.numpy()), rtol=1e-14)
    sp, D = _case("random600")
    _, At = _both(sp)
    b = torch.from_numpy(_cvec(np.random.default_rng(15), 600))
    for ortho in (tsp.Ortho.CGS2, tsp.Ortho.MGS):
        xn = _arnoldi_cycle(tsp.SpmvHandle(At), tsp.IdentityPrec(), b, torch.zeros_like(b), 30,
                            ortho)
        r1 = np.linalg.norm(b.numpy() - sp @ xn.numpy()) / np.linalg.norm(b.numpy())
        assert r1 < 0.5


@pytest.mark.parametrize("ortho", ["CGS2", "MGS"])
def test_gmres(ortho):
    """test_complex.py's GMRES (m=40, tol 1e-10): converged, residual below
    1e-9, and x within 1e-9 of tpukk's."""
    sp, D = _case("mirror50")
    Aj, At = _both(sp)
    b = _cvec(np.random.default_rng(16), 50)
    ht = tsp.GmresHandle(m=40, tol=1e-10, max_restarts=10, ortho=getattr(tsp.Ortho, ortho))
    x, stats = tsp.gmres(ht, At, torch.from_numpy(b))
    assert stats.converged
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-9
    hj = jsp.GmresHandle(m=40, tol=1e-10, max_restarts=10, ortho=getattr(jsp.Ortho, ortho))
    xj, sj = jsp.gmres(hj, Aj, jnp.asarray(b))
    assert sj.converged and stats.num_iters == sj.num_iters
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", ["none", "jacobi", "superlu", "rcm"])
def test_gmres_complex_shifted(kind):
    """GMRES(30) on the unstructured case (K3's plain version), without a
    preconditioner, with a complex Jacobi diagonal and with reorder="rcm"
    (K5 on complex views), and on a 120-row case with imported complex
    SuperLU factors (two K4 solves an apply): residual below 1e-9, x within
    1e-9 of tpukk's run."""
    sp, D = _case("random120" if kind == "superlu" else "random600")
    Aj, At = _both(sp)
    b = _cvec(np.random.default_rng(17), D.shape[0])
    reorder = "rcm" if kind == "rcm" else "none"
    ht = tsp.GmresHandle(m=30, tol=1e-10, max_restarts=20, reorder=reorder)
    hj = jsp.GmresHandle(m=30, tol=1e-10, max_restarts=20, reorder=reorder)
    pt = pj = None
    if kind == "jacobi":
        pt, pj = tsp.JacobiPrec(At), jsp.JacobiPrec(Aj)
        assert pt.inv_diag.dtype == torch.complex128
    elif kind == "superlu":
        lu = spla.splu(sp.tocsc())
        pt = tsp.superlu_import(lu, device=CPU)
    x, st = tsp.gmres(ht, At, torch.from_numpy(b), prec=pt)
    assert st.converged
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-9
    if kind == "superlu":
        # tpukk compiles its cycle with the imported solves' levels inside
        # (a minute on the CPU): held to the solution, and the import to
        # tpukk's in test_superlu_import_complex
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(D, b), rtol=1e-9, atol=1e-9)
        return
    xj, sj = jsp.gmres(hj, Aj, jnp.asarray(b), prec=pj)
    assert sj.converged
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


def test_pcg_hermitian():
    """test_complex.py's HPD PCG (n = 40, tol 1e-10): H·x = b at 1e-8, and x
    within 1e-8 of tpukk's."""
    rng = np.random.default_rng(42)
    n = 40
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = B @ B.conj().T + n * np.eye(n)
    Aj, At = _both(sps.csr_matrix(H.astype(np.complex128)))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x, stats = tsp.pcg(At, torch.from_numpy(b), tol=1e-10, max_iters=200)
    assert stats.converged
    np.testing.assert_allclose(H @ x.numpy(), b, rtol=1e-8, atol=1e-8)
    xj, sj = jsp.pcg(Aj, jnp.asarray(b), tol=1e-10, max_iters=200)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("prec", ["jacobi", "lu"])
def test_pcg_magnetic_laplacian(prec):
    """PCG on a magnetic Laplacian + 0.01·I (Hermitian, DIA route): 30 × 30
    with JacobiPrec and its complex-typed diagonal, 12 × 12 with LUPrec over
    its exact complex L and U (two K4 solves an apply); within 1e-8 of the
    solution and of tpukk's iterate with the same preconditioner."""
    H = magnetic_laplacian(*((30, 30) if prec == "jacobi" else (12, 12)), shift=0.01)
    Aj, At = _both(H)
    assert tsp.SpmvHandle(At).algorithm == (SpmvAlgorithm.DIA if prec == "jacobi"
                                            else SpmvAlgorithm.DENSE)
    b = _cvec(np.random.default_rng(18), H.shape[0])
    if prec == "jacobi":
        pt, pj = tsp.JacobiPrec(At), jsp.JacobiPrec(Aj)
    else:
        lu = spla.splu(H.tocsc(), permc_spec="NATURAL", diag_pivot_thresh=0.0)
        L, U = lu.L.tocsr(), lu.U.tocsr()
        pt = tsp.LUPrec(*_both(L)[1:], *_both(U)[1:])
        pj = jsp.LUPrec(_both(L)[0], _both(U)[0])
    x, st = tsp.pcg(At, torch.from_numpy(b), tol=1e-10, max_iters=1000, prec=pt)
    xj, sj = jsp.pcg(Aj, jnp.asarray(b), tol=1e-10, max_iters=1000, prec=pj)
    assert st.converged and st.num_iters == sj.num_iters
    np.testing.assert_allclose(H @ x.numpy(), b, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# K5 on complex values, conversions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
def test_permute_complex(dtype):
    """K5's wrapper moves complex values (its plain version here; on the
    card complex64 as f64 and complex128 as rows of two f64): exact."""
    rng = np.random.default_rng(19)
    src = rng.permutation(1000)
    plan = build_permute_plan(src, CPU)
    x = torch.from_numpy(_cvec(rng, 1000)).to(dtype)
    assert torch.equal(static_permute(plan, x), x[torch.from_numpy(src)])
    X = torch.complex(torch.randn(1000, 3, dtype=torch.float64),
                      torch.randn(1000, 3, dtype=torch.float64)).to(dtype)
    assert torch.equal(permute_gather(plan.src, X), X[torch.from_numpy(src)])


def test_conversions_carry_complex_values():
    """CsrMatrix.from_scipy and interop's csr_from_numpy,
    level_plan_from_numpy and spgemm_symbolic_from_numpy carry complex numpy
    arrays into the port unchanged."""
    sp, D = _case("random600", np.complex64)
    At = tkc.CsrMatrix.from_scipy(sp, device=CPU)
    assert At.dtype == torch.complex64
    np.testing.assert_array_equal(At.values.numpy(), sp.data)
    sp = sp.astype(np.complex128)
    Aj, _ = _both(sp)
    Ai = csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                        nrows=600, ncols=600, device=CPU)
    assert Ai.dtype == torch.complex128
    np.testing.assert_array_equal(Ai.values.numpy(), sp.data)
    T = sps.csr_matrix(np.tril(sp.toarray()))
    levels = jsp.sptrsv._compute_levels(T.indptr, T.indices, 600, True)
    plan = level_plan_from_numpy(T.indptr, T.indices, T.data, levels, True, CPU)
    assert plan.dtype == torch.complex128
    b = _cvec(np.random.default_rng(20), 600)
    x = ks.sptrsv_levels(plan, torch.from_numpy(b), plan.order, plan.order).numpy()
    np.testing.assert_allclose(T @ x, b, rtol=1e-10, atol=1e-10)
    hj = jsp.SpgemmHandle()
    jsp.spgemm_symbolic(hj, Aj, Aj)
    h = tsp.SpgemmHandle()
    spgemm_symbolic_from_numpy(h, Ai, Ai, hj.row_map_c, hj.entries_c)
    C = tsp.spgemm_numeric(h, Ai, Ai)
    np.testing.assert_allclose(C.to_scipy().toarray(), (sp @ sp).toarray(), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# ROADMAP A3b, once refused, now ported (tests/test_torch_complex_gs.py holds
# the sweeps in every direction); what stays refused
# ---------------------------------------------------------------------------

def test_complex_gauss_seidel_names_a3b():
    """Complex Gauss-Seidel, refused until A3b was ported, now runs: POINT,
    CLUSTER and TWOSTAGE on a complex matrix, block GS on its 3×3 blocks and
    a complex b on a real handle, each a symmetric sweep equal to tpukk's
    within 1e-12."""
    import tpukk.sparse.gauss_seidel as jgs

    sp, D = _case("random600")
    Aj, At = _both(sp)
    b = _cvec(np.random.default_rng(0), 600)

    def held(hj, ht, Aj, At, b):
        got = tsp.gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 1, "symmetric").numpy()
        ref = np.asarray(jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 1, "symmetric"))
        assert got.dtype == np.complex128
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())

    for alg in ("POINT", "CLUSTER", "TWOSTAGE"):
        h, hj = tsp.GsHandle(tsp.GsAlgorithm[alg]), jgs.GsHandle(jgs.GsAlgorithm[alg])
        tsp.gauss_seidel_symbolic(h, At)
        tsp.gauss_seidel_numeric(h, At)
        jgs.gauss_seidel_symbolic(hj, Aj)
        jgs.gauss_seidel_numeric(hj, Aj)
        held(hj, h, Aj, At, b)
    Bj = jkc.crs2bsr(Aj, 3)
    Bt = tkc.BsrMatrix.from_scipy_bsr(Bj.to_scipy(), device=CPU)
    hb, hbj = tsp.GsHandle(), jsp.GsHandle()
    tsp.gauss_seidel_symbolic(hb, Bt)
    tsp.gauss_seidel_numeric(hb, Bt)
    jsp.gauss_seidel_symbolic(hbj, Bj)
    jsp.gauss_seidel_numeric(hbj, Bj)
    held(hbj, hb, Bj, Bt, b)
    Arj, Ar = _both(abs(sp))
    hr, hrj = tsp.GsHandle(), jgs.GsHandle()
    tsp.gauss_seidel_symbolic(hr, Ar)
    tsp.gauss_seidel_numeric(hr, Ar)
    jgs.gauss_seidel_symbolic(hrj, Arj)
    jgs.gauss_seidel_numeric(hrj, Arj)
    held(hrj, hr, Arj, Ar, b)


@pytest.mark.parametrize("case", ["banded400", "random600"])
def test_complex_spmm_names_a3b(case):
    """A complex 2-D x on the DIA and ONEHOT routes, refused until A3b was
    ported, now runs K2 and K7 (their plain versions here) and equals tpukk
    and the dense product; ELL, SEGSUM and DENSE give the same values."""
    sp, D = _case(case)
    Aj, At = _both(sp)
    X = torch.from_numpy(np.stack([_cvec(np.random.default_rng(21 + j), D.shape[0])
                                   for j in range(3)], 1))
    assert tsp.SpmvHandle(At).algorithm == ROUTE[case]
    Y = tsp.spmm(At, X).numpy()
    np.testing.assert_allclose(Y, np.asarray(jsp.spmm(Aj, jnp.asarray(X.numpy()))), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Y, D @ X.numpy(), rtol=1e-12, atol=1e-12)
    for alg in (SpmvAlgorithm.ELL, SpmvAlgorithm.SEGSUM, SpmvAlgorithm.DENSE):
        Y = tsp.spmm(At, X, algorithm=alg).numpy()
        np.testing.assert_allclose(Y, D @ X.numpy(), rtol=1e-12, atol=1e-12)


def test_real_kernel_wrappers_refuse_complex():
    """The wrappers of K2 (dia_spmm), K7 (csr_spmm) and K6 (gs_color_step,
    gs_sweep) take complex values (their plain versions here, equal to the
    dense product and to the per-color path); what stays real raises
    TpuKKError: K3's max reduction, and K9's probe (real, as tpukk's is)."""
    from tpukk_torch.common import TpuKKError
    from tpukk_torch.common import probe_cuda as kp

    sp, D = _case("banded400")
    _, At = _both(sp)
    rng = np.random.default_rng(22)
    X = torch.from_numpy(np.stack([_cvec(rng, 400) for _ in range(4)], 1))
    Y = kc.dia_spmm(build_dia_plan(At, dtype=torch.complex128), X).numpy()
    np.testing.assert_allclose(Y, D @ X.numpy(), rtol=1e-12, atol=1e-12)
    cp = kc.build_csr_plan(At, torch.complex128)
    np.testing.assert_allclose(kc.csr_spmm(cp, X).numpy(), D @ X.numpy(), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(TpuKKError, match="max"):
        kc.csr_spmv(cp, torch.zeros(400, dtype=torch.complex128), "max")
    Ar = tkc.CsrMatrix.from_scipy(abs(sp), device=CPU)
    h = tsp.GsHandle()
    tsp.gauss_seidel_symbolic(h, Ar)
    tsp.gauss_seidel_numeric(h, Ar)
    plan = next(iter(h._plans.values())).to(torch.complex128)
    assert plan.csr.values.dtype == plan.inv_diag.dtype == torch.complex128
    z = torch.from_numpy(_cvec(rng, 400))
    np.testing.assert_array_equal(gs_cuda.gs_sweep(plan, None, z, 1.0).numpy(),
                                  gs_cuda.gs_sweep_per_color(plan, None, z, 1.0).numpy())
    blk = plan.blocks[0]
    x = torch.from_numpy(_cvec(rng, 400))
    got = gs_cuda.gs_color_step(blk, x.clone(), z, 1.0)
    assert torch.equal(got, gs_cuda.gs_color_step_plain(blk, x.clone(), z, 1.0))
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "probe_ss_cost_torch.py"
    spec = importlib.util.spec_from_file_location("probe_ss_cost_torch", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    pplan, px = drv.make_plan("base", 80, 3, CPU)
    with pytest.raises(TpuKKError, match="dtype"):
        kp.probe_gather_acc(pplan, px.to(torch.complex64))


def test_spiluk_factors_the_real_part_like_tpukk():
    """A difference of the reference, not a port fault (ROADMAP §C):
    tpukk's SpILUK factors the real part of complex values
    (tpukk/sparse/spiluk.py:141), and the port does the same, so both give
    the same factors."""
    sp, D = _case("random600")
    Aj, At = _both(sp)
    ht = tsp.SpilukHandle(0)
    tsp.spiluk_symbolic(ht, At)
    Lt, Ut = tsp.spiluk_numeric(ht, At)
    hj = jsp.SpilukHandle(0)
    jsp.spiluk_symbolic(hj, Aj)
    Lj, Uj = jsp.spiluk_numeric(hj, Aj)
    np.testing.assert_allclose(Lt.to_scipy().toarray(), Lj.to_scipy().toarray(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Ut.to_scipy().toarray(), Uj.to_scipy().toarray(), rtol=1e-12,
                               atol=1e-12)
