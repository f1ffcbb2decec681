"""tpukk_torch's complex SpMM and Gauss-Seidel (ROADMAP A3b) against tpukk on
the CPU.

The same numpy inputs, made from a seed, go to tpukk and to the port
(``device="cpu"``, so K2, K6 and K7 run their plain versions):

- POINT, CLUSTER (MIS2) and TWOSTAGE sweeps in each direction, on a vector
  (k = 1) and a multivector of k = 3, in complex128 and complex64, against
  tpukk's ``gauss_seidel_apply`` (which vmaps the columns);
- block Gauss-Seidel on a banded block graph (the DIA route: K1 on vectors,
  K2 on multivectors) and an unstructured one (the BSR route), against
  tpukk's block half-sweeps;
- GsPrec inside PCG on a small Hermitian magnetic Laplacian: tpukk's
  iteration count and solution;
- complex ``spmm`` on the DIA and ONEHOT routes against ``tpukk.sparse.spmm``;
- a complex b on a real handle (POINT, CLUSTER, TWOSTAGE and block), which
  both packages promote to complex.

Tolerance: complex128 within 1e-12 of max|ref|, complex64 within 1e-5 (the
products of a row are summed in another order, and a few sweeps carry that
rounding along); PCG to tpukk's iteration count and 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse as jsp
from tpukk.sparse import gauss_seidel as jgs
import tpukk_torch.containers as tkc
import tpukk_torch.sparse as tsp
from tpukk_torch.sparse import GsAlgorithm, SpmvAlgorithm
from tpukk_torch.sparse import gs_cuda, spmv_cuda

CPU = "cpu"
CDTYPES = [np.complex64, np.complex128]
TOL = {np.complex64: 1e-5, np.complex128: 1e-12}


def _rel_close(got, ref, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.dtype(dtype), (got.dtype, dtype)
    err = np.abs(got.astype(np.complex128) - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


def _cx(rng, shape, dtype):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _complex_dd(n=300, seed=11):
    """generate_diag_dominant_csr's matrix with imaginary parts on every
    entry: past the DENSE size, so TWOSTAGE's L and U take the ONEHOT route."""
    sp = jkc.generate_diag_dominant_csr(n, 5, dtype=np.float64, seed=seed).to_scipy().tocsr()
    im = np.random.default_rng(seed).standard_normal(sp.nnz) * 0.3
    spc = sps.csr_matrix((sp.data + 1j * im, sp.indices, sp.indptr), shape=sp.shape)
    spc.sort_indices()
    return spc


def _magnetic_laplacian(nx, shift):
    """4I − Σ e^{iθ} over grid neighbours (Landau gauge): Hermitian positive
    definite for a positive shift."""
    n = nx * nx
    ix = np.arange(n) % nx
    ex = (ix[:-1] < nx - 1).astype(float)
    ey = np.exp(2j * np.pi * 0.01 * ix[:-nx])
    H = sps.diags([-ey.conj(), -ex, np.full(n, 4.0 + shift), -ex, -ey], [-nx, -1, 0, 1, nx],
                  format="csr").astype(np.complex128)
    H.eliminate_zeros()
    H.sort_indices()
    return H


def _handles(alg, sp, dtype):
    spd = sp.astype(dtype)
    Aj = jkc.CsrMatrix.from_scipy(spd)
    At = tkc.CsrMatrix.from_scipy(spd, device=CPU)
    hj = jgs.GsHandle(jgs.GsAlgorithm[alg])
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj, omega=1.1)
    ht = tsp.GsHandle(GsAlgorithm[alg])
    tsp.gauss_seidel_symbolic(ht, At)
    tsp.gauss_seidel_numeric(ht, At, omega=1.1)
    return Aj, At, hj, ht


_HANDLES = {}


def _cached(alg, dtype):
    key = (alg, dtype)
    if key not in _HANDLES:
        _HANDLES[key] = _handles(alg, _complex_dd(), dtype)
    return _HANDLES[key]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("alg", ["POINT", "CLUSTER", "TWOSTAGE"])
@pytest.mark.parametrize("dtype", CDTYPES, ids=["c64", "c128"])
def test_complex_sweeps_equal_tpukk(dtype, alg, direction, k):
    """Two sweeps from a given x and one from zero: the port's complex
    sweeps (K6's plain version for POINT and CLUSTER, K3/K7's for
    TWOSTAGE's triangles) keep the complex dtype and equal tpukk's."""
    Aj, At, hj, ht = _cached(alg, dtype)
    if alg != "TWOSTAGE":
        np.testing.assert_array_equal(ht.order, hj.order)
        assert next(iter(ht._plans.values())).csr.values.dtype == torch.from_numpy(
            np.zeros(1, dtype)).dtype
    rng = np.random.default_rng(3)
    shape = (At.nrows,) if k == 1 else (At.nrows, k)
    b, x0 = _cx(rng, shape, dtype), _cx(rng, shape, dtype)
    xt = torch.from_numpy(x0.copy())
    got = tsp.gauss_seidel_apply(ht, At, xt, torch.from_numpy(b), 2, direction)
    assert torch.equal(xt, torch.from_numpy(x0))  # x is not modified
    ref = jgs.gauss_seidel_apply(hj, Aj, jnp.asarray(x0), jnp.asarray(b), 2, direction)
    _rel_close(got, ref, dtype)
    got0 = tsp.gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 1, direction)
    _rel_close(got0, jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 1, direction), dtype)


@pytest.mark.parametrize("dtype", CDTYPES, ids=["c64", "c128"])
def test_complex_fused_sweep_plain_equals_per_color_steps(dtype):
    """K6's fused sweep's plain version equals the per-color loop of
    gs_color_step_plain exactly in complex values, and a color step stays
    within step_error_bound of tpukk's step formula in complex128."""
    _, At, _, ht = _cached("CLUSTER", dtype)
    plan = next(iter(ht._plans.values()))
    plan.reps = ht.cluster_inner_sweeps
    rng = np.random.default_rng(4)
    b = torch.from_numpy(_cx(rng, (At.nrows, 3), dtype))
    x = torch.from_numpy(_cx(rng, (At.nrows, 3), dtype))
    fused = gs_cuda.gs_sweep(plan, x, b, 1.1, "symmetric", 1)
    loop = gs_cuda.gs_sweep_per_color(plan, x, b, 1.1, "symmetric", 1)
    assert torch.equal(fused, loop)
    blk = plan.blocks[0]
    xp = x.clone()
    got = gs_cuda.gs_color_step(blk, xp.clone(), b, 1.1)
    s, e = blk.start, blk.start + blk.nrows
    ax = spmv_cuda.csr_spmm_plain(blk.csr, xp)
    want = (1 - 1.1) * xp[s:e] + 1.1 * blk.inv_diag[:, None] * (b[s:e] - ax)
    assert ((got[s:e] - want).abs() <= gs_cuda.step_error_bound(blk, xp, b, 1.1)).all()
    assert torch.equal(got[e:], xp[e:]) and torch.equal(got[:s], xp[:s])


def _block_pair(Ab, b):
    Aj = jkc.BsrMatrix.from_scipy_bsr(sps.bsr_matrix(Ab, blocksize=(b, b)))
    At = tkc.BsrMatrix.from_scipy_bsr(Aj.to_scipy(), device=CPU)
    hj, ht = jsp.GsHandle(), tsp.GsHandle()
    jsp.gauss_seidel_symbolic(hj, Aj)
    jsp.gauss_seidel_numeric(hj, Aj, omega=0.9)
    tsp.gauss_seidel_symbolic(ht, At)
    tsp.gauss_seidel_numeric(ht, At, omega=0.9)
    np.testing.assert_array_equal(ht.colors, np.asarray(hj.colors))
    return Aj, At, hj, ht


def _block_matrix(route, dtype, shift=0.5j):
    """A banded 3-dof block matrix (the DIA route) or an unstructured one
    (the BSR route), with ``shift`` (0.5i) on the diagonal blocks' diagonal."""
    if route == "dia":
        Ac = jkc.generate_structured_laplacian(8, 8, dtype=np.float64).to_scipy()
        A = (sps.kron(Ac, np.eye(3))
             + sps.kron(sps.eye(Ac.shape[0]), 0.3 * np.ones((3, 3)) + 3 * np.eye(3)))
    else:
        R = jkc.generate_random_bsr(40, 40, 3, 4, dtype=np.float64, seed=3).to_scipy().tocsr()
        A = R + R.T + sps.identity(R.shape[0]) * (abs(R).sum(1).max() * 2 + 1)
    return (A + shift * sps.identity(A.shape[0])).tocsr().astype(dtype)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("route", ["dia", "bsr"])
@pytest.mark.parametrize("dtype", CDTYPES, ids=["c64", "c128"])
def test_complex_block_gs_equals_tpukk(dtype, route, k):
    """Complex block GS: D and D⁻¹ stay complex; the banded block graph takes
    the DIA route (K1 on vectors, K2 on multivectors), the unstructured one
    the BSR route; both sweep as tpukk's _block_half_sweep does."""
    Aj, At, hj, ht = _block_pair(_block_matrix(route, dtype), 3)
    want = SpmvAlgorithm.DIA if route == "dia" else SpmvAlgorithm.BSR
    assert ht._blk["h"].algorithm == want
    assert ht._blk["sets"][0][2].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    rng = np.random.default_rng(5)
    shape = (At.nrows,) if k == 1 else (At.nrows, k)
    b, x0 = _cx(rng, shape, dtype), _cx(rng, shape, dtype)
    for direction in ("forward", "backward", "symmetric"):
        got = tsp.gauss_seidel_apply(ht, At, torch.from_numpy(x0), torch.from_numpy(b), 2,
                                     direction)
        ref = jsp.gauss_seidel_apply(hj, Aj, jnp.asarray(x0), jnp.asarray(b), 2, direction)
        _rel_close(got, ref, dtype)


def test_complex_gsprec_pcg_equals_tpukk():
    """GsPrec (symmetric POINT sweeps: a Hermitian operator on a Hermitian
    matrix) inside PCG on a magnetic Laplacian: tpukk's iteration count."""
    H = _magnetic_laplacian(20, 0.01)
    Aj = jkc.CsrMatrix.from_scipy(H)
    At = tkc.CsrMatrix.from_scipy(H, device=CPU)
    b = _cx(np.random.default_rng(6), H.shape[0], np.complex128)
    hj = jsp.GsHandle()
    jsp.gauss_seidel_symbolic(hj, Aj)
    jsp.gauss_seidel_numeric(hj, Aj)
    ht = tsp.GsHandle()
    tsp.gauss_seidel_symbolic(ht, At)
    tsp.gauss_seidel_numeric(ht, At)
    xj, sj = jsp.pcg(Aj, jnp.asarray(b), tol=1e-10, max_iters=500, prec=jsp.GsPrec(hj, Aj))
    xt, st = tsp.pcg(At, torch.from_numpy(b), tol=1e-10, max_iters=500,
                     prec=tsp.GsPrec(ht, At))
    assert sj.converged and st.converged and st.num_iters == sj.num_iters
    assert xt.dtype == torch.complex128
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.linalg.norm(b - H @ xt.numpy()) <= 1e-9 * np.linalg.norm(b)


def _banded(rng, n=400):
    offs = (-20, -1, 0, 1, 20)
    diags = [rng.standard_normal(n - abs(o)) + 1j * rng.standard_normal(n - abs(o)) for o in offs]
    diags[2] = diags[2] + 8.0
    return sps.diags(diags, offs, format="csr")


def _random(rng, n=600):
    D = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    D = D * (rng.random((n, n)) < 0.02)
    np.fill_diagonal(D, D.diagonal() + 8.0)
    return sps.csr_matrix(D)


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("case", ["banded400", "random600"])
@pytest.mark.parametrize("dtype", CDTYPES, ids=["c64", "c128"])
def test_complex_spmm_routes_equal_tpukk(dtype, case, k):
    """Complex SpMM takes the real gate's route (DIA → K2, ONEHOT → K7,
    here their plain versions) and equals tpukk.sparse.spmm, with complex
    alpha and beta."""
    rng = np.random.default_rng(42)
    sp = (_banded(rng) if case == "banded400" else _random(rng)).astype(dtype)
    sp.sort_indices()
    Aj = jkc.CsrMatrix.from_scipy(sp)
    At = tkc.CsrMatrix.from_scipy(sp, device=CPU)
    want = SpmvAlgorithm.DIA if case == "banded400" else SpmvAlgorithm.ONEHOT
    assert tsp.SpmvHandle(At).algorithm == want
    X, Y0 = _cx(rng, (sp.shape[1], k), dtype), _cx(rng, (sp.shape[0], k), dtype)
    got = tsp.spmm(At, torch.from_numpy(X))
    _rel_close(got, jsp.spmm(Aj, jnp.asarray(X)), dtype)
    alpha, beta = 0.5 - 1j, 2 + 0.25j
    got = tsp.spmm(At, torch.from_numpy(X), alpha, beta, torch.from_numpy(Y0))
    ref = jsp.spmm(Aj, jnp.asarray(X), alpha, beta, jnp.asarray(Y0))
    _rel_close(got, ref, dtype)


@pytest.mark.parametrize("alg", ["POINT", "CLUSTER", "TWOSTAGE", "BLOCK"])
def test_complex_b_on_a_real_handle(alg):
    """A complex b on a real handle: the port promotes the plan (and D, D⁻¹
    of block GS) to complex128, as tpukk's promotion does, and equals
    tpukk's sweep."""
    rng = np.random.default_rng(8)
    if alg == "BLOCK":
        Aj, At, hj, ht = _block_pair(_block_matrix("dia", np.float64, 0.0), 3)
    else:
        sp = _complex_dd().real.tocsr()
        Aj, At, hj, ht = _handles(alg, sp, np.float64)
    b = _cx(rng, At.nrows, np.complex128)
    got = tsp.gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 2, "symmetric")
    ref = jsp.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 2, "symmetric")
    _rel_close(got, ref, np.complex128)
    if alg in ("POINT", "CLUSTER"):
        assert set(ht._plans) == {torch.float64, torch.complex128}
