"""tpukk_torch's Gauss-Seidel path against tpukk on the CPU (mirrors
tests/test_gauss_seidel.py).

Slice: ``GsHandle`` → ``gauss_seidel_symbolic`` → ``gauss_seidel_numeric`` →
forward / backward / symmetric sweeps and ``gauss_seidel_apply`` (POINT,
CLUSTER with MIS2 and Balloon, TWOSTAGE plain and ``compact_form``; ω = 1 and
1.2; ``x=None``, ``permuted=True``, a multivector of k = 4), and ``GsPrec``
inside ``pcg``.  Kernel module: K6's plain version (``gs_color_step_plain``)
against tpukk's color step on tpukk's own color blocks.  The SERIAL coloring,
the MIS2 aggregates and the Balloon clusters equal tpukk's, so both packages
sweep in one order; ``interop.gs_symbolic_from_numpy`` hands over colorings
that are computed only in tpukk.

Tolerance: |x − x_ref| ≤ tol_for(dtype)·max|x_ref| (tests/conftest.py's
10·eps): the products of a color block are summed in another order
(index_add_ against tpukk's padded-row sum), and a few sweeps carry that
rounding along.  The sequential-GS oracle is held at the same tolerance; the
multivector's columns are held to single-column applies at the same
tolerance; GsPrec-PCG to tpukk's iteration count and 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.sparse.linalg import spsolve_triangular

import tpukk.containers as jkc
import tpukk.sparse as jsp
from tpukk.sparse import gauss_seidel as jgs
from tpukk_torch.interop import csr_from_numpy, gs_symbolic_from_numpy
from tpukk_torch.sparse import (ClusteringAlgorithm, GsAlgorithm, GsHandle, GsPrec, JacobiPrec,
                                backward_sweep, forward_sweep, gauss_seidel_apply,
                                gauss_seidel_numeric, gauss_seidel_symbolic, pcg,
                                symmetric_sweep)
from tpukk_torch.sparse import gs_cuda, spmv_cuda

from conftest import tol_for

CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _close(got, ref, dtype=np.float64):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol_for(dtype) * max(np.abs(ref).max(), 1e-300), err


def _shifted_lap(nx, shift, dtype=np.float64):
    sp = jkc.generate_structured_laplacian(nx, nx, dtype=dtype).to_scipy()
    sp.setdiag(sp.diagonal() + shift)
    return jkc.CsrMatrix.from_scipy(sp.tocsr())


# handle settings, each the same in both packages
VARIANTS = {
    "point": dict(algorithm="POINT"),
    "cluster_mis2": dict(algorithm="CLUSTER", clustering="MIS2"),
    "cluster_balloon": dict(algorithm="CLUSTER", clustering="BALLOON"),
    "twostage": dict(algorithm="TWOSTAGE"),
    "twostage_compact": dict(algorithm="TWOSTAGE", compact_form=True, inner_sweeps=3),
}


def _handles(variant, Aj, At, omega=1.0):
    kw = dict(VARIANTS[variant])
    alg, clu = kw.pop("algorithm"), kw.pop("clustering", None)
    hj = jgs.GsHandle(jgs.GsAlgorithm[alg],
                      clustering=None if clu is None else jgs.ClusteringAlgorithm[clu], **kw)
    ht = GsHandle(GsAlgorithm[alg],
                  clustering=None if clu is None else ClusteringAlgorithm[clu], **kw)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj, omega=omega)
    gauss_seidel_symbolic(ht, At)
    gauss_seidel_numeric(ht, At, omega=omega)
    return hj, ht


@pytest.fixture(scope="module")
def mats():
    # dd: past the DENSE size, so TWOSTAGE's L and U take the ONEHOT route
    return {"dd": jkc.generate_diag_dominant_csr(300, 5, dtype=np.float64, seed=11),
            "lap": _shifted_lap(12, 1.0)}


@pytest.mark.parametrize("omega", [1.0, 1.2])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sweeps_equal_tpukk(mats, variant, direction, omega, rng):
    for Aj in mats.values():
        At = _port(Aj)
        hj, ht = _handles(variant, Aj, At, omega)
        if variant.startswith(("point", "cluster")):
            np.testing.assert_array_equal(ht.order, hj.order)
        b = rng.standard_normal(Aj.nrows)
        x0 = rng.standard_normal(Aj.nrows)
        ref = jgs.gauss_seidel_apply(hj, Aj, jnp.asarray(x0), jnp.asarray(b), 2, direction)
        xt = torch.from_numpy(x0.copy())
        got = gauss_seidel_apply(ht, At, xt, torch.from_numpy(b), 2, direction)
        assert torch.equal(xt, torch.from_numpy(x0))  # x is not modified
        _close(got, ref)
        sweep = {"forward": forward_sweep, "backward": backward_sweep,
                 "symmetric": symmetric_sweep}[direction]
        _close(sweep(ht, At, None, torch.from_numpy(b), 1),
               jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 1, direction))


def test_point_forward_sweep_is_gs_in_color_order(mats, rng):
    """With the same order, multicolor GS is GS on the permuted matrix:
    x_p ← (D + L_p)⁻¹ (b_p − U_p·x_p) at ω = 1."""
    for Aj in mats.values():
        At = _port(Aj)
        h = GsHandle()
        gauss_seidel_symbolic(h, At)
        gauss_seidel_numeric(h, At)
        b, x0 = rng.standard_normal(Aj.nrows), rng.standard_normal(Aj.nrows)
        got = forward_sweep(h, At, torch.from_numpy(x0), torch.from_numpy(b)).numpy()
        o = h.order
        Ap = At.to_scipy()[o][:, o].tocsr()
        rhs = b[o] - sps.triu(Ap, k=1) @ x0[o]
        ref = np.empty_like(b)
        ref[o] = spsolve_triangular(sps.tril(Ap, k=0).tocsr(), rhs, lower=True)
        _close(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ["point", "cluster_mis2"])
def test_color_step_plain_equals_tpukk_step(variant, dtype, rng):
    """K6's plain version, one color step on each of tpukk's color blocks,
    uncoupled (POINT) and coupled (CLUSTER), k = 1 and 4, against tpukk's
    step (gauss_seidel.py:277-286) on the same permuted x.  The kernel's two
    modes are held to this plain version on the card (test_torch_cuda.py)."""
    Aj = jkc.CsrMatrix.from_scipy(_shifted_lap(14, 0.5).to_scipy().astype(dtype))
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At, omega=1.2)
    blocks = ht._blocks[torch.float32 if dtype == np.float32 else torch.float64]
    assert len(blocks) == len(hj.blocks)
    assert any(b.coupled for b in blocks) == (variant != "point")
    n = Aj.nrows
    for k in (1, 4):
        shape = (n,) if k == 1 else (n, k)
        for c, (bj, bt) in enumerate(zip(hj.blocks, blocks)):
            assert bt.start == bj.start and bt.nrows == bj.inv_diag.shape[0]
            np.testing.assert_array_equal(bt.inv_diag.numpy(), np.asarray(bj.inv_diag))
            xp = rng.standard_normal(shape).astype(dtype)
            bp = rng.standard_normal(shape).astype(dtype)
            s, e = bj.start, bj.start + bt.nrows
            cols = [xp] if k == 1 else [xp[:, j] for j in range(k)]
            bcols = [bp] if k == 1 else [bp[:, j] for j in range(k)]
            ref = []
            for xj, bjj in zip(cols, bcols):
                ax = jnp.sum(bj.vals * jnp.take(jnp.asarray(xj), bj.cols, axis=0), axis=1)
                xnew = (1.0 - 1.2) * xj[s:e] + 1.2 * bj.inv_diag * (bjj[s:e] - ax)
                ref.append(np.concatenate([xj[:s], np.asarray(xnew, dtype), xj[e:]]))
            ref = ref[0] if k == 1 else np.stack(ref, axis=1)
            got = gs_cuda.gs_color_step(bt, torch.from_numpy(xp.copy()), torch.from_numpy(bp), 1.2)
            _close(got, ref, dtype)


@pytest.mark.parametrize("variant", ["point", "cluster_mis2", "twostage"])
def test_multivector_k4_equals_single_columns_and_tpukk(mats, variant, rng, monkeypatch):
    Aj = mats["dd"]
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At)
    spmm_calls = []
    orig = spmv_cuda.csr_spmm
    monkeypatch.setattr(spmv_cuda, "csr_spmm", lambda p, X: spmm_calls.append(X.shape) or orig(p, X))
    B = rng.standard_normal((Aj.nrows, 4))
    X0 = rng.standard_normal((Aj.nrows, 4))
    for x0 in (None, X0):
        xt = None if x0 is None else torch.from_numpy(x0)
        got = gauss_seidel_apply(ht, At, xt, torch.from_numpy(B), 2)
        ref = jgs.gauss_seidel_apply(hj, Aj, None if x0 is None else jnp.asarray(x0),
                                     jnp.asarray(B), 2)
        _close(got, ref)
        for j in range(4):
            col = gauss_seidel_apply(ht, At, None if x0 is None else xt[:, j].contiguous(),
                                     torch.from_numpy(B[:, j].copy()), 2)
            _close(got[:, j], col.numpy())
    # TWOSTAGE's unbanded L and U take K7 on the ONEHOT route
    assert (len(spmm_calls) > 0) == (variant == "twostage")


def test_wide_multivector_goes_in_chunks_of_16(mats, rng):
    Aj = mats["lap"]
    At = _port(Aj)
    hj, ht = _handles("point", Aj, At)
    B = rng.standard_normal((Aj.nrows, 19))
    got = gauss_seidel_apply(ht, At, None, torch.from_numpy(B), 1)
    _close(got, jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(B), 1))


@pytest.mark.parametrize("variant", ["point", "cluster_balloon"])
def test_permuted_space_apply(mats, variant, rng):
    Aj = mats["dd"]
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At)
    b = rng.standard_normal(Aj.nrows)
    x_nat = gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 3)
    bp = torch.from_numpy(b[ht.order])
    x0 = torch.zeros_like(bp)
    xp = gauss_seidel_apply(ht, At, x0, bp, 3, permuted=True)
    assert torch.equal(x0, torch.zeros_like(bp))
    _close(xp.numpy()[ht.inv_order], x_nat.numpy())
    ref = jgs.gauss_seidel_apply(hj, Aj, jnp.zeros(Aj.nrows), jnp.asarray(b)[hj.order], 3,
                                 permuted=True)
    _close(xp, ref)


def test_gs_symbolic_from_numpy_takes_tpukk_colorings(mats, rng):
    """A VB coloring and a CLUSTER clustering computed in tpukk, handed over."""
    Aj = mats["dd"]
    At = _port(Aj)
    b = rng.standard_normal(Aj.nrows)
    hj = jgs.GsHandle(coloring=jgs.ColoringAlgorithm.VB)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj, omega=0.9)
    ht = GsHandle()
    gs_symbolic_from_numpy(ht, At, colors=np.asarray(hj.colors))
    gauss_seidel_numeric(ht, At, omega=0.9)
    np.testing.assert_array_equal(ht.order, hj.order)
    _close(gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 2),
           jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 2))
    hj = jgs.GsHandle(jgs.GsAlgorithm.CLUSTER)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj)
    for colors in (np.asarray(hj.colors), None):
        ht = GsHandle(GsAlgorithm.CLUSTER)
        gs_symbolic_from_numpy(ht, At, colors=colors, cluster_labels=hj.cluster_labels)
        gauss_seidel_numeric(ht, At)
        np.testing.assert_array_equal(ht.order, hj.order)
        _close(gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 2),
               jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 2))


def test_error_decreases_every_sweep_f32(rng):
    """The reference's oracle (Test_Sparse_gauss_seidel.hpp) in f32, where the
    port sweeps in the matrix's dtype as tpukk does."""
    Aj = jkc.CsrMatrix.from_scipy(_shifted_lap(16, 1.0).to_scipy().astype(np.float32))
    At = _port(Aj)
    x_true = rng.standard_normal(Aj.nrows)
    b = (Aj.to_scipy().astype(np.float64) @ x_true).astype(np.float32)
    for variant in ("point", "cluster_mis2", "cluster_balloon", "twostage"):
        hj, ht = _handles(variant, Aj, At)
        x, errs = None, []
        for _ in range(5):
            x = gauss_seidel_apply(ht, At, x, torch.from_numpy(b), 1)
            assert x.dtype == torch.float32
            errs.append(np.linalg.norm(x.numpy() - x_true))
        assert all(e1 < e0 for e0, e1 in zip(errs, errs[1:])) and errs[-1] < 0.2 * errs[0]
        _close(x, jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 5), np.float32)


def test_gsprec_pcg_equals_tpukk_on_laplacian():
    Aj = jkc.generate_structured_laplacian(30, 30, dtype=np.float64)
    At = _port(Aj)
    b = np.random.default_rng(5).standard_normal(Aj.nrows)
    hj, ht = _handles("point", Aj, At)
    xj, sj = jsp.pcg(Aj, jnp.asarray(b), tol=1e-10, max_iters=500, prec=jsp.GsPrec(hj, Aj))
    xt, st = pcg(At, torch.from_numpy(b), tol=1e-10, max_iters=500, prec=GsPrec(ht, At))
    assert sj.converged and st.converged and st.num_iters == sj.num_iters
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()


def test_gsprec_takes_fewer_pcg_iterations_than_jacobi_on_fem():
    from tpukk_torch.containers import generate_fem2d_csr

    A = generate_fem2d_csr(800, seed=0, dtype=np.float64, device=CPU)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.nrows))
    h = GsHandle()
    gauss_seidel_symbolic(h, A)
    gauss_seidel_numeric(h, A)
    x, st = pcg(A, b, tol=1e-8, max_iters=3000, prec=GsPrec(h, A))
    _, sjac = pcg(A, b, tol=1e-8, max_iters=3000, prec=JacobiPrec(A))
    assert st.converged and sjac.converged and st.num_iters < sjac.num_iters
    r = b.numpy() - A.to_scipy() @ x.numpy()
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b.numpy())


def test_refuses_block_matrices_and_misuse():
    At = _port(jkc.generate_diag_dominant_csr(30, 3, dtype=np.float64, seed=8))
    with pytest.raises(NotImplementedError, match="A2"):
        gauss_seidel_symbolic(GsHandle(), object())
    h = GsHandle()
    with pytest.raises(Exception, match="symbolic first"):
        gauss_seidel_numeric(h, At)
    gauss_seidel_symbolic(h, At)
    with pytest.raises(Exception, match="numeric first"):
        gauss_seidel_apply(h, At, None, torch.ones(30, dtype=torch.float64))
