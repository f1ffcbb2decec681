"""tpukk_torch's CUDA kernels on a CUDA device: each kernel against its plain
version, and the SpMV/PCG, ILU(0)-GMRES and Gauss-Seidel paths (coloring,
MIS2, sweeps, GsPrec-PCG) through the kernels.  Every test skips without a
CUDA device: the kernels have no CPU mode.

This file imports neither JAX nor tpukk, so it runs on a GPU host that has
neither, without tests/conftest.py (which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: |y - y_plain| <= 20·eps·(|A|·|x|)_i (the products are the same,
summed in another order); the max reduction and the permutation must agree
exactly; a triangular solve x must satisfy |T·x - b| <= 20·eps·(|T|·|x|)_i and
|x - x_plain| <= M(T)⁻¹·(40·eps·|T||x|)_i (M(T) the comparison matrix); a
Gauss-Seidel color step is held to gs_cuda.step_error_bound (20·eps of its
absolute terms) on the block's rows and must leave the other rows exactly as
they were; whole sweeps (a few color steps in a row) to 1e-12 relative in f64.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk_torch.containers as tkc
import tpukk_torch.graph as tg
from tpukk_torch.sparse import (ClusteringAlgorithm, GmresHandle, GsAlgorithm, GsHandle, GsPrec,
                                JacobiPrec, LUPrec, Ortho, SpilukHandle, SpmvAlgorithm,
                                SpmvHandle, gauss_seidel_apply, gauss_seidel_numeric,
                                gauss_seidel_symbolic, gmres, pcg, spiluk_numeric,
                                spiluk_symbolic, spmm, spmv, trsv)
from tpukk_torch.sparse import gs_cuda as kg
from tpukk_torch.sparse import spmv_cuda as kc
from tpukk_torch.sparse import sptrsv_cuda as ks
from tpukk_torch.sparse import spmv_impl
from tpukk_torch.sparse.sptrsv import SptrsvHandle, sptrsv_symbolic

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _x(n, dtype, dev, k=None, seed=0):
    a = np.random.default_rng(seed).standard_normal(n if k is None else (n, k))
    return torch.from_numpy(a).to(dev, dtype)


def _held(got, plain, bound, dtype):
    torch.cuda.synchronize()
    return bool(((got - plain).abs() <= 20 * torch.finfo(dtype).eps * bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_kernel_matches_plain(dev, dtype):
    d = np.zeros((500, 400))
    d[::7, ::3] = 1.5  # rows with and without entries
    cases = [tkc.generate_structured_laplacian(64, 64, device=dev),
             tkc.generate_random_csr(3000, 2500, 12, seed=3, device=dev),
             tkc.generate_random_csr(300, 300, 70, seed=4, device=dev),  # 32 lanes
             tkc.CsrMatrix.from_dense(d, device=dev)]
    for A in cases:
        x = _x(A.ncols, dtype, dev)
        cp = kc.build_csr_plan(A, dtype)
        acp = dataclasses.replace(cp, values=cp.values.abs())
        n0 = kc.csr_spmv.launches
        assert _held(kc.csr_spmv(cp, x), kc.csr_plain(cp, x), kc.csr_plain(acp, x.abs()), dtype)
        assert kc.csr_spmv.launches == n0 + 1
        xa = x.abs()
        assert torch.equal(kc.csr_spmv(acp, xa, "max"), kc.csr_plain(acp, xa, "max"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_dia_kernels_match_plain(dev, dtype):
    sq = tkc.generate_structured_laplacian(64, 64, device=dev)
    rect = tkc.CsrMatrix.from_scipy(sps.diags([1.0, 2.0, 3.0], [-3, 0, 40], shape=(300, 500)),
                                    device=dev)
    for A in (sq, rect):
        p = spmv_impl.build_dia_plan(A, dtype=dtype)
        ap = dataclasses.replace(p, diags=p.diags.abs())
        for k in (None, 1, 8, 11):
            X = _x(A.ncols, dtype, dev, k)
            fn = kc.dia_spmv if k is None else kc.dia_spmm
            n0 = fn.launches
            assert _held(fn(p, X), kc.dia_plain(p, X), kc.dia_plain(ap, X.abs()), dtype)
            assert fn.launches == n0 + 1


def test_cuda_tensor_never_falls_back(dev):
    A = tkc.generate_structured_laplacian(32, 32, device="cpu")
    p = spmv_impl.build_dia_plan(A)
    with pytest.raises(Exception):
        kc.dia_spmv(p, torch.ones(A.ncols, device=dev))  # plan on the CPU


def test_handle_and_pcg_run_through_the_kernels(dev):
    A = tkc.generate_structured_laplacian(100, 100, dtype=np.float64, device=dev)
    R = tkc.generate_random_csr(5000, 5000, 10, seed=2, dtype=np.float64, device=dev)
    kc.reset_launch_counts()
    x = _x(A.ncols, torch.float64, dev)
    y = spmv(A, x, mode="T")
    yr = SpmvHandle(R)(_x(R.ncols, torch.float64, dev))
    torch.cuda.synchronize()
    assert SpmvHandle(R).algorithm == SpmvAlgorithm.ONEHOT
    np.testing.assert_allclose(y.cpu().numpy(), A.to_scipy().T @ x.cpu().numpy(), rtol=1e-12,
                               atol=1e-12)
    assert yr.shape == (5000,) and kc.launch_counts()["csr_spmv"] == 1
    b = _x(A.nrows, torch.float64, dev, seed=1)
    xs, st = pcg(A, b, tol=1e-8, max_iters=2000, prec=JacobiPrec(A))
    r = b.cpu().numpy() - A.to_scipy() @ xs.cpu().numpy()
    assert st.converged and np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b.cpu().numpy())
    assert kc.launch_counts()["dia_spmv"] > st.num_iters


def test_empty_shapes_launch_nothing(dev):
    A = tkc.CsrMatrix.from_arrays([0], [], np.zeros(0), ncols=5, device=dev)
    p = spmv_impl.DiaPlan.from_numpy(np.zeros((1, 0)), [0], 0, 5, dev)
    n0 = kc.launch_counts()
    assert kc.csr_spmv(kc.build_csr_plan(A, torch.float64),
                       torch.ones(5, dtype=torch.float64, device=dev)).shape == (0,)
    assert kc.dia_spmv(p, torch.ones(5, dtype=torch.float64, device=dev)).shape == (0,)
    assert kc.dia_spmm(p, torch.ones(5, 0, dtype=torch.float64, device=dev)).shape == (0, 0)
    assert kc.launch_counts() == n0


def _ilu0(A):
    h = SpilukHandle(0)
    spiluk_symbolic(h, A)
    return spiluk_numeric(h, A)


def _solve_residual_ok(T, x, b, dtype):
    """|T·x - b| <= 20·eps·(|T|·|x|) per element, in f64 on the host."""
    sp = T.to_scipy().astype(np.float64)
    xh, bh = x.double().cpu().numpy(), b.double().cpu().numpy()
    bound = abs(sp) @ np.abs(xh)
    return bool((np.abs(sp @ xh - bh) <= 20 * torch.finfo(dtype).eps * bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sptrsv_kernel_matches_plain(dev, dtype):
    mats = [tkc.generate_structured_laplacian(64, 64, dtype=np.float64, device=dev),
            tkc.generate_diag_dominant_csr(3000, 8, dtype=np.float64, seed=5, device=dev)]
    for A in mats:
        for lower, T in zip((True, False), _ilu0(A)):
            T = T.astype(dtype)
            h = SptrsvHandle(lower=lower)
            sptrsv_symbolic(h, T)
            b = _x(T.nrows, dtype, dev, seed=2)
            n0 = ks.sptrsv_levels.launches
            x = ks.sptrsv_levels(h.plan, b)
            assert ks.sptrsv_levels.launches == n0 + 1
            xp = ks.sptrsv_plain(h.plan, b)
            torch.cuda.synchronize()
            assert ((x - xp).abs().double() <= ks.solve_error_bound(h.plan, x)).all()
            # in level order the plan is strictly lower: check the residual there
            order = h.plan.order.long()
            Tl = tkc.CsrMatrix.from_scipy(T.to_scipy()[order.cpu().numpy()][:, order.cpu().numpy()])
            assert _solve_residual_ok(Tl, x, b, dtype)
            # a second solve on the same plan (next epoch) gives the same x
            assert torch.equal(ks.sptrsv_levels(h.plan, b), x)


def test_sptrsv_kernel_replays_in_a_cuda_graph(dev):
    A = tkc.generate_structured_laplacian(40, 40, dtype=np.float64, device=dev)
    L, _ = _ilu0(A)
    h = SptrsvHandle(lower=True)
    sptrsv_symbolic(h, L)
    b = _x(L.nrows, torch.float64, dev, seed=3)
    ref = ks.sptrsv_levels(h.plan, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ks.sptrsv_levels(h.plan, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ks.sptrsv_levels(h.plan, b)
    for _ in range(3):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_permute_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(4)
    for n, k in ((100_003, None), (5000, 3), (1, None)):
        src = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        x = _x(n, dtype, dev, k)
        n0 = ks.permute_gather.launches
        y = ks.permute_gather(src, x)
        assert ks.permute_gather.launches == n0 + 1
        assert torch.equal(y, ks.permute_plain(src, x))
    assert ks.permute_gather(src[:0], x).shape == (0,)
    assert ks.permute_gather.launches == n0 + 1


def test_ilu_gmres_runs_through_the_kernels(dev):
    A = tkc.generate_diag_dominant_csr(4000, 8, dtype=np.float64, seed=7, device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=5)
    kc.reset_launch_counts()
    ks.reset_launch_counts()
    x, st = gmres(GmresHandle(m=20, tol=1e-10, max_restarts=20), A, b, prec=LUPrec(*_ilu0(A)))
    r = b.cpu().numpy() - A.to_scipy() @ x.cpu().numpy()
    assert st.converged and np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b.cpu().numpy())
    assert ks.launch_counts()["sptrsv_levels"] >= 2 * st.num_iters
    assert ks.launch_counts()["permute_gather"] >= 4 * st.num_iters
    assert kc.launch_counts()["csr_spmv"] >= st.num_iters


def test_rcm_route_runs_through_the_kernels(dev):
    A = tkc.generate_fem2d_csr(5000, seed=3, dtype=np.float32, device=dev)
    h = SpmvHandle(A, SpmvAlgorithm.RCM)
    x = _x(A.ncols, torch.float32, dev)
    ks.reset_launch_counts()
    y = h(x)
    assert ks.launch_counts()["permute_gather"] == 2
    ref = A.to_scipy().astype(np.float64) @ x.double().cpu().numpy()
    bound = abs(A.to_scipy().astype(np.float64)) @ np.abs(x.double().cpu().numpy())
    assert (np.abs(y.double().cpu().numpy() - ref) <= 20 * np.finfo(np.float32).eps * bound).all()


@pytest.mark.parametrize("ortho,sweeps", [("MGS", None), ("CGS2", 3)], ids=["mgs", "jacobi3"])
def test_gmres_variants_on_cuda(dev, ortho, sweeps):
    A = tkc.generate_diag_dominant_csr(3000, 8, dtype=np.float64, seed=9, device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=6)
    prec = LUPrec(*_ilu0(A), jacobi_sweeps=sweeps)
    x, st = gmres(GmresHandle(m=20, tol=1e-10, max_restarts=30, ortho=Ortho[ortho]), A, b,
                  prec=prec)
    r = b.cpu().numpy() - A.to_scipy() @ x.cpu().numpy()
    assert st.converged and np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b.cpu().numpy())


def test_trsv_on_cuda(dev):
    A = tkc.generate_diag_dominant_csr(2000, 6, dtype=np.float64, seed=10, device=dev)
    B = _x(A.nrows, torch.float64, dev, k=3, seed=7)
    for uplo, T in zip("LU", _ilu0(A)):
        Td = T.to_scipy().toarray()
        for trans in "NT":
            X = trsv(uplo, trans, "N", T, B)
            assert X.device == B.device and X.shape == B.shape
            op = Td.T if trans == "T" else Td
            Bh = B.cpu().numpy()
            assert np.abs(op @ X.cpu().numpy() - Bh).max() <= 1e-12 * np.abs(Bh).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_spmm_kernel_matches_plain(dev, dtype):
    cases = [tkc.generate_random_csr(3000, 2500, 12, seed=3, device=dev),
             tkc.generate_random_csr(300, 300, 70, seed=4, device=dev),  # 32 lanes
             tkc.generate_structured_laplacian(40, 40, device=dev)]
    for A in cases:
        cp = kc.build_csr_plan(A, dtype)
        acp = dataclasses.replace(cp, values=cp.values.abs())
        for k in (1, 2, 5, 8, 13, 16):
            X = _x(A.ncols, dtype, dev, k)
            n0 = kc.csr_spmm.launches
            assert _held(kc.csr_spmm(cp, X), kc.csr_spmm_plain(cp, X),
                         kc.csr_spmm_plain(acp, X.abs()), dtype)
            assert kc.csr_spmm.launches == n0 + 1


def test_onehot_spmm_route_launches_k7(dev):
    A = tkc.generate_random_csr(5000, 4000, 9, seed=6, dtype=np.float64, device=dev)
    X = _x(A.ncols, torch.float64, dev, 8)
    n0 = kc.csr_spmm.launches
    Y = spmm(A, X)
    assert kc.csr_spmm.launches == n0 + 1
    ref = A.to_scipy() @ X.cpu().numpy()
    assert np.abs(Y.cpu().numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _gs_handle(A, alg=GsAlgorithm.POINT, **kw):
    h = GsHandle(alg, **kw)
    gauss_seidel_symbolic(h, A)
    gauss_seidel_numeric(h, A, omega=kw.pop("omega", 1.0))
    return h


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("alg", ["POINT", "CLUSTER"])
def test_gs_color_step_kernel_matches_plain(dev, alg, dtype):
    mats = [tkc.generate_structured_laplacian(60, 60, dtype=np.float64, device=dev),
            tkc.generate_diag_dominant_csr(3000, 9, dtype=np.float64, seed=5, device=dev)]
    for A in mats:
        h = _gs_handle(A, GsAlgorithm[alg])
        blocks = [b.to(dtype) for b in next(iter(h._blocks.values()))]
        if A is mats[0]:  # symmetric: POINT blocks are uncoupled, CLUSTER ones coupled
            assert any(b.coupled for b in blocks) == (alg == "CLUSTER")
        for k in (None, 4, 16):
            for blk in blocks:
                x = _x(A.nrows, dtype, dev, k, seed=1)
                b = _x(A.nrows, dtype, dev, k, seed=2)
                plain = kg.gs_color_step_plain(blk, x.clone(), b, 1.2)
                tol = kg.step_error_bound(blk, x, b, 1.2)
                s, e = blk.start, blk.start + blk.nrows
                # an uncoupled block also runs out of place when marked coupled,
                # with a new buffer and with a caller's (larger) scratch buffer
                cases = [(blk, None)] if blk.coupled else [(blk, None), (
                    dataclasses.replace(blk, coupled=True), None)]
                cases.append((dataclasses.replace(blk, coupled=True), torch.full(
                    (x[s:e].numel() + 3,), float("nan"), dtype=dtype, device=dev)))
                for bv, scratch in cases:
                    n0 = kg.gs_color_step.launches
                    got = kg.gs_color_step(bv, x.clone(), b, 1.2, scratch)
                    torch.cuda.synchronize()
                    assert kg.gs_color_step.launches == n0 + 1
                    assert ((got[s:e] - plain[s:e]).abs() <= tol).all()
                    assert torch.equal(got[:s], x[:s]) and torch.equal(got[e:], x[e:])


def test_coloring_and_mis2_on_the_card_equal_the_cpu(dev):
    lap = tkc.generate_structured_laplacian(100, 100, device=dev)        # offsets path
    rnd = tkc.generate_random_csr(5000, 5000, 8, seed=13, device=dev)    # selection path
    sp = rnd.to_scipy()
    rnd = tkc.CsrMatrix.from_scipy(((sp + sp.T) * 0.5).tocsr(), device=dev)
    for A in (lap, rnd):
        cpu = tkc.CsrMatrix.from_scipy(A.to_scipy(), device="cpu")
        for alg in (tg.ColoringAlgorithm.VB, tg.ColoringAlgorithm.VBD):
            kc.reset_launch_counts()
            c = tg.graph_color(A, alg)
            assert tg.verify_coloring(A, c)
            np.testing.assert_array_equal(c, tg.graph_color(cpu, alg))
        assert (kc.launch_counts()["csr_spmv"] > 0) == (A is rnd)
        kc.reset_launch_counts()
        roots = tg.graph_mis2(A)
        assert kc.launch_counts()["csr_spmv"] >= 2
        np.testing.assert_array_equal(roots, tg.graph_mis2(cpu))


def test_cluster_sweep_matches_its_plain_version(dev):
    """CLUSTER blocks are coupled; an in-place kernel would race there."""
    sp = tkc.generate_structured_laplacian(70, 70, dtype=np.float64, device="cpu").to_scipy()
    sp.setdiag(sp.diagonal() + 0.5)
    cpu = tkc.CsrMatrix.from_scipy(sp.tocsr(), device="cpu")
    A = tkc.CsrMatrix.from_scipy(sp.tocsr(), device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=3)
    for clustering in (ClusteringAlgorithm.MIS2, ClusteringAlgorithm.BALLOON):
        h = _gs_handle(A, GsAlgorithm.CLUSTER, clustering=clustering)
        hc = _gs_handle(cpu, GsAlgorithm.CLUSTER, clustering=clustering)
        np.testing.assert_array_equal(h.order, hc.order)
        n0 = kg.gs_color_step.launches
        x = gauss_seidel_apply(h, A, None, b, 3)
        assert kg.gs_color_step.launches > n0
        ref = gauss_seidel_apply(hc, cpu, None, b.cpu(), 3)
        assert (x.cpu() - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_gsprec_pcg_runs_through_k6(dev):
    A = tkc.generate_structured_laplacian(100, 100, dtype=np.float64, device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=1)
    h = _gs_handle(A)
    n0 = kg.gs_color_step.launches
    xs, st = pcg(A, b, tol=1e-8, max_iters=2000, prec=GsPrec(h, A))
    r = b.cpu().numpy() - A.to_scipy() @ xs.cpu().numpy()
    assert st.converged and np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b.cpu().numpy())
    ncolors = len(h.color_offsets) - 1
    assert kg.gs_color_step.launches - n0 >= 2 * ncolors * st.num_iters
    _, sj = pcg(A, b, tol=1e-8, max_iters=2000, prec=JacobiPrec(A))
    assert st.num_iters < sj.num_iters


def test_twostage_multivector_launches_k7(dev):
    A = tkc.generate_diag_dominant_csr(4000, 8, dtype=np.float64, seed=7, device=dev)
    h = _gs_handle(A, GsAlgorithm.TWOSTAGE)
    B = _x(A.nrows, torch.float64, dev, 8, seed=4)
    n0 = kc.csr_spmm.launches
    X = gauss_seidel_apply(h, A, None, B, 2)
    assert kc.csr_spmm.launches > n0
    for j in range(8):
        xj = gauss_seidel_apply(h, A, None, B[:, j].contiguous(), 2)
        assert (X[:, j] - xj).abs().max() <= 1e-12 * xj.abs().max()
