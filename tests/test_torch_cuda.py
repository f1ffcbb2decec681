"""tpukk_torch's CUDA kernels on a CUDA device: each kernel against its plain
version (K3 also on its tiling's edge cases, in both of its modes, and
replayed in a CUDA graph to the same bits), and the SpMV/PCG,
ILU(0)-GMRES and Gauss-Seidel paths (coloring,
MIS2, sweeps, GsPrec-PCG), SpGEMM (K8, DIA, spgemm_jacobi, SpADD,
triangles) and the factor-and-solve slice (SUPERNODAL on K4, SuperLU and
CHOLMOD imports, their applies two K4 launches and no K5, equal to K5, K4,
K4, K5 bit for bit, PAR_ILUT, MDF, the ILU(k) refresh) through the kernels, and
the probe kernel K9; K4 with the level permutations folded in (src/dst), at
each lane width, replayed in a CUDA graph, and trapping on a plan that does
not order its triangle; K6's fused sweep equal to the per-color path it
replaces bit for bit, one launch per GsPrec apply, replayed in a CUDA graph,
and trapping on a plan whose steps cannot finish.  Every test skips without a CUDA device: the
kernels have no CPU mode.

This file imports neither JAX nor tpukk, so it runs on a GPU host that has
neither, without tests/conftest.py (which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: |y - y_plain| <= 20·eps·(|A|·|x|)_i (the products are the same,
summed in another order); the max reduction and the permutation must agree
exactly; a triangular solve x must satisfy |T·x - b| <= 20·eps·(|T|·|x|)_i and
|x - x_plain| <= M(T)⁻¹·(40·eps·|T||x|)_i (M(T) the comparison matrix); a
Gauss-Seidel color step is held to gs_cuda.step_error_bound (20·eps of its
absolute terms) on the block's rows and must leave the other rows exactly as
they were; whole sweeps (a few color steps in a row) to 1e-12 relative in f64;
K8 bit for bit to its plain version (both sum in the pair order); a SpGEMM
entry c to scipy's within (n_c + 1)·eps·Σ_p|a_p·b_p| (n_c its products); K9
to 1e-6 absolute (its products and sums are the plain version's, in the same
order, on values below 0.05); a supernodal solve to scipy's within 1e-5 of
max|x| in f32 and 1e-12 in f64; the ILU(k) refresh to 1e-12 of spiluk_numeric;
PAR_ILUT's factors to the CPU's with equal patterns and values within 1e-8 of
max|·| (its device segment sums add their terms in another order).
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk_torch.containers as tkc
import tpukk_torch.graph as tg
from tpukk_torch.common import TpuKKError
from tpukk_torch.sparse import (ClusteringAlgorithm, GmresHandle, GsAlgorithm, GsHandle, GsPrec,
                                JacobiPrec, LUPrec, Ortho, SpilukHandle, SpmvAlgorithm,
                                SpmvHandle, gauss_seidel_apply, gauss_seidel_numeric,
                                gauss_seidel_symbolic, gmres, pcg, spiluk_numeric,
                                spiluk_symbolic, spmm, spmv, trsv)
from tpukk_torch.sparse import gs_cuda as kg
from tpukk_torch.sparse import spmv_cuda as kc
from tpukk_torch.sparse import sptrsv_cuda as ks
from tpukk_torch.sparse import spmv_impl
from tpukk_torch.sparse.sptrsv import SptrsvHandle, sptrsv_solve, sptrsv_symbolic

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
             tkc.CsrMatrix.from_dense(d, device=dev),
             tkc.generate_random_csr(100_000, 100_000, 16, seed=3, device=dev),  # rand100k
             tkc.CsrMatrix.from_scipy(sps.identity(256, format="csr"), device=dev)]  # the floor
    for A in cases:
        x = _x(A.ncols, dtype, dev)
        cp = kc.build_csr_plan(A, dtype)
        acp = dataclasses.replace(cp, values=cp.values.abs())
        n0 = kc.csr_spmv.launches
        assert _held(kc.csr_spmv(cp, x), kc.csr_plain(cp, x), kc.csr_plain(acp, x.abs()), dtype)
        assert kc.csr_spmv.launches == n0 + 1
        xa = x.abs()
        assert torch.equal(kc.csr_spmv(acp, xa, "max"), kc.csr_plain(acp, xa, "max"))


def _k3_edge():
    """The shapes K3's tiling has to get right (as tests/test_torch_spmv.py's
    _k3_edge): empty rows, the coloring's selection matrix (0/1 entry a row,
    long empty runs), one row, no rows, rows longer than the entry cap, and
    nnz % 4 == 3."""
    r = np.random.default_rng(11)
    d = sps.random(300, 200, density=0.05, random_state=1, format="csr").toarray()
    d[::3] = 0.0
    n, w = 700, 9
    cols = r.integers(0, n, (n, w))
    cols[r.random((n, w)) < 0.4] = -1
    cols[100:400] = -1
    valid = (cols >= 0).reshape(-1)
    rm = np.r_[0, np.cumsum(valid)]
    long_ = sps.random(64, 5000, density=0.0006, random_state=2, format="lil")
    long_[5, :] = r.standard_normal(5000)
    long_[40, :700] = r.standard_normal(700)
    c = sps.random(1001, 900, density=0.0113, random_state=3, format="coo")
    keep = c.nnz - (c.nnz - 3) % 4
    return {"empty_rows": sps.csr_matrix(d),
            "selection": sps.csr_matrix((np.ones(rm[-1]), cols.reshape(-1)[valid], rm),
                                        shape=(n * w, n)),
            "one_row": sps.csr_matrix((r.standard_normal(37), np.arange(37), [0, 37]),
                                      shape=(1, 40)),
            "no_rows": sps.csr_matrix((0, 5)),
            "long_row": long_.tocsr(),
            "nnz_odd": sps.csr_matrix((c.data[:keep], (c.row[:keep], c.col[:keep])),
                                      shape=c.shape)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_kernel_edge_cases_match_plain(dev, dtype):
    for name, sp in _k3_edge().items():
        A = tkc.CsrMatrix.from_scipy(sp, device=dev)
        x = _x(A.ncols, dtype, dev)
        for streamed in (None, False, True):
            cp = kc.build_csr_plan(A, dtype, streamed)
            acp = dataclasses.replace(cp, values=cp.values.abs())
            y = kc.csr_spmv(cp, x)
            assert y.shape == (A.nrows,)
            assert _held(y, kc.csr_plain(cp, x), kc.csr_plain(acp, x.abs()), dtype), \
                (name, streamed)
            xa = x.abs()
            assert torch.equal(kc.csr_spmv(acp, xa, "max"), kc.csr_plain(acp, xa, "max")), \
                (name, streamed)


def test_csr_kernel_misaligned_tile_starts(dev):
    """Tiles that start and end off 16 bytes, in arrays that start off 16
    bytes: the plan reads A's own arrays, wherever they start."""
    A = tkc.generate_random_csr(5000, 4000, 7, seed=9, device=dev)
    for dtype in (torch.float32, torch.float64):
        big = torch.zeros(A.nnz + 1, dtype=dtype, device=dev)
        big[1:] = A.values.to(dtype)
        off = dataclasses.replace(A, values=big[1:])  # values start 4 or 8 bytes in
        for streamed in (False, True):
            cp = kc.build_csr_plan(off, dtype, streamed)
            starts = cp.tiles[:, 2].cpu().numpy()
            assert (starts % 4 != 0).any() and cp.values.data_ptr() % 16 != 0
            x = _x(A.ncols, dtype, dev)
            acp = dataclasses.replace(cp, values=cp.values.abs())
            assert _held(kc.csr_spmv(cp, x), kc.csr_plain(cp, x), kc.csr_plain(acp, x.abs()),
                         dtype), streamed


def test_csr_kernel_replays_in_a_cuda_graph(dev):
    """One launch, no memset, no host work per call: a captured call replays
    to the bits of a direct call (the sums' order is fixed by the tiles)."""
    A = tkc.generate_random_csr(20_000, 20_000, 12, seed=5, device=dev)
    for dtype in (torch.float32, torch.float64):
        cp = kc.build_csr_plan(A, dtype)
        x = _x(A.ncols, dtype, dev)
        direct = kc.csr_spmv(cp, x)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        n0 = kc.csr_spmv.launches
        with torch.cuda.graph(g):
            y = kc.csr_spmv(cp, x)
        assert kc.csr_spmv.launches == n0 + 1
        for _ in range(3):
            y.zero_()
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, direct)


def test_csr_plan_on_the_cpu_refuses_a_cuda_x(dev):
    A = tkc.generate_random_csr(300, 300, 5, seed=1, device="cpu")
    cp = kc.build_csr_plan(A, torch.float32)
    with pytest.raises(Exception):
        kc.csr_spmv(cp, torch.ones(A.ncols, device=dev))


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


def _held_folded(plan, b, src=None, dst=None):
    """K4 with src/dst against its plain version under the M(T)⁻¹ bound (the
    bound of the plain version's level-order x, carried through dst), and
    three more calls on the same plan (new epochs) giving the same x."""
    n0 = ks.sptrsv_levels.launches
    x = ks.sptrsv_levels(plan, b, src, dst)
    assert ks.sptrsv_levels.launches == n0 + 1
    xl = ks.sptrsv_plain(plan, b, src)
    torch.cuda.synchronize()
    tol = ks.scatter_dst(ks.solve_error_bound(plan, xl), dst, b.shape[0])
    assert ((x - ks.scatter_dst(xl, dst, b.shape[0])).abs().double() <= tol).all()
    for _ in range(3):
        assert torch.equal(ks.sptrsv_levels(plan, b, src, dst), x)
    return x


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
            x = _held_folded(h.plan, b)
            # in level order the plan is strictly lower: check the residual there
            order = h.plan.order.long()
            Tl = tkc.CsrMatrix.from_scipy(T.to_scipy()[order.cpu().numpy()][:, order.cpu().numpy()])
            assert _solve_residual_ok(Tl, x, b, dtype)
            # the level order folded in: b and x in natural order
            xf = _held_folded(h.plan, b, h.plan.order, h.plan.order)
            assert torch.equal(xf[order], ks.sptrsv_levels(h.plan, b[order].contiguous()))
            assert _solve_residual_ok(T, xf, b, dtype)
            # sptrsv_solve is that one folded launch, no K5
            ks.reset_launch_counts()
            assert torch.equal(sptrsv_solve(h, T, b), xf)
            assert ks.launch_counts() == {"sptrsv_levels": 1, "permute_gather": 0}


@pytest.mark.parametrize("lanes", [16, 32])
def test_sptrsv_kernel_every_lane_width(dev, lanes):
    """K4 at each lane width it takes, whatever the plan's own choice: rows
    shorter and longer than the group (ILU(0) factors, a supernodal DAG)."""
    from tpukk_torch.sparse.sptrsv_supernodal import build_supernodal_fused_plan

    A = tkc.generate_diag_dominant_csr(3000, 8, dtype=np.float64, seed=5, device=dev)
    for lower, T in zip((True, False), _ilu0(A)):
        h = SptrsvHandle(lower=lower)
        sptrsv_symbolic(h, T)
        plan = dataclasses.replace(h.plan, lanes=lanes)
        _held_folded(plan, _x(T.nrows, torch.float64, dev, seed=2), plan.order, plan.order)
    for lower, T in _splu_factors(30, np.float32):
        T.sort_indices()
        fp = build_supernodal_fused_plan(T.indptr, T.indices, T.data, T.shape[0], lower, 32,
                                         device=dev)
        plan = dataclasses.replace(fp.plan, lanes=lanes)
        _held_folded(plan, _x(T.shape[0], torch.float32, dev, seed=3), fp.src, fp.dst)


@pytest.mark.parametrize("folded", [False, True], ids=["level-order", "folded"])
def test_sptrsv_kernel_replays_in_a_cuda_graph(dev, folded):
    """A captured K4 launch replays with the epoch it advances itself, on a
    new b each time, and equals an eager call on that b."""
    A = tkc.generate_structured_laplacian(40, 40, dtype=np.float64, device=dev)
    L, _ = _ilu0(A)
    h = SptrsvHandle(lower=True)
    sptrsv_symbolic(h, L)
    idx = (h.plan.order, h.plan.order) if folded else (None, None)
    b = _x(L.nrows, torch.float64, dev, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ks.sptrsv_levels(h.plan, b, *idx)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ks.sptrsv_levels(h.plan, b, *idx)
    for seed in (4, 5, 6):
        b.copy_(_x(L.nrows, torch.float64, dev, seed=seed))
        out.zero_()
        g.replay()
        ref = ks.sptrsv_levels(h.plan, b, *idx)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_sptrsv_kernel_traps_on_an_unordered_plan(dev):
    """A plan whose row waits on itself never gets its value: K4 traps after
    2^28 polls and the launch fails, instead of hanging the card (in a child
    process: a trap ends its CUDA context)."""
    import subprocess
    import sys
    from pathlib import Path

    code = f"""
import sys, dataclasses, numpy as np, torch
sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})
from tpukk_torch.sparse import sptrsv_cuda as ks
dev = torch.device("cuda", 0)
p = ks.build_level_plan([0, 1, 3], [0, 0, 1], np.array([1.0, 0.5, 1.0]), 2, [1, 2], True, dev)
p = dataclasses.replace(p, rowptr=torch.tensor([0, 1, 1], dtype=torch.int32, device=dev))
try:
    ks.sptrsv_levels(p, torch.ones(2, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
except RuntimeError:
    sys.exit(0)
sys.exit(3)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr


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
    # two K4 launches per apply, the level permutations folded in: no K5
    assert ks.launch_counts()["sptrsv_levels"] >= 2 * st.num_iters
    assert ks.launch_counts()["sptrsv_levels"] % 2 == 0
    assert ks.launch_counts()["permute_gather"] == 0
    assert kc.launch_counts()["csr_spmv"] >= st.num_iters
    prec = LUPrec(*_ilu0(A))
    ks.reset_launch_counts()
    prec.apply(b)
    assert ks.launch_counts() == {"sptrsv_levels": 2, "permute_gather": 0}


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


def _spmm_cases(dev):
    """K7's matrices: rows of about 12 entries, rows of about 70 (past 32
    lanes a row), a Laplacian, and empty rows beside a row of 3,000 entries."""
    d = sps.random(400, 3000, density=0.004, random_state=5, format="lil")
    d[::3] = 0.0
    d[7, :] = np.random.default_rng(12).standard_normal(3000)
    return [tkc.generate_random_csr(3000, 2500, 12, seed=3, device=dev),
            tkc.generate_random_csr(300, 300, 70, seed=4, device=dev),
            tkc.generate_structured_laplacian(40, 40, device=dev),
            tkc.CsrMatrix.from_scipy(d.tocsr(), device=dev)]


def _spmm_geometries(k, itemsize):
    """Every geometry spmm_geometry can pick for k columns: each vector width
    that divides k (X's offset decides among them), at every slot count."""
    out = []
    for vec in (4, 2, 1):
        if vec * itemsize <= 16 and k % vec == 0:
            cols = 1 << (-(-k // vec) - 1).bit_length()
            out += [kc.SpmmGeometry(vec, cols, s) for s in (1, 2, 4, 8, 16, 32) if s * cols <= 32]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_spmm_kernel_matches_plain(dev, dtype):
    """Every k in 1..16 at every geometry, and the host's own choice."""
    size = torch.finfo(dtype).bits // 8
    for A in _spmm_cases(dev):
        cp = kc.build_csr_plan(A, dtype)
        acp = dataclasses.replace(cp, values=cp.values.abs())
        for k in range(1, kc.SPMM_MAX_K + 1):
            X = _x(A.ncols, dtype, dev, k)
            plain, bound = kc.csr_spmm_plain(cp, X), kc.csr_spmm_plain(acp, X.abs())
            n0 = kc.csr_spmm.launches
            assert _held(kc.csr_spmm(cp, X), plain, bound, dtype)
            assert kc.csr_spmm.launches == n0 + 1
            for g in _spmm_geometries(k, size):
                assert _held(kc.csr_spmm(cp, X, g), plain, bound, dtype), (A.shape, k, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_spmm_kernel_misaligned_x(dev, dtype):
    """X a contiguous slice at an odd row offset, and X viewed from a flat
    buffer one value in (off every vector boundary): the host picks the
    vector width X allows, and a pinned wider one is refused."""
    A = tkc.generate_random_csr(2000, 1500, 20, seed=9, device=dev)
    cp = kc.build_csr_plan(A, dtype)
    acp = dataclasses.replace(cp, values=cp.values.abs())
    size = torch.finfo(dtype).bits // 8
    for k in range(1, kc.SPMM_MAX_K + 1):
        rows = _x(A.ncols + 3, dtype, dev, k, seed=k)[3:]
        flat = _x(A.ncols * k + 1, dtype, dev, seed=k)[1:].view(A.ncols, k)
        for X in (rows, flat):
            assert X.is_contiguous()
            g = kc.spmm_geometry(A.nnz / A.nrows, A.nrows, k, size, X.data_ptr() % 16)
            assert X.data_ptr() % (g.vec * size) == 0 and k % g.vec == 0
            assert _held(kc.csr_spmm(cp, X), kc.csr_spmm_plain(cp, X),
                         kc.csr_spmm_plain(acp, X.abs()), dtype), (k, g)
        assert kc.spmm_geometry(20, 2000, k, size, size).vec == 1
        if k % 2 == 0:
            with pytest.raises(TpuKKError, match="does not fit X"):
                kc.csr_spmm(cp, flat, kc.SpmmGeometry(2, k // 2, 1))


def test_onehot_spmm_route_launches_k7(dev):
    A = tkc.generate_random_csr(5000, 4000, 9, seed=6, dtype=np.float64, device=dev)
    X = _x(A.ncols, torch.float64, dev, 8)
    n0 = kc.csr_spmm.launches
    Y = spmm(A, X)
    assert kc.csr_spmm.launches == n0 + 1
    ref = A.to_scipy() @ X.cpu().numpy()
    assert np.abs(Y.cpu().numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _gs_handle(A, alg=GsAlgorithm.POINT, omega=1.0, **kw):
    h = GsHandle(alg, **kw)
    gauss_seidel_symbolic(h, A)
    gauss_seidel_numeric(h, A, omega=omega)
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


def _sweep_cases(dev):
    lap = tkc.generate_structured_laplacian(60, 60, dtype=np.float64, device=dev)
    dd = tkc.generate_diag_dominant_csr(3000, 9, dtype=np.float64, seed=5, device=dev)
    return {"point_lap": _gs_handle(lap, omega=1.2),
            "cluster_lap": _gs_handle(lap, GsAlgorithm.CLUSTER, omega=1.2),
            "point_dd": _gs_handle(dd, omega=1.2)}  # non-symmetric: coupled POINT blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gs_sweep_kernel_equals_per_color_path(dev, dtype):
    """K6's fused sweep against the path it replaces (K5, a fill, a
    gs_color_step launch per color step at the sweep's lanes per row, K5),
    bit for bit: every direction, x given and not, natural and permuted
    order, k = 1 and 4, two sweeps; at the plan's chunk size and at chunks
    of 7 rows (several chunks a step)."""
    from tpukk_torch.sparse.gauss_seidel import _plan_in

    for name, h in _sweep_cases(dev).items():
        plan = _plan_in(h, dtype)
        for p in (plan, dataclasses.replace(plan, chunk_rows=7, _steps={}, _bufs={})):
            for k in (None, 4):
                b = _x(plan.n, dtype, dev, k, seed=1)
                for x in (None, _x(plan.n, dtype, dev, k, seed=2)):
                    for direction in ("forward", "backward", "symmetric"):
                        for permuted in (False, True):
                            n0 = kg.gs_sweep.launches
                            got = kg.gs_sweep(p, x, b, h.omega, direction, 2, permuted)
                            assert kg.gs_sweep.launches == n0 + 1
                            ref = kg.gs_sweep_per_color(p, x, b, h.omega, direction, 2, permuted)
                            torch.cuda.synchronize()
                            assert torch.equal(got, ref), (name, k, direction, permuted)


def test_gsprec_apply_is_one_k6_launch(dev):
    """GsPrec.apply (POINT and CLUSTER): one gs_sweep launch, no color step,
    no K5 permutation; its result equals the plain sweep's on the CPU."""
    from tpukk_torch.common import permute

    A = tkc.generate_structured_laplacian(80, 80, dtype=np.float64, device=dev)
    cpu = tkc.CsrMatrix.from_scipy(A.to_scipy(), device="cpu")
    r = _x(A.nrows, torch.float64, dev, seed=4)
    for alg in (GsAlgorithm.POINT, GsAlgorithm.CLUSTER):
        prec = GsPrec(_gs_handle(A, alg), A)
        counts = (kg.gs_sweep.launches, kg.gs_color_step.launches, permute.permute_gather.launches)
        z = prec.apply(r)
        torch.cuda.synchronize()
        assert (kg.gs_sweep.launches, kg.gs_color_step.launches,
                permute.permute_gather.launches) == (counts[0] + 1, counts[1], counts[2])
        ref = GsPrec(_gs_handle(cpu, alg), cpu).apply(r.cpu())
        assert (z.cpu() - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_gs_sweep_replays_in_a_cuda_graph(dev):
    """A captured gs_sweep replays with the state it resets itself, on a new
    b each time, and equals an eager call on that b."""
    from tpukk_torch.sparse.gauss_seidel import _plan_in

    for h in _sweep_cases(dev).values():
        plan = _plan_in(h, torch.float64)
        b = _x(plan.n, torch.float64, dev, seed=3)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kg.gs_sweep(plan, None, b, h.omega, "symmetric", 1)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = kg.gs_sweep(plan, None, b, h.omega, "symmetric", 1)
        for seed in (4, 5, 6):
            b.copy_(_x(plan.n, torch.float64, dev, seed=seed))
            out.zero_()
            g.replay()
            ref = kg.gs_sweep(plan, None, b, h.omega, "symmetric", 1)
            torch.cuda.synchronize()
            assert torch.equal(out, ref)


def test_gs_sweep_traps_on_a_plan_that_cannot_finish(dev):
    """A step that waits on more chunks than the step before it has never
    starts: the kernel traps after 2^28 polls and the launch fails, instead
    of hanging the card (in a child process: a trap ends its CUDA context)."""
    import subprocess
    import sys
    from pathlib import Path

    code = f"""
import sys, numpy as np, torch
sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})
from tpukk_torch.sparse import gs_cuda as kg
dev = torch.device("cuda", 0)
n = 8
plan = kg.build_gs_sweep_plan(np.r_[0, np.arange(n)], np.arange(n - 1), np.full(n - 1, -0.5),
                              np.ones(n), np.arange(n + 1), np.arange(n), dev)
st = plan.steps("forward", 1, False)
st.steps[1, kg.STEP_FIELDS.index("wait")] += 1
try:
    kg.gs_sweep(plan, None, torch.ones(n, dtype=torch.float64, device=dev), 1.0, "forward", 1)
    torch.cuda.synchronize()
except RuntimeError:
    sys.exit(0)
sys.exit(3)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr


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
        n0 = kg.gs_sweep.launches
        x = gauss_seidel_apply(h, A, None, b, 3)
        assert kg.gs_sweep.launches == n0 + 1
        ref = gauss_seidel_apply(hc, cpu, None, b.cpu(), 3)
        assert (x.cpu() - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_gsprec_pcg_runs_through_k6(dev):
    A = tkc.generate_structured_laplacian(100, 100, dtype=np.float64, device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=1)
    h = _gs_handle(A)
    n0 = kg.gs_sweep.launches
    xs, st = pcg(A, b, tol=1e-8, max_iters=2000, prec=GsPrec(h, A))
    r = b.cpu().numpy() - A.to_scipy() @ xs.cpu().numpy()
    assert st.converged and np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b.cpu().numpy())
    # one K6 launch per preconditioner apply
    assert kg.gs_sweep.launches - n0 >= st.num_iters
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


def _arrow(n, seed, dev):
    """A random sparse matrix with one dense row and one dense column: C = A·A
    has an entry (the dense row times the dense column) with n products."""
    rng = np.random.default_rng(seed)
    S = sps.random(n, n, density=4.0 / n, random_state=seed, format="lil")
    S[0, :] = rng.standard_normal(n)
    S[:, 0] = rng.standard_normal((n, 1))
    return tkc.CsrMatrix.from_scipy(S.tocsr(), device=dev)


def _repeated(nrows, ncols, per_row, seed, dev):
    """A random CSR matrix in which every third row repeats a column (its
    columns unsorted within a row): two products of one A entry reach one C
    entry."""
    rng = np.random.default_rng(seed)
    rm, ent = [0], []
    for i in range(nrows):
        cols = list(rng.choice(ncols, size=per_row, replace=False))
        if i % 3 == 0:
            cols.insert(int(rng.integers(0, per_row)), cols[-1])
        ent += cols
        rm.append(len(ent))
    vals = rng.standard_normal(len(ent))
    return tkc.CsrMatrix.from_arrays(np.array(rm), np.array(ent), vals, nrows=nrows, ncols=ncols,
                                     device=dev)


def _pair_cases(dev):
    d = np.zeros((80, 60))
    d[::4, ::3] = 1.5  # rows with and without entries
    d[1::4, 5] = -2.0
    E = tkc.CsrMatrix.from_dense(d, device=dev)
    dense = tkc.CsrMatrix.from_dense(np.random.default_rng(8).standard_normal((40, 40)), device=dev)
    rep = _repeated(300, 300, 6, 4, dev)
    return [("rectangular", tkc.generate_random_csr(600, 400, 4, seed=9, device=dev),
             tkc.generate_random_csr(400, 300, 3, seed=10, device=dev)),
            ("empty rows", E, tkc.CsrMatrix.from_dense(d.T.copy(), device=dev)),
            ("one dense row and column: a row past the shared-memory cap", _arrow(3000, 1, dev),
             None),
            ("40 products per entry, lanes in a group", dense, dense),
            ("B repeats columns", tkc.generate_random_csr(200, 300, 5, seed=3, device=dev), rep),
            ("A repeats columns", rep, tkc.generate_random_csr(300, 250, 5, seed=6, device=dev))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_spgemm_pairs_kernel_matches_plain(dev, dtype):
    """K8 equals its plain version bit for bit: both add each C entry's
    products from 0 in (A entry, B entry) order, on a row of C past the
    shared-memory cap (accumulated in global memory), on rows of B and A that
    repeat a column, on empty rows and on a rectangular product; one launch a
    call, and a CUDA graph replays it to the same bits."""
    from tpukk_torch.sparse import SpgemmHandle, spgemm_symbolic
    from tpukk_torch.sparse import spgemm_cuda as ksg

    for label, A, B in _pair_cases(dev):
        B = A if B is None else B
        h = SpgemmHandle()
        spgemm_symbolic(h, A, B)
        plan = h.row_plan
        a, b = A.values.to(dtype), B.values.to(dtype)
        n0 = ksg.spgemm_rows.launches
        got = ksg.spgemm_rows(plan, a, b)
        assert ksg.spgemm_rows.launches == n0 + 1, label
        plain = ksg.spgemm_rows_plain(plan, a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), label
        if label.startswith("one dense"):
            assert plan.bins[-1]["global_memory"] and int(torch.diff(plan.c_row_map).max()) == 3000
        if label.startswith("40 products"):
            assert all(bn["lanes"] > 1 for bn in plan.bins)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ksg.spgemm_rows(plan, a, b)
    y.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, got)


def test_spgemm_numeric_reuse_is_exact(dev):
    """Doubling every value of A multiplies every product by exactly 4, and K8
    sums in plan order: numeric reuse with 2·A gives exactly 4·C."""
    from tpukk_torch.sparse import SpgemmHandle, spgemm_numeric, spgemm_symbolic

    for dtype in (np.float32, np.float64):
        for A in (tkc.generate_random_csr(2000, 2000, 8, seed=2, dtype=dtype, device=dev),
                  tkc.generate_structured_laplacian(50, 50, dtype=dtype, device=dev)):
            h = SpgemmHandle()
            spgemm_symbolic(h, A, A)
            C = spgemm_numeric(h, A, A)
            A2 = A.with_values(2 * A.values)
            assert torch.equal(spgemm_numeric(h, A2, A2).values, 4 * C.values)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_spgemm_numeric_on_cuda_matches_scipy(dev, dtype):
    """SpgemmHandle(KK) on the card: C's pattern equals scipy's |A|·|B|
    exactly; values within (n_c + 1)·eps·(|A||B|) of A·B in f64."""
    from tpukk_torch.sparse import SpgemmHandle, spgemm_numeric, spgemm_symbolic
    from tpukk_torch.sparse import spgemm_cuda as ksg

    for A, B in ((tkc.generate_structured_laplacian(60, 60, dtype=dtype, device=dev), None),
                 (tkc.generate_random_csr(600, 400, 4, seed=9, dtype=dtype, device=dev),
                  tkc.generate_random_csr(400, 300, 3, seed=10, dtype=dtype, device=dev))):
        B = A if B is None else B
        h = SpgemmHandle()
        spgemm_symbolic(h, A, B)
        n0 = ksg.spgemm_rows.launches
        C = spgemm_numeric(h, A, B)
        assert ksg.spgemm_rows.launches == n0 + 1 and C.device == A.device
        sa, sb = A.to_scipy().astype(np.float64), B.to_scipy().astype(np.float64)
        bound = (abs(sa) @ abs(sb)).tocsr()
        bound.sort_indices()
        np.testing.assert_array_equal(C.host_row_map(), bound.indptr)
        np.testing.assert_array_equal(C.host_entries(), bound.indices)
        ref = (sa @ sb).toarray()[np.repeat(np.arange(C.nrows), np.diff(bound.indptr)),
                                  bound.indices]
        n_c = np.bincount(h.row_plan.expand()[2].cpu().numpy(), minlength=C.nnz)
        err = np.abs(C.values.double().cpu().numpy() - ref)
        assert (err <= (n_c + 1) * np.finfo(dtype).eps * bound.data).all()


def test_spgemm_routes_on_cuda(dev):
    """DIA SpGEMM, spgemm_jacobi, SpADD and the device triangle count run on
    the card and match scipy; a CUDA operand never falls back to the plain
    version."""
    from tpukk_torch.sparse import (SpgemmHandle, spadd, spgemm_jacobi, spgemm_numeric,
                                    spgemm_symbolic)
    from tpukk_torch.sparse import spgemm_cuda as ksg

    band = tkc.generate_banded_csr(5000, 3, dtype=np.float64, seed=2, device=dev)
    h = SpgemmHandle()
    spgemm_symbolic(h, band, band)
    assert h.dia_plan is not None
    C = spgemm_numeric(h, band, band)
    assert C.device == band.device
    ref = band.to_scipy() @ band.to_scipy()
    assert abs(C.to_scipy() - ref).max() <= 1e-12 * abs(ref).max()

    L = tkc.generate_structured_laplacian(12, 10, dtype=np.float64, device=dev)
    B = tkc.generate_random_csr(120, 40, 3, seed=9, dtype=np.float64, device=dev)
    hj = SpgemmHandle()
    spgemm_symbolic(hj, L, B)
    dinv = 1.0 / L.to_scipy().diagonal()
    n0 = ksg.spgemm_rows.launches
    P = spgemm_jacobi(hj, L, B, 0.7, dinv)
    assert ksg.spgemm_rows.launches == n0 + 1
    ref = B.to_scipy() - 0.7 * sps.diags(dinv) @ L.to_scipy() @ B.to_scipy()
    assert abs(P.to_scipy() - ref).max() <= 1e-12 * abs(ref).max()

    A = tkc.generate_random_csr(500, 400, 4, seed=5, dtype=np.float64, device=dev)
    B2 = tkc.generate_random_csr(500, 400, 6, seed=6, dtype=np.float64, device=dev)
    S = spadd(2.0, A, -0.5, B2)
    assert S.device == A.device
    ref = 2.0 * A.to_scipy() - 0.5 * B2.to_scipy()
    assert abs(S.to_scipy() - ref).max() <= 1e-15 * abs(ref).max()

    G = tkc.generate_fem2d_csr(3000, device=dev)
    plan = tg.build_triangle_plan(G)
    n = tg.triangle_count(G)
    assert n == plan.num_triangles == int(tg.triangle_count_device(plan))

    one = torch.tensor([0, 1], dtype=torch.int32)
    zero = torch.tensor([0], dtype=torch.int32)
    plan_cpu = ksg.build_row_plan(one, zero, one, zero, one, zero, 1)
    with pytest.raises(Exception):
        ksg.spgemm_rows(plan_cpu, torch.ones(1, device=dev), torch.ones(1, device=dev))


def test_probe_kernel_matches_plain(dev):
    """K9 against its plain version for the three variants, with more steps
    than output blocks (accumulation after a first step) and at B = 1, 3."""
    import importlib.util
    from pathlib import Path

    from tpukk_torch.common import probe_cuda as kp

    path = Path(__file__).resolve().parent.parent / "scripts" / "probe_ss_cost_torch.py"
    spec = importlib.util.spec_from_file_location("probe_ss_cost_torch", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    for variant in drv.VARIANTS:
        for n_ss, B in ((80, 3), (200, 1)):
            plan, x = drv.make_plan(variant, n_ss, B, dev)
            n0 = kp.probe_gather_acc.launches
            y = kp.probe_gather_acc(plan, x)
            assert kp.probe_gather_acc.launches == n0 + 1
            plain = kp.probe_plain(plan, x)
            torch.cuda.synchronize()
            assert float((y - plain).abs().max()) <= 1e-6, (variant, n_ss, B)
    with pytest.raises(Exception):
        kp.probe_gather_acc(plan, x.double())


def _splu_factors(n_side, dtype):
    import scipy.sparse.linalg as spla

    A = tkc.generate_structured_laplacian(n_side, n_side, dtype=np.float64, device="cpu")
    lu = spla.splu(A.to_scipy().tocsc())
    return [(lower, (lu.L if lower else lu.U).tocsr().astype(dtype)) for lower in (True, False)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_supernodal_solve_on_cuda(dev, dtype):
    """SUPERNODAL runs one K4 launch on the expanded DAG in f32 and f64 (no
    K5: b and x go through K4's src/dst); the batched plan (fused=False)
    runs no kernel of these two.  Both match scipy's triangular solve."""
    import scipy.sparse.linalg as spla

    from tpukk_torch.sparse import SptrsvAlgorithm, sptrsv_solve
    from tpukk_torch.sparse import sptrsv_supernodal as tsn

    for lower, T in _splu_factors(30, dtype):
        T.sort_indices()
        Tm = tkc.CsrMatrix.from_scipy(T, device=dev)
        h = SptrsvHandle(lower=lower, algorithm=SptrsvAlgorithm.SUPERNODAL)
        sptrsv_symbolic(h, Tm)
        b = _x(T.shape[0], torch.float32 if dtype == np.float32 else torch.float64, dev, seed=4)
        ks.reset_launch_counts()
        x = sptrsv_solve(h, Tm, b)
        assert ks.launch_counts() == {"sptrsv_levels": 1, "permute_gather": 0}
        ref = spla.spsolve_triangular(T.astype(np.float64), b.double().cpu().numpy(), lower=lower)
        tol = 1e-5 if dtype == np.float32 else 1e-12
        assert np.abs(x.double().cpu().numpy() - ref).max() <= tol * np.abs(ref).max()
        bp = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, T.shape[0], lower,
                                       device=dev, fused=False)
        ks.reset_launch_counts()
        xb = tsn.supernodal_solve(bp, b)
        assert ks.launch_counts() == {"sptrsv_levels": 0, "permute_gather": 0}
        assert np.abs(xb.double().cpu().numpy() - ref).max() <= tol * np.abs(ref).max()


def test_imported_factors_and_ilut_mdf_on_cuda(dev):
    """superlu_import and cholmod_import (SUPERNODAL) as preconditioners,
    PAR_ILUT and MDF factors in LUPrec, the ILU(k) refresh against
    spiluk_numeric: all on the card."""
    import scipy.sparse.linalg as spla

    from tpukk_torch.sparse import (SptrsvAlgorithm, build_iluk_refresh, cholmod_import,
                                    mdf_numeric, mdf_symbolic, MdfHandle, par_ilut,
                                    refresh_to_csr, spiluk_refresh, superlu_import)

    A = tkc.generate_diag_dominant_csr(600, 6, dtype=np.float64, seed=3, device=dev)
    b = _x(A.nrows, torch.float64, dev, seed=8)
    prec = superlu_import(spla.splu(A.to_scipy().tocsc()), SptrsvAlgorithm.SUPERNODAL,
                          device=dev)
    # an exact factorization: one restart cycle of 2 steps (iterations count in cycles)
    x, st = gmres(GmresHandle(m=2, tol=1e-10, max_restarts=5), A, b, prec=prec)
    assert st.converged and st.num_iters <= 2
    S = tkc.generate_structured_laplacian(20, 20, dtype=np.float64, device="cpu").to_scipy()
    Ld = np.linalg.cholesky(S.toarray() + 0.5 * np.eye(S.shape[0]))
    Ls = sps.csr_matrix(Ld)
    n = Ls.shape[0]
    super_, pi, px, s_, xv = [0], [0], [0], [], []
    for c0 in range(0, n, 4):        # supernodes of 4 columns, full lower panels
        ridx = np.arange(c0, n)
        s_.extend(ridx.tolist())
        xv.extend(Ld[c0:, c0:c0 + 4].T.ravel().tolist())
        super_.append(c0 + 4)
        pi.append(len(s_))
        px.append(len(xv))
    for dt in (np.float32, np.float64):
        solver = cholmod_import(n=n, super_=super_, pi=pi, px=px, s=s_, x=xv,
                                algorithm=SptrsvAlgorithm.SUPERNODAL, value_dtype=dt, device=dev)
        bb = _x(n, torch.float64, dev, seed=9)
        ref = np.linalg.solve(S.toarray() + 0.5 * np.eye(n), bb.cpu().numpy())
        got = solver(bb).cpu().numpy()
        assert np.abs(got - ref).max() <= (1e-4 if dt == np.float32 else 1e-10) * np.abs(ref).max()
    L, U = par_ilut(A, max_iters=5, fill_factor=2.0)
    assert L.device == A.device
    _, sp0 = gmres(GmresHandle(m=10, tol=1e-10, max_restarts=50), A, b)
    _, sp1 = gmres(GmresHandle(m=10, tol=1e-10, max_restarts=50), A, b, prec=LUPrec(L, U))
    assert sp1.converged and sp1.num_iters <= sp0.num_iters
    hm = MdfHandle()
    mdf_symbolic(hm, A)
    Lm, Um = mdf_numeric(hm, A)
    assert Lm.device == A.device and sorted(hm.permutation.tolist()) == list(range(A.nrows))
    h = SpilukHandle(1)
    spiluk_symbolic(h, A)
    plan = build_iluk_refresh(h, A)
    A2 = A.with_values(2 * A.values)
    Lr, Ur = refresh_to_csr(plan, *spiluk_refresh(plan, A2.values))
    L2, U2 = spiluk_numeric(h, A2)
    for got, want in ((Lr, L2), (Ur, U2)):
        w = want.to_scipy()
        assert abs(got.to_scipy() - w).max() <= 1e-12 * abs(w).max()


class _Factor:
    """The two methods of a CHOLMOD factor object that cholmod_import uses."""

    def __init__(self, L, perm):
        self._L, self._perm = L, perm

    def L(self):
        return self._L.tocsc()

    def P(self):
        return self._perm


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
def test_imported_factor_apply_is_two_k4_launches(dev, algorithm, dtype):
    """SuperLU's and CHOLMOD's outer permutations ride in K4's src and dst:
    an apply launches K4 twice and K5 never, and equals K5, K4, K4, K5 bit
    for bit; a b of another length is refused before any launch."""
    import scipy.sparse.linalg as spla

    from tpukk_torch.sparse import SptrsvAlgorithm, cholmod_import, superlu_import

    alg = SptrsvAlgorithm[algorithm]
    A = tkc.generate_diag_dominant_csr(600, 6, dtype=np.float64, seed=3, device="cpu")
    slu = superlu_import(spla.splu(A.to_scipy().tocsc()), alg, value_dtype=dtype, device=dev)
    S = tkc.generate_structured_laplacian(20, 20, dtype=np.float64, device="cpu").to_scipy()
    perm = np.random.default_rng(4).permutation(S.shape[0])
    Sp = S.toarray()[perm][:, perm] + 0.5 * np.eye(S.shape[0])
    chol = cholmod_import(_Factor(sps.csr_matrix(np.linalg.cholesky(Sp)), perm), algorithm=alg,
                          value_dtype=dtype, device=dev)
    bdt = torch.float32 if dtype == np.float32 else torch.float64
    for solver, first, second, before, after in (
            (slu, (slu.Lh, slu.L), (slu.Uh, slu.U), slu.inv_perm_r, slu.perm_c),
            (chol, (chol.Lh, chol.L), (chol.Lth, chol.Lt), chol.perm, chol.inv_perm)):
        b = _x(first[1].nrows, bdt, dev, seed=6)
        ks.reset_launch_counts()
        x = solver(b)
        torch.cuda.synchronize()
        assert ks.launch_counts() == {"sptrsv_levels": 2, "permute_gather": 0}
        y = sptrsv_solve(*first, ks.permute_gather(before, b))
        assert torch.equal(x, ks.permute_gather(after, sptrsv_solve(*second, y)))
        ks.reset_launch_counts()
        for n in (b.shape[0] - 1, b.shape[0] + 1):
            with pytest.raises(TpuKKError, match="rows"):
                solver(_x(n, bdt, dev, seed=6))
        assert ks.launch_counts() == {"sptrsv_levels": 0, "permute_gather": 0}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_supernodal_dag_kernels_match_plain(dev, dtype):
    """A fused supernodal solve's one launch on the inputs the solve gives
    it: K4 reads b through src (the x-rows' -1, the zero slot, reads 0),
    solves the 2n-row DAG and writes the x-rows through dst, against its
    plain version under the M(T)⁻¹ bound; for the DAG built from f32 and
    from f64 values, and without src/dst on b already in level order."""
    from tpukk_torch.sparse.sptrsv_supernodal import build_supernodal_fused_plan

    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for lower, T in _splu_factors(30, dtype):
        T.sort_indices()
        n = T.shape[0]
        fp = build_supernodal_fused_plan(T.indptr, T.indices, T.data, n, lower, 32, device=dev)
        assert fp.dtype == tdt and fp.num_rows_dag == 2 * n
        b = _x(n, tdt, dev, seed=5)
        x = _held_folded(fp.plan, b, fp.src, fp.dst)
        bdag = torch.where(fp.src >= 0, b[fp.src.long().clamp_min(0)], 0)
        xdag = _held_folded(fp.plan, bdag)
        keep = fp.dst >= 0
        assert torch.equal(x[fp.dst[keep].long()], xdag[keep])


def test_par_ilut_on_the_card_equals_the_cpu(dev):
    """PAR_ILUT's sweeps, prune and residual on the card against the same
    numeric phase on the CPU: equal patterns, values within 1e-8."""
    from tpukk_torch.sparse import ParIlutHandle, par_ilut_numeric, par_ilut_symbolic

    Ac = tkc.generate_diag_dominant_csr(600, 6, dtype=np.float64, seed=3, device="cpu")
    out = {}
    for d in (dev, "cpu"):
        h = ParIlutHandle(max_iters=5, residual_tol=1e-12, fill_factor=2.0)
        A = tkc.CsrMatrix.from_scipy(Ac.to_scipy(), device=d)
        par_ilut_symbolic(h, A)
        out[str(d)] = (h, *par_ilut_numeric(h, A))
    (hg, Lg, Ug), (hc, Lc, Uc) = out[str(dev)], out["cpu"]
    assert hg.num_iters == hc.num_iters
    assert abs(hg.final_residual - hc.final_residual) <= 1e-8 * hc.final_residual
    for G, W in ((Lg, Lc), (Ug, Uc)):
        g, w = G.to_scipy(), W.to_scipy()
        assert np.array_equal(g.indptr, w.indptr) and np.array_equal(g.indices, w.indices)
        assert abs(g - w).max() <= 1e-8 * abs(w).max()
