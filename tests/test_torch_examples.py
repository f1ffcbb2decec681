"""The port's examples (tpukk_torch/examples/): each main(device="cpu") runs
clean, and what it computes is held to tpukk on the same inputs — the
tpukk example of the same name under examples/ (tests/test_examples.py runs
those).  The examples live inside the package, so tests/test_examples.py,
which globs examples/, does not collect them.

Tolerance: colorings, MIS-2 roots, RCB parts, bandwidths, supernode counts
and iteration counts exactly; f64 solutions and products 1e-12 relative (max
norm); f32 products and solves 1e-5 relative (blas_wiki's reductions and
products too); bf16 axpy exactly (one rounding of the same f32 value).  The f32 GMRES of
rcm_reorder_solve is held to its residual only: its count is set by rounding
(ROADMAP, section C).
"""
import importlib

import numpy as np
import pytest
import torch

import tpukk.containers as jkc
import tpukk.graph as jg
import tpukk.sparse as js
from tpukk import blas as jblas

NAMES = ["graph_wiki", "gmres_ex_real_A", "rcm_reorder_solve", "sptrsv_supernodal",
         "banded_spgemm", "sparse_wiki", "blas_wiki", "half_xpy", "batched_eig",
         "batched_solve", "ode_integrate", "dist_halo_spmv", "dist_gt_pcg"]


def _main(name, capsys):
    out = importlib.import_module(f"tpukk_torch.examples.{name}").main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.strip()
    return out, printed


def _rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_graph_wiki(capsys):
    out, printed = _main("graph_wiki", capsys)
    A = jkc.generate_structured_laplacian(24, 24)
    np.testing.assert_array_equal(out["colors"], np.asarray(jg.graph_color(A)))
    np.testing.assert_array_equal(out["d2"], np.asarray(jg.graph_color_d2(A)))
    np.testing.assert_array_equal(out["roots"], np.asarray(jg.graph_mis2(A)))
    pts = np.stack(np.meshgrid(np.arange(24), np.arange(24)), -1).reshape(-1, 2).astype(float)
    np.testing.assert_array_equal(out["parts"], jg.rcb(pts, 4))
    assert "valid = True" in printed


def test_gmres_ex_real_A(capsys):
    out, printed = _main("gmres_ex_real_A", capsys)
    A = jkc.generate_diag_dominant_csr(400, 8, dtype=np.float64, seed=1)
    b = np.ones(A.nrows)
    xj, stj = js.gmres(js.GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b)
    kh = js.SpilukHandle(fill_level=0)
    js.spiluk_symbolic(kh, A)
    xj2, stj2 = js.gmres(js.GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b,
                         prec=js.LUPrec(*js.spiluk_numeric(kh, A)))
    assert (out["stats"].num_iters, out["stats_ilu"].num_iters) == (stj.num_iters, stj2.num_iters)
    assert _rel(out["x"], xj) <= 1e-12 and _rel(out["x_ilu"], xj2) <= 1e-12
    assert printed.count("converged=True") == 2


def test_rcm_reorder_solve(capsys):
    import scipy.sparse as sps

    out, printed = _main("rcm_reorder_solve", capsys)
    sp = jkc.generate_fem2d_csr(1200, seed=11).to_scipy().tocsr()
    sp = (sp + 4.0 * sps.eye(sp.shape[0], format="csr")).tocsr().astype(np.float32)
    A = jkc.CsrMatrix.from_scipy(sp)
    h = js.SpmvHandle(A, js.SpmvAlgorithm.RCM)
    x = np.random.default_rng(0).standard_normal(A.ncols).astype(np.float32)
    assert _rel(out["y"], np.asarray(h.matvec(x))) <= 1e-5
    ph = h.rcm_permuted()[0]
    rows = np.repeat(np.arange(sp.shape[0]), np.diff(ph.A.to_scipy().tocsr().indptr))
    assert out["bandwidth"][1] == int(np.abs(rows - ph.A.to_scipy().tocsr().indices).max())
    assert out["stats"].converged and "bandwidth" in printed


def test_sptrsv_supernodal(capsys):
    out, printed = _main("sptrsv_supernodal", capsys)
    from tpukk_torch.examples.sptrsv_supernodal import blocked_lower_factor

    T = blocked_lower_factor(256, 16)
    L = jkc.CsrMatrix.from_scipy(T.astype(np.float32))
    h = js.SptrsvHandle(lower=True, algorithm=js.SptrsvAlgorithm.SUPERNODAL)
    js.sptrsv_symbolic(h, L)
    assert (out["num_supernodes"], out["max_block"]) == (h.sn_plan.num_supernodes,
                                                         h.sn_plan.max_block)
    b = np.random.default_rng(1).standard_normal(L.nrows).astype(np.float32)
    assert _rel(out["x"], np.asarray(js.sptrsv_solve(h, L, b))) <= 1e-5
    assert "relative residual" in printed


def test_banded_spgemm(capsys):
    out, _ = _main("banded_spgemm", capsys)
    for key, A, alg in (("C", jkc.generate_banded_csr(2000, 3, dtype=np.float64, seed=0), None),
                        ("C2", jkc.generate_structured_laplacian(40, 40, dtype=np.float64),
                         js.SpgemmAlgorithm.DIA)):
        h = js.SpgemmHandle() if alg is None else js.SpgemmHandle(alg)
        js.spgemm_symbolic(h, A, A)
        C = js.spgemm_numeric(h, A, A)
        np.testing.assert_array_equal(out[key].host_row_map(), C.host_row_map())
        np.testing.assert_array_equal(out[key].host_entries(), C.host_entries())
        assert _rel(out[key].values, C.host_values_full()) <= 1e-12


def test_sparse_wiki(capsys):
    out, printed = _main("sparse_wiki", capsys)
    A = jkc.generate_structured_laplacian(32, 32, dtype=np.float32)
    x = np.ones(A.ncols, np.float32)
    assert _rel(out["y"], np.asarray(js.spmv(A, x))) <= 1e-5
    assert out["C"].nnz == js.spadd(1.0, A, 1.0, A).nnz
    C2 = js.spgemm(A, A)
    assert out["C2"].nnz == C2.nnz and _rel(out["C2"].values, C2.host_values_full()) <= 1e-5
    B = jkc.crs2bsr(jkc.generate_structured_laplacian(64, dtype=np.float32), 4)
    assert js.SpmvHandle(B).algorithm.name == "DIA"
    assert _rel(out["yb"], np.asarray(js.spmv(B, np.ones(B.ncols, np.float32)))) <= 1e-5
    sp = A.to_scipy()
    sp.setdiag(sp.diagonal() + 1.0)
    Add = jkc.CsrMatrix.from_scipy(sp.tocsr())
    h = js.GsHandle(js.GsAlgorithm.POINT)
    js.gauss_seidel_symbolic(h, Add)
    js.gauss_seidel_numeric(h, Add)
    xs = js.gauss_seidel_apply(h, Add, None, np.ones(Add.nrows, np.float32), num_sweeps=5)
    assert _rel(out["xs"], np.asarray(xs)) <= 1e-5
    assert "bsr spmv" in printed and "rel residual" in printed


def test_blas_wiki(capsys):
    out, printed = _main("blas_wiki", capsys)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    y = rng.standard_normal(1000).astype(np.float32)
    want = dict(
        abs=jblas.blas1.abs(x)[0], axpy=jblas.axpy(2.0, x, y)[0], dot=jblas.dot(x, y),
        fill=jblas.fill(x, 3.0)[0], mult=jblas.mult(1.0, y, 2.0, x, y)[0], nrm1=jblas.nrm1(x),
        nrm2=jblas.nrm2(x), nrminf=jblas.nrminf(x), reciprocal=jblas.reciprocal(x)[0],
        scal=jblas.scal(0.5, x)[0], update=jblas.update(1.0, x, 2.0, y, 0.0, y)[0])
    A = rng.standard_normal((64, 32)).astype(np.float32)
    v = rng.standard_normal(32).astype(np.float32)
    want["gemv"] = jblas.gemv("N", 1.0, A, v, 0.0, np.zeros(64, np.float32))[0]
    B = rng.standard_normal((32, 16)).astype(np.float32)
    want["gemm"] = jblas.gemm("N", "N", 1.0, A, B, 0.0, np.zeros((64, 16), np.float32))[0, 0]
    for key, w in want.items():
        assert out[key].dtype == torch.float32
        assert abs(float(out[key]) - float(w)) <= 1e-5 * max(1.0, abs(float(w))), key
    assert int(out["iamax"]) == int(jblas.iamax(x))
    assert "gemm ->" in printed


def test_half_xpy(capsys):
    import jax.numpy as jnp

    out, printed = _main("half_xpy", capsys)
    x = jnp.asarray(np.linspace(0, 1, 4096), jnp.bfloat16)
    y = jnp.asarray(np.linspace(1, 0, 4096), jnp.bfloat16)
    z = np.asarray(jblas.axpy(2.0, x, y).astype(jnp.float32))
    assert out["z"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["z"].float().numpy(), z)
    assert "torch.bfloat16" in printed


def test_batched_eig(capsys):
    import jax.numpy as jnp
    from tpukk.batched import eig, eigendecomposition

    out, printed = _main("batched_eig", capsys)
    A = out["A"]
    w, _, _ = eig(jnp.asarray(A))
    w, wt = np.asarray(w), out["w"].numpy()
    for b in range(4):   # the same eigenvalues (paired by value: see test_torch_batched)
        for g in wt[b]:
            assert np.abs(w[b] - g).min() <= 1e-12 * np.abs(w[b]).max()
    er, ei, _, _ = eigendecomposition(jnp.asarray(A[:1]))
    assert _rel(out["er"], er) <= 1e-12 and _rel(out["ei"], ei) <= 1e-12
    assert out["residual"] < 1e-12 and out["similarity"] < 1e-12
    assert "conjugate pairs adjacent" in printed


def test_batched_solve(capsys):
    from tpukk.batched import BatchedCrsMatrix, batched_gmres
    from tpukk.batched import dense as jbd

    out, printed = _main("batched_solve", capsys)
    A, b = out["A"], out["b"]
    lu, piv, _ = jbd.getrf(A)
    assert _rel(out["x"], jbd.getrs(lu, piv, b)) <= 1e-12
    dd, l = jbd.pttrf(out["d"], out["e"])
    assert _rel(out["xt"], jbd.pttrs(dd, l, b)) <= 1e-12
    assert _rel(out["xs"], jbd.pbtrs(jbd.pbtrf(out["S"]), b)) <= 1e-12
    A0 = jkc.generate_diag_dominant_csr(40, 4, dtype=np.float64, seed=2)
    vals = np.stack([np.asarray(A0.values) * (1 + 0.05 * k) for k in range(8)])
    xg, res = batched_gmres(BatchedCrsMatrix.from_csr(A0, vals), out["rhs"].numpy(), restart=20,
                            max_restarts=3)
    assert _rel(out["xg"], xg) <= 1e-12
    assert float(out["res"].max()) < 1e-10
    assert "team GMRES" in printed


def test_ode_integrate(capsys):
    import jax.numpy as jnp
    from tpukk.ode import RKType, bdf_solve, bdf_solve_adaptive, rk_solve

    out, printed = _main("ode_integrate", capsys)
    r = rk_solve(lambda t, y: -y, jnp.array([1.0]), 0.0, 1.0, kind=RKType.RKDP)
    assert int(out["rk"].num_steps) == int(r.num_steps)
    assert _rel(out["rk"].y, r.y) <= 1e-12
    r2 = bdf_solve(lambda t, y: -50.0 * (y - jnp.cos(t)), jnp.array([0.0]), 0.0, 2.0,
                   num_steps=80, order=2)
    assert _rel(out["bdf2"].y, r2.y) <= 1e-12
    np.testing.assert_allclose(out["batch"].numpy()[:, 0],
                               np.linspace(0.5, 2.0, 16) * np.exp(-1.0), rtol=1e-6)

    def rob(t, y):
        return jnp.array([-0.04 * y[0] + 1e4 * y[1] * y[2],
                          0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                          3e7 * y[1] ** 2])

    ra = bdf_solve_adaptive(rob, jnp.array([1.0, 0.0, 0.0]), 0.0, 100.0, rtol=1e-6, atol=1e-9)
    assert int(out["robertson"].num_steps) == int(ra.num_steps)
    assert int(out["robertson"].status) == int(ra.status) == 0
    assert _rel(out["robertson"].y, ra.y) <= 1e-9
    assert "accepted steps" in printed


def _mesh4():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]), ("parts",))


def test_dist_halo_spmv(capsys):
    """Four gloo ranks: the halo SpMV and ten CG steps as tpukk's on a mesh of
    four (y 1e-5 relative in f32, the CG iterate 1e-4)."""
    import jax
    import tpukk.dist as jd

    out, printed = _main("dist_halo_spmv", capsys)
    mesh = _mesh4()
    A = jkc.generate_structured_laplacian(64, 64, dtype=np.float32)
    plan = jd.shard_halo_plan(jd.build_halo_plan(A, 4), mesh)
    x = np.ones(plan.padded_rows, np.float32)
    x[A.ncols:] = 0
    assert _rel(out["y"], np.asarray(jd.dist_spmv_halo(plan, x, mesh))[:A.nrows]) <= 1e-5
    cplan = jd.shard_partition(jd.partition_rows(A, 4), mesh)
    b = np.zeros(cplan.padded_rows, np.float32)
    b[:A.nrows] = 1.0
    state = (np.zeros_like(b), b.copy(), b.copy(), float(b @ b))
    step = jax.jit(lambda s: jd.dist_cg_step(cplan, s, mesh))
    for _ in range(10):
        state = step(state)
    assert _rel(out["x"], np.asarray(state[0])[:A.nrows]) <= 1e-4
    assert abs(out["rr"] - float(state[3])) <= 1e-4 * float(state[3])
    assert "halo width = 64" in printed


def test_dist_gt_pcg(capsys):
    """Four gloo ranks: K3's plain version on each rank's block against
    tpukk's gather-table SpMV (1e-5 relative in f32), PCG within one
    iteration of tpukk's and both solutions within its tolerance."""
    import jax.numpy as jnp
    import tpukk.dist as jd

    out, printed = _main("dist_gt_pcg", capsys)
    mesh = _mesh4()
    A = jkc.generate_structured_laplacian(48, 48, dtype=np.float32)
    n = A.nrows
    plan = jd.shard_dist_gt_plan(jd.build_dist_gt_plan(A, 4), mesh)
    x = np.zeros(plan.padded_rows, np.float32)
    x[:n] = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    assert _rel(out["y"], np.asarray(jd.dist_spmv_gt(plan, jnp.asarray(x), mesh))[:n]) <= 1e-5
    b = np.zeros(plan.padded_rows, np.float32)
    b[:n] = 1.0
    xs, iters, rel = jd.dist_pcg(plan, jnp.asarray(b), mesh, tol=1e-5, max_iters=500)
    assert abs(out["iters"] - int(iters)) <= 1 and out["rel"] <= 1e-5
    assert _rel(out["x"], np.asarray(xs)[:n]) <= 1e-4
    assert "PCG through the plan" in printed


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_device_or_cpu(name, monkeypatch):
    """Each main() runs on the CUDA device by default, and without one raises
    (naming device='cpu') instead of dropping to the CPU."""
    from tpukk_torch.common import TpuKKError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuKKError, match="device='cpu'"):
        importlib.import_module(f"tpukk_torch.examples.{name}").main()
