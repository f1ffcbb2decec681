"""tpukk_torch's CUDA kernels on a CUDA device: each kernel against its plain
version, and the SpMV/PCG path through the kernels.  Every test skips
without a CUDA device: the kernels have no CPU mode.

This file imports neither JAX nor tpukk, so it runs on a GPU host that has
neither, without tests/conftest.py (which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: |y - y_plain| <= 20·eps·(|A|·|x|)_i (the products are the same,
summed in another order); the max reduction must agree exactly.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk_torch.containers as tkc
from tpukk_torch.sparse import JacobiPrec, SpmvAlgorithm, SpmvHandle, pcg, spmv
from tpukk_torch.sparse import spmv_cuda as kc
from tpukk_torch.sparse import spmv_impl

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
