"""tpukk_torch.lapack against tpukk.lapack and the numpy oracles of
tests/test_lapack.py, on the same numpy inputs (f32 and f64), plus the
exports and getrf's pivot convention.

Tolerances: tests/test_lapack.py's own (2000·eps relative, 10× that
absolute; 5000·eps for svd's and cholesky's reconstructions), and the same
against tpukk's results; getrf's pivots and permutation equal tpukk's
exactly (0-based, ``jax.lax.linalg.lu``'s convention).
"""
import numpy as np
import pytest
import torch

from tpukk import lapack as jlapack
from tpukk_torch import lapack

from conftest import tol_for


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, dtype, scale=2000):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol_for(dtype, scale),
                               atol=tol_for(dtype, scale) * 10)


def test_exports_match_tpukk():
    assert set(jlapack.__all__) <= set(lapack.__all__)
    assert all(callable(getattr(lapack, n)) for n in jlapack.__all__)


@pytest.mark.parametrize("name", ["blas", "lapack"])
def test_top_level_subpackages(name):
    """tpukk_torch re-exports blas and lapack, as tpukk does."""
    import tpukk
    import tpukk_torch

    assert name in tpukk_torch.__all__ and hasattr(tpukk, name)
    assert getattr(tpukk_torch, name) is __import__(f"tpukk_torch.{name}", fromlist=["_"])


def test_gesv(rng, scalar):
    n = 20
    A = rng.standard_normal((n, n)).astype(scalar) + n * np.eye(n, dtype=scalar)
    b = rng.standard_normal(n).astype(scalar)
    x = lapack.gesv(_t(A), _t(b))
    _close(x, np.linalg.solve(A, b), scalar)
    _close(x, jlapack.gesv(A, b), scalar)
    B = rng.standard_normal((n, 3)).astype(scalar)
    _close(lapack.gesv(_t(A), _t(B)), np.linalg.solve(A, B), scalar)


def test_gesv_refuses_a_rectangle():
    with pytest.raises(Exception, match="square"):
        lapack.gesv(torch.zeros(3, 4), torch.zeros(3))


def test_svd(rng, scalar):
    A = rng.standard_normal((15, 10)).astype(scalar)
    U, s, Vt = lapack.svd(_t(A))
    _close(U.numpy() @ np.diag(s.numpy()) @ Vt.numpy(), A, scalar, 5000)
    _close(s, np.asarray(jlapack.svd(A)[1]), scalar, 5000)
    s_only = lapack.svd(_t(A), compute_uv=False)
    _close(s_only, np.asarray(jlapack.svd(A, compute_uv=False)), scalar, 5000)
    Uf = lapack.svd(_t(A), full_matrices=True)[0]
    assert tuple(Uf.shape) == np.asarray(jlapack.svd(A, full_matrices=True)[0]).shape


def test_trtri(rng, scalar):
    n = 12
    A = rng.standard_normal((n, n)).astype(scalar) + n * np.eye(n, dtype=scalar)
    for uplo, tri in (("L", np.tril), ("U", np.triu)):
        Li = lapack.trtri(_t(A), uplo)
        _close(Li.numpy() @ tri(A), np.eye(n), scalar)
        _close(Li, jlapack.trtri(A, uplo), scalar)
    Lu = lapack.trtri(_t(A), "L", "U")
    _close(Lu.numpy() @ (np.tril(A, -1) + np.eye(n)), np.eye(n), scalar)
    _close(Lu, jlapack.trtri(A, "L", "U"), scalar)


def test_getrf_getrs_qr_chol(rng, scalar):
    n = 10
    A = rng.standard_normal((n, n)).astype(scalar) + n * np.eye(n, dtype=scalar)
    lu, piv, _ = lapack.getrf(_t(A))
    b = rng.standard_normal(n).astype(scalar)
    _close(lapack.getrs(lu, piv, _t(b)), np.linalg.solve(A, b), scalar)
    Q, R = lapack.geqrf(_t(A))
    _close(Q.numpy() @ R.numpy(), A, scalar)
    S = A @ A.T + n * np.eye(n, dtype=scalar)
    L = lapack.cholesky(_t(S))
    _close(L.numpy() @ L.numpy().T, S, scalar, 5000)
    _close(L, jlapack.cholesky(S), scalar, 5000)
    _close(lapack.cholesky(_t(S), upper=True), jlapack.cholesky(S, upper=True), scalar, 5000)


def test_getrf_pivots_are_tpukks(rng, scalar):
    """Pivoting matrices (no diagonal boost): the 0-based pivots and the
    permutation equal jax.lax.linalg.lu's, and A[perm] = L·U."""
    n = 16
    A = rng.standard_normal((n, n)).astype(scalar)
    lu, piv, perm = lapack.getrf(_t(A))
    jlu, jpiv, jperm = jlapack.getrf(A)
    assert piv.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert not np.array_equal(perm.numpy(), np.arange(n))  # rows were swapped
    _close(lu, jlu, scalar, 5000)
    L = np.tril(lu.numpy(), -1) + np.eye(n, dtype=scalar)
    _close(L @ np.triu(lu.numpy()), A[perm.numpy()], scalar, 5000)
    # getrs takes getrf's output, and so does tpukk's on the same factors
    B = rng.standard_normal((n, 2)).astype(scalar)
    X = lapack.getrs(lu, piv, _t(B))
    _close(X, np.asarray(jlapack.getrs(jlu, jpiv, B)), scalar, 20000)
    _close(A @ X.numpy(), B, scalar, 20000)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_getrf_getrs_complex(dtype):
    """Complex LU: tpukk's pivots and permutation exactly, the factors and
    getrs's solution within 2000·eps of tpukk's."""
    rng = np.random.default_rng(31)
    n = 12
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)
    lu, piv, perm = lapack.getrf(_t(A))
    jlu, jpiv, jperm = jlapack.getrf(A)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    real = np.float32 if dtype == np.complex64 else np.float64
    _close(lu, jlu, real)
    _close(lapack.getrs(lu, piv, _t(b)), jlapack.getrs(jlu, jpiv, b), real)
