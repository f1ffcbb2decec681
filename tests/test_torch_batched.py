"""tpukk_torch.batched against tpukk.batched on the CPU (mirrors
tests/test_batched.py test by test).

Each test hands the same numpy inputs, made from a seed, to tpukk and to the
port (CPU tensors, so the port runs on the CPU) and holds the port to
tpukk's result and to the numpy/scipy oracle of tests/test_batched.py.
Tolerance against tpukk: f64 within 1e-10 of max|ref| (the same LAPACK-style
algorithms, their sums in another order), f32 within 1e-4; factorizations
whose factors are unique up to sign (QR, SVD, eigh) are held through what
they reconstruct.  The general eigensolver runs tpukk's own algorithm: its
Hessenberg form is held to tpukk's, each eigenvalue and its eigenvectors to
tpukk's (paired by value: see TestGeneralEig), eigendecomposition's sorted
layout in order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.batched as jb
import tpukk_torch.batched as tb
from tpukk.batched import dense as jbd
from tpukk.containers import CsrMatrix as JCsr
from tpukk.containers import generate_diag_dominant_csr
from tpukk_torch.batched import dense as tbd
from tpukk_torch.containers import CsrMatrix as TCsr

from conftest import tol_for

CPU = "cpu"
REL = {np.float32: 1e-4, np.float64: 1e-10, np.complex64: 1e-4, np.complex128: 1e-10}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vs_tpukk(got, ref, dtype):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got.astype(np.complex128) - ref).max() <= REL[np.dtype(dtype).type] * scale


def _close(a, b, dtype, scale=100):
    np.testing.assert_allclose(_np(a), b, rtol=tol_for(dtype, scale),
                               atol=tol_for(dtype, scale) * 10)


@pytest.fixture
def batch(rng, scalar):
    B, n = 6, 12
    A = rng.standard_normal((B, n, n)).astype(scalar) + 5 * np.eye(n, dtype=scalar)
    x = rng.standard_normal((B, n)).astype(scalar)
    Y = rng.standard_normal((B, n, n)).astype(scalar)
    return A, x, Y


class TestBatchedDense:
    def test_gemm(self, batch, scalar):
        A, _, Y = batch
        got = tbd.gemm("N", "N", 1.0, T(A), T(Y), 0.0, T(Y))
        _vs_tpukk(got, jbd.gemm("N", "N", 1.0, A, Y, 0.0, Y), scalar)
        _close(got, A @ Y, scalar, 300)
        got = tbd.gemm("T", "N", 2.0, T(A), T(Y), 1.0, T(Y))
        _vs_tpukk(got, jbd.gemm("T", "N", 2.0, A, Y, 1.0, Y), scalar)
        _close(got, Y + 2 * np.swapaxes(A, 1, 2) @ Y, scalar, 300)

    def test_gemv_ger_dot(self, batch, scalar):
        A, x, _ = batch
        y = np.zeros_like(x)
        got = tbd.gemv("N", 1.0, T(A), T(x), 0.0, T(y))
        _vs_tpukk(got, jbd.gemv("N", 1.0, A, x, 0.0, y), scalar)
        _close(got, np.einsum("bij,bj->bi", A, x), scalar, 300)
        got = tbd.ger(1.5, T(x), T(x), T(A))
        _vs_tpukk(got, jbd.ger(1.5, x, x, A), scalar)
        _close(got, A + 1.5 * np.einsum("bi,bj->bij", x, x), scalar)
        _vs_tpukk(tbd.syr("L", 0.5, T(x), T(A)), jbd.syr("L", 0.5, x, A), scalar)
        got = tbd.dot(T(x), T(x))
        _vs_tpukk(got, jbd.dot(x, x), scalar)
        _close(got, (x * x).sum(-1), scalar, 300)

    def test_vector_ops(self, batch, scalar):
        _, x, _ = batch
        y = x[::-1].copy().reshape(x.shape)
        for name, args, ref in (("axpy", (2.0, x, y), y + 2 * x), ("xpay", (3.0, x, y), x + 3 * y),
                                ("hadamard", (2.0, x, y), 2 * x * y), ("scale", (0.5, x), 0.5 * x)):
            got = getattr(tbd, name)(*[T(a) if isinstance(a, np.ndarray) else a for a in args])
            _vs_tpukk(got, getattr(jbd, name)(*args), scalar)
            _close(got, ref, scalar)
        alpha = np.linspace(0.5, 2.0, x.shape[0]).astype(scalar)
        _vs_tpukk(tbd.axpy(T(alpha), T(x), T(y)), jbd.axpy(alpha, x, y), scalar)
        assert np.all(_np(tbd.iamax(T(x))) == np.asarray(jbd.iamax(x)))
        assert np.all(_np(tbd.iamax(T(x))) == np.argmax(np.abs(x), -1))
        np.testing.assert_array_equal(_np(tbd.copy(T(x))), x)
        np.testing.assert_array_equal(_np(tbd.set_value(T(x), 3.0)), np.full_like(x, 3.0))

    def test_add_radial_set_identity(self, batch, scalar):
        A, _, _ = batch
        out = tbd.add_radial(0.1, T(A))
        _vs_tpukk(out, jbd.add_radial(0.1, A), scalar)
        d = np.diagonal(A, axis1=1, axis2=2)
        _close(np.diagonal(_np(out), axis1=1, axis2=2), d + 0.1 * np.where(d >= 0, 1, -1), scalar)
        I = _np(tbd.set_identity(T(A)))
        assert np.all(I == np.eye(A.shape[-1], dtype=scalar))

    def test_lu_solve_roundtrip(self, batch, scalar):
        A, x, _ = batch
        LU = tbd.lu(T(A))
        _vs_tpukk(LU, jbd.lu(A), scalar)
        got = tbd.solve_lu(LU, T(x))
        _vs_tpukk(got, jbd.solve_lu(jbd.lu(A), x), scalar)
        _close(got, np.linalg.solve(A, x[..., None])[..., 0], scalar, 5000)
        _vs_tpukk(tbd.solve_lu(LU, T(x), "T"), jbd.solve_lu(jbd.lu(A), x, "T"), scalar)
        Ainv = _np(tbd.inverse_lu(LU))
        _close(Ainv @ A, np.broadcast_to(np.eye(A.shape[-1]), A.shape), scalar, 5000)

    def test_getrf_getrs(self, batch, scalar):
        A, x, _ = batch
        lu_, piv, perm = tbd.getrf(T(A))
        jlu, jpiv, jperm = jbd.getrf(A)
        np.testing.assert_array_equal(_np(piv), np.asarray(jpiv))
        np.testing.assert_array_equal(_np(perm), np.asarray(jperm))
        _vs_tpukk(lu_, jlu, scalar)
        got = tbd.getrs(lu_, piv, T(x))
        _vs_tpukk(got, jbd.getrs(jlu, jpiv, x), scalar)
        _close(got, np.linalg.solve(A, x[..., None])[..., 0], scalar, 2000)
        _vs_tpukk(tbd.getrs(lu_, piv, T(x), "T"), jbd.getrs(jlu, jpiv, x, "T"), scalar)
        _vs_tpukk(tbd.gbtrs(*tbd.gbtrf(T(A))[:2], T(x)), jbd.gbtrs(jlu, jpiv, x), scalar)

    def test_trsm_trmm_trtri(self, batch, scalar):
        A, x, _ = batch
        L = np.tril(A)
        got = tbd.trsv("L", "N", "N", T(A), T(x))
        _vs_tpukk(got, jbd.trsv("L", "N", "N", A, x), scalar)
        _close(got, np.stack([np.linalg.solve(L[b], x[b]) for b in range(len(A))]), scalar, 2000)
        for side, uplo, trans, diag in (("L", "U", "T", "N"), ("R", "L", "N", "U"),
                                        ("L", "U", "N", "N")):
            _vs_tpukk(tbd.trsm(side, uplo, trans, diag, 2.0, T(A), T(A)),
                      jbd.trsm(side, uplo, trans, diag, 2.0, A, A), scalar)
        _vs_tpukk(tbd.tbsv("U", "N", "N", T(A), T(x)), jbd.tbsv("U", "N", "N", A, x), scalar)
        got = tbd.trmm("L", "L", "N", "N", 1.0, T(A), T(A))
        _vs_tpukk(got, jbd.trmm("L", "L", "N", "N", 1.0, A, A), scalar)
        _close(got, L @ A, scalar, 300)
        _vs_tpukk(tbd.trmm("R", "U", "T", "U", 0.5, T(A), T(A)),
                  jbd.trmm("R", "U", "T", "U", 0.5, A, A), scalar)
        Li = tbd.trtri("L", "N", T(A))
        _vs_tpukk(Li, jbd.trtri("L", "N", A), scalar)
        _close(_np(Li) @ L, np.broadcast_to(np.eye(A.shape[-1]), A.shape), scalar, 2000)

    def test_qr_svd_eigh(self, batch, scalar):
        A, _, _ = batch
        Q, R = tbd.qr(T(A))
        _close(_np(Q) @ _np(R), A, scalar, 2000)
        jQ, jR = jbd.qr(A)
        _vs_tpukk(np.abs(_np(R)), np.abs(np.asarray(jR)), scalar)
        _vs_tpukk(tbd.apply_q(Q, T(A), "T"), np.swapaxes(_np(Q), 1, 2) @ A, scalar)
        U, s, Vt = tbd.svd(T(A))
        _vs_tpukk(s, jbd.svd(A)[1], scalar)
        _close(_np(U) * _np(s)[:, None, :] @ _np(Vt), A, scalar, 5000)
        S = A + np.swapaxes(A, 1, 2)
        w, V = tbd.eigh(T(S))
        _vs_tpukk(w, jbd.eigh(S)[0], scalar)
        _close(_np(V) @ (_np(w)[..., None] * np.swapaxes(_np(V), 1, 2)), S, scalar, 10000)

    def test_gesv(self, batch, scalar):
        A, x, _ = batch
        got = tbd.gesv(T(A), T(x))
        _vs_tpukk(got, jbd.gesv(A, x), scalar)
        _close(got, np.linalg.solve(A, x[..., None])[..., 0], scalar, 2000)

    def test_pttrf_pttrs(self, rng, scalar):
        B, n = 4, 20
        d = (rng.random((B, n)) + 2).astype(scalar)
        e = (rng.random((B, n - 1)) * 0.5).astype(scalar)
        dd, l = tbd.pttrf(T(d), T(e))
        jdd, jl = jbd.pttrf(d, e)
        _vs_tpukk(dd, jdd, scalar)
        _vs_tpukk(l, jl, scalar)
        b = rng.standard_normal((B, n)).astype(scalar)
        x = tbd.pttrs(dd, l, T(b))
        _vs_tpukk(x, jbd.pttrs(jdd, jl, b), scalar)
        for bi in range(B):
            Tm = np.diag(d[bi]) + np.diag(e[bi], 1) + np.diag(e[bi], -1)
            _close(Tm @ _np(x)[bi], b[bi], scalar, 2000)

    def test_pbtrf_pbtrs(self, rng, scalar):
        B, n = 3, 10
        M = rng.standard_normal((B, n, n)).astype(scalar)
        A = M @ np.swapaxes(M, 1, 2) + n * np.eye(n, dtype=scalar)
        L = tbd.pbtrf(T(A))
        _vs_tpukk(L, jbd.pbtrf(A), scalar)
        b = rng.standard_normal((B, n)).astype(scalar)
        x = tbd.pbtrs(L, T(b))
        _vs_tpukk(x, jbd.pbtrs(jbd.pbtrf(A), b), scalar)
        _close(x, np.linalg.solve(A, b[..., None])[..., 0], scalar, 5000)

    def test_laswp(self, rng, scalar):
        B, n = 2, 5
        A = rng.standard_normal((B, n, n)).astype(scalar)
        lu_, piv, perm = tbd.getrf(T(A))
        swapped = tbd.laswp(piv, T(A))
        np.testing.assert_array_equal(_np(swapped), np.asarray(jbd.laswp(np.asarray(piv), A)))
        _close(swapped, np.take_along_axis(A, _np(perm)[..., None], axis=1), scalar)


class TestBatchedSparse:
    def _problem(self, rng, B=5, n=30):
        A0 = generate_diag_dominant_csr(n, 4, dtype=np.float64, seed=1)
        base = np.asarray(A0.values)
        vals = np.stack([base * (1 + 0.1 * b) for b in range(B)])
        At = TCsr.from_scipy(A0.to_scipy(), device=CPU)
        return A0, jb.BatchedCrsMatrix.from_csr(A0, vals), tb.BatchedCrsMatrix.from_csr(
            At, T(vals)), rng.standard_normal((B, n))

    def test_batched_spmv(self, rng):
        A0, Aj, At, X = self._problem(rng)
        Y = tb.batched_spmv(At, T(X))
        _vs_tpukk(Y, jb.batched_spmv(Aj, X), np.float64)
        for b in range(At.n_batch):
            sp = A0.to_scipy().copy()
            sp.data = np.asarray(Aj.values[b])
            _close(_np(Y)[b], sp @ X[b], np.float64, 100)

    def test_batched_cg(self, rng):
        A0, _, _, _ = self._problem(rng)
        sp = A0.to_scipy()
        S = sps.csr_matrix((sp + sp.T) * 0.5)
        S.sort_indices()
        A0s = JCsr.from_scipy(S)
        vals = np.stack([np.asarray(A0s.values) * (1 + 0.1 * b) for b in range(5)])
        Aj = jb.BatchedCrsMatrix.from_csr(A0s, vals)
        At = tb.BatchedCrsMatrix.from_csr(TCsr.from_scipy(S, device=CPU), T(vals))
        Brhs = rng.standard_normal((5, A0s.nrows))
        Xs, it, res = tb.batched_cg(At, T(Brhs), max_iters=200, tol=1e-10, prec=tb.JacobiPrec(At))
        Xj, itj, resj = jb.batched_cg(Aj, Brhs, max_iters=200, tol=1e-10, prec=jb.JacobiPrec(Aj))
        assert it == itj == 200
        _vs_tpukk(Xs, Xj, np.float64)
        assert np.all(_np(res) < 1e-8 * np.linalg.norm(Brhs, axis=-1).max())

    def test_batched_gmres(self, rng):
        A0, Aj, At, X = self._problem(rng)
        Brhs = rng.standard_normal((At.n_batch, A0.nrows))
        Xg, res = tb.batched_gmres(At, T(Brhs), restart=30, max_restarts=3, tol=1e-10)
        Xj, resj = jb.batched_gmres(Aj, Brhs, restart=30, max_restarts=3, tol=1e-10)
        _vs_tpukk(Xg, Xj, np.float64)
        assert np.all(_np(res) < 1e-6 * np.linalg.norm(Brhs, axis=-1).max())
        Xp, _ = tb.batched_gmres(At, T(Brhs), restart=10, max_restarts=4, prec=tb.JacobiPrec(At))
        Xpj, _ = jb.batched_gmres(Aj, Brhs, restart=10, max_restarts=4, prec=jb.JacobiPrec(Aj))
        _vs_tpukk(Xp, Xpj, np.float64)


def test_qr_with_column_pivoting(rng):
    """A[:,perm] = QR, orthonormal Q, non-increasing |diag R|, and tpukk's
    perm, Q and R (cf. KokkosBatched_QR_WithColumnPivoting_Decl.hpp)."""
    A = rng.standard_normal((3, 8, 6)).astype(np.float32)
    Q, R, perm = tbd.qr_with_column_pivoting(T(A))
    jQ, jR, jperm = jbd.qr_with_column_pivoting(A)
    np.testing.assert_array_equal(_np(perm), np.asarray(jperm))
    _vs_tpukk(Q, jQ, np.float32)
    _vs_tpukk(R, jR, np.float32)
    for i in range(3):
        ap = A[i][:, _np(perm[i])]
        assert np.abs(_np(Q[i]) @ _np(R[i]) - ap).max() < 1e-4
        assert np.abs(_np(Q[i]).T @ _np(Q[i]) - np.eye(6)).max() < 1e-5
        assert np.all(np.diff(np.abs(np.diagonal(_np(R[i])))) <= 1e-5)
    Aw = rng.standard_normal((2, 4, 7)).astype(np.float32)
    Qw, Rw, pw = tbd.qr_with_column_pivoting(T(Aw))
    np.testing.assert_array_equal(_np(pw), np.asarray(jbd.qr_with_column_pivoting(Aw)[2]))
    for i in range(2):
        ap = Aw[i][:, _np(pw[i])]
        assert np.abs(_np(Qw[i]) @ _np(Rw[i]) - ap).max() < 1e-4


def test_utv_solve_rank_deficient(rng):
    """UTV's rank detection and minimum-norm solve on a rank-3 8×6 batch,
    tpukk's rank and solution (cf. KokkosBatched_UTV_Decl.hpp /
    KokkosBatched_SolveUTV_Decl.hpp)."""
    B = (rng.standard_normal((2, 8, 3)) @ rng.standard_normal((2, 3, 6))).astype(np.float32)
    U, Tm, V, perm, rank = tbd.utv(T(B))
    jU, jT, jV, jperm, jrank = jbd.utv(B)
    assert np.all(_np(rank) == 3) and np.all(_np(rank) == np.asarray(jrank))
    # the pivots past the rank pick among columns whose remaining norms are
    # rounding noise (~1e-7 in f32), so only the first `rank` are tpukk's
    np.testing.assert_array_equal(_np(perm)[:, :3], np.asarray(jperm)[:, :3])
    for i in range(2):
        bp = B[i][:, _np(perm[i])]
        rec = _np(U[i]) @ _np(Tm[i]) @ _np(V[i]).T
        assert np.abs(rec - bp).max() < 1e-4 * np.abs(B[i]).max()
    b = rng.standard_normal((2, 8)).astype(np.float32)
    x = tbd.solve_utv(U, Tm, V, perm, rank, T(b))
    # the minimum-norm solution is unique: tpukk's, whatever the pivots past the rank
    _vs_tpukk(x, jbd.solve_utv(jU, jT, jV, jperm, jrank, b), np.float32)
    for i in range(2):
        xr, *_ = np.linalg.lstsq(B[i], b[i], rcond=1e-5)
        assert np.linalg.norm(B[i] @ _np(x[i]) - b[i]) <= np.linalg.norm(B[i] @ xr - b[i]) * (1 + 1e-4)
        assert np.linalg.norm(_np(x[i])) <= np.linalg.norm(xr) * (1 + 1e-4)
    C = rng.standard_normal((1, 5, 5)).astype(np.float32) + 3 * np.eye(5, dtype=np.float32)
    U, Tm, V, perm, rank = tbd.utv(T(C))
    assert int(_np(rank)[0]) == 5
    bc = rng.standard_normal((1, 5)).astype(np.float32)
    xc = tbd.solve_utv(U, Tm, V, perm, rank, T(bc))
    assert np.abs(C[0] @ _np(xc[0]) - bc[0]).max() < 1e-3


class TestBandStorage:
    """Band-storage functions against tpukk's and scipy's banded oracles."""

    def _spd_band(self, rng, n, kd):
        A = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - kd), min(n, i + kd + 1)):
                A[i, j] = rng.standard_normal() * 0.1
        A = A + A.T + np.eye(n) * (2 * kd + 2)
        Ab = np.zeros((kd + 1, n))
        for i in range(kd + 1):
            Ab[i, : n - i] = np.diag(A, -i)
        return A, Ab

    def test_pbtrf_pbtrs(self, rng):
        import scipy.linalg as sla

        n, kd = 23, 4
        A, Ab = self._spd_band(rng, n, kd)
        L = tb.pbtrf_banded(T(Ab))
        _vs_tpukk(L, jb.pbtrf_banded(jnp.asarray(Ab)), np.float64)
        assert np.abs(_np(L) - sla.cholesky_banded(Ab, lower=True)).max() < 1e-10
        b = rng.standard_normal(n)
        x = tb.pbtrs_banded(L, T(b))
        _vs_tpukk(x, jb.pbtrs_banded(jb.pbtrf_banded(jnp.asarray(Ab)), jnp.asarray(b)),
                  np.float64)
        assert np.abs(_np(x) - sla.solveh_banded(Ab, b, lower=True)).max() < 1e-10
        AbB = np.stack([Ab, Ab * 1.5])
        LB = tb.pbtrf_banded(T(AbB))
        assert LB.shape == (2, kd + 1, n)
        _vs_tpukk(LB, jb.pbtrf_banded(jnp.asarray(AbB)), np.float64)
        bB = rng.standard_normal((2, n))
        _vs_tpukk(tb.pbtrs_banded(LB, T(bB)),
                  jb.pbtrs_banded(jb.pbtrf_banded(jnp.asarray(AbB)), jnp.asarray(bB)), np.float64)

    def test_gbtrf_gbtrs(self, rng):
        import scipy.linalg as sla

        n, kl, ku = 19, 2, 3
        G = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - kl), min(n, i + ku + 1)):
                G[i, j] = rng.standard_normal()
        G += np.eye(n) * (kl + ku + 3)
        Gb = np.zeros((kl + ku + 1, n))
        for idx, d in enumerate(range(ku, -kl - 1, -1)):
            dv = np.diag(G, d)
            if d >= 0:
                Gb[idx, d:d + len(dv)] = dv
            else:
                Gb[idx, : len(dv)] = dv
        Lb, Ub = tb.gbtrf_banded(T(Gb), kl, ku)
        jLb, jUb = jb.gbtrf_banded(jnp.asarray(Gb), kl, ku)
        _vs_tpukk(Lb, jLb, np.float64)
        _vs_tpukk(Ub, jUb, np.float64)
        b = rng.standard_normal(n)
        y = tb.gbtrs_banded(Lb, Ub, T(b))
        _vs_tpukk(y, jb.gbtrs_banded(jLb, jUb, jnp.asarray(b)), np.float64)
        assert np.abs(_np(y) - sla.solve_banded((kl, ku), Gb, b)).max() < 1e-9
        Lm = np.eye(n)
        for i in range(1, kl + 1):
            Lm += np.diag(_np(Lb)[i - 1, : n - i], -i)
        Um = np.zeros((n, n))
        for t in range(ku + 1):
            Um += np.diag(_np(Ub)[t, : n - t], t)
        assert np.abs(Lm @ Um - G).max() < 1e-10

    def test_tbsv(self, rng):
        import scipy.linalg as sla

        n, kd = 23, 4
        A, _ = self._spd_band(rng, n, kd)
        b = rng.standard_normal(n)
        Tl = np.tril(A)
        Tb = np.zeros((kd + 1, n))
        for i in range(kd + 1):
            Tb[i, : n - i] = np.diag(Tl, -i)
        xt = tb.tbsv_banded(T(Tb), T(b), lower=True)
        _vs_tpukk(xt, jb.tbsv_banded(jnp.asarray(Tb), jnp.asarray(b), lower=True), np.float64)
        assert np.abs(sla.solve_triangular(Tl, b, lower=True) - _np(xt)).max() < 1e-10
        U2 = np.triu(A)
        Ub2 = np.zeros((kd + 1, n))
        for t in range(kd + 1):
            Ub2[t, : n - t] = np.diag(U2, t)
        xu = tb.tbsv_banded(T(Ub2), T(b), lower=False)
        _vs_tpukk(xu, jb.tbsv_banded(jnp.asarray(Ub2), jnp.asarray(b), lower=False), np.float64)
        assert np.abs(sla.solve_triangular(U2, b, lower=False) - _np(xu)).max() < 1e-10
        _vs_tpukk(tb.tbsv_banded(T(Tb), T(b), unit_diag=True),
                  jb.tbsv_banded(jnp.asarray(Tb), jnp.asarray(b), unit_diag=True), np.float64)


class TestGeneralEig:
    """tpukk's general eigensolver, ported: its Hessenberg form and each
    eigenvalue with its left and right eigenvectors are tpukk's, and the
    eigenvalues are numpy.linalg.eig's multiset.  Where along T's diagonal
    an eigenvalue lands is decided by when the QR sweeps deflate, and a
    deflation test near its threshold is decided by the last bits of a
    subdiagonal (XLA's and torch's rotations round differently), so the
    eigenvalues are paired with tpukk's by value; eigendecomposition's
    sorted layout is held in order."""

    @staticmethod
    def _match_multisets(got, ref, tol):
        ref = list(ref)
        for g in got:
            j = int(np.argmin([abs(g - r) for r in ref]))
            assert abs(g - ref[j]) < tol, (g, ref[j])
            ref.pop(j)

    @staticmethod
    def _pairs(w, jw):
        """For each of w's eigenvalues, the index of tpukk's nearest unused one."""
        left = list(range(len(jw)))
        out = []
        for g in w:
            j = min(left, key=lambda q: abs(g - jw[q]))
            out.append(j)
            left.remove(j)
        return out

    @pytest.mark.parametrize("n", [1, 2, 3, 6, 12])
    def test_eig_random(self, rng, n):
        A = rng.standard_normal((3, n, n))
        w, VL, VR = (_np(v) for v in tb.eig(T(A)))
        jw, jVL, jVR = (np.asarray(v) for v in jb.eig(jnp.asarray(A)))
        for b in range(3):
            self._match_multisets(w[b], np.linalg.eigvals(A[b]), 1e-8 * max(1, np.abs(A[b]).sum()))
            pair = self._pairs(w[b], jw[b])
            for i in range(n):
                j = pair[i]
                assert abs(w[b, i] - jw[b, j]) <= 1e-10 * np.abs(jw[b]).max()
                # the same eigenvector as tpukk's, up to a unit phase
                for V, jV in ((VR, jVR), (VL, jVL)):
                    ph = np.vdot(jV[b][:, j], V[b][:, i])
                    assert abs(abs(ph) - 1) < 1e-8
                    assert np.abs(V[b][:, i] - ph * jV[b][:, j]).max() < 1e-8
                assert np.linalg.norm(A[b] @ VR[b][:, i] - w[b, i] * VR[b][:, i]) < 1e-10 * n
                assert np.linalg.norm(np.conj(VL[b][:, i]) @ A[b]
                                      - w[b, i] * np.conj(VL[b][:, i])) < 1e-10 * n

    def test_schur_similarity(self, rng):
        A = rng.standard_normal((2, 7, 7))
        Tt, Z = (_np(v) for v in tb.schur(T(A)))
        jT, _ = jb.schur(jnp.asarray(A))
        for b in range(2):
            jd = np.diagonal(np.asarray(jT)[b])
            d = np.diagonal(Tt[b])
            assert np.abs(d - jd[self._pairs(d, jd)]).max() <= 1e-10 * np.abs(jd).max()
        H, Q = (_np(v) for v in tb.hessenberg(T(A)))
        jH, jQ = jb.hessenberg(jnp.asarray(A))
        _vs_tpukk(H, jH, np.float64)
        _vs_tpukk(Q, jQ, np.float64)
        for b in range(2):
            assert np.abs(np.tril(Tt[b], -1)).max() < 1e-12
            assert np.abs(Z[b] @ Tt[b] @ Z[b].conj().T - A[b]).max() < 1e-10
            assert np.abs(Z[b].conj().T @ Z[b] - np.eye(7)).max() < 1e-12

    def test_eig_complex_input(self, rng):
        A = rng.standard_normal((2, 5, 5)) + 1j * rng.standard_normal((2, 5, 5))
        w = _np(tb.eigenvalues(T(A)))
        jw = np.asarray(jb.eigenvalues(jnp.asarray(A)))
        for b in range(2):
            assert np.abs(w[b] - jw[b][self._pairs(w[b], jw[b])]).max() <= 1e-10 * np.abs(jw).max()
            self._match_multisets(w[b], np.linalg.eigvals(A[b]), 1e-9)

    def test_eigendecomposition_pairs_adjacent(self, rng):
        A = rng.standard_normal((1, 6, 6))
        er, ei, UL, UR = (_np(v) for v in tb.eigendecomposition(T(A)))
        jer, jei, _, _ = (np.asarray(v) for v in jb.eigendecomposition(jnp.asarray(A)))
        _vs_tpukk(er, jer, np.float64)
        _vs_tpukk(ei, jei, np.float64)
        er, ei = er[0], ei[0]
        i = 0
        while i < 6:
            if abs(ei[i]) > 1e-10:
                assert abs(er[i] - er[i + 1]) < 1e-8
                assert abs(ei[i] + ei[i + 1]) < 1e-8
                assert ei[i] > 0
                i += 2
            else:
                i += 1

    def test_eig_f32(self, rng):
        A = rng.standard_normal((2, 4, 4)).astype(np.float32)
        w, _, VR = tb.eig(T(A))
        assert w.dtype == torch.complex64
        w, VR = _np(w), _np(VR)
        jw = np.asarray(jb.eig(jnp.asarray(A))[0])
        for b in range(2):
            assert np.abs(w[b] - jw[b][self._pairs(w[b], jw[b])]).max() <= 1e-4 * np.abs(jw).max()
            for i in range(4):
                assert np.linalg.norm(A[b] @ VR[b][:, i] - w[b, i] * VR[b][:, i]) < 1e-4


def test_batched_exports_match_tpukk():
    """tpukk_torch.batched exports every public name of tpukk.batched and
    of tpukk.batched.dense."""
    for jmod, tmod in ((jb, tb), (jbd, tbd)):
        names = {n for n in dir(jmod) if not n.startswith("_") and n not in ("annotations",)}
        missing = {n for n in names if not hasattr(tmod, n)} - {"jax", "jnp", "check", "np"}
        assert not missing, missing
    assert set(jbd.__all__) == set(tbd.__all__)


# ---- complex LU, add_radial and CG; batched_spmv's rows --------------------

CPLX = [np.complex64, np.complex128]


def _crandn(rng, shape, dtype):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("cdtype", CPLX, ids=["c64", "c128"])
def test_complex_getrf_getrs_gbtrf_laswp(cdtype):
    """getrf/getrs, gbtrf/gbtrs and laswp on complex batches: tpukk's pivots
    and permutation exactly, factors and solutions as tpukk's, the swapped
    rows exactly."""
    rng = np.random.default_rng(41)
    A = _crandn(rng, (3, 6, 6), cdtype)
    b = _crandn(rng, (3, 6), cdtype)
    lu_, piv, perm = tbd.getrf(T(A))
    jlu, jpiv, jperm = jbd.getrf(A)
    np.testing.assert_array_equal(_np(piv), np.asarray(jpiv))
    np.testing.assert_array_equal(_np(perm), np.asarray(jperm))
    _vs_tpukk(lu_, jlu, cdtype)
    for trans in ("N", "T"):
        _vs_tpukk(tbd.getrs(lu_, piv, T(b), trans), jbd.getrs(jlu, jpiv, b, trans), cdtype)
    glu, gpiv, _ = tbd.gbtrf(T(A))
    _vs_tpukk(tbd.gbtrs(glu, gpiv, T(b)), jbd.gbtrs(*jbd.gbtrf(A)[:2], b), cdtype)
    np.testing.assert_array_equal(_np(tbd.laswp(piv, T(A))),
                                  np.asarray(jbd.laswp(np.asarray(jpiv), A)))


@pytest.mark.parametrize("cdtype", CPLX, ids=["c64", "c128"])
def test_complex_add_radial(cdtype):
    """add_radial on complex diagonals takes jnp's order on (real, imag):
    0+1j ≥ 0, 0−1j < 0, as tpukk does."""
    rng = np.random.default_rng(43)
    A = _crandn(rng, (2, 4, 4), cdtype)
    A[0, 0, 0], A[0, 1, 1], A[0, 2, 2], A[0, 3, 3] = 1j, -1j, 0, -2 + 5j
    _vs_tpukk(tbd.add_radial(0.25, T(A)), jbd.add_radial(0.25, A), cdtype)


def test_complex_batched_cg_cocg():
    """batched_cg on complex symmetric systems: tpukk's unconjugated sums
    (COCG), its iterate and its complex residual norms."""
    rng = np.random.default_rng(47)
    A0 = generate_diag_dominant_csr(30, 4, dtype=np.float64, seed=1)
    sp = A0.to_scipy()
    S = sps.csr_matrix((sp + sp.T) * 0.5)
    S.sort_indices()
    Aj0 = JCsr.from_scipy(S)
    base = np.asarray(Aj0.values)
    vals = np.stack([base * (1 + 0.1 * b) + 0.05j * b * base for b in range(4)])
    Aj = jb.BatchedCrsMatrix.from_csr(Aj0, vals)
    At = tb.BatchedCrsMatrix.from_csr(TCsr.from_scipy(S, device=CPU), T(vals))
    B = _crandn(rng, (4, S.shape[0]), np.complex128)
    Xs, it, res = tb.batched_cg(At, T(B), max_iters=60, tol=1e-10, prec=tb.JacobiPrec(At))
    Xj, itj, resj = jb.batched_cg(Aj, B, max_iters=60, tol=1e-10, prec=jb.JacobiPrec(Aj))
    assert it == itj == 60
    _vs_tpukk(Xs, Xj, np.complex128)
    np.testing.assert_allclose(_np(res), np.asarray(resj), rtol=1e-6, atol=1e-12)
    for b in range(4):
        Sb = S.copy()
        Sb.data = vals[b]
        assert np.abs(Sb @ _np(Xs)[b] - B[b]).max() < 1e-8 * np.abs(B[b]).max()


def test_batched_spmv_rows_keyword():
    """batched_spmv(A, X, rows): the entries' rows given, as tpukk takes them."""
    rng = np.random.default_rng(53)
    A0 = generate_diag_dominant_csr(30, 4, dtype=np.float64, seed=1)
    vals = np.stack([np.asarray(A0.values) * (1 + 0.1 * b) for b in range(3)])
    Aj = jb.BatchedCrsMatrix.from_csr(A0, vals)
    At = tb.BatchedCrsMatrix.from_csr(TCsr.from_scipy(A0.to_scipy(), device=CPU), T(vals))
    X = rng.standard_normal((3, 30))
    rm = np.asarray(A0.row_map)
    rows = np.repeat(np.arange(30, dtype=np.int32), np.diff(rm))
    got = tb.batched_spmv(At, T(X), rows=T(rows))
    _vs_tpukk(got, jb.batched_spmv(Aj, X, rows=jnp.asarray(rows)), np.float64)
    _vs_tpukk(got, tb.batched_spmv(At, T(X)), np.float64)
