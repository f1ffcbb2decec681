"""tpukk_torch.blas against tpukk.blas and the numpy oracles of
tests/test_blas.py, on the same numpy inputs (mirrors that file case by
case, f32 and f64), plus the exports, the no-aliasing contract and a
hypothesis check of rotmg against tpukk's.

Tolerances: tests/test_blas.py's own, scale·eps of the dtype against numpy
(scale 20 by default, 100-500 where that file has it), and the same bound
against tpukk's result; iamax, fill and rotmg's flag exactly; rotmg's
returned values within 1e-12 relative of tpukk's (the same IEEE operations
in the same order, JAX's fusions aside).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpukk import blas as jblas
from tpukk_torch import blas
from tpukk_torch.common.types import TpuKKError

from conftest import tol_for


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, dtype, scale=20):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=tol_for(dtype, scale),
                               atol=tol_for(dtype, scale))


def _both(got, ref, jgot, dtype, scale=20):
    """The port within the bound of the numpy oracle and of tpukk's result."""
    _close(got, ref, dtype, scale)
    _close(got, np.asarray(jgot), dtype, scale)
    assert _np(got).dtype == np.asarray(jgot).dtype


@pytest.fixture
def vecs(rng, scalar):
    x = rng.standard_normal(257).astype(scalar)
    y = rng.standard_normal(257).astype(scalar)
    z = rng.standard_normal(257).astype(scalar)
    return x, y, z


def test_exports_match_tpukk():
    names = {n for n in dir(jblas) if not n.startswith("_")}
    missing = {n for n in names if not hasattr(blas, n)}
    assert not missing, missing
    for mod in ("blas1", "blas2", "blas3"):
        assert set(getattr(jblas, mod).__all__) <= set(getattr(blas, mod).__all__)


class TestBlas1:
    def test_abs(self, vecs, scalar):
        x, _, _ = vecs
        _both(blas.blas1.abs(_t(x)), np.abs(x), jblas.blas1.abs(x), scalar)

    def test_axpby(self, vecs, scalar):
        x, y, _ = vecs
        _both(blas.axpby(2.0, _t(x), -0.5, _t(y)), 2 * x - 0.5 * y,
              jblas.axpby(2.0, x, -0.5, y), scalar)

    def test_axpy(self, vecs, scalar):
        x, y, _ = vecs
        _both(blas.axpy(3.0, _t(x), _t(y)), 3 * x + y, jblas.axpy(3.0, x, y), scalar)

    def test_dot(self, vecs, scalar):
        x, y, _ = vecs
        _both(blas.dot(_t(x), _t(y)), np.dot(x, y), jblas.dot(x, y), scalar, 300)

    def test_dot_mv(self, rng, scalar):
        X = rng.standard_normal((64, 3)).astype(scalar)
        Y = rng.standard_normal((64, 3)).astype(scalar)
        _both(blas.dot(_t(X), _t(Y)), (X * Y).sum(0), jblas.dot(X, Y), scalar, 100)

    def test_fill(self, vecs, scalar):
        x, _, _ = vecs
        xt = _t(x)
        out = blas.fill(xt, 3.0)
        assert np.all(_np(out) == np.array(3.0, scalar))
        assert out.dtype == xt.dtype and out.data_ptr() != xt.data_ptr()
        np.testing.assert_array_equal(_np(xt), x)

    def test_iamax(self, vecs, scalar):
        x, _, _ = vecs
        assert int(blas.iamax(_t(x))) == int(np.argmax(np.abs(x))) == int(jblas.iamax(x))

    def test_mult(self, vecs, scalar):
        x, y, z = vecs
        _both(blas.mult(0.5, _t(z), 2.0, _t(x), _t(y)), 0.5 * z + 2.0 * x * y,
              jblas.mult(0.5, z, 2.0, x, y), scalar)

    def test_norms(self, vecs, scalar):
        x, _, _ = vecs
        xt = _t(x)
        _both(blas.nrm1(xt), np.abs(x).sum(), jblas.nrm1(x), scalar, 300)
        _both(blas.nrm2(xt), np.linalg.norm(x), jblas.nrm2(x), scalar, 100)
        _both(blas.nrm2_squared(xt), np.linalg.norm(x) ** 2, jblas.nrm2_squared(x), scalar, 300)
        _both(blas.nrminf(xt), np.abs(x).max(), jblas.nrminf(x), scalar)

    def test_nrm2w(self, vecs, scalar):
        x, y, _ = vecs
        w = np.abs(y) + 1.0
        _both(blas.nrm2w(_t(x), _t(w)), np.linalg.norm(x / w), jblas.nrm2w(x, w), scalar, 100)

    def test_reciprocal_scal_update(self, vecs, scalar):
        x, y, z = vecs
        _both(blas.reciprocal(_t(x)), 1.0 / x, jblas.reciprocal(x), scalar)
        _both(blas.scal(2.0, _t(x)), 2 * x, jblas.scal(2.0, x), scalar)
        _both(blas.update(1.0, _t(x), 2.0, _t(y), 3.0, _t(z)), x + 2 * y + 3 * z,
              jblas.update(1.0, x, 2.0, y, 3.0, z), scalar)

    def test_sum_swap(self, vecs, scalar):
        x, y, _ = vecs
        _both(blas.blas1.sum(_t(x)), x.sum(), jblas.blas1.sum(x), scalar, 300)
        xt, yt = _t(x), _t(y)
        a, b = blas.swap(xt, yt)
        _close(a, y, scalar)
        _close(b, x, scalar)
        # new tensors: writing to the results leaves the inputs as they were
        a.zero_()
        b.zero_()
        np.testing.assert_array_equal(_np(xt), x)
        np.testing.assert_array_equal(_np(yt), y)

    def test_mv_coefficients(self, rng, scalar):
        X = rng.standard_normal((32, 4)).astype(scalar)
        Y = rng.standard_normal((32, 4)).astype(scalar)
        a = np.arange(1, 5, dtype=scalar)
        b = np.arange(4, 0, -1).astype(scalar)
        _both(blas.axpby(_t(a), _t(X), _t(b), _t(Y)), X * a[None] + Y * b[None],
              jblas.axpby(a, X, b, Y), scalar)

    def test_rot(self, vecs, scalar):
        x, y, _ = vecs
        c, s = np.array(0.8, scalar), np.array(0.6, scalar)
        xr, yr = blas.rot(_t(x), _t(y), c, s)
        jx, jy = jblas.rot(x, y, c, s)
        _both(xr, c * x + s * y, jx, scalar)
        _both(yr, c * y - s * x, jy, scalar)

    def test_rotg(self, scalar):
        r, z, c, s = blas.rotg(np.array(3.0, scalar), np.array(4.0, scalar), device="cpu")
        _close(r, 5.0, scalar)
        _close(c, 0.6, scalar)
        _close(s, 0.8, scalar)
        # the rotation really zeroes b
        _close(c * 3.0 + s * 4.0, float(r), scalar)
        _close(c * 4.0 - s * 3.0, 0.0, scalar)
        for got, want in zip((r, z, c, s), jblas.rotg(np.array(3.0, scalar),
                                                      np.array(4.0, scalar))):
            _both(got, np.asarray(want), want, scalar)

    @pytest.mark.parametrize("a,b", [(0.0, 0.0), (-3.0, 1.0), (1.0, -3.0), (0.0, 2.0),
                                     (2.0, 2.0)])
    def test_rotg_signs_and_edges(self, scalar, a, b):
        """rotg's sign convention (r takes the sign of the larger of |a|,
        |b|; b's on a tie) and z, against tpukk's."""
        got = blas.rotg(np.array(a, scalar), np.array(b, scalar), device="cpu")
        want = jblas.rotg(np.array(a, scalar), np.array(b, scalar))
        for g, w in zip(got, want):
            _close(g, np.asarray(w), scalar)

    @pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
    @pytest.mark.parametrize("fn,args", [(blas.rotg, (3.0, 4.0)),
                                         (blas.rotmg, (2.0, 3.0, 1.5, 0.7))])
    def test_rot_constructors_place_numbers_on_the_default_device(self, scalar, fn, args):
        """Numbers go to ``device`` (None: CUDA, refused here); tensors keep
        their device, and a number beside one follows it."""
        with pytest.raises(TpuKKError, match="device='cpu'"):
            fn(*(scalar(v) for v in args))
        first = torch.from_numpy(np.array(args[0], scalar))
        got = fn(first, *(scalar(v) for v in args[1:]))
        assert all(g.device == first.device and g.dtype == first.dtype for g in got[:3])
        want = fn(*(scalar(v) for v in args), device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_rotm_apply(self, scalar):
        x = np.array([1.0, 2.0], scalar)
        y = np.array([3.0, 4.0], scalar)
        param = np.array([-2.0, 0, 0, 0, 0], scalar)
        xr, yr = blas.rotm(_t(x), _t(y), _t(param))
        _close(xr, x, scalar)
        _close(yr, y, scalar)

    @pytest.mark.parametrize("flag", [-1.0, 0.0, 1.0])
    def test_rotm_flags(self, scalar, flag):
        x = np.array([1.0, 2.0, -0.5], scalar)
        y = np.array([3.0, 4.0, 0.25], scalar)
        param = np.array([flag, 0.5, -0.25, 2.0, 1.5], scalar)
        jx, jy = jblas.rotm(x, y, param)
        xr, yr = blas.rotm(_t(x), _t(y), _t(param))
        _close(xr, np.asarray(jx), scalar)
        _close(yr, np.asarray(jy), scalar)

    def test_rotmg_zeroes_y(self, scalar):
        """Applying the returned H to (x1, y1) zeroes the second component
        (tests/test_blas.py checks f64 alone, to 1e-12; f32 here to 20·eps
        of |x1'|), in the inputs' dtype, with tpukk's values."""
        d1, d2, x1, y1 = (scalar(v) for v in (2.0, 3.0, 1.5, 0.7))
        got = blas.rotmg(d1, d2, x1, y1, device="cpu")
        want = jblas.rotmg(d1, d2, x1, y1)
        assert got[3].dtype == _t(np.zeros(1, scalar)).dtype
        xr, yr = blas.rotm(_t(np.array(x1)), _t(np.array(y1)), got[3])
        assert abs(float(yr)) < (1e-12 if scalar == np.float64 else tol_for(scalar, 20)
                                 * abs(float(xr)))
        for g, w in zip(got, want):
            _close(g, np.asarray(w), scalar)

    def test_python_scalars_keep_f32(self):
        """JAX's weak types keep f32 as f32 under a Python scalar; so does the port."""
        x = torch.ones(4, dtype=torch.float32)
        for out in (blas.axpy(2.0, x, x), blas.axpby(2.0, x, 0.5, x), blas.scal(3, x),
                    blas.update(1.0, x, 2.0, x, 3.0, x), blas.mult(0.5, x, 2.0, x, x)):
            assert out.dtype == torch.float32
        assert blas.nrm2(x).dtype == torch.float32

    def test_set_is_a_new_tensor(self, rng, scalar):
        y = _t(rng.standard_normal(6).astype(scalar))
        x = _t(rng.standard_normal(6).astype(np.float64))
        out = blas.set(y, x)
        assert out.dtype == y.dtype and out.data_ptr() not in (x.data_ptr(), y.data_ptr())
        _close(out, np.asarray(jblas.set(y.numpy(), x.numpy())), scalar)


class TestBlas2:
    def test_gemv_modes(self, rng, scalar):
        A = rng.standard_normal((40, 30)).astype(scalar)
        x = rng.standard_normal(30).astype(scalar)
        y = rng.standard_normal(40).astype(scalar)
        _both(blas.gemv("N", 2.0, _t(A), _t(x), 0.5, _t(y)), 0.5 * y + 2 * A @ x,
              jblas.gemv("N", 2.0, A, x, 0.5, y), scalar, 200)
        xt = rng.standard_normal(40).astype(scalar)
        yt = rng.standard_normal(30).astype(scalar)
        for mode in ("T", "C", "H"):
            _both(blas.gemv(mode, 1.0, _t(A), _t(xt), 0.0, _t(yt)), A.T @ xt,
                  jblas.gemv("T" if mode == "H" else mode, 1.0, A, xt, 0.0, yt), scalar, 200)

    def test_ger(self, rng, scalar):
        A = rng.standard_normal((20, 25)).astype(scalar)
        x = rng.standard_normal(20).astype(scalar)
        y = rng.standard_normal(25).astype(scalar)
        _both(blas.ger(1.5, _t(x), _t(y), _t(A)), A + 1.5 * np.outer(x, y),
              jblas.ger(1.5, x, y, A), scalar, 100)

    def test_syr_syr2(self, rng, scalar):
        n = 16
        A = np.triu(rng.standard_normal((n, n))).astype(scalar)
        x = rng.standard_normal(n).astype(scalar)
        y = rng.standard_normal(n).astype(scalar)
        _both(blas.syr("U", 2.0, _t(x), _t(A)), A + np.triu(2.0 * np.outer(x, x)),
              jblas.syr("U", 2.0, x, A), scalar, 100)
        _both(blas.syr2("L", 1.0, _t(x), _t(y), _t(A)),
              A + np.tril(np.outer(x, y) + np.outer(y, x)),
              jblas.syr2("L", 1.0, x, y, A), scalar, 100)


class TestBlas3:
    def test_gemm_modes(self, rng, scalar):
        A = rng.standard_normal((33, 17)).astype(scalar)
        B = rng.standard_normal((17, 29)).astype(scalar)
        C = rng.standard_normal((33, 29)).astype(scalar)
        _both(blas.gemm("N", "N", 1.0, _t(A), _t(B), 0.0, _t(C)), A @ B,
              jblas.gemm("N", "N", 1.0, A, B, 0.0, C), scalar, 300)
        _both(blas.gemm("T", "T", 2.0, _t(B), _t(A), 1.0, _t(C.T.copy())), C.T + 2 * (B.T @ A.T),
              jblas.gemm("T", "T", 2.0, B, A, 1.0, C.T.copy()), scalar, 300)

    def test_gemm_single_column(self, rng, scalar):
        # the gemv fallback shape (KokkosBlas3_gemm.hpp:162-163)
        A = rng.standard_normal((16, 8)).astype(scalar)
        B = rng.standard_normal((8, 1)).astype(scalar)
        C = np.zeros((16, 1), scalar)
        _both(blas.gemm("N", "N", 1.0, _t(A), _t(B), 0.0, _t(C)), A @ B,
              jblas.gemm("N", "N", 1.0, A, B, 0.0, C), scalar, 100)

    def test_gemm_preferred_element_type(self, rng):
        """bf16 operands accumulate in f32 (the default) and the result is C's dtype."""
        A = rng.standard_normal((24, 16)).astype(np.float32)
        B = rng.standard_normal((16, 8)).astype(np.float32)
        Ab, Bb = _t(A).bfloat16(), _t(B).bfloat16()
        C = torch.zeros(24, 8, dtype=torch.float32)
        got = blas.gemm("N", "N", 1.0, Ab, Bb, 0.0, C)
        ref = Ab.float().numpy() @ Bb.float().numpy()
        assert got.dtype == torch.float32
        _close(got, ref, np.float32, 100)
        got64 = blas.gemm("N", "N", 1.0, _t(A), _t(B), 0.0, _t(np.zeros((24, 8))),
                          preferred_element_type=np.float64)
        _close(got64, A.astype(np.float64) @ B.astype(np.float64), np.float64, 100)

    def test_trmm(self, rng, scalar):
        n = 12
        A = rng.standard_normal((n, n)).astype(scalar)
        B = rng.standard_normal((n, 7)).astype(scalar)
        _both(blas.trmm("L", "L", "N", "N", 1.0, _t(A), _t(B)), np.tril(A) @ B,
              jblas.trmm("L", "L", "N", "N", 1.0, A, B), scalar, 200)
        _both(blas.trmm("R", "U", "T", "N", 2.0, _t(A), _t(B.T.copy())), 2 * B.T @ np.triu(A).T,
              jblas.trmm("R", "U", "T", "N", 2.0, A, B.T.copy()), scalar, 200)
        ref = (np.tril(A, -1) + np.eye(n)) @ B
        _both(blas.trmm("L", "L", "N", "U", 1.0, _t(A), _t(B)), ref,
              jblas.trmm("L", "L", "N", "U", 1.0, A, B), scalar, 200)

    def test_trsm(self, rng, scalar):
        n = 12
        A = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(scalar)
        B = rng.standard_normal((n, 5)).astype(scalar)
        X = _np(blas.trsm("L", "L", "N", "N", 1.0, _t(A), _t(B)))
        _close(np.tril(A) @ X, B, scalar, 500)
        _close(X, np.asarray(jblas.trsm("L", "L", "N", "N", 1.0, A, B)), scalar, 500)
        X2 = _np(blas.trsm("R", "U", "N", "N", 2.0, _t(A), _t(B.T.copy())))
        _close(X2 @ np.triu(A), 2 * B.T, scalar, 500)
        _close(X2, np.asarray(jblas.trsm("R", "U", "N", "N", 2.0, A, B.T.copy())), scalar, 500)

    @pytest.mark.parametrize("side,uplo,trans,diag", [
        ("L", "U", "T", "N"), ("R", "L", "T", "U"), ("L", "L", "C", "U"), ("R", "U", "C", "N")])
    def test_trsm_flags_match_tpukk(self, rng, scalar, side, uplo, trans, diag):
        n = 9
        A = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(scalar)
        B = rng.standard_normal((n, 4) if side == "L" else (4, n)).astype(scalar)
        _close(blas.trsm(side, uplo, trans, diag, 1.5, _t(A), _t(B)),
               np.asarray(jblas.trsm(side, uplo, trans, diag, 1.5, A, B)), scalar, 500)


class TestRotmgRescaling:
    """The full drotmg gamma-threshold rescaling (reference LAPACK semantics),
    as tests/test_blas.py checks it, plus tpukk's returned values."""

    @pytest.mark.parametrize("d1,d2,x1,y1", [
        (2.0, 3.0, 1.5, -0.5),          # ordinary flag path
        (1e-12, 2.0, 1.0, 1.0),         # small d1 -> rescale up
        (1e12, 1e-14, 3.0, 2.0),        # large d1 / tiny d2
        (4.0, 1e18, 1.0, 2.0),          # huge d2 -> rescale down
        (1e-20, 1e-20, 7.0, 3.0),       # both tiny
    ])
    def test_matches_lapack(self, d1, d2, x1, y1):
        from scipy.linalg import blas as sblas

        rparam = np.asarray(sblas.drotmg(d1, d2, x1, y1), np.float64).ravel()
        nd1, nd2, nx1, param = blas.rotmg(np.float64(d1), np.float64(d2),
                                          np.float64(x1), np.float64(y1), device="cpu")
        nd1, nd2, nx1 = float(nd1), float(nd2), float(nx1)
        p = _np(param).astype(np.float64)
        assert p[0] == rparam[0]

        def full(par):
            fl, h11, h21, h12, h22 = par
            if fl == -2.0:
                return np.eye(2)
            if fl == 0.0:
                return np.array([[1.0, h12], [h21, 1.0]])
            if fl == 1.0:
                return np.array([[h11, 1.0], [-1.0, h22]])
            return np.array([[h11, h12], [h21, h22]])

        H = full(p)
        np.testing.assert_allclose(H, full(rparam), rtol=1e-6, atol=1e-300)
        out = H @ np.array([x1, y1])
        assert abs(out[1]) <= 1e-10 * max(1.0, abs(out[0]))
        np.testing.assert_allclose(out[0], nx1, rtol=1e-10)
        rng = np.random.default_rng(3)
        for _ in range(3):
            v = rng.standard_normal(2)
            w = H @ v
            lhs = d1 * v[0] ** 2 + d2 * v[1] ** 2
            rhs = nd1 * w[0] ** 2 + nd2 * w[1] ** 2
            np.testing.assert_allclose(rhs, lhs, rtol=1e-8)
        gamsq = 4096.0 ** 2
        for d in (nd1, nd2):
            if d != 0:
                assert 1.0 / gamsq <= abs(d) <= gamsq
        _rotmg_equal(blas.rotmg(d1, d2, x1, y1, device="cpu"),
                     jblas.rotmg(np.float64(d1), np.float64(d2), np.float64(x1), np.float64(y1)))


def _rotmg_equal(got, want):
    """The port's (d1, d2, x1, param) against tpukk's: the flag exactly, the
    values within 1e-12 relative."""
    assert float(got[3][0]) == float(np.asarray(want[3])[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12, atol=0)


_decades = st.floats(min_value=-30, max_value=30)
# |x1|, |y1| in [1e-3, 1e3] or 0, so that no product falls below the normal
# range: XLA on the CPU flushes subnormals to zero, torch does not
_coord = st.one_of(st.just(0.0), st.tuples(st.sampled_from([-1.0, 1.0]),
                                           st.floats(min_value=-3, max_value=3))
                   .map(lambda t: t[0] * 10.0 ** t[1]))


@settings(max_examples=30, deadline=None)
@given(ed1=_decades, ed2=_decades, x1=_coord, y1=_coord)
def test_rotmg_hypothesis_matches_tpukk(ed1, ed2, x1, y1):
    """rotmg on positive scale factors over 60 decades (every rescaling
    branch) gives tpukk's flag and values."""
    d1, d2 = 10.0 ** ed1, 10.0 ** ed2
    _rotmg_equal(blas.rotmg(d1, d2, x1, y1, device="cpu"),
                 jblas.rotmg(np.float64(d1), np.float64(d2), np.float64(x1), np.float64(y1)))


@pytest.mark.parametrize("d1,d2,x1,y1", [(-2.0, 3.0, 1.5, 0.7), (2.0, -3.0, 0.5, 1.7),
                                         (-1e-20, 1e-20, 7.0, 3.0)])
def test_rotmg_negative_weight_is_lapacks_zero(d1, d2, x1, y1):
    """A negative d1, or q2 < 0 with |q2| >= |q1|: LAPACK's flag -1 with H,
    d1, d2 and x1 all 0 (tpukk's rescaling loop does not end there, so
    scipy's drotmg is the reference)."""
    from scipy.linalg import blas as sblas

    nd1, nd2, nx1, param = blas.rotmg(d1, d2, x1, y1, device="cpu")
    np.testing.assert_array_equal(param.numpy(), np.asarray(sblas.drotmg(d1, d2, x1, y1)))
    assert float(param[0]) == -1.0 and (float(nd1), float(nd2), float(nx1)) == (0.0, 0.0, 0.0)
