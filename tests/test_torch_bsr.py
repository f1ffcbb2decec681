"""tpukk_torch's BSR route against tpukk on the CPU, on the same numpy
inputs (mirrors tests/test_spmv.py:65,187, tests/test_spgemm_spadd.py:100,361
and tests/test_gauss_seidel.py:182).

Slice: ``SpmvHandle`` on a ``BsrMatrix`` (AUTO: DIA on the scalar expansion
of a banded block graph, else BSR; a pinned algorithm: BSR), ``spmv``/``spmm``
on a BsrMatrix, ``bspgemm_symbolic``/``bspgemm_numeric``/``bspgemm`` with
reuse, ``bspadd`` and block Gauss-Seidel.  The DIA route runs K1/K2's plain
version here; the BSR route, bspgemm, bspadd and the block updates are torch
ops on every device.

Tolerances: routes, C's block pattern and block GS's colors equal tpukk's
exactly; SpMV within 20·eps·(|A|·|x|)_i of scipy in f64 and of tpukk's result;
bspgemm and bspadd within 1e-12 (f64) / 1e-5 (f32) relative (max norm) of
tpukk's values; bspgemm's reuse on 2·A exactly 2·C; two BSR products on the
same input the same bits; block GS iterates within 1e-12 (f64) / 1e-5 (f32)
relative of tpukk's after each sweep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse as js
import tpukk_torch.containers as tkc
import tpukk_torch.sparse as ts
from tpukk_torch.sparse import SpmvAlgorithm

CPU = "cpu"
DTYPES = [np.float32, np.float64]


def _port(Bj):
    """tpukk's BsrMatrix as the port's, on the CPU (the same blocks)."""
    return tkc.BsrMatrix.from_scipy_bsr(Bj.to_scipy(), device=CPU)


def _matrix(name, dtype):
    """tpukk's BsrMatrix of the named case (each comment says which route
    tpukk's AUTO takes on it)."""
    rng = np.random.default_rng(7)
    if name == "lap64_b4":   # banded block graph: AUTO takes DIA
        return jkc.crs2bsr(jkc.generate_structured_laplacian(64, dtype=dtype), 4)
    if name == "lap12_random_blocks_b4":   # tests/test_spmv.py:187's matrix
        sp = jkc.generate_structured_laplacian(12, 12, dtype=np.float32).to_scipy().tocsr()
        blocks = (rng.standard_normal((sp.nnz, 4, 4)) * 0.1).astype(dtype)
        return jkc.BsrMatrix.from_scipy_bsr(
            sps.bsr_matrix((blocks, sp.indices, sp.indptr), shape=(sp.shape[0] * 4,) * 2))
    if name == "elasticity_b3":   # tests/test_gauss_seidel.py:182's matrix
        return jkc.BsrMatrix.from_scipy_bsr(sps.bsr_matrix(_elasticity(10, dtype),
                                                           blocksize=(3, 3)))
    if name == "random_b3":   # unstructured: AUTO takes BSR
        return jkc.generate_random_bsr(300, 300, 3, 6, dtype=dtype, seed=4)
    raise KeyError(name)


MATRICES = ["lap64_b4", "lap12_random_blocks_b4", "elasticity_b3", "random_b3"]


def _elasticity(n, dtype=np.float64):
    """kron(Laplacian, I3) + kron(I, 0.3·1 + 3·I3): a 3-dof block matrix."""
    Ac = jkc.generate_structured_laplacian(n, n, dtype=np.float64).to_scipy()
    return (sps.kron(Ac, np.eye(3))
            + sps.kron(sps.eye(Ac.shape[0]), 0.3 * np.ones((3, 3)) + 3 * np.eye(3))).astype(dtype)


def _held(got, A_sp, x, dtype, ref=None):
    """|got - A·x| <= 20·eps·(|A||x|) elementwise, A·x from scipy in f64 (or ref)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    A64 = A_sp.astype(np.float64)
    x64 = np.asarray(x, np.float64)
    want = A64 @ x64 if ref is None else np.asarray(ref, np.float64)
    bound = 20 * np.finfo(dtype).eps * (abs(A64) @ np.abs(x64)) + 1e-300
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("alg", ["AUTO", "BSR", "ELL", "DS"])
@pytest.mark.parametrize("name", MATRICES)
def test_bsr_spmv_route_and_values(name, alg, dtype):
    Bj = _matrix(name, dtype)
    Bt = _port(Bj)
    hj = js.SpmvHandle(Bj, getattr(js.SpmvAlgorithm, alg))
    ht = ts.SpmvHandle(Bt, getattr(SpmvAlgorithm, alg))
    assert ht.algorithm.name == hj.algorithm.name
    x = np.random.default_rng(1).standard_normal(Bt.ncols).astype(dtype)
    y = ht(torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype
    _held(y, Bj.to_scipy(), x, dtype)
    _held(y, Bj.to_scipy(), x, dtype, ref=np.asarray(hj(x)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", MATRICES)
def test_bsr_spmm_both_routes(name, dtype):
    Bj = _matrix(name, dtype)
    Bt = _port(Bj)
    X = np.random.default_rng(2).standard_normal((Bt.ncols, 5)).astype(dtype)
    for alg in (SpmvAlgorithm.AUTO, SpmvAlgorithm.BSR):
        Y = ts.spmm(Bt, torch.from_numpy(X), algorithm=alg)
        Yj = js.spmm(Bj, X, algorithm=getattr(js.SpmvAlgorithm, alg.name))
        for j in range(X.shape[1]):
            _held(Y[:, j], Bj.to_scipy(), X[:, j], dtype)
            _held(Y[:, j], Bj.to_scipy(), X[:, j], dtype, ref=np.asarray(Yj)[:, j])


def test_spmv_bsr_convenience(rng):
    """tests/test_spmv.py:65: the handle-less spmv on a BsrMatrix, 1-D and 2-D."""
    A = jkc.generate_structured_laplacian(64, dtype=np.float64)
    B = _port(jkc.crs2bsr(A, 4))
    x = rng.standard_normal(B.ncols)
    _held(ts.spmv(B, torch.from_numpy(x)), A.to_scipy(), x, np.float64)
    X = rng.standard_normal((B.ncols, 4))
    Y = ts.spmv(B, torch.from_numpy(X))
    for j in range(4):
        _held(Y[:, j], A.to_scipy(), X[:, j], np.float64)
    # alpha, beta and y, as on CSR
    y0 = rng.standard_normal(B.nrows)
    out = ts.spmv(B, torch.from_numpy(x), alpha=2.0, beta=-0.5, y=torch.from_numpy(y0))
    np.testing.assert_allclose(out.numpy(), 2 * (A.to_scipy() @ x) - 0.5 * y0, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["lap12_random_blocks_b4", "random_b3"])
def test_bsr_route_gives_the_same_bits_twice(name):
    Bt = _port(_matrix(name, np.float32))
    h = ts.SpmvHandle(Bt, SpmvAlgorithm.BSR)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(Bt.ncols).astype(np.float32))
    assert torch.equal(h(x), h(x))
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((Bt.ncols, 3)))
    assert torch.equal(h(X), h(X))


def test_auto_dia_route_equals_the_csr_handle():
    """AUTO on a banded BSR runs DIA on bsr2crs(A): the same bits as
    SpmvHandle(DIA) on that CSR (chip_smoke.py holds lap1000's to the CSR's
    AUTO handle, which is DIA there, on the card)."""
    Bt = _port(_matrix("lap64_b4", np.float32))
    h = ts.SpmvHandle(Bt)
    hc = ts.SpmvHandle(tkc.bsr2crs(Bt), SpmvAlgorithm.DIA)
    assert h.algorithm == SpmvAlgorithm.DIA
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(Bt.ncols).astype(np.float32))
    assert torch.equal(h(x), hc(x))


def test_transpose_modes_on_bsr():
    """As tpukk: mode T on the BSR route raises (CSR only); on AUTO's DIA
    route the handle holds the CSR expansion, so T works."""
    Bj = _matrix("random_b3", np.float64)
    hb = ts.SpmvHandle(_port(Bj))
    x = torch.zeros(hb.A.nrows, dtype=torch.float64)
    with pytest.raises(Exception, match="CSR only"):
        hb(x, mode="T")
    with pytest.raises(Exception, match="CSR only"):
        js.SpmvHandle(Bj)(np.zeros(Bj.nrows), mode="T")
    Dj = _matrix("lap12_random_blocks_b4", np.float64)
    hd = ts.SpmvHandle(_port(Dj))
    xv = np.random.default_rng(6).standard_normal(Dj.nrows)
    _held(hd(torch.from_numpy(xv), mode="T"), Dj.to_scipy().T.tocsr(), xv, np.float64,
          ref=np.asarray(js.SpmvHandle(Dj)(xv, mode="T")))


def test_complex_bsr_names_a3():
    """Complex BSR SpMV (ROADMAP A3a): the BSR route's segment sum over the
    real and imaginary parts, held to tpukk's product on the same blocks."""
    Bj = _matrix("random_b3", np.float64)
    rng = np.random.default_rng(9)
    sp = Bj.to_scipy()
    spc = sps.bsr_matrix((sp.data * (1 + 0.5j) + 0.25j * rng.standard_normal(sp.data.shape),
                          sp.indices, sp.indptr), shape=sp.shape)
    Bjc = jkc.BsrMatrix.from_scipy_bsr(spc)
    hc = ts.SpmvHandle(_port(Bjc))
    assert hc.algorithm == SpmvAlgorithm.BSR
    x = rng.standard_normal(sp.shape[1]) + 1j * rng.standard_normal(sp.shape[1])
    ref = np.asarray(js.SpmvHandle(Bjc)(jnp.asarray(x)))
    np.testing.assert_allclose(hc(torch.from_numpy(x)).numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref, spc @ x, rtol=1e-12, atol=1e-12)
    # mode C: the BSR route on the conjugated blocks
    np.testing.assert_allclose(hc(torch.from_numpy(x), mode="C").numpy(), spc.conj() @ x,
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# bspgemm (tests/test_spgemm_spadd.py:100)
# ---------------------------------------------------------------------------

def _block_operands(dtype, nb=30, b=4, seed=11):
    rng = np.random.default_rng(seed)
    S = sps.random(nb, nb, density=0.15, random_state=seed, format="csr")
    S.data[:] = 1.0
    dense = (np.kron(S.toarray(), np.ones((b, b)))
             * rng.standard_normal((nb * b, nb * b))).astype(dtype)
    A = jkc.crs2bsr(jkc.CsrMatrix.from_dense(dense), b)
    B = jkc.crs2bsr(jkc.CsrMatrix.from_dense(dense.T.copy()), b)
    return A, B, dense


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_bspgemm_vs_tpukk_and_dense(dtype):
    Aj, Bj, dense = _block_operands(dtype)
    Cj = js.bspgemm(Aj, Bj)
    At, Bt = _port(Aj), _port(Bj)
    h = ts.SpgemmHandle()
    ts.bspgemm_symbolic(h, At, Bt)
    C = ts.bspgemm_numeric(h, At, Bt)
    np.testing.assert_array_equal(C.row_map.numpy(), np.asarray(Cj.row_map))
    np.testing.assert_array_equal(C.entries.numpy(), np.asarray(Cj.entries))
    assert C.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype and C.block_size == 4
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert _rel(C.values.numpy(), np.asarray(Cj.values)) <= tol
    ref = dense.astype(np.float64) @ dense.T.astype(np.float64)
    assert _rel(C.to_scipy().toarray(), ref) <= tol
    # reuse on new values: 2·A gives exactly 2·C, A itself the same bits
    C2 = ts.bspgemm_numeric(h, At.with_values(2 * At.values), Bt)
    assert torch.equal(C2.values, 2 * C.values)
    assert torch.equal(ts.bspgemm_numeric(h, At, Bt).values, C.values)
    assert torch.equal(ts.bspgemm(At, Bt).values, C.values)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_bspgemm_blocks_over_4_vs_tpukk(dtype):
    """Blocks of 6 (the numeric's batched ``bmm`` form; blocks up to 4 take
    the broadcast product) against tpukk and the dense product, with exact
    reuse."""
    Aj, Bj, dense = _block_operands(dtype, nb=12, b=6, seed=5)
    At, Bt = _port(Aj), _port(Bj)
    h = ts.SpgemmHandle()
    ts.bspgemm_symbolic(h, At, Bt)
    C = ts.bspgemm_numeric(h, At, Bt)
    Cj = js.bspgemm(Aj, Bj)
    np.testing.assert_array_equal(C.entries.numpy(), np.asarray(Cj.entries))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert _rel(C.values.numpy(), np.asarray(Cj.values)) <= tol
    assert _rel(C.to_scipy().toarray(), dense.astype(np.float64) @ dense.T) <= tol
    C2 = ts.bspgemm_numeric(h, At.with_values(2 * At.values), Bt)
    assert torch.equal(C2.values, 2 * C.values)


def test_bspgemm_banded_b2_f64():
    """A banded block matrix (fem2d-like blocks of 2) squared, against scipy
    and tpukk."""
    Aj = jkc.crs2bsr(jkc.generate_structured_laplacian(20, 20, dtype=np.float64), 2)
    At = _port(Aj)
    C = ts.bspgemm(At, At)
    Cj = js.bspgemm(Aj, Aj)
    np.testing.assert_array_equal(C.entries.numpy(), np.asarray(Cj.entries))
    assert _rel(C.values.numpy(), np.asarray(Cj.values)) <= 1e-12
    ref = (Aj.to_scipy() @ Aj.to_scipy()).toarray()
    assert _rel(C.to_scipy().toarray(), ref) <= 1e-12


def test_bspgemm_checks():
    Aj, Bj, _ = _block_operands(np.float64)
    At, Bt = _port(Aj), _port(Bj)
    h = ts.SpgemmHandle()
    with pytest.raises(Exception, match="symbolic first"):
        ts.bspgemm_numeric(h, At, Bt)
    other = _port(jkc.generate_random_bsr(60, 60, 2, 3, dtype=np.float64))
    with pytest.raises(Exception, match="block sizes"):
        ts.bspgemm_symbolic(h, At, other)
    ts.bspgemm_symbolic(h, At, Bt)
    dense = Aj.to_scipy().toarray()
    dense[-4:] = 0.0  # the last block row's blocks dropped
    fewer = tkc.BsrMatrix.from_scipy_bsr(sps.bsr_matrix(dense, blocksize=(4, 4)), device=CPU)
    with pytest.raises(Exception, match="differ from the symbolic"):
        ts.bspgemm_numeric(h, fewer, Bt)
    with pytest.raises(Exception, match="BsrMatrix"):
        ts.bspgemm(tkc.bsr2crs(At), Bt)


# ---------------------------------------------------------------------------
# bspadd (tests/test_spgemm_spadd.py:361)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("coefs", [(2.0, -1.0), (2.0, -0.5), (1.0, 0.0)])
def test_bspadd_block_matrices(dtype, coefs):
    a, b = coefs
    Aj = jkc.generate_random_bsr(8, 8, 4, 3, dtype=dtype, seed=1)
    Bj = jkc.generate_random_bsr(8, 8, 4, 3, dtype=dtype, seed=2)
    Cj = js.bspadd(a, Aj, b, Bj)
    C = ts.bspadd(a, tkc.generate_random_bsr(8, 8, 4, 3, dtype=dtype, seed=1, device=CPU), b,
                  tkc.generate_random_bsr(8, 8, 4, 3, dtype=dtype, seed=2, device=CPU))
    assert C.block_size == 4 and C.values.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_array_equal(C.row_map.numpy(), np.asarray(Cj.row_map))
    np.testing.assert_array_equal(C.entries.numpy(), np.asarray(Cj.entries))
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert _rel(C.values.numpy(), np.asarray(Cj.values)) <= tol
    ref = (a * Aj.to_scipy() + b * Bj.to_scipy()).toarray()
    assert _rel(C.to_scipy().toarray(), ref) <= tol


def test_bspadd_checks():
    A = tkc.generate_random_bsr(8, 8, 4, 3, device=CPU)
    with pytest.raises(Exception, match="shape/block"):
        ts.bspadd(1.0, A, 1.0, tkc.generate_random_bsr(16, 16, 2, 3, device=CPU))
    with pytest.raises(Exception, match="BsrMatrix"):
        ts.bspadd(1.0, A, 1.0, tkc.bsr2crs(A))


# ---------------------------------------------------------------------------
# block Gauss-Seidel (tests/test_gauss_seidel.py:182)
# ---------------------------------------------------------------------------

def _gs_pair(Ab, omega=1.0):
    Aj = jkc.BsrMatrix.from_scipy_bsr(sps.bsr_matrix(Ab, blocksize=(3, 3)))
    At = _port(Aj)
    hj, ht = js.GsHandle(), ts.GsHandle()
    js.gauss_seidel_symbolic(hj, Aj)
    js.gauss_seidel_numeric(hj, Aj, omega=omega)
    ts.gauss_seidel_symbolic(ht, At)
    ts.gauss_seidel_numeric(ht, At, omega=omega)
    np.testing.assert_array_equal(ht.colors, np.asarray(hj.colors))
    return Aj, At, hj, ht


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_block_gauss_seidel_bsr(rng, dtype):
    """The error falls on every symmetric sweep, to under 5 % in five, and
    each sweep's iterate is tpukk's."""
    Ab = _elasticity(10, dtype)
    xstar = rng.standard_normal(Ab.shape[0])
    b = (Ab.astype(np.float64) @ xstar).astype(dtype)
    Aj, At, hj, ht = _gs_pair(Ab)
    assert ht._blk["h"].algorithm == SpmvAlgorithm.DIA
    tol = 1e-5 if dtype == np.float32 else 1e-12
    x = xj = None
    errs = []
    for _ in range(5):
        x = ts.gauss_seidel_apply(ht, At, x, torch.from_numpy(b), num_sweeps=1,
                                  direction="symmetric")
        xj = js.gauss_seidel_apply(hj, Aj, xj, jnp.asarray(b), num_sweeps=1,
                                   direction="symmetric")
        assert x.dtype == torch.from_numpy(b).dtype
        assert _rel(x.numpy(), np.asarray(xj)) <= tol
        errs.append(float(np.linalg.norm(x.numpy() - xstar)))
    assert all(errs[i + 1] < errs[i] for i in range(len(errs) - 1)), errs
    assert errs[-1] < 0.05 * errs[0]


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_block_gs_directions_and_omega(direction, omega):
    Ab = _elasticity(8)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(Ab.shape[0])
    x0 = rng.standard_normal(Ab.shape[0])
    Aj, At, hj, ht = _gs_pair(Ab, omega)
    x0t = torch.from_numpy(x0.copy())
    x = ts.gauss_seidel_apply(ht, At, x0t, torch.from_numpy(b), num_sweeps=2,
                              direction=direction)
    xj = js.gauss_seidel_apply(hj, Aj, jnp.asarray(x0), jnp.asarray(b), num_sweeps=2,
                               direction=direction)
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-12
    np.testing.assert_array_equal(x0t.numpy(), x0)  # the given x is not modified


def test_block_gs_on_the_bsr_route_and_multivector():
    """An unstructured block graph (the BSR route), and a rank-2 b swept
    column by column as tpukk's vmap does."""
    rng = np.random.default_rng(10)
    R = jkc.generate_random_bsr(40, 40, 3, 4, dtype=np.float64, seed=3).to_scipy().tocsr()
    Ab = (R + R.T + sps.identity(R.shape[0]) * (abs(R).sum(1).max() * 2 + 1)).tocsr()
    Aj, At, hj, ht = _gs_pair(Ab)
    assert ht._blk["h"].algorithm == SpmvAlgorithm.BSR
    B = rng.standard_normal((Ab.shape[0], 3))
    X = ts.gauss_seidel_apply(ht, At, None, torch.from_numpy(B), num_sweeps=2)
    Xj = js.gauss_seidel_apply(hj, Aj, None, jnp.asarray(B), num_sweeps=2)
    assert _rel(X.numpy(), np.asarray(Xj)) <= 1e-12
    x1 = ts.gauss_seidel_apply(ht, At, None, torch.from_numpy(B[:, 1].copy()), num_sweeps=2)
    assert _rel(X[:, 1].numpy(), x1.numpy()) <= 1e-14


def test_block_gs_needs_every_diagonal_block():
    """tpukk's check and message: a block row without its diagonal block."""
    S = sps.csr_matrix(np.array([[0, 1.0], [1.0, 1.0]]))
    Ab = sps.kron(S, np.eye(3) + 0.1).tocsr()
    Aj = jkc.BsrMatrix.from_scipy_bsr(sps.bsr_matrix(Ab, blocksize=(3, 3)))
    hj = js.GsHandle()
    js.gauss_seidel_symbolic(hj, Aj)
    with pytest.raises(Exception, match="every block row needs a diagonal block"):
        js.gauss_seidel_numeric(hj, Aj)
    At = _port(Aj)
    ht = ts.GsHandle()
    ts.gauss_seidel_symbolic(ht, At)
    with pytest.raises(Exception, match="every block row needs a diagonal block"):
        ts.gauss_seidel_numeric(ht, At)
