"""tpukk_torch's supernodal triangular solve and factor imports against tpukk
on the CPU.

Kernel paths: the SUPERNODAL route (the expanded DAG on K4's plain version,
b and x folded through its src/dst, f32 and f64) against ``tpukk``'s fused
supernodal plan, whose Pallas kernel runs in interpret mode as
tests/test_solvers.py runs it, against ``tpukk``'s batched
``supernodal_solve`` and against scipy; the batched plan (``fused=False``)
against ``tpukk``'s.  Host
symbolic: the supernode partitions, the split of an imported partition and
the quotient levels equal ``tpukk``'s.  Slice: ``SptrsvHandle(SUPERNODAL)``,
``superlu_import`` and ``cholmod_import`` (raw arrays and a ``factor=``
stand-in), both algorithms.

Tolerances: f64 solves 1e-10 relative to max|x| (the same blocks, solved by
other batched routines); f32 solves 5e-5 of max|x|, the tolerance
tests/test_solvers.py holds the fused Pallas plan to (both reduce the solve
through D⁻¹ taken in f64 and rounded to f32); imported factors used as
solvers 1e-8 (f64) as in tests/test_solvers.py; partitions, levels and
counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import tpukk.containers as jkc
import tpukk.sparse as jsp
import tpukk.sparse.sptrsv_supernodal as jsn
import tpukk_torch.containers as tkc
from tpukk.sparse.sptrsv_cholmod import cholmod_import as j_cholmod_import
from tpukk_torch.common import TpuKKError
from tpukk_torch.sparse import (GmresHandle, SptrsvAlgorithm, SptrsvHandle, cholmod_import,
                                cholmod_raw_to_csr, gmres, sptrsv_solve, sptrsv_symbolic,
                                superlu_import)
from tpukk_torch.common.permute import permute_plain
from tpukk_torch.sparse import sptrsv_cuda as ks
from tpukk_torch.sparse import sptrsv_supernodal as tsn
from tpukk_torch.sparse.sptrsv import _permuted_solve

CPU = "cpu"
SN = SptrsvAlgorithm.SUPERNODAL


def _factor(case, lower, dtype=np.float64):
    """tri of the SuperLU factors of a test matrix, sorted CSR."""
    A = {"lap14": lambda: jkc.generate_structured_laplacian(14, 14, dtype=np.float64),
         "lap12": lambda: jkc.generate_structured_laplacian(12, 12, dtype=np.float64),
         "diagdom200": lambda: jkc.generate_diag_dominant_csr(200, 5, dtype=np.float64,
                                                              seed=3)}[case]()
    lu = spla.splu(A.to_scipy().tocsc())
    T = (lu.L if lower else lu.U).tocsr().astype(dtype)
    T.sort_indices()
    return T


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _triplets(T, lower):
    n = T.shape[0]
    return tsn._lower_triplets(T.indptr, T.indices, T.data, n, lower)


# ---------------------------------------------------------------------------
# host symbolic: partitions and levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_size", [4, 32, 64])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", ["lap14", "diagdom200"])
def test_partitions_and_levels_equal_tpukk(case, lower, max_size):
    T = _factor(case, lower)
    n = T.shape[0]
    rows, cols, _ = _triplets(T, lower)
    strict = cols < rows
    sn = tsn._detect_supernodes(rows[strict], cols[strict], n, max_size)
    np.testing.assert_array_equal(sn, jsn._detect_supernodes(rows[strict], cols[strict], n,
                                                             max_size))
    nsn = int(sn[-1]) + 1
    np.testing.assert_array_equal(tsn._quotient_levels(sn[rows], sn[cols], nsn),
                                  jsn._quotient_levels(sn[rows], sn[cols], nsn))
    part = np.repeat(np.arange(n // 7 + 1), 7)[:n]
    np.testing.assert_array_equal(tsn._split_partition(part, max_size),
                                  jsn._split_partition(part, max_size))
    pj = jsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower,
                                   max_size=max_size, fused=False)
    pt = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower,
                                   max_size=max_size, device=CPU, fused=False)
    assert isinstance(pt, tsn.SupernodalPlan)
    assert (pt.num_supernodes, pt.num_levels_sn, pt.max_block) == \
        (pj.num_supernodes, len(pj.levels), pj.max_block)


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", ["lap14", "diagdom200"])
def test_fused_plan_counts_equal_tpukk(case, lower):
    """The port's expanded DAG has exactly 2n rows and one level more than
    the supernode levels; its partition and supernode levels are tpukk's."""
    T = _factor(case, lower, np.float32)
    n = T.shape[0]
    fj = jsn.build_supernodal_fused_plan(T.indptr, T.indices, T.data, n, lower=lower)
    ft = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, device=CPU)
    assert isinstance(ft, tsn.FusedSupernodalPlan) and ft.dtype == torch.float32
    assert (ft.num_supernodes, ft.num_levels_sn, ft.max_block) == \
        (fj.num_supernodes, fj.num_levels_sn, fj.max_block)
    assert ft.num_rows_dag == 2 * n and ft.plan.n == 2 * n
    assert ft.num_levels == ft.num_levels_sn + 1
    # every dependency of a DAG row lies earlier in K4's level order
    assert (ft.plan.cols.numpy() < ft.plan.rows().numpy()).all()


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", ["lap14", "diagdom200"])
def test_batched_f64_solve_matches_tpukk(case, lower, rng):
    T = _factor(case, lower)
    n = T.shape[0]
    b = rng.standard_normal(n)
    pj = jsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, fused=False)
    ref = np.asarray(jsn.supernodal_solve(pj, jnp.asarray(b)))
    pt = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, device=CPU,
                                   fused=False)
    assert isinstance(pt, tsn.SupernodalPlan)
    x = tsn.supernodal_solve(pt, torch.from_numpy(b))
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), ref) <= 1e-10
    assert _rel(x.numpy(), spla.spsolve_triangular(T, b, lower=lower)) <= 1e-10


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", ["lap14", "diagdom200"])
def test_fused_dag_in_f64_matches_tpukk_batched(case, lower, rng):
    """The expanded DAG built from f64 values stays in f64 and meets the
    batched route's tolerance against tpukk's batched solve."""
    T = _factor(case, lower)
    n = T.shape[0]
    b = rng.standard_normal(n)
    pj = jsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, fused=False)
    ref = np.asarray(jsn.supernodal_solve(pj, jnp.asarray(b)))
    ft = tsn.build_supernodal_fused_plan(T.indptr, T.indices, T.data, n, lower, 64, device=CPU)
    assert ft.dtype == torch.float64 and ft.plan.vals.dtype == torch.float64
    x = tsn.supernodal_solve(ft, torch.from_numpy(b))
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), ref) <= 1e-10
    assert _rel(x.numpy(), spla.spsolve_triangular(T, b, lower=lower)) <= 1e-10


@pytest.mark.parametrize("fused", ["auto", True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_fused_option_routes_and_matches_tpukk_batched(lower, dtype, fused, rng):
    """fused="auto" and True build the DAG in the values' dtype, False the
    batched plan; every route is held to tpukk's batched solve (1e-10 in
    f64, 5e-5 of max|x| in f32)."""
    T = _factor("diagdom200", lower, dtype)
    n = T.shape[0]
    b = rng.standard_normal(n).astype(dtype)
    pj = jsn.build_supernodal_plan(T.indptr, T.indices, T.data.astype(np.float64), n,
                                   lower=lower, fused=False)
    ref = np.asarray(jsn.supernodal_solve(pj, jnp.asarray(b.astype(np.float64))))
    pt = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, device=CPU,
                                   fused=fused)
    kind = tsn.SupernodalPlan if fused is False else tsn.FusedSupernodalPlan
    assert isinstance(pt, kind) and pt.dtype == torch.from_numpy(b).dtype
    x = tsn.supernodal_solve(pt, torch.from_numpy(b))
    assert x.dtype == torch.from_numpy(b).dtype
    tol = 1e-10 if dtype == np.float64 else 5e-5
    assert _rel(x.numpy(), ref) <= tol


def test_fused_option_rejects_other_values():
    T = _factor("lap12", True)
    with pytest.raises(TpuKKError, match="fused"):
        tsn.build_supernodal_plan(T.indptr, T.indices, T.data, T.shape[0], device=CPU,
                                  fused="yes")


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_dag_folded_call_equals_three_launches(lower, dtype, rng):
    """The DAG's one folded call equals K5 feeding b through a zero slot, K4
    and K5 reading the x-rows, exactly (the plain versions); the x-rows read
    src -1 (0), the z-rows write nothing."""
    T = _factor("lap14", lower, dtype)
    n = T.shape[0]
    fp = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, device=CPU)
    src, dst = fp.src.long(), fp.dst.long()
    assert int((src < 0).sum()) == n and int((dst < 0).sum()) == n
    assert torch.equal(torch.sort(dst[dst >= 0]).values, torch.arange(n))
    b = torch.from_numpy(rng.standard_normal(n).astype(dtype))
    src_in = torch.where(src >= 0, src, n).to(torch.int32)       # zero slot at n
    src_out = torch.empty(n, dtype=torch.int32)
    src_out[dst[dst >= 0]] = torch.nonzero(dst >= 0).flatten().to(torch.int32)
    xdag = ks.sptrsv_plain(fp.plan, permute_plain(src_in, torch.nn.functional.pad(b, (0, 1))))
    ref = permute_plain(src_out, xdag)
    assert torch.equal(ks.sptrsv_plain(fp.plan, b, src=fp.src, dst=fp.dst), ref)
    ks.reset_launch_counts()
    assert torch.equal(tsn.supernodal_solve(fp, b), ref)
    assert ks.launch_counts() == {"sptrsv_levels": 0, "permute_gather": 0}


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_fused_f32_solve_matches_tpukk_interpret(lower):
    rng = np.random.default_rng(77)
    T = _factor("lap14", lower, np.float32)
    n = T.shape[0]
    fj = jsn.build_supernodal_fused_plan(T.indptr, T.indices, T.data, n, lower=lower)
    assert fj is not None
    b = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jsn.supernodal_solve(fj, jnp.asarray(b), interpret=True))
    ft = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=lower, device=CPU)
    ks.reset_launch_counts()
    x = tsn.supernodal_solve(ft, torch.from_numpy(b))
    assert x.dtype == torch.float32 and ks.launch_counts() == {"sptrsv_levels": 0,
                                                              "permute_gather": 0}
    xs = spla.spsolve_triangular(T.astype(np.float64), b.astype(np.float64), lower=lower)
    assert np.abs(x.numpy() - ref).max() <= 5e-5 * np.abs(xs).max()
    assert np.abs(x.numpy() - xs).max() <= 5e-5 * np.abs(xs).max()


def test_fused_imported_partition_matches_tpukk_interpret():
    rng = np.random.default_rng(77)
    T = _factor("lap12", True, np.float32)
    n = T.shape[0]
    part = np.arange(n) // 4
    fj = jsn.build_supernodal_fused_plan(T.indptr, T.indices, T.data, n, lower=True,
                                         sn_of_col=part)
    ft = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=True, sn_of_col=part,
                                   device=CPU)
    assert ft.num_supernodes == fj.num_supernodes == n // 4
    b = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jsn.supernodal_solve(fj, jnp.asarray(b), interpret=True))
    x = tsn.supernodal_solve(ft, torch.from_numpy(b)).numpy()
    xs = spla.spsolve_triangular(T.astype(np.float64), b.astype(np.float64), lower=True)
    assert np.abs(x - ref).max() <= 5e-5 * np.abs(xs).max()
    assert np.abs(x - xs).max() <= 5e-5 * np.abs(xs).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_supernodal_handle_matches_tpukk(lower, dtype, rng):
    """SptrsvHandle(SUPERNODAL) → sptrsv_symbolic → sptrsv_solve in both
    packages (tpukk's CPU route is its batched plan in either dtype, the
    port's the expanded DAG in both, its supernodes capped at 32 as
    tpukk's fused builder caps them)."""
    T = _factor("diagdom200", lower, dtype)
    Tj = jkc.CsrMatrix.from_scipy(T)
    hj = jsp.SptrsvHandle(lower=lower, algorithm=jsp.SptrsvAlgorithm.SUPERNODAL)
    jsp.sptrsv_symbolic(hj, Tj)
    b = rng.standard_normal(T.shape[0]).astype(dtype)
    ref = np.asarray(jsp.sptrsv_solve(hj, Tj, jnp.asarray(b)))
    Tt = tkc.CsrMatrix.from_scipy(T, device=CPU)
    ht = SptrsvHandle(lower=lower, algorithm=SN, supernode_max_size=64)
    sptrsv_symbolic(ht, Tt)
    x = sptrsv_solve(ht, Tt, torch.from_numpy(b))
    assert x.dtype == torch.from_numpy(b).dtype
    assert isinstance(ht.sn_plan, tsn.FusedSupernodalPlan)
    pj = jsn.build_supernodal_plan(T.indptr, T.indices, T.data, T.shape[0], lower=lower,
                                   max_size=32, fused=False)
    assert ht.num_levels == len(pj.levels)
    if dtype == np.float64:
        assert _rel(x.numpy(), ref) <= 1e-10
    else:
        assert np.abs(x.numpy() - ref).max() <= 5e-5 * np.abs(ref).max()


def test_supernodal_refuses_missing_or_zero_diagonal():
    T = sps.csr_matrix(np.array([[1.0, 0, 0], [1.0, 0.0, 0], [0, 2.0, 3.0]]))
    T.eliminate_zeros()
    for dt in (np.float32, np.float64):
        with pytest.raises(TpuKKError, match="diagonal"):
            sptrsv_symbolic(SptrsvHandle(algorithm=SN),
                            tkc.CsrMatrix.from_scipy(T.astype(dt), device=CPU))
    Z = sps.csr_matrix((np.array([1.0, 0.0, 1.0]), np.array([0, 1, 2]), np.arange(4)))
    assert tsn.build_supernodal_fused_plan(Z.indptr, Z.indices, Z.data, 3, device=CPU) is None
    with pytest.raises(TpuKKError, match="zero diagonal"):
        tsn.build_supernodal_plan(Z.indptr, Z.indices, Z.data, 3, device=CPU)


# ---------------------------------------------------------------------------
# imported factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
def test_superlu_import_matches_tpukk(algorithm, rng):
    A = jkc.generate_diag_dominant_csr(100, 5, dtype=np.float64, seed=23)
    lu = spla.splu(A.to_scipy().tocsc())
    b = rng.standard_normal(A.nrows)
    ref = np.asarray(jsp.superlu_import(lu, jsp.SptrsvAlgorithm[algorithm])(jnp.asarray(b)))
    solver = superlu_import(lu, SptrsvAlgorithm[algorithm], device=CPU)
    x = solver(torch.from_numpy(b)).numpy()
    assert _rel(x, ref) <= 1e-10
    np.testing.assert_allclose(x, np.linalg.solve(A.to_scipy().toarray(), b), rtol=1e-8,
                               atol=1e-8)
    # an exact factorization: GMRES converges in its first cycle of 2 steps
    At = tkc.CsrMatrix.from_scipy(A.to_scipy(), device=CPU)
    _, st = gmres(GmresHandle(m=2, tol=1e-10, max_restarts=5), At, torch.from_numpy(b),
                  prec=solver)
    assert st.converged and st.num_iters <= 2 and st.end_rel_res < 1e-10


def _raw_from_dense_chol(Ls, partition):
    """CHOLMOD supernodal raw arrays of a lower-triangular matrix for a given
    partition (tests/test_solvers.py's packing)."""
    Ld = np.asarray(Ls.todense())
    super_, pi, px, s, x = [0], [0], [0], [], []
    for sz in partition:
        c0 = super_[-1]
        c1 = c0 + sz
        pat = set(range(c0, c1))
        for c in range(c0, c1):
            nz = np.nonzero(Ld[:, c])[0]
            pat |= set(nz[nz >= c])
        ridx = np.array(sorted(pat), np.int64)
        s.extend(ridx.tolist())
        x.extend(Ld[ridx][:, c0:c1].T.ravel().tolist())
        super_.append(c1)
        pi.append(len(s))
        px.append(len(x))
    return tuple(np.array(a) for a in (super_, pi, px, s, x))


def _chol_case(n_perm=None):
    rng = np.random.default_rng(5)
    if n_perm is None:
        A = jkc.generate_structured_laplacian(6, 8, dtype=np.float64).to_scipy()
        A = (A + 0.5 * sps.identity(48)).toarray()
        perm = np.arange(48)
        sizes, left = [1, 1, 1, 5], 40
        while left > 0:
            sizes.append(min(4, left))
            left -= min(4, left)
    else:
        M = rng.standard_normal((n_perm, n_perm))
        A = M @ M.T + n_perm * np.eye(n_perm)
        perm = rng.permutation(n_perm)
        sizes = [n_perm]
    Ls = sps.csr_matrix(np.linalg.cholesky(A[perm][:, perm]))
    return A, perm, Ls, sizes


@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
@pytest.mark.parametrize("n_perm", [None, 30], ids=["partitioned", "permuted"])
def test_cholmod_raw_import_matches_tpukk(algorithm, n_perm, rng):
    A, perm, Ls, sizes = _chol_case(n_perm)
    n = A.shape[0]
    super_, pi, px, s, x = _raw_from_dense_chol(Ls, sizes)
    kw = dict(n=n, super_=super_, pi=pi, px=px, s=s, x=x, perm=perm)
    b = rng.standard_normal(n)
    ref = np.asarray(j_cholmod_import(algorithm=jsp.SptrsvAlgorithm[algorithm], **kw)(
        jnp.asarray(b)))
    solver = cholmod_import(algorithm=SptrsvAlgorithm[algorithm], device=CPU, **kw)
    got = solver(torch.from_numpy(b)).numpy()
    assert _rel(got, ref) <= 1e-10
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=1e-8, atol=1e-8)
    L, part = cholmod_raw_to_csr(n, super_, pi, px, s, x)
    assert abs(L - Ls).max() == 0 and int(part[-1]) + 1 == len(sizes)
    if algorithm == "SUPERNODAL":
        # the imported partition (split at 64) shapes the blocks of both solves
        np.testing.assert_array_equal(solver.Lh.sn_partition, part)
        assert solver.Lh.sn_plan.num_supernodes == solver.Lth.sn_plan.num_supernodes == \
            len(sizes)


class _FactorStandIn:
    """The two methods of scikit-sparse's cholmod.Factor that the import uses."""

    def __init__(self, L, perm):
        self._L, self._perm = L, perm

    def L(self):
        return self._L.tocsc()

    def P(self):
        return self._perm


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
def test_cholmod_factor_import(algorithm, dtype, rng):
    A, perm, Ls, _ = _chol_case(30)
    b = rng.standard_normal(A.shape[0])
    solver = cholmod_import(_FactorStandIn(Ls, perm), algorithm=SptrsvAlgorithm[algorithm],
                            value_dtype=dtype, device=CPU)
    assert solver.L.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    ref = np.linalg.solve(A, b)
    tol = 1e-8 if dtype == np.float64 else 1e-4
    got = solver.apply(torch.from_numpy(b.astype(dtype))).double().numpy()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    with pytest.raises(ValueError, match="raw arrays"):
        cholmod_import(n=3)


def _unfolded(solver, b):
    """The apply as gather, solve, solve, gather (the K5, K4, K4, K5 of the
    port before the fold), from the solver's own handles and permutations."""
    if hasattr(solver, "Uh"):
        first, second, before, after = ((solver.Lh, solver.L), (solver.Uh, solver.U),
                                        solver.inv_perm_r, solver.perm_c)
    else:
        first, second, before, after = ((solver.Lh, solver.L), (solver.Lth, solver.Lt),
                                        solver.perm, solver.inv_perm)
    y = sptrsv_solve(*first, permute_plain(before, b))
    return permute_plain(after, sptrsv_solve(*second, y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
@pytest.mark.parametrize("importer", ["superlu", "cholmod"])
def test_folded_import_equals_gathers_and_tpukk(importer, algorithm, dtype, rng):
    """An imported factor's apply, its outer permutations folded into the
    solves' src and dst, equals gather, solve, solve, gather bit for bit,
    and tpukk's import within the file's tolerances."""
    if importer == "superlu":
        A = jkc.generate_diag_dominant_csr(100, 5, dtype=np.float64, seed=23)
        lu = spla.splu(A.to_scipy().tocsc())
        solver = superlu_import(lu, SptrsvAlgorithm[algorithm], value_dtype=dtype, device=CPU)
        ref_solver = jsp.superlu_import(lu, jsp.SptrsvAlgorithm[algorithm])
        n = A.nrows
    else:
        A, perm, Ls, sizes = _chol_case(30)
        kw = dict(zip(("super_", "pi", "px", "s", "x"), _raw_from_dense_chol(Ls, sizes)),
                  n=30, perm=perm)
        solver = cholmod_import(algorithm=SptrsvAlgorithm[algorithm], value_dtype=dtype,
                                device=CPU, **kw)
        ref_solver = j_cholmod_import(algorithm=jsp.SptrsvAlgorithm[algorithm], **kw)
        n = 30
    b = rng.standard_normal(n)
    bt = torch.from_numpy(b.astype(dtype))
    got = solver(bt)
    assert got.dtype == bt.dtype and torch.equal(got, _unfolded(solver, bt))
    ref = np.asarray(ref_solver(jnp.asarray(b)))
    if dtype == np.float64:
        assert _rel(got.numpy(), ref) <= 1e-10
    else:
        assert np.abs(got.double().numpy() - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.parametrize("extra", [-1, 1], ids=["short", "long"])
@pytest.mark.parametrize("algorithm", ["SEQLVLSCHD", "SUPERNODAL"])
@pytest.mark.parametrize("importer", ["superlu", "cholmod"])
def test_folded_import_refuses_a_b_of_another_length(importer, algorithm, extra):
    """The folded apply checks b's length, as sptrsv_solve does: K4 reads b
    through src and writes n values through dst, so a short b would be read
    past its end and a long one would leave its tail unsolved."""
    if importer == "superlu":
        A = jkc.generate_diag_dominant_csr(40, 5, dtype=np.float64, seed=23)
        solver = superlu_import(spla.splu(A.to_scipy().tocsc()), SptrsvAlgorithm[algorithm],
                                device=CPU)
        n = A.nrows
    else:
        _, perm, Ls, sizes = _chol_case(30)
        kw = dict(zip(("super_", "pi", "px", "s", "x"), _raw_from_dense_chol(Ls, sizes)),
                  n=30, perm=perm)
        solver = cholmod_import(algorithm=SptrsvAlgorithm[algorithm], device=CPU, **kw)
        n = 30
    with pytest.raises(TpuKKError, match="rows"):
        solver(torch.ones(n + extra, dtype=torch.float64))
    with pytest.raises(TpuKKError, match="rank-1"):
        solver(torch.ones((n, 1), dtype=torch.float64))


def test_permuted_solve_on_the_batched_plan_keeps_its_gathers(rng):
    """The batched supernodal plan (fused=False), which K4 does not run,
    gathers b before its solve and x after it, and checks b's length."""
    T = _factor("lap12", True)
    n = T.shape[0]
    Tt = tkc.CsrMatrix.from_scipy(T, device=CPU)
    h = SptrsvHandle(lower=True, algorithm=SN)
    sptrsv_symbolic(h, Tt)
    h.sn_plan = tsn.build_supernodal_plan(T.indptr, T.indices, T.data, n, lower=True,
                                          device=CPU, fused=False)
    before = torch.from_numpy(rng.permutation(n).astype(np.int32))
    after = torch.from_numpy(rng.permutation(n).astype(np.int32))
    b = torch.from_numpy(rng.standard_normal(n))
    got = _permuted_solve(h, before, after)(b)
    ref = permute_plain(after, tsn.supernodal_solve(h.sn_plan, permute_plain(before, b)))
    assert torch.equal(got, ref)
    with pytest.raises(TpuKKError, match=f"{n} rows"):
        _permuted_solve(h, before, after)(torch.ones(n + 1, dtype=torch.float64))
