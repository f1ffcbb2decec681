"""tpukk_torch's triangular solve, ILU(k) factorization and orderings against
tpukk on the CPU.

Kernel modules: K4's plain version (``sptrsv_solve`` on a CPU tensor) against
``tpukk``'s level-set solve in f64 and against its fused Pallas kernel in
interpret mode in f32, as tests/test_solvers.py runs it, with the level
permutations folded in (``src``/``dst``) exactly equal to K5, K4, K5; K5's
plain version against ``tpukk``'s routed Pallas permutation in interpret
mode.  Host
planners: the C++ of ``csrc/host.cpp`` against the pure-Python plain versions
of both packages and against ``tpukk``'s native library.  Slice: ``trsv`` in
every mode, ``SpilukHandle`` → ``spiluk_symbolic`` → ``spiluk_numeric``.

Tolerances: f64 solves 1e-12 relative to max|x| (the same products summed in
another order, on well-conditioned triangles); f32 1e-5 relative, the
tolerance tests/test_solvers.py holds the Pallas kernel to; ILU factors
1e-12 (both packages factor in f64 with the same IKJ order); permutations,
patterns and levels exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import tpukk.containers as jkc
import tpukk.graph as jgr
import tpukk.sparse as jsp
import tpukk_torch.containers as tkc
from tpukk import native as jnative
from tpukk.common import utils as jutils
from tpukk.common.permute import build_permute_plan as j_permute_plan
from tpukk.common.permute import static_permute as j_static_permute
from tpukk.sparse import sptrsv as jst
from tpukk.sparse.spiluk import _iluk_pattern as j_iluk_pattern
from tpukk.sparse.sptrsv_pallas import build_fused_sptrsv_plan, fused_sptrsv_solve
from tpukk_torch import graph as tgr
from tpukk_torch import native as tnative
from tpukk_torch.common import TpuKKError, tracing
from tpukk_torch.common.utils import permute, permute_via_sort
from tpukk_torch.common.permute import build_permute_plan, permute_plain, static_permute
from tpukk_torch.interop import csr_from_numpy, level_plan_from_numpy
from tpukk_torch.sparse import (SpilukHandle, SptrsvAlgorithm, SptrsvHandle, spiluk_numeric,
                                spiluk_symbolic, sptrsv_solve, sptrsv_symbolic, trsv)
from tpukk_torch.sparse import spiluk as tspiluk
from tpukk_torch.sparse import sptrsv as tst
from tpukk_torch.sparse import sptrsv_cuda as ks


def _launches(kernel) -> int:
    """The registry's launch counter of a kernel function."""
    return tracing.launch_counts([kernel])[kernel.__name__]


CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _tri(A, lower, dtype=np.float64):
    """tri(A) with a strengthened diagonal (tests/test_solvers.py:_tri)."""
    sp = A.to_scipy()
    T = (sps.tril(sp) if lower else sps.triu(sp)).tocsr()
    T.setdiag(np.abs(T.diagonal()) + 2.0)
    T.sort_indices()
    return jkc.CsrMatrix.from_scipy(T.astype(dtype))


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-300)


TRI_CASES = {
    "diagdom80": lambda: jkc.generate_diag_dominant_csr(80, 4, dtype=np.float64, seed=2),
    "lap12": lambda: jkc.generate_structured_laplacian(12, 12, dtype=np.float64),
}


# ---------------------------------------------------------------------------
# K4: the level-scheduled solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", sorted(TRI_CASES))
def test_sptrsv_matches_tpukk_levelset_f64(case, lower, rng):
    Tj = _tri(TRI_CASES[case](), lower)
    hj = jsp.SptrsvHandle(lower=lower)
    jsp.sptrsv_symbolic(hj, Tj)
    b = rng.standard_normal(Tj.nrows)
    ref = np.asarray(jsp.sptrsv_solve(hj, Tj, jnp.asarray(b)))
    Tt = _port(Tj)
    ht = SptrsvHandle(lower=lower)
    sptrsv_symbolic(ht, Tt)
    x = sptrsv_solve(ht, Tt, torch.from_numpy(b))
    assert x.dtype == torch.float64 and _launches(ks.sptrsv_levels) == 0
    assert ht.num_levels == hj.num_levels
    np.testing.assert_array_equal(ht.order, hj.order)
    assert _rel(x.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_sptrsv_matches_fused_pallas_interpret_f32(lower, rng):
    A = jkc.generate_structured_laplacian(9, 9, dtype=np.float32)
    Tj = _tri(A, lower, np.float32)
    rm, ent = Tj.host_row_map(), Tj.host_entries()
    vals = np.asarray(Tj.values)
    levels = jst._compute_levels(rm, ent, Tj.nrows, lower)
    plan = build_fused_sptrsv_plan(rm, ent, vals, Tj.nrows, levels, lower)
    assert plan is not None
    b = rng.standard_normal(Tj.nrows).astype(np.float32)
    ref = np.asarray(fused_sptrsv_solve(plan, jnp.asarray(b), interpret=True))
    Tt = _port(Tj)
    ht = SptrsvHandle(lower=lower)
    sptrsv_symbolic(ht, Tt)
    x = sptrsv_solve(ht, Tt, torch.from_numpy(b))
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), ref) <= 1e-5
    xs = spla.spsolve_triangular(Tj.to_scipy().astype(np.float64).tocsr(), b.astype(np.float64),
                                 lower=lower)
    assert _rel(x.numpy(), xs) <= 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("case", sorted(TRI_CASES))
def test_folded_plain_equals_permute_solve_permute(case, lower, dtype, rng):
    """K4's plain version with the level order folded in (src = dst = order)
    is exactly K5's plain version, K4's, and K5's again; through the
    wrapper on a CPU tensor too, and sptrsv_solve is that one call."""
    Tt = _port(_tri(TRI_CASES[case](), lower, dtype))
    h = SptrsvHandle(lower=lower)
    sptrsv_symbolic(h, Tt)
    plan = h.plan
    b = torch.from_numpy(rng.standard_normal(Tt.nrows).astype(dtype))
    inv_order = torch.argsort(plan.order).to(torch.int32)
    ref = permute_plain(inv_order, ks.sptrsv_plain(plan, permute_plain(plan.order, b)))
    assert torch.equal(ks.sptrsv_plain(plan, b, src=plan.order, dst=plan.order), ref)
    assert torch.equal(ks.sptrsv_levels(plan, b, src=plan.order, dst=plan.order), ref)
    assert torch.equal(sptrsv_solve(h, Tt, b), ref)
    # src alone: x in level order; dst alone: b in level order
    assert torch.equal(ks.sptrsv_levels(plan, b, src=plan.order),
                       ks.sptrsv_plain(plan, permute_plain(plan.order, b)))
    bl = permute_plain(plan.order, b)
    assert torch.equal(ks.sptrsv_levels(plan, bl, dst=plan.order), ref)
    assert _launches(ks.sptrsv_levels) == 0
    with pytest.raises(TpuKKError, match="int32"):
        ks.sptrsv_levels(plan, b, src=plan.order.long())
    with pytest.raises(TpuKKError, match="rows"):
        ks.sptrsv_levels(plan, b[:-1])


def test_level_plan_lanes_follow_level_width():
    """K4 gives a row 32 lanes, and packs two rows a warp on plans whose
    levels average 1,000 rows or more."""
    for n, width, lanes in ((50, 1, 32), (5000, 999, 32), (5000, 1000, 16), (8000, 4000, 16)):
        levels = np.arange(n) // width + 1
        rm = np.arange(n + 1)
        plan = ks.build_level_plan(rm, np.arange(n), np.ones(n), n, levels, True, CPU)
        assert plan.lanes == lanes and plan.astype(torch.float32).lanes == lanes


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_folded_solve_matches_fused_pallas_interpret_f32(lower, rng):
    """The folded call (one K4 launch on the card) against tpukk's whole
    fused_sptrsv_solve — permute, fused Pallas kernel, permute — in
    interpret mode, on one level schedule."""
    Tj = _tri(jkc.generate_diag_dominant_csr(90, 5, dtype=np.float32, seed=6), lower,
              np.float32)
    rm, ent = Tj.host_row_map(), Tj.host_entries()
    vals = np.asarray(Tj.values)
    levels = jst._compute_levels(rm, ent, Tj.nrows, lower)
    jplan = build_fused_sptrsv_plan(rm, ent, vals, Tj.nrows, levels, lower)
    assert jplan is not None
    b = rng.standard_normal(Tj.nrows).astype(np.float32)
    ref = np.asarray(fused_sptrsv_solve(jplan, jnp.asarray(b), interpret=True))
    plan = level_plan_from_numpy(rm, ent, vals, levels, lower, CPU)
    x = ks.sptrsv_levels(plan, torch.from_numpy(b), src=plan.order, dst=plan.order)
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_levels_and_level_plan_from_tpukk(lower, rng):
    """The port's levels equal tpukk's, and a plan built through interop
    from tpukk's levels solves as the handle's does."""
    Tj = _tri(jkc.generate_diag_dominant_csr(200, 6, dtype=np.float64, seed=11), lower)
    rm, ent, vals = Tj.host_row_map(), Tj.host_entries(), Tj.host_values_full()
    lj = jst._compute_levels(rm, ent, Tj.nrows, lower)
    np.testing.assert_array_equal(tst._compute_levels(rm, ent, Tj.nrows, lower), lj)
    plan = level_plan_from_numpy(rm, ent, vals, lj, lower, CPU)
    assert plan.num_levels == int(lj.max())
    # level order makes every dependency earlier: strictly lower in plan space
    rows = plan.rows().numpy()
    assert (plan.cols.numpy() < rows).all()
    b = rng.standard_normal(Tj.nrows)
    bt = torch.from_numpy(b)
    x = ks.sptrsv_levels(plan, bt, src=plan.order, dst=plan.order).numpy()
    xs = spla.spsolve_triangular(Tj.to_scipy().tocsr(), b, lower=lower)
    assert _rel(x, xs) <= 1e-12


def test_sptrsv_refuses_zero_diagonal_and_supernodal():
    """A zero pivot is refused by both algorithms; SUPERNODAL solves a
    well-posed triangle (tests/test_torch_supernodal.py holds it to tpukk)."""
    T = sps.csr_matrix(np.array([[1.0, 0, 0], [1.0, 0.0, 0], [0, 2.0, 3.0]]))
    T.eliminate_zeros()
    with pytest.raises(TpuKKError, match="zero diagonal in level 1"):
        sptrsv_symbolic(SptrsvHandle(lower=True), tkc.CsrMatrix.from_scipy(T, device=CPU))
    with pytest.raises(TpuKKError, match="diagonal"):
        sptrsv_symbolic(SptrsvHandle(algorithm=SptrsvAlgorithm.SUPERNODAL),
                        tkc.CsrMatrix.from_scipy(T, device=CPU))
    T.setdiag([1.0, 2.0, 3.0])
    b = np.array([1.0, 2.0, 3.0])
    for dt in (np.float32, np.float64):
        h = SptrsvHandle(algorithm=SptrsvAlgorithm.SUPERNODAL)
        Tt = tkc.CsrMatrix.from_scipy(T.astype(dt), device=CPU)
        sptrsv_symbolic(h, Tt)
        assert h.sn_plan is not None and h.num_levels >= 1
        x = sptrsv_solve(h, Tt, torch.from_numpy(b.astype(dt)))
        assert _rel(x.numpy(), spla.spsolve_triangular(T.tocsr(), b, lower=True)) <= 1e-6


# ---------------------------------------------------------------------------
# trsv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diag", ["N", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_trsv_matches_tpukk(uplo, trans, diag, rng):
    Aj = jkc.generate_diag_dominant_csr(50, 4, dtype=np.float64, seed=9)
    Tj = _tri(Aj, uplo == "L")
    B = rng.standard_normal((Tj.nrows, 2))
    ref = np.asarray(jsp.trsv(uplo, trans, diag, Tj, jnp.asarray(B)))
    X = trsv(uplo, trans, diag, _port(Tj), torch.from_numpy(B))
    x1 = trsv(uplo, trans, diag, _port(Tj), torch.from_numpy(B[:, 0]))
    assert X.shape == B.shape and x1.shape == (Tj.nrows,)
    assert _rel(X.numpy(), ref) <= 1e-12
    np.testing.assert_array_equal(x1.numpy(), X[:, 0].numpy())
    T = Tj.to_scipy().toarray()
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    op = T.T if trans == "T" else T
    assert _rel(op @ X.numpy(), B) <= 1e-12


# ---------------------------------------------------------------------------
# K5: the static permutation
# ---------------------------------------------------------------------------

def test_permute_plain_matches_routed_pallas_interpret():
    rng = np.random.default_rng(4)
    n = 5000
    src = rng.permutation(n).astype(np.int64)
    jplan = j_permute_plan(src, _force=True)
    assert jplan is not None
    x = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(j_static_permute(jplan, jnp.asarray(x), interpret=True))
    plan = build_permute_plan(src, CPU)
    y = static_permute(plan, torch.from_numpy(x))
    assert _launches(ks.permute_gather) == 0
    np.testing.assert_array_equal(y.numpy(), ref)
    X = rng.standard_normal((n, 3))
    np.testing.assert_array_equal(permute_plain(plan.src, torch.from_numpy(X)).numpy(), X[src])
    with pytest.raises(TpuKKError, match="permutation"):
        build_permute_plan(np.zeros(4, np.int64), CPU)
    # common.utils: the gather form and tpukk's key-sort convention
    keys = rng.permutation(n).astype(np.int32)
    np.testing.assert_array_equal(
        permute_via_sort(torch.from_numpy(X), torch.from_numpy(keys)).numpy(),
        np.asarray(jutils.permute_via_sort(jnp.asarray(X), jnp.asarray(keys))))
    np.testing.assert_array_equal(permute(torch.from_numpy(x), torch.from_numpy(src)).numpy(),
                                  np.asarray(jutils.permute(jnp.asarray(x), jnp.asarray(src))))


# ---------------------------------------------------------------------------
# host planners and SpILUK
# ---------------------------------------------------------------------------

def _as_set(indptr, indices):
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return set(zip(rows.tolist(), np.asarray(indices).tolist()))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_iluk_pattern_matches_tpukk(k):
    A = jkc.generate_diag_dominant_csr(60, 5, dtype=np.float64, seed=4)
    sp = A.to_scipy()
    ip, ix = tnative.iluk_symbolic(sp.indptr, sp.indices, A.nrows, k)
    got = _as_set(ip, ix)
    jp, jx = jnative.iluk_symbolic(sp.indptr, sp.indices, A.nrows, k)
    assert got == _as_set(jp, jx)
    pj = j_iluk_pattern(sp, k)
    assert got == _as_set(pj.indptr, pj.indices)
    pt = tspiluk._iluk_pattern(sp, k)
    assert got == _as_set(pt.indptr, pt.indices)
    assert tnative.iluk_depth(ip, ix, A.nrows) == jnative.iluk_depth(jp, jx, A.nrows)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_spiluk_factors_match_tpukk(k):
    Aj = jkc.generate_diag_dominant_csr(60, 5, dtype=np.float64, seed=4)
    hj = jsp.SpilukHandle(k)
    nnz_j = jsp.spiluk_symbolic(hj, Aj)
    Lj, Uj = jsp.spiluk_numeric(hj, Aj)
    At = _port(Aj)
    ht = SpilukHandle(k)
    assert spiluk_symbolic(ht, At) == nnz_j
    assert ht.depth == hj.depth
    Lt, Ut = spiluk_numeric(ht, At)
    assert Lt.dtype == torch.float64 and Lt.device.type == "cpu"
    for t, j in ((Lt, Lj), (Ut, Uj)):
        d = (t.to_scipy() - j.to_scipy()).tocsr()
        assert np.abs(d.data).max(initial=0.0) <= 1e-12 * np.abs(j.to_scipy().data).max()
        assert _as_set(t.host_row_map(), t.host_entries()) == \
            _as_set(j.host_row_map(), j.host_entries())
    # the C++ numeric against the plain Python IKJ, on the same pattern
    sp = At.to_scipy()
    pat = ht.pattern
    vals = tnative.ilu_numeric(pat.indptr, pat.indices, sp.indptr, sp.indices, sp.data, At.nrows)
    np.testing.assert_allclose(vals, tspiluk._ilu_numeric_plain(sp, pat.indptr, pat.indices),
                               rtol=1e-14, atol=1e-300)


def test_spiluk_f32_casts_and_refresh_is_not_ported():
    """f32 factors stay f32; the device refresh (ported: the name is kept)
    refactors new f32 values as spiluk_numeric does (1e-5 of max|U|: f32
    against the host's f64 factorization cast to f32)."""
    Aj = jkc.generate_diag_dominant_csr(40, 4, dtype=np.float32, seed=5)
    At = _port(Aj)
    h = SpilukHandle(0)
    spiluk_symbolic(h, At)
    L, U = spiluk_numeric(h, At)
    assert L.dtype == U.dtype == torch.float32
    assert np.allclose(L.to_scipy().diagonal(), 1.0)
    plan = tspiluk.build_iluk_refresh(h, At)
    A2 = At.with_values(1.5 * At.values)
    lv, uv = tspiluk.spiluk_refresh(plan, A2.values)
    assert lv.dtype == uv.dtype == torch.float32
    Lr, Ur = tspiluk.refresh_to_csr(plan, lv, uv)
    L2, U2 = spiluk_numeric(h, A2)
    scale = np.abs(U2.to_scipy().data).max()
    assert abs(Lr.to_scipy() - L2.to_scipy()).max() <= 1e-5 * scale
    assert abs(Ur.to_scipy() - U2.to_scipy()).max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# orderings
# ---------------------------------------------------------------------------

def _bandwidth(sp):
    coo = sp.tocoo()
    return int(np.abs(coo.row - coo.col).max(initial=0))


def test_rcm_matches_tpukk_and_plain_quality():
    Aj = jkc.generate_fem2d_csr(700, seed=5)
    At = tkc.generate_fem2d_csr(700, seed=5, device=CPU)
    perm = tgr.rcm(At)
    np.testing.assert_array_equal(perm, jgr.rcm(Aj))
    assert sorted(perm.tolist()) == list(range(At.nrows))
    plain = tgr.rcm_plain(At)
    bw = _bandwidth(tgr.permute_matrix(At, perm).to_scipy())
    bw_plain = _bandwidth(tgr.permute_matrix(At, plain).to_scipy())
    assert bw <= 1.5 * bw_plain and bw * 4 < _bandwidth(At.to_scipy())
    Bj = jgr.permute_matrix(Aj, perm).to_scipy()
    assert abs(tgr.permute_matrix(At, perm).to_scipy() - Bj).max() == 0
    coords = np.random.default_rng(2).random((300, 2))
    np.testing.assert_array_equal(tgr.rcb(coords, 6), jgr.rcb(coords, 6))


def test_generators_default_to_cuda():
    np.testing.assert_array_equal(
        tkc.generate_fem2d_csr(200, seed=2, device=CPU).host_entries(),
        jkc.generate_fem2d_csr(200, seed=2).host_entries())
    if not torch.cuda.is_available():
        with pytest.raises(TpuKKError, match="device='cpu'"):
            tkc.generate_fem2d_csr(50)
