"""tpukk_torch's SpGEMM path against tpukk on the CPU (mirrors
tests/test_spgemm_spadd.py).

Slice: ``SpgemmHandle`` → ``spgemm_symbolic`` (host C++, or DIA) →
``spgemm_numeric`` (KK through K8's plain version, DENSE_ACC, DEBUG, DIA) →
numeric reuse, ``spgemm``, ``spgemm_jacobi``.  Kernel module: K8's plain
version (``spgemm_cuda.spgemm_rows_plain``) against the ordered sum over
tpukk's pair plan, and against the Pallas kernels of
``tpukk/sparse/spgemm_pallas.py`` run in interpret mode on tpukk's own pair
plan, the port given tpukk's C pattern by
``interop.spgemm_symbolic_from_numpy``; the other Pallas rows run in
tests/test_torch_spadd_triangle.py.

Tolerances: the symbolic phase and DIA's pattern equal tpukk's exactly; K8's
plain version equals the ordered sum over tpukk's pair plan bit for bit (the
same rounded products, added from 0 in the same order); f64 values within
1e-12 relative (max norm) of tpukk's numeric (the same products, summed in
the same order or by another exact-order segment sum); f32 values against a
Pallas kernel within 1e-5 relative (the TPU kernels split values into bf16
planes and sum chunk by chunk); numeric reuse with 2·A gives exactly 4·C.
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
from tpukk import native as jnative
from tpukk.sparse import spgemm_pallas as jsp_pallas
from tpukk.sparse.spgemm import SpgemmAlgorithm as JAlg
from tpukk.sparse.spgemm import SpgemmHandle as JHandle
from tpukk.sparse.spgemm import spgemm_jacobi as jspgemm_jacobi
from tpukk.sparse.spgemm import spgemm_numeric as jspgemm_numeric
from tpukk.sparse.spgemm import spgemm_symbolic as jspgemm_symbolic
from tpukk_torch import native
from tpukk_torch.interop import csr_from_numpy, spgemm_symbolic_from_numpy
from tpukk_torch.sparse import (SpgemmAlgorithm, SpgemmHandle, spgemm, spgemm_jacobi,
                                spgemm_numeric, spgemm_symbolic)
from tpukk_torch.sparse import spgemm_cuda
from tpukk_torch.sparse.spgemm import symbolic_plain
from tpukk_torch.common import tracing


def _launches(kernel) -> int:
    """The registry's launch counter of a kernel function."""
    return tracing.launch_counts([kernel])[kernel.__name__]


CPU = "cpu"

# every function of spgemm_pallas.py that reaches pl.pallas_call, by row of the
# kernel table in PERF.md
PALLAS_ROWS = {23: "_onehot_pair_call", 24: "_dl_pair_call", 25: "_dl_pair_call_batched",
               26: "_gt_pair_call", 27: "_gtp_pk_call", 28: "_expand3_call",
               29: "_rowperm3a_call"}


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _operands(name, dtype=np.float64):
    """The small cases of tests/test_spgemm_spadd.py; B None means A·A."""
    if name == "lap35":
        return jkc.generate_structured_laplacian(35, 35, dtype=dtype), None
    if name == "lap60":
        return jkc.generate_structured_laplacian(60, 60, dtype=dtype), None
    if name == "rect600x400x300":
        return (jkc.generate_random_csr(600, 400, 4, seed=9, dtype=dtype),
                jkc.generate_random_csr(400, 300, 3, seed=10, dtype=dtype))
    if name == "rand300":
        return jkc.generate_random_csr(300, 300, 6, seed=11, dtype=dtype), None
    if name == "rand2000":
        return jkc.generate_random_csr(2000, 2000, 6, seed=5, dtype=dtype), None
    if name == "rand40":  # one pair chunk: the only size where tpukk's dst-lane plan has B = 1
        return jkc.generate_random_csr(40, 40, 3, seed=1, dtype=dtype), None
    raise KeyError(name)


CASES = ["lap35", "lap60", "rect600x400x300", "rand300", "rand2000"]


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got.astype(np.float64) - ref).max(initial=0.0)
                 / max(np.abs(ref).max(initial=0.0), 1e-300))


@pytest.mark.parametrize("case", CASES)
def test_native_symbolic_equals_tpukk_and_plain(case):
    """C's pattern (row_map_c, entries_c) equals tpukk's native symbolic's and
    the numpy plain version's."""
    Aj, Bj = _operands(case)
    Bj = Aj if Bj is None else Bj
    args = (Aj.host_row_map(), Aj.host_entries(), Aj.nrows, Bj.ncols, Bj.host_row_map(),
            Bj.host_entries())
    ref = jnative.spgemm_symbolic(*args)
    assert ref is not None, "tpukk's native library did not build"
    got = native.spgemm_symbolic(*args)
    assert len(got) == 2
    for g, r in zip(got, ref[:2]):
        np.testing.assert_array_equal(g, r)
    for g, p in zip(got, symbolic_plain(_port(Aj), _port(Bj))):
        np.testing.assert_array_equal(g, p)


def _raw(nrows, ncols, per_row, seed, repeat):
    """(row_map, entries, values) of a random CSR matrix, columns unsorted
    within a row; with repeat, every third row repeats one of its columns."""
    rng = np.random.default_rng(seed)
    rm, ent = [0], []
    for i in range(nrows):
        cols = list(rng.choice(ncols, size=per_row, replace=False))
        if repeat and i % 3 == 0:
            cols.insert(int(rng.integers(0, per_row)), cols[-1])
        if i % 7 == 5:
            cols = []  # an empty row
        ent += cols
        rm.append(len(ent))
    return (np.array(rm, np.int32), np.array(ent, np.int32),
            rng.standard_normal(len(ent)))


def _ordered_operands(case):
    """(A, B) as raw (row_map, entries, values, nrows, ncols) arrays."""
    if case in CASES:
        Aj, Bj = _operands(case)
        Bj = Aj if Bj is None else Bj
        return [(M.host_row_map(), M.host_entries(), np.asarray(M.host_values_full(), np.float64),
                 M.nrows, M.ncols) for M in (Aj, Bj)]
    if case == "A repeats a column":
        return [(*_raw(120, 90, 5, 1, True), 120, 90), (*_raw(90, 70, 4, 2, False), 90, 70)]
    if case == "B repeats a column":
        return [(*_raw(120, 90, 5, 3, False), 120, 90), (*_raw(90, 70, 4, 4, True), 90, 70)]
    if case == "empty rows":
        d = np.zeros((30, 30))
        d[::4, ::3] = 1.5
        d[1::4, 5] = -2.0
        sp = sps.csr_matrix(d)
        return [(sp.indptr, sp.indices, sp.data, 30, 30)] * 2
    assert case == "rectangular"
    return [(*_raw(50, 80, 6, 5, False), 50, 80), (*_raw(80, 20, 3, 6, False), 80, 20)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES + ["A repeats a column", "B repeats a column",
                                          "empty rows", "rectangular"])
def test_row_plain_equals_ordered_sum_over_tpukk_pairs(case, dtype):
    """K8's plain version equals, bit for bit, the sum over tpukk's pair plan
    in plan order (np.add.at adds in index order) from 0: the row-wise
    numeric keeps the pair plan's order."""
    (arm, aent, aval, n, k), (brm, bent, bval, _, m) = _ordered_operands(case)
    rm, ent, a_idx, b_idx, c_idx = jnative.spgemm_symbolic(arm, aent, n, m, brm, bent)
    a, b = aval.astype(dtype), bval.astype(dtype)
    ref = np.zeros(len(ent), dtype)
    np.add.at(ref, np.asarray(c_idx), a[np.asarray(a_idx)] * b[np.asarray(b_idx)])
    A = csr_from_numpy(arm, aent, a, nrows=n, ncols=k, device=CPU)
    B = csr_from_numpy(brm, bent, b, nrows=k, ncols=m, device=CPU)
    h = SpgemmHandle()
    spgemm_symbolic(h, A, B)
    np.testing.assert_array_equal(h.row_map_c, rm)
    np.testing.assert_array_equal(h.entries_c, ent)
    got = spgemm_cuda.spgemm_rows_plain(h.row_plan, A.values, B.values)
    assert got.dtype == torch.from_numpy(a).dtype
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", CASES)
def test_kk_numeric_f64_matches_tpukk(case):
    Aj, Bj = _operands(case)
    Bj = Aj if Bj is None else Bj
    hj = JHandle()
    jspgemm_symbolic(hj, Aj, Bj)
    Cj = jspgemm_numeric(hj, Aj, Bj)
    A, B = _port(Aj), _port(Bj)
    h = SpgemmHandle()
    spgemm_symbolic(h, A, B)
    assert h.row_plan is not None and h.dia_plan is None
    n0 = _launches(spgemm_cuda.spgemm_rows)
    C = spgemm_numeric(h, A, B)
    assert _launches(spgemm_cuda.spgemm_rows) == n0  # the plain version: no launch on the CPU
    np.testing.assert_array_equal(C.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(C.host_entries(), Cj.host_entries())
    assert _rel(C.values, Cj.host_values_full()) <= 1e-12


def _spy(monkeypatch):
    """Count the calls of every Pallas function of spgemm_pallas.py."""
    calls = {}
    for name in PALLAS_ROWS.values():
        orig = getattr(jsp_pallas, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(jsp_pallas, name, spy)
    return calls


def _pallas_plan(row, hj, Aj, Bj, monkeypatch):
    """tpukk's Pallas plan for one row of the kernel table, built as
    tests/test_spgemm_spadd.py builds it."""
    pp = hj.pair_plan
    args = (pp.a_idx, pp.b_idx, pp.c_idx, Aj.nnz, Bj.nnz, pp.nnz_c)
    if row == 23:
        return jsp_pallas.build_onehot_pair_plan(pp, Aj.nnz, Bj.nnz, layout="flat")
    if row in (24, 25):
        plan = jsp_pallas.build_onehot_pair_plan(pp, Aj.nnz, Bj.nnz, layout="dstlane")
        assert (plan.batch == 1) == (row == 24)
        return plan
    if row == 26:
        monkeypatch.setenv("TPUKK_NO_PK_PAIR", "1")
        plan = jsp_pallas.GtPairPlan(*args)
        assert plan.layout == "legacy"
        return plan
    if row == 27:
        plan = jsp_pallas.GtPairPlan(*args)
        assert plan.layout == "pk"
        return plan
    # rows 28-29: the fused sort-based pipeline, routing forced as in
    # test_spgemm_sort_pair_fused_interpret
    import tpukk.common.permute as pmod

    orig = pmod.build_permute_plan
    monkeypatch.setattr(pmod, "build_permute_plan", lambda src, **kw: orig(src, _force=True))
    plan = jsp_pallas.SortPairPlan(*args)
    assert plan.fused, "fused gate did not engage"
    return plan


def run_pallas_row(row, case, monkeypatch):
    """One Pallas kernel in interpret mode on tpukk's pair plan against the
    port's numeric on tpukk's C pattern, f32."""
    Aj, Bj = _operands(case, np.float32)
    Bj = Aj if Bj is None else Bj
    hj = JHandle()
    jspgemm_symbolic(hj, Aj, Bj)
    plan = _pallas_plan(row, hj, Aj, Bj, monkeypatch)
    calls = _spy(monkeypatch)
    if isinstance(plan, jsp_pallas.SortPairPlan):
        ref = jsp_pallas.sort_pair_numeric(plan, Aj.values, Bj.values, interpret=True)
    else:
        ref = jsp_pallas.onehot_pair_numeric(plan, Aj.values, Bj.values, interpret=True)
    ran = {PALLAS_ROWS[r] for r in ((28, 29) if row in (28, 29) else (row,))}
    assert ran <= set(calls) and not set(calls) & (set(PALLAS_ROWS.values()) - ran), calls

    A, B = _port(Aj), _port(Bj)
    h = SpgemmHandle()
    spgemm_symbolic_from_numpy(h, A, B, hj.row_map_c, hj.entries_c)
    C = spgemm_numeric(h, A, B)
    assert C.dtype == torch.float32
    assert _rel(C.values, np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("row,case", [(23, "lap35"), (23, "rect600x400x300"), (24, "rand40"),
                                      (25, "lap35"), (25, "rect600x400x300"), (27, "lap60")])
def test_pallas_pair_kernels_match_port(row, case, monkeypatch):
    run_pallas_row(row, case, monkeypatch)


@pytest.mark.parametrize("algo", [SpgemmAlgorithm.DENSE_ACC, SpgemmAlgorithm.DEBUG])
@pytest.mark.parametrize("case", ["lap35", "rect600x400x300"])
def test_other_algorithms_match_tpukk(algo, case):
    Aj, Bj = _operands(case)
    Bj = Aj if Bj is None else Bj
    hj = JHandle(JAlg[algo.name])
    jspgemm_symbolic(hj, Aj, Bj)
    Cj = jspgemm_numeric(hj, Aj, Bj)
    A, B = _port(Aj), _port(Bj)
    h = SpgemmHandle(algo)
    spgemm_symbolic(h, A, B)
    C = spgemm_numeric(h, A, B)
    np.testing.assert_array_equal(C.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(C.host_entries(), Cj.host_entries())
    assert _rel(C.values, Cj.host_values_full()) <= 1e-12
    assert C.dtype == A.dtype


def _dia_pair(kind):
    if kind == "banded":
        A = jkc.generate_banded_csr(400, 3, dtype=np.float64, seed=2)
        return A, A
    if kind == "rect":
        return (jkc.generate_banded_csr(300, 2, dtype=np.float64, seed=4),
                jkc.generate_banded_csr(300, 4, dtype=np.float64, seed=5))
    A = jkc.generate_structured_laplacian(25, 25, dtype=np.float64)
    return A, A


@pytest.mark.parametrize("kind,algo", [("banded", "KK"), ("rect", "DIA"), ("laplacian", "DIA")])
def test_dia_matches_tpukk(kind, algo):
    """AUTO (KK) routes a band with full diagonals to DIA; DIA is opt-in on a
    Laplacian, whose clipped band holds explicit zeros: the pattern equals
    tpukk's in both."""
    Aj, Bj = _dia_pair(kind)
    hj = JHandle(JAlg[algo])
    jspgemm_symbolic(hj, Aj, Bj)
    assert hj.dia_plan is not None
    Cj = jspgemm_numeric(hj, Aj, Bj)
    A, B = _port(Aj), _port(Bj)
    h = SpgemmHandle(SpgemmAlgorithm[algo])
    spgemm_symbolic(h, A, B)
    assert h.dia_plan is not None and h.row_plan is None
    C = spgemm_numeric(h, A, B)
    np.testing.assert_array_equal(C.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(C.host_entries(), Cj.host_entries())
    assert _rel(C.values, Cj.host_values_full()) <= 1e-12
    ref = (A.to_scipy() @ B.to_scipy()).toarray()
    np.testing.assert_allclose(C.to_scipy().toarray(), ref, rtol=1e-12, atol=1e-12)
    # the reuse contract: same pattern, new values
    A2 = A.with_values(A.values * 2 + 1)
    C2 = spgemm_numeric(h, A2, B)
    np.testing.assert_allclose(C2.to_scipy().toarray(), (A2.to_scipy() @ B.to_scipy()).toarray(),
                               rtol=1e-12, atol=1e-12)


def test_kk_does_not_route_a_holey_band_to_dia():
    A = _port(jkc.generate_structured_laplacian(20, 20, dtype=np.float64))
    h = SpgemmHandle()
    spgemm_symbolic(h, A, A)
    assert h.dia_plan is None and h.row_plan is not None


def test_dia_refuses_an_unbanded_matrix():
    A = _port(jkc.generate_random_csr(200, 200, 40, seed=3, dtype=np.float64))
    with pytest.raises(Exception, match="not banded"):
        spgemm_symbolic(SpgemmHandle(SpgemmAlgorithm.DIA), A, A)


def test_spgemm_jacobi_matches_tpukk():
    Lj = jkc.generate_structured_laplacian(12, 10, dtype=np.float64)
    Bj = jkc.generate_random_csr(120, 40, 3, seed=9, dtype=np.float64)
    dinv = 1.0 / Lj.to_scipy().diagonal()
    hj = JHandle()
    jspgemm_symbolic(hj, Lj, Bj)
    Cj = jspgemm_jacobi(hj, Lj, Bj, 0.7, dinv)
    L, B = _port(Lj), _port(Bj)
    h = SpgemmHandle()
    spgemm_symbolic(h, L, B)
    C = spgemm_jacobi(h, L, B, 0.7, dinv)
    np.testing.assert_array_equal(C.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(C.host_entries(), Cj.host_entries())
    assert _rel(C.values, Cj.host_values_full()) <= 1e-12
    ref = (B.to_scipy() - 0.7 * sps.diags(dinv) @ L.to_scipy() @ B.to_scipy()).toarray()
    np.testing.assert_allclose(C.to_scipy().toarray(), ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numeric_reuse(dtype):
    """New values on the same patterns re-run only the numeric phase; 2·A
    gives exactly 4·C, and new random values match tpukk's reuse."""
    Aj = jkc.generate_random_csr(300, 300, 6, seed=11, dtype=dtype)
    A = _port(Aj)
    h = SpgemmHandle()
    spgemm_symbolic(h, A, A)
    plan = h.row_plan
    C = spgemm_numeric(h, A, A)
    A2 = A.with_values(2 * A.values)
    assert torch.equal(spgemm_numeric(h, A2, A2).values, 4 * C.values)
    assert h.row_plan is plan
    vals = np.random.default_rng(3).standard_normal(Aj.nnz).astype(dtype)
    Aj3 = jkc.CsrMatrix.from_arrays(Aj.row_map, Aj.entries, vals, nrows=Aj.nrows,
                                    ncols=Aj.ncols)
    hj = JHandle()
    jspgemm_symbolic(hj, Aj, Aj)
    Cj3 = jspgemm_numeric(hj, Aj3, Aj3)
    C3 = spgemm_numeric(h, A.with_values(vals), A.with_values(vals))
    assert _rel(C3.values, Cj3.host_values_full()) <= (1e-12 if dtype == np.float64 else 1e-6)


def test_empty_rows_and_rectangular():
    d = np.zeros((8, 8))
    d[1, 2] = 1.0
    d[5, 5] = 2.0
    A = csr_from_numpy(*(lambda s: (s.indptr, s.indices, s.data))(sps.csr_matrix(d)),
                       nrows=8, ncols=8, device=CPU)
    C = spgemm(A, A)
    np.testing.assert_array_equal(C.to_scipy().toarray(), d @ d)
    Aj = jkc.generate_random_csr(40, 60, 5, seed=1, dtype=np.float64)
    Bj = jkc.generate_random_csr(60, 30, 4, seed=2, dtype=np.float64)
    C = spgemm(_port(Aj), _port(Bj))
    assert C.shape == (40, 30)
    np.testing.assert_allclose(C.to_scipy().toarray(), (Aj.to_scipy() @ Bj.to_scipy()).toarray(),
                               rtol=1e-12, atol=1e-14)
    Z = csr_from_numpy(np.zeros(9, np.int32), np.zeros(0, np.int32), np.zeros(0), nrows=8,
                       ncols=8, device=CPU)
    Cz = spgemm(Z, A)
    assert Cz.nnz == 0 and Cz.shape == (8, 8)


def test_row_plan_checks_its_input():
    """The kernel does not bounds-check its reads, so the plan refuses
    patterns that do not fit one another and values of other lengths, and the
    plain version (like the kernel) a C pattern that lacks a product."""
    t = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    with pytest.raises(Exception, match="row map lengths"):  # C has another row count than A
        spgemm_cuda.build_row_plan(t(0, 1), t(0), t(0, 1), t(0), t(0, 1, 1), t(0), 1)
    with pytest.raises(Exception, match="row map does not rise"):  # A's row map past its entries
        spgemm_cuda.build_row_plan(t(0, 2), t(0), t(0, 1), t(0), t(0, 1), t(0), 1)
    with pytest.raises(Exception, match="outside"):  # an A column past B's rows
        spgemm_cuda.build_row_plan(t(0, 1), t(3), t(0, 1), t(0), t(0, 1), t(0), 1)
    with pytest.raises(Exception, match="outside"):  # a B column past C's columns
        spgemm_cuda.build_row_plan(t(0, 1), t(0), t(0, 1), t(4), t(0, 1), t(0), 2)
    plan = spgemm_cuda.build_row_plan(t(0, 1), t(0), t(0, 1), t(0), t(0, 1), t(0), 1)
    with pytest.raises(Exception, match="lengths"):
        spgemm_cuda.spgemm_rows(plan, torch.ones(2, dtype=torch.float64),
                                torch.ones(1, dtype=torch.float64))
    holey = spgemm_cuda.build_row_plan(t(0, 1), t(0), t(0, 1), t(1), t(0, 1), t(0), 2)
    with pytest.raises(Exception, match="lacks"):
        spgemm_cuda.spgemm_rows(holey, torch.ones(1, dtype=torch.float64),
                                torch.ones(1, dtype=torch.float64))
    with pytest.raises(Exception, match="sorted"):
        spgemm_symbolic_from_numpy(SpgemmHandle(), *[_port(jkc.generate_structured_laplacian(
            3, 3, dtype=np.float64))] * 2, np.r_[0, np.full(9, 2)], np.array([1, 0]))
