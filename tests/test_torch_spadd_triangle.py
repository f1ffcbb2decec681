"""tpukk_torch's SpADD and triangle counting against tpukk on the CPU, and the
Pallas SpGEMM kernels that tests/test_torch_spgemm.py leaves out (the
gather-table layout and the fused sort-based pipeline), in interpret mode.

Slice: ``SpaddHandle`` → ``spadd_symbolic`` → ``spadd_numeric`` with sorted
and unsorted rows and numeric reuse; ``triangle_count`` and
``triangle_count_per_row`` (host C++) and ``triangle_count_device`` over a
``TrianglePlan`` with unit and random weights; ``bspgemm`` and ``bspadd``
raise until the BSR route is ported.

Tolerances: patterns and triangle counts equal tpukk's and scipy's exactly;
SpADD values within 1e-15 relative (max norm) of tpukk's (alpha·a + beta·b
rounded once, in both); weighted triangle sums within 1e-13 relative (three
products per triangle, summed in another order); Pallas rows as in
tests/test_torch_spgemm.py.
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
from tpukk.graph import triangle as jtri
from tpukk.sparse.spadd import SpaddHandle as JSpaddHandle
from tpukk.sparse.spadd import spadd as jspadd
from tpukk.sparse.spadd import spadd_numeric as jspadd_numeric
from tpukk.sparse.spadd import spadd_symbolic as jspadd_symbolic
from tpukk_torch.graph import (build_triangle_plan, triangle_count, triangle_count_device,
                               triangle_count_per_row)
from tpukk_torch.graph.triangle import count_plain
from tpukk_torch.interop import csr_from_numpy
from tpukk_torch.sparse import (SpaddHandle, bspadd, bspgemm, bspgemm_numeric,
                                bspgemm_symbolic, spadd, spadd_numeric, spadd_symbolic)

from test_torch_spgemm import run_pallas_row

CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max(initial=0.0) / max(np.abs(ref).max(initial=0.0), 1e-300))


def _unsorted(Aj, seed):
    """The same matrix with each row's entries in a random order."""
    rm, ent, vals = Aj.host_row_map(), Aj.host_entries().copy(), Aj.host_values_full().copy()
    rng = np.random.default_rng(seed)
    for i in range(Aj.nrows):
        p = rng.permutation(np.arange(rm[i], rm[i + 1]))
        ent[rm[i]:rm[i + 1]], vals[rm[i]:rm[i + 1]] = ent[p], vals[p]
    return jkc.CsrMatrix.from_arrays(rm, ent, vals, nrows=Aj.nrows, ncols=Aj.ncols)


@pytest.mark.parametrize("sorted_input", [True, False])
def test_spadd_matches_tpukk_and_scipy(sorted_input):
    Aj = jkc.generate_random_csr(50, 40, 4, seed=5, dtype=np.float64)
    Bj = jkc.generate_random_csr(50, 40, 6, seed=6, dtype=np.float64)
    if not sorted_input:
        Aj, Bj = _unsorted(Aj, 1), _unsorted(Bj, 2)
    Cj = jspadd(2.0, Aj, -0.5, Bj, sorted_input=sorted_input)
    C = spadd(2.0, _port(Aj), -0.5, _port(Bj), sorted_input=sorted_input)
    np.testing.assert_array_equal(C.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(C.host_entries(), Cj.host_entries())
    assert _rel(C.values, Cj.host_values_full()) <= 1e-15
    ref = (2.0 * Aj.to_scipy() - 0.5 * Bj.to_scipy()).tocsr()
    ref.sort_indices()
    assert abs(C.to_scipy() - ref).max() <= 1e-15 * abs(ref).max()


def test_spadd_numeric_reuse():
    Aj = jkc.generate_random_csr(20, 20, 3, seed=7, dtype=np.float64)
    Bj = jkc.generate_random_csr(20, 20, 3, seed=8, dtype=np.float64)
    hj = JSpaddHandle()
    jspadd_symbolic(hj, Aj, Bj)
    A, B = _port(Aj), _port(Bj)
    h = SpaddHandle()
    spadd_symbolic(h, A, B)
    for alpha, beta in ((1.0, 1.0), (0.0, 1.0), (3.0, -2.0)):
        C = spadd_numeric(h, alpha, A, beta, B)
        Cj = jspadd_numeric(hj, alpha, Aj, beta, Bj)
        assert _rel(C.values, Cj.host_values_full()) <= 1e-15
    A2 = A.with_values(A.values * 2)
    C2 = spadd_numeric(h, 1.0, A2, 1.0, B)
    np.testing.assert_allclose(C2.to_scipy().toarray(), (A2.to_scipy() + B.to_scipy()).toarray(),
                               rtol=1e-15)


def test_spadd_f32_and_shape_check():
    Aj = jkc.generate_random_csr(30, 30, 4, seed=1, dtype=np.float32)
    Bj = jkc.generate_random_csr(30, 30, 4, seed=2, dtype=np.float32)
    C = spadd(1.5, _port(Aj), 0.25, _port(Bj))
    Cj = jspadd(1.5, Aj, 0.25, Bj)
    assert C.dtype == torch.float32
    assert _rel(C.values, Cj.host_values_full()) <= 1e-7
    with pytest.raises(Exception, match="shape"):
        spadd(1.0, _port(Aj), 1.0, _port(jkc.generate_random_csr(30, 20, 2, seed=3)))


def _graphs():
    return {"fem2d_2000": jkc.generate_fem2d_csr(2000),
            "lap30": jkc.generate_structured_laplacian(30, 30, dtype=np.float64),
            "rand_sym": jkc.CsrMatrix.from_scipy(
                (lambda s: (s + s.T).tocsr())(sps.random(400, 400, density=0.05,
                                                          random_state=4, format="csr")))}


@pytest.mark.parametrize("name", ["fem2d_2000", "lap30", "rand_sym"])
def test_triangle_counts_match_tpukk(name):
    Gj = _graphs()[name]
    G = _port(Gj)
    n = triangle_count(G)
    per_row = triangle_count_per_row(G)
    assert n == jtri.triangle_count(Gj)
    np.testing.assert_array_equal(per_row, jtri.triangle_count_per_row(Gj))
    np.testing.assert_array_equal(per_row, count_plain(G))
    assert per_row.sum() == n
    unit = Gj.to_scipy()
    unit.data[:] = 1.0
    L = sps.tril(unit, k=-1).tocsr()
    assert n == int(round((L @ L).multiply(L).sum()))


@pytest.mark.parametrize("name", ["fem2d_2000", "rand_sym"])
def test_triangle_count_device_matches_tpukk(name):
    Gj = _graphs()[name]
    G = _port(Gj)
    plan, pj = build_triangle_plan(G), jtri.build_triangle_plan(Gj)
    assert plan.num_triangles == pj.num_triangles == triangle_count(G)
    for k in ("a_idx", "b_idx", "t_idx", "rows"):
        np.testing.assert_array_equal(getattr(plan, k).numpy(), np.asarray(getattr(pj, k)))
    assert float(triangle_count_device(plan)) == float(jtri.triangle_count_device(pj))
    np.testing.assert_array_equal(triangle_count_device(plan, per_row=True).numpy(),
                                  np.asarray(jtri.triangle_count_device(pj, per_row=True)))
    w = np.random.default_rng(5).uniform(0.5, 2.0, len(plan.ent))
    got = triangle_count_device(plan, torch.from_numpy(w), per_row=True)
    ref = np.asarray(jtri.triangle_count_device(pj, w, per_row=True))
    assert _rel(got, ref) <= 1e-13
    assert _rel(triangle_count_device(plan, torch.from_numpy(w)).reshape(1),
                np.asarray(jtri.triangle_count_device(pj, w)).reshape(1)) <= 1e-13
    # independent oracle: row sums of (W·W) .* W, W the weighted lower triangle
    W = sps.csr_matrix((w, plan.ent, plan.rm), shape=(G.nrows, G.nrows))
    assert _rel(got, np.asarray((W @ W).multiply(W).sum(axis=1)).ravel()) <= 1e-13


def test_empty_graph_has_no_triangles():
    G = csr_from_numpy(np.zeros(6, np.int32), np.zeros(0, np.int32), np.zeros(0), nrows=5,
                       ncols=5, device=CPU)
    assert triangle_count(G) == 0
    plan = build_triangle_plan(G)
    assert plan.num_triangles == 0 and float(triangle_count_device(plan)) == 0.0


@pytest.mark.parametrize("fn,args", [(bspgemm, (None, None)), (bspgemm_symbolic, (None,) * 3),
                                     (bspgemm_numeric, (None,) * 3),
                                     (bspadd, (1.0, None, 1.0, None))])
def test_block_variants_raise_naming_the_bsr_item(fn, args):
    with pytest.raises(Exception, match="queue A item 2"):
        fn(*args)


@pytest.mark.parametrize("row,case", [(26, "lap35"), (26, "rand300"), (28, "rand2000"),
                                      (29, "lap35")])
def test_pallas_gather_table_and_fused_kernels_match_port(row, case, monkeypatch):
    """Row 26 (the gather-table layout, reached when tpukk's packed build is
    switched off); rows 28-29 (the fused sort-based pipeline: b expansion,
    then permute phase 3 with the a gather and the product) on a compact
    (rand2000, one pair per C entry) and a non-compact (lap35) plan."""
    run_pallas_row(row, case, monkeypatch)
