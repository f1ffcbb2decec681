"""tpukk_torch's graph coloring, MIS2 and coarsening against tpukk on the CPU.

The same graph, made from a seed, goes through both packages.  Colorings,
MIS2 roots, aggregates and coarse graphs must be equal element for element:
both run the same deterministic algorithms (hash priorities, seeded Luby
priorities, host greedy), and the port's gathers (rolled offsets, K3's plain
version on the selection matrix, an indexed ELL read) return the same
integers as tpukk's.  Above 4096 vertices tpukk's MIS2 runs its Pallas rounds
in interpret mode and the port its K3 rounds through the plain version.
"""
import numpy as np
import pytest
import scipy.sparse as sps

import tpukk.containers as jkc
import tpukk.graph as jg
import tpukk_torch.graph as tg
from tpukk_torch import native
from tpukk_torch.graph import coloring as tcol
from tpukk_torch.interop import csr_from_numpy

CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _sym(A):
    sp = A.to_scipy()
    sp = ((sp + sp.T) * 0.5).tocsr()
    sp.sort_indices()
    return jkc.CsrMatrix.from_scipy(sp.astype(np.float64))


GRAPHS = {
    # the port's gather path for each, by tpukk's gates
    "lap80_offsets": lambda: jkc.generate_structured_laplacian(80, 80),
    "random3000_selection": lambda: _sym(jkc.generate_random_csr(3000, 3000, 8, seed=13)),
    "random300_ell": lambda: _sym(jkc.generate_random_csr(300, 300, 5, seed=2)),
    "lap3d_ell": lambda: jkc.generate_structured_laplacian(8, 8, 8),
}
PATH_OF = {"lap80_offsets": "_vb_rolled", "random3000_selection": "_vb_selection",
           "random300_ell": "_vb_ell", "lap3d_ell": "_vb_ell"}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


@pytest.mark.parametrize("alg", [a.name for a in tg.ColoringAlgorithm])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_graph_color_equals_tpukk(graphs, case, alg, monkeypatch):
    Aj = graphs[case]
    At = _port(Aj)
    taken = []
    for fn in ("_vb_rolled", "_vb_selection", "_vb_ell"):
        orig = getattr(tcol, fn)
        monkeypatch.setattr(tcol, fn, lambda *a, _f=orig, _n=fn: taken.append(_n) or _f(*a))
    ref = jg.graph_color(Aj, jg.ColoringAlgorithm[alg])
    got = tg.graph_color(At, tg.ColoringAlgorithm[alg])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert tg.verify_coloring(At, got) and jg.verify_coloring(Aj, got)
    assert taken == ([] if alg == "SERIAL" else [PATH_OF[case]])


def test_selection_path_equals_tpukk_interpret_mode(graphs):
    """tpukk takes its one-hot gather path on the CPU only in interpret mode;
    there it forgets the VBD flag (coloring.py:347 does not pass
    ``deterministic``), so VBD is held to tpukk's ELL-path VBD."""
    Aj = graphs["random300_ell"]
    At = _port(Aj)
    ref = jg.graph_color(Aj, jg.ColoringAlgorithm.VB, _interpret=True)
    np.testing.assert_array_equal(tg.graph_color(At, tg.ColoringAlgorithm.VB, _selection=True),
                                  np.asarray(ref))
    got = tg.graph_color(At, tg.ColoringAlgorithm.VBD, _selection=True)
    np.testing.assert_array_equal(got, np.asarray(jg.graph_color(Aj, jg.ColoringAlgorithm.VBD)))
    assert tg.verify_coloring(At, got)


def test_serial_greedy_native_equals_plain(graphs):
    for Aj in graphs.values():
        rm, ent = Aj.host_row_map(), Aj.host_entries()
        np.testing.assert_array_equal(native.d1_greedy_color(rm, ent, Aj.nrows),
                                      tcol.serial_greedy_plain(rm, ent, Aj.nrows))


def test_graph_color_d2_square_and_rectangular(graphs):
    Aj = _sym(jkc.generate_random_csr(60, 60, 4, seed=3))
    got = tg.graph_color_d2(_port(Aj))
    np.testing.assert_array_equal(got, np.asarray(jg.graph_color_d2(Aj)))
    pat = Aj.to_scipy()
    pat.data[:] = 1.0
    sq = (pat @ pat.T + pat).tocsr()
    assert tg.verify_coloring(_port(jkc.CsrMatrix.from_scipy(sq.astype(np.float64))), got)
    B = sps.random(250, 180, 0.02, random_state=11, format="csr").astype(np.float32)
    Bj = jkc.CsrMatrix.from_scipy(B)
    got = tg.graph_color_d2(_port(Bj))
    np.testing.assert_array_equal(got, np.asarray(jg.graph_color_d2(Bj)))
    pb = B.copy()
    pb.data[:] = 1.0
    con = (pb @ pb.T).tocsr()
    assert tg.verify_coloring(_port(jkc.CsrMatrix.from_scipy(con.astype(np.float64))), got)


def test_verify_coloring_and_color_sets_equal_tpukk(graphs):
    Aj = graphs["lap3d_ell"]
    At = _port(Aj)
    colors = tg.graph_color(At, tg.ColoringAlgorithm.SERIAL)
    bad = colors.copy()
    bad[1] = bad[0]  # vertices 0 and 1 are neighbors
    for c in (colors, bad, np.zeros_like(colors)):
        assert tg.verify_coloring(At, c) == jg.verify_coloring(Aj, c)
    for got, ref in zip(tg.color_sets(colors), jg.color_sets(colors)):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def mis2_graphs():
    # below and above the 4096-vertex device threshold
    return {"lap15": jkc.generate_structured_laplacian(15, 15),
            "lap70": jkc.generate_structured_laplacian(70, 70)}


@pytest.mark.parametrize("case", ["lap15", "lap70"])
def test_mis2_equals_tpukk(mis2_graphs, case):
    Aj = mis2_graphs[case]
    At = _port(Aj)
    roots = tg.graph_mis2(At)
    np.testing.assert_array_equal(roots, np.asarray(jg.graph_mis2(Aj)))
    # independent and maximal at distance 2, on the host
    pat = Aj.to_scipy()
    pat.data[:] = 1.0
    A2 = (pat @ pat + pat).tocsr()
    sub = A2[roots][:, roots]
    assert abs(sub - sps.diags(sub.diagonal())).sum() == 0
    ind = np.zeros(Aj.nrows)
    ind[roots] = 1.0
    assert ((A2 @ ind) > 0).all()
    labels = tg.graph_mis2_aggregate(At)
    np.testing.assert_array_equal(labels, np.asarray(jg.graph_mis2_aggregate(Aj)))
    coarse, labels2 = tg.graph_mis2_coarsen(At)
    cj, lj = jg.graph_mis2_coarsen(Aj)
    np.testing.assert_array_equal(labels2, np.asarray(lj))
    assert coarse.nrows == cj.nrows and abs(coarse.to_scipy() - cj.to_scipy()).max() == 0


@pytest.mark.parametrize("heuristic", ["mis2", "heavy_edge"])
def test_coarsen_equals_tpukk(heuristic):
    Aj = _sym(jkc.generate_random_csr(80, 80, 4, seed=4))
    coarse, labels = tg.coarsen(_port(Aj), tg.CoarsenHeuristic(heuristic))
    cj, lj = jg.coarsen(Aj, jg.CoarsenHeuristic(heuristic))
    np.testing.assert_array_equal(labels, np.asarray(lj))
    assert coarse.nrows == int(labels.max()) + 1 < Aj.nrows
    np.testing.assert_allclose(coarse.to_scipy().toarray(), cj.to_scipy().toarray(), rtol=1e-14)
    _, P = tg.explicit_coarsen(_port(Aj), labels, keep_values=False)
    assert P.shape == (Aj.nrows, coarse.nrows)
