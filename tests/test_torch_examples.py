"""The port's examples (tpukk_torch/examples/): each main(device="cpu") runs
clean, and what it computes is held to tpukk on the same inputs — the
tpukk example of the same name under examples/ (tests/test_examples.py runs
those).  The examples live inside the package, so tests/test_examples.py,
which globs examples/, does not collect them.

Tolerance: colorings, MIS-2 roots, RCB parts, bandwidths, supernode counts
and iteration counts exactly; f64 solutions and products 1e-12 relative (max
norm); f32 products and solves 1e-5 relative.  The f32 GMRES of
rcm_reorder_solve is held to its residual only: its count is set by rounding
(ROADMAP, section C).
"""
import importlib

import numpy as np
import pytest
import torch

import tpukk.containers as jkc
import tpukk.graph as jg
import tpukk.sparse as js

NAMES = ["graph_wiki", "gmres_ex_real_A", "rcm_reorder_solve", "sptrsv_supernodal",
         "banded_spgemm"]


def _main(name, capsys):
    out = importlib.import_module(f"tpukk_torch.examples.{name}").main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.strip()
    return out, printed


def _rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_graph_wiki(capsys):
    out, printed = _main("graph_wiki", capsys)
    A = jkc.generate_structured_laplacian(24, 24)
    np.testing.assert_array_equal(out["colors"], np.asarray(jg.graph_color(A)))
    np.testing.assert_array_equal(out["d2"], np.asarray(jg.graph_color_d2(A)))
    np.testing.assert_array_equal(out["roots"], np.asarray(jg.graph_mis2(A)))
    pts = np.stack(np.meshgrid(np.arange(24), np.arange(24)), -1).reshape(-1, 2).astype(float)
    np.testing.assert_array_equal(out["parts"], jg.rcb(pts, 4))
    assert "valid = True" in printed


def test_gmres_ex_real_A(capsys):
    out, printed = _main("gmres_ex_real_A", capsys)
    A = jkc.generate_diag_dominant_csr(400, 8, dtype=np.float64, seed=1)
    b = np.ones(A.nrows)
    xj, stj = js.gmres(js.GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b)
    kh = js.SpilukHandle(fill_level=0)
    js.spiluk_symbolic(kh, A)
    xj2, stj2 = js.gmres(js.GmresHandle(m=25, tol=1e-8, max_restarts=40), A, b,
                         prec=js.LUPrec(*js.spiluk_numeric(kh, A)))
    assert (out["stats"].num_iters, out["stats_ilu"].num_iters) == (stj.num_iters, stj2.num_iters)
    assert _rel(out["x"], xj) <= 1e-12 and _rel(out["x_ilu"], xj2) <= 1e-12
    assert printed.count("converged=True") == 2


def test_rcm_reorder_solve(capsys):
    import scipy.sparse as sps

    out, printed = _main("rcm_reorder_solve", capsys)
    sp = jkc.generate_fem2d_csr(1200, seed=11).to_scipy().tocsr()
    sp = (sp + 4.0 * sps.eye(sp.shape[0], format="csr")).tocsr().astype(np.float32)
    A = jkc.CsrMatrix.from_scipy(sp)
    h = js.SpmvHandle(A, js.SpmvAlgorithm.RCM)
    x = np.random.default_rng(0).standard_normal(A.ncols).astype(np.float32)
    assert _rel(out["y"], np.asarray(h.matvec(x))) <= 1e-5
    ph = h.rcm_permuted()[0]
    rows = np.repeat(np.arange(sp.shape[0]), np.diff(ph.A.to_scipy().tocsr().indptr))
    assert out["bandwidth"][1] == int(np.abs(rows - ph.A.to_scipy().tocsr().indices).max())
    assert out["stats"].converged and "bandwidth" in printed


def test_sptrsv_supernodal(capsys):
    out, printed = _main("sptrsv_supernodal", capsys)
    from tpukk_torch.examples.sptrsv_supernodal import blocked_lower_factor

    T = blocked_lower_factor(256, 16)
    L = jkc.CsrMatrix.from_scipy(T.astype(np.float32))
    h = js.SptrsvHandle(lower=True, algorithm=js.SptrsvAlgorithm.SUPERNODAL)
    js.sptrsv_symbolic(h, L)
    assert (out["num_supernodes"], out["max_block"]) == (h.sn_plan.num_supernodes,
                                                         h.sn_plan.max_block)
    b = np.random.default_rng(1).standard_normal(L.nrows).astype(np.float32)
    assert _rel(out["x"], np.asarray(js.sptrsv_solve(h, L, b))) <= 1e-5
    assert "relative residual" in printed


def test_banded_spgemm(capsys):
    out, _ = _main("banded_spgemm", capsys)
    for key, A, alg in (("C", jkc.generate_banded_csr(2000, 3, dtype=np.float64, seed=0), None),
                        ("C2", jkc.generate_structured_laplacian(40, 40, dtype=np.float64),
                         js.SpgemmAlgorithm.DIA)):
        h = js.SpgemmHandle() if alg is None else js.SpgemmHandle(alg)
        js.spgemm_symbolic(h, A, A)
        C = js.spgemm_numeric(h, A, A)
        np.testing.assert_array_equal(out[key].host_row_map(), C.host_row_map())
        np.testing.assert_array_equal(out[key].host_entries(), C.host_entries())
        assert _rel(out[key].values, C.host_values_full()) <= 1e-12


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_device_or_cpu(name, monkeypatch):
    """Each main() runs on the CUDA device by default, and without one raises
    (naming device='cpu') instead of dropping to the CPU."""
    from tpukk_torch.common import TpuKKError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuKKError, match="device='cpu'"):
        importlib.import_module(f"tpukk_torch.examples.{name}").main()
