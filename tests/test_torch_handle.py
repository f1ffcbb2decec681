"""tpukk_torch.handle (TpukkHandle, spiluk_numeric_streams,
sptrsv_solve_streams) against tpukk.handle on the same seeded inputs, with
device="cpu", and against the port's own handles made directly.  Mirrors
tests/test_handle.py (test_handle_lifecycle, test_handle_composition,
test_streams).

Tolerance: 1e-12 relative (max norm) in f64 for the products, factors and
solves against tpukk (the same operations, rounded in other orders); the
aggregate against the port's direct handles exactly (the same calls).
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.handle as jh
import tpukk.sparse as js
import tpukk_torch.containers as tkc
import tpukk_torch.handle as th
import tpukk_torch.sparse as ts
from tpukk_torch.common import TpuKKError
from tpukk_torch.graph import ColoringAlgorithm

CPU = "cpu"
KINDS = ["spgemm", "spadd", "gs", "sptrsv", "spiluk", "par_ilut", "gmres"]


def _close(got, want, tol=1e-12):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _csr_close(Ct, Cj, tol=1e-12):
    np.testing.assert_array_equal(Ct.host_row_map(), Cj.host_row_map())
    np.testing.assert_array_equal(Ct.host_entries(), Cj.host_entries())
    _close(Ct.values, Cj.host_values_full(), tol)


def _pair(n, deg, seed):
    Aj = jkc.generate_diag_dominant_csr(n, deg, dtype=np.float64, seed=seed)
    At = tkc.generate_diag_dominant_csr(n, deg, dtype=np.float64, seed=seed, device=CPU)
    np.testing.assert_array_equal(At.host_values(), Aj.host_values_full())
    return Aj, At


@pytest.mark.parametrize("kind", KINDS)
def test_handle_lifecycle(kind):
    for handle, err in ((jh.TpukkHandle(), Exception), (th.TpukkHandle(), TpuKKError)):
        get = getattr(handle, f"get_{kind}_handle")
        with pytest.raises(err):
            get()
        h = getattr(handle, f"create_{kind}_handle")()
        assert get() is h
        getattr(handle, f"destroy_{kind}_handle")()
        with pytest.raises(err):
            get()
    # the port's sub-handle is the class of its name in tpukk_torch.sparse
    h = getattr(th.TpukkHandle(), f"create_{kind}_handle")()
    hj = getattr(jh.TpukkHandle(), f"create_{kind}_handle")()
    assert type(h).__name__ == type(hj).__name__ and getattr(ts, type(h).__name__) is type(h)


def test_sptrsv_handles_lower_and_upper():
    kh = th.TpukkHandle()
    lo, up = kh.create_sptrsv_handle(lower=True), kh.create_sptrsv_handle(lower=False)
    assert lo.lower and not up.lower
    assert kh.get_sptrsv_handle(True) is lo and kh.get_sptrsv_handle(False) is up
    kh.destroy_sptrsv_handle(lower=False)
    assert kh.get_sptrsv_handle() is lo
    with pytest.raises(TpuKKError):
        kh.get_sptrsv_handle(lower=False)


def test_handle_options_reach_the_sub_handles():
    kh = th.TpukkHandle()
    gs = kh.create_gs_handle(ts.GsAlgorithm.CLUSTER, ColoringAlgorithm.SERIAL,
                             clustering=ts.ClusteringAlgorithm.MIS2)
    assert gs.algorithm == ts.GsAlgorithm.CLUSTER and gs.coloring_algorithm == ColoringAlgorithm.SERIAL
    assert th.TpukkHandle().create_gs_handle().coloring_algorithm == ColoringAlgorithm.VB
    g = kh.create_gmres_handle(m=7, tol=1e-5, max_restarts=3, ortho=ts.Ortho.MGS)
    assert (g.m, g.tol, g.max_restarts, g.ortho) == (7, 1e-5, 3, ts.Ortho.MGS)
    assert kh.create_spiluk_handle(2).fill_level == 2
    assert kh.create_spadd_handle(False).sorted_input is False
    assert kh.create_par_ilut_handle(max_iters=3).max_iters == 3
    assert kh.create_spgemm_handle(ts.SpgemmAlgorithm.DEBUG).algorithm == ts.SpgemmAlgorithm.DEBUG


def test_handle_composition_matches_tpukk(rng):
    Aj, At = _pair(50, 4, 20)
    khj, kht = jh.TpukkHandle(), th.TpukkHandle()
    js.spgemm_symbolic(khj.create_spgemm_handle(), Aj, Aj)
    ts.spgemm_symbolic(kht.create_spgemm_handle(), At, At)
    _csr_close(ts.spgemm_numeric(kht.get_spgemm_handle(), At, At),
               js.spgemm_numeric(khj.get_spgemm_handle(), Aj, Aj))

    b = rng.standard_normal(At.nrows)
    bt = torch.from_numpy(b)
    gj, gt = khj.create_gs_handle(), kht.create_gs_handle()
    for g, A, fn in ((gj, Aj, js), (gt, At, ts)):
        fn.gauss_seidel_symbolic(g, A)
        fn.gauss_seidel_numeric(g, A)
    xj = js.gauss_seidel_apply(gj, Aj, None, b, 2)
    xt = ts.gauss_seidel_apply(gt, At, None, bt, 2)
    _close(xt, xj)
    assert np.linalg.norm(At.to_scipy() @ xt.numpy() - b) < np.linalg.norm(b)

    xgj, stj = js.gmres(khj.create_gmres_handle(m=20, tol=1e-8), Aj, b)
    xgt, stt = ts.gmres(kht.create_gmres_handle(m=20, tol=1e-8), At, bt)
    assert stt.converged and stj.converged and stt.num_iters == stj.num_iters
    _close(xgt, xgj)

    ja, ta = khj.create_spadd_handle(), kht.create_spadd_handle()
    js.spadd_symbolic(ja, Aj, Aj)
    ts.spadd_symbolic(ta, At, At)
    _csr_close(ts.spadd_numeric(ta, 2.0, At, -0.5, At), js.spadd_numeric(ja, 2.0, Aj, -0.5, Aj))


def test_ilu_gmres_through_the_handle_equals_the_direct_handles():
    """The composition that chip_smoke.py runs on the card (ILU(0) + GMRES),
    here on the CPU: the same iterations and the same bits as the handles
    made directly, and tpukk's solution within 1e-12."""
    Aj, At = _pair(300, 6, 21)
    b = np.random.default_rng(22).standard_normal(At.nrows)
    bt = torch.from_numpy(b)
    kh = th.TpukkHandle()
    ts.spiluk_symbolic(kh.create_spiluk_handle(0), At)
    L, U = ts.spiluk_numeric(kh.get_spiluk_handle(), At)
    x, st = ts.gmres(kh.create_gmres_handle(m=30, tol=1e-10), At, bt, prec=ts.LUPrec(L, U))
    hd = ts.SpilukHandle(0)
    ts.spiluk_symbolic(hd, At)
    Ld, Ud = ts.spiluk_numeric(hd, At)
    xd, std = ts.gmres(ts.GmresHandle(m=30, tol=1e-10), At, bt, prec=ts.LUPrec(Ld, Ud))
    assert st.converged and st.num_iters == std.num_iters
    assert torch.equal(x, xd)
    khj = jh.TpukkHandle()
    js.spiluk_symbolic(khj.create_spiluk_handle(0), Aj)
    Lj, Uj = js.spiluk_numeric(khj.get_spiluk_handle(), Aj)
    _csr_close(L, Lj)
    _csr_close(U, Uj)
    xj, stj = js.gmres(khj.create_gmres_handle(m=30, tol=1e-10), Aj, b, prec=js.LUPrec(Lj, Uj))
    assert stj.num_iters == st.num_iters
    _close(x, xj)


def test_streams_match_tpukk(rng):
    pairs = [_pair(30, 3, s) for s in (1, 2, 3)]
    hj = [js.SpilukHandle(0) for _ in pairs]
    ht = [ts.SpilukHandle(0) for _ in pairs]
    for a, c, (Aj, At) in zip(hj, ht, pairs):
        js.spiluk_symbolic(a, Aj)
        ts.spiluk_symbolic(c, At)
    luj = jh.spiluk_numeric_streams(hj, [p[0] for p in pairs])
    lut = th.spiluk_numeric_streams(ht, [p[1] for p in pairs])
    assert len(lut) == len(luj) == 3
    for (Lt, Ut), (Lj, Uj) in zip(lut, luj):
        _csr_close(Lt, Lj)
        _csr_close(Ut, Uj)
    tris_j, tris_t, handles_j, handles_t = [], [], [], []
    for Aj, _ in pairs:
        T = sps.tril(Aj.to_scipy()).tocsr()
        T.setdiag(np.abs(T.diagonal()) + 1.0)
        T.sort_indices()
        tris_j.append(jkc.CsrMatrix.from_scipy(T))
        tris_t.append(tkc.CsrMatrix.from_scipy(T, device=CPU))
        for hs, tris, mod in ((handles_j, tris_j, js), (handles_t, tris_t, ts)):
            h = mod.SptrsvHandle(True)
            mod.sptrsv_symbolic(h, tris[-1])
            hs.append(h)
    rhss = [rng.standard_normal(30) for _ in pairs]
    xj = jh.sptrsv_solve_streams(handles_j, tris_j, rhss)
    xt = th.sptrsv_solve_streams(handles_t, tris_t, [torch.from_numpy(r) for r in rhss])
    for a, c, Tm, r in zip(xt, xj, tris_t, rhss):
        _close(a, c)
        np.testing.assert_allclose(Tm.to_scipy() @ a.numpy(), r, rtol=1e-10, atol=1e-10)
