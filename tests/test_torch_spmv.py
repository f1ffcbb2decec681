"""tpukk_torch SpMV against tpukk on the CPU.

Kernel modules: each CUDA kernel's plain version (what its wrapper runs on a
CPU tensor) against the Pallas kernel it replaces, run in interpret mode as
tests/test_spmv.py runs it, on one matrix handed to both packages; f64
against scipy.  K7 (``csr_spmm``) against tpukk's ``spmm`` with a 2-D x and
against scipy, and the ONEHOT route's choice of K7 up to 16 columns.  Slice: SpmvHandle/spmv routes, modes N/T/C/H with alpha/beta,
f32/f64 and empty rows against tpukk.sparse.spmv, and the AUTO gate.

Tolerance: |y - y_ref| <= 20·eps·(|A|·|x|)_i, the reference's scaled-eps
oracle (tests/conftest.py:tol_for) taken row by row, since both sides sum the
same products in a different order.  tests/test_torch_cuda.py holds each
kernel against its plain version on a CUDA device.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk.sparse as jsp
import tpukk_torch.containers as tkc
from tpukk.sparse import spmv_impl as j_impl
from tpukk.sparse import spmv_pallas as jpl
from tpukk_torch.interop import csr_from_numpy, dia_plan_from_numpy
from tpukk_torch.sparse import SpmvAlgorithm, SpmvHandle, spmm, spmv
from tpukk_torch.sparse import spmv_cuda as kc
from tpukk_torch.sparse import spmv_impl as t_impl

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _port(Aj):
    """The same matrix, handed to tpukk_torch on the CPU."""
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _close(got, ref, A_sp, x, dtype, scale=20):
    """|got - ref| <= scale·eps·(|A|·|x|) row by row (plus one eps of slack
    for rows whose bound is 0)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    bound = abs(A_sp).astype(np.float64) @ np.abs(np.asarray(x, np.float64))
    eps = np.finfo(dtype).eps
    err = np.abs(got - ref)
    assert got.shape == ref.shape
    assert (err <= scale * eps * bound + eps).all(), float(err.max())


def _vec(rng, n, dtype, k=None):
    return rng.standard_normal(n if k is None else (n, k)).astype(dtype)


DIA_CASES = {
    "lap2d": lambda dt: jkc.generate_structured_laplacian(40, 40, dtype=dt),
    "lap3d": lambda dt: jkc.generate_structured_laplacian(12, 12, 12, dtype=dt),
    "banded": lambda dt: jkc.generate_banded_csr(700, 3, dtype=dt, seed=2),
}


# ---------------------------------------------------------------------------
# K1 / K2: DIA kernels' plain versions against the Pallas DIA kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_spmv_plain_matches_pallas_dia(case, rng):
    Aj = DIA_CASES[case](np.float32)
    pj = j_impl.build_dia_plan(Aj)
    x = _vec(rng, Aj.ncols, np.float32)
    ref = np.asarray(jpl.dia_spmv(jpl.build_dia_pallas_plan(pj), jnp.asarray(x), interpret=True))
    pt = dia_plan_from_numpy(pj.diags_host, pj.offsets, Aj.nrows, Aj.ncols, CPU)
    y = kc.dia_spmv(pt, torch.from_numpy(x))
    assert y.dtype == torch.float32 and kc.dia_spmv.launches == 0
    _close(y.numpy(), ref, Aj.to_scipy(), x, np.float32)


@pytest.mark.parametrize("k", [3, 8])
def test_dia_spmm_plain_matches_pallas_dia_mv(k, rng):
    Aj = DIA_CASES["lap2d"](np.float32)
    pj = j_impl.build_dia_plan(Aj)
    X = _vec(rng, Aj.ncols, np.float32, k)
    ref = np.asarray(jpl.dia_spmm(jpl.build_dia_pallas_plan(pj), jnp.asarray(X), interpret=True))
    pt = dia_plan_from_numpy(pj.diags_host, pj.offsets, Aj.nrows, Aj.ncols, CPU)
    Y = kc.dia_spmm(pt, torch.from_numpy(X))
    for j in range(k):
        _close(Y[:, j].numpy(), ref[:, j], Aj.to_scipy(), X[:, j], np.float32)


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_f64_against_scipy(case, rng):
    # the f64 route replaces the double-single _dia_ds_call; held to scipy f64
    # because tpukk's interpret-mode ds output is only ~1e-7 accurate
    Aj = DIA_CASES[case](np.float64)
    At = _port(Aj)
    pt = t_impl.build_dia_plan(At)
    x = _vec(rng, Aj.ncols, np.float64)
    _close(kc.dia_spmv(pt, torch.from_numpy(x)).numpy(), Aj.to_scipy() @ x, Aj.to_scipy(),
           x, np.float64)


def test_dia_plan_nonsquare_and_checks(rng):
    # bounds use ncols, not nrows; duplicates and off-plan entries refuse
    sp = sps.random(60, 90, density=0.0, format="csr")
    sp = (sps.diags([1.0, 2.0, 3.0], [0, 5, 40], shape=(60, 90)) + sp).tocsr()
    At = tkc.CsrMatrix.from_scipy(sp, device=CPU)
    pt = t_impl.build_dia_plan(At)
    x = _vec(rng, 90, np.float64)
    np.testing.assert_allclose(kc.dia_spmv(pt, torch.from_numpy(x)).numpy(), sp @ x, rtol=1e-14)
    dup = tkc.CsrMatrix.from_arrays([0, 2, 3], [0, 0, 1], np.ones(3), ncols=2, device=CPU)
    with pytest.raises(Exception, match="duplicate"):
        t_impl.build_dia_plan(dup)


# ---------------------------------------------------------------------------
# K3: CSR kernel's plain version against the one-hot / gather-table kernels
# ---------------------------------------------------------------------------

CSR_CASES = {
    # (matrix, layouts run in interpret mode): the layouts of
    # tests/test_spmv.py:144-168; dstlane only where interpret mode is quick
    "lap2d": (lambda: jkc.generate_structured_laplacian(40, 40, dtype=np.float32),
              ("flat", "dstlane", "gt", "auto")),
    "random": (lambda: jkc.generate_random_csr(2000, 1800, 8, seed=3, dtype=np.float32),
               ("flat", "gt")),
    "random_small": (lambda: jkc.generate_random_csr(500, 700, 4, seed=5, dtype=np.float32),
                     ("dstlane",)),
    "fem_small": (lambda: jkc.read_mtx(ROOT / "data" / "fem2d_small.mtx.gz",
                                       value_dtype=np.float32), ("flat", "gt")),
}


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_sum_plain_matches_onehot(case, rng):
    make, layouts = CSR_CASES[case]
    Aj = make()
    At = _port(Aj)
    x = _vec(rng, Aj.ncols, np.float32)
    plan = kc.build_csr_plan(At, torch.float32)
    assert plan.group == kc.lanes_per_row(Aj.nnz, Aj.nrows)
    y = kc.csr_spmv(plan, torch.from_numpy(x)).numpy()
    for layout in layouts:
        pj = jpl.build_onehot_spmv_plan(Aj, layout=layout)
        ref = np.asarray(jpl.onehot_spmv(pj, jnp.asarray(x), interpret=True))
        _close(y, ref, Aj.to_scipy(), x, np.float32)


@pytest.mark.parametrize("case", ["random", "fem_small"])
def test_csr_max_plain_matches_onehot_max(case, rng):
    Aj = CSR_CASES[case][0]()
    Aa = jkc.CsrMatrix.from_arrays(Aj.host_row_map(), Aj.host_entries(),
                                   np.abs(Aj.host_values()), nrows=Aj.nrows, ncols=Aj.ncols)
    xa = np.abs(_vec(rng, Aj.ncols, np.float32))
    pj = jpl.build_onehot_spmv_plan(Aa, layout="gt")
    assert isinstance(pj, jpl.GtSpmvPlan)
    ref = np.asarray(jpl.onehot_spmv(pj, jnp.asarray(xa), interpret=True, reduce="max"))
    y = kc.csr_spmv(kc.build_csr_plan(_port(Aa), torch.float32), torch.from_numpy(xa), "max")
    np.testing.assert_array_equal(y.numpy(), ref)  # a max of equal products is exact


def test_csr_max_empty_rows_give_zero():
    At = tkc.CsrMatrix.from_arrays([0, 1, 1, 3], [0, 0, 1], np.array([-2.0, 3.0, -1.0]),
                                   ncols=2, device=CPU)
    y = kc.csr_spmv(kc.build_csr_plan(At, torch.float64), torch.ones(2, dtype=torch.float64),
                    "max")
    np.testing.assert_array_equal(y.numpy(), [0.0, 0.0, 3.0])  # neutral 0, as onehot_spmv


@pytest.mark.parametrize("case", ["lap2d", "random", "fem_small"])
def test_csr_f64_against_scipy(case, rng):
    # the f64 route replaces the double-single _gi4_ds_call_batched
    Aj = CSR_CASES[case][0]()
    sp = Aj.to_scipy().astype(np.float64)
    At = tkc.CsrMatrix.from_scipy(sp, device=CPU)
    x = _vec(rng, Aj.ncols, np.float64)
    y = kc.csr_spmv(kc.build_csr_plan(At, torch.float64), torch.from_numpy(x)).numpy()
    _close(y, sp @ x, sp, x, np.float64)


def test_lanes_per_row_rule():
    assert [kc.lanes_per_row(n, 10) for n in (0, 10, 19, 20, 45, 160, 320, 10_000)] == \
        [1, 1, 1, 2, 4, 16, 32, 32]


def test_wrappers_refuse_bad_operands(rng):
    At = tkc.generate_structured_laplacian(20, 20, dtype=np.float32, device=CPU)
    pd = t_impl.build_dia_plan(At)
    pc = kc.build_csr_plan(At, torch.float32)
    x = torch.from_numpy(_vec(rng, At.ncols, np.float32))
    bad = [
        lambda: kc.dia_spmv(pd, x.double()),              # dtype
        lambda: kc.dia_spmv(pd, x[:-1]),                  # shape
        lambda: kc.dia_spmv(pd, torch.stack([x, x], 1)),  # rank
        lambda: kc.dia_spmm(pd, torch.stack([x, x], 0).T),  # not contiguous
        lambda: kc.csr_spmv(pc, x, "min"),                # reduce
        lambda: kc.csr_spmv(pc, x.double()),
    ]
    for call in bad:
        with pytest.raises(Exception):
            call()


# ---------------------------------------------------------------------------
# K7: CSR SpMM kernel's plain version against tpukk's multi-RHS product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_csr_spmm_plain_matches_tpukk_and_scipy(k, dtype, rng, monkeypatch):
    Aj = jkc.generate_random_csr(2000, 1800, 8, seed=3, dtype=dtype)
    At = _port(Aj)
    X = _vec(rng, Aj.ncols, dtype, k)
    calls = []
    orig = kc.csr_spmm
    monkeypatch.setattr(kc, "csr_spmm", lambda p, x: calls.append(x.shape) or orig(p, x))
    Y = spmm(At, torch.from_numpy(X), algorithm=SpmvAlgorithm.ONEHOT)
    assert calls == [(Aj.ncols, k)] and Y.dtype == torch.from_numpy(X).dtype
    assert orig.launches == 0
    ref = np.asarray(jsp.spmv(Aj, jnp.asarray(X), algorithm=jsp.SpmvAlgorithm.ONEHOT))
    sp = Aj.to_scipy().astype(np.float64)
    for j in range(k):
        _close(Y[:, j].numpy(), ref[:, j], sp, X[:, j], dtype)
        _close(Y[:, j].numpy(), sp @ X[:, j].astype(np.float64), sp, X[:, j], dtype)
    # each column equals the single-column K3 product within the same bound
    plan = kc.build_csr_plan(At, torch.from_numpy(X).dtype)
    for j in range(k):
        _close(Y[:, j].numpy(), kc.csr_spmv(plan, torch.from_numpy(X[:, j].copy())).numpy(),
               sp, X[:, j], dtype)


def test_csr_spmm_plain_matches_onehot_spmm_interpret(rng):
    """The Pallas multi-RHS kernels themselves (onehot_spmm, interpret mode)
    on the layouts tests/test_spmv.py runs them on."""
    Aj = jkc.generate_random_csr(500, 700, 4, seed=5, dtype=np.float32)
    X = _vec(rng, Aj.ncols, np.float32, 4)
    Y = kc.csr_spmm(kc.build_csr_plan(_port(Aj), torch.float32), torch.from_numpy(X)).numpy()
    for layout in ("flat", "gt"):
        pj = jpl.build_onehot_spmv_plan(Aj, layout=layout)
        ref = np.asarray(jpl.onehot_spmm(pj, jnp.asarray(X), interpret=True))
        for j in range(4):
            _close(Y[:, j], ref[:, j], Aj.to_scipy(), X[:, j], np.float32)


def test_onehot_route_takes_ell_beyond_16_columns(rng, monkeypatch):
    Aj = jkc.generate_random_csr(400, 300, 5, seed=2, dtype=np.float64)
    calls = []
    orig = kc.csr_spmm
    monkeypatch.setattr(kc, "csr_spmm", lambda p, x: calls.append(x.shape) or orig(p, x))
    for k in (1, 17):
        X = _vec(rng, Aj.ncols, np.float64, k)
        Y = spmm(_port(Aj), torch.from_numpy(X), algorithm=SpmvAlgorithm.ONEHOT).numpy()
        ref = np.asarray(jsp.spmm(Aj, jnp.asarray(X), algorithm=jsp.SpmvAlgorithm.ELL))
        for j in range(k):
            _close(Y[:, j], ref[:, j], Aj.to_scipy(), X[:, j], np.float64)
    assert calls == []
    with pytest.raises(Exception, match="columns"):
        kc.csr_spmm(kc.build_csr_plan(_port(Aj), torch.float64),
                    torch.zeros((Aj.ncols, 17), dtype=torch.float64))


# ---------------------------------------------------------------------------
# the slice: SpmvHandle / spmv / spmm against tpukk.sparse
# ---------------------------------------------------------------------------

ROUTES = [SpmvAlgorithm.DENSE, SpmvAlgorithm.DIA, SpmvAlgorithm.ELL, SpmvAlgorithm.SEGSUM,
          SpmvAlgorithm.ONEHOT, SpmvAlgorithm.PALLAS, SpmvAlgorithm.DS, SpmvAlgorithm.AUTO]
# tpukk on the CPU cannot run its Pallas routes outside interpret mode; the
# values of the route that computes the same product stand in
J_ROUTE = {SpmvAlgorithm.ONEHOT: jsp.SpmvAlgorithm.ELL, SpmvAlgorithm.PALLAS: jsp.SpmvAlgorithm.DIA,
           SpmvAlgorithm.DS: jsp.SpmvAlgorithm.AUTO}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("route", ROUTES, ids=[r.name for r in ROUTES])
def test_handle_routes_match_tpukk(route, dtype, rng):
    Aj = jkc.generate_structured_laplacian(30, 20, dtype=dtype)
    At = _port(Aj)
    x = _vec(rng, Aj.ncols, dtype)
    jroute = J_ROUTE.get(route, jsp.SpmvAlgorithm[route.name])
    ref = np.asarray(jsp.spmv(Aj, jnp.asarray(x), algorithm=jroute))
    h = SpmvHandle(At, route)
    y = h(torch.from_numpy(x))
    assert y.dtype == (torch.float64 if route == SpmvAlgorithm.DS else torch.from_numpy(x).dtype)
    _close(y.numpy(), ref, Aj.to_scipy(), x, dtype)


@pytest.mark.parametrize("mode", ["N", "T", "C", "H"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.5, 0.0), (1.0, 1.0), (-1.0, 0.5),
                                        (0.0, 2.0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_modes_alpha_beta_match_tpukk(mode, alpha, beta, dtype, rng):
    Aj = jkc.generate_random_csr(400, 300, 6, seed=7, dtype=dtype)  # past the DENSE size
    At = _port(Aj)
    assert SpmvHandle(At).algorithm == SpmvAlgorithm.ONEHOT
    n_in, n_out = (Aj.nrows, Aj.ncols) if mode in "TH" else (Aj.ncols, Aj.nrows)
    x = _vec(rng, n_in, dtype)
    y0 = _vec(rng, n_out, dtype)
    ref = np.asarray(jsp.spmv(Aj, jnp.asarray(x), alpha, beta, jnp.asarray(y0), mode=mode))
    got = spmv(At, torch.from_numpy(x), alpha, beta, torch.from_numpy(y0), mode=mode)
    assert got.dtype == torch.from_numpy(x).dtype
    sp = Aj.to_scipy().T if mode in "TH" else Aj.to_scipy()
    # |alpha·A·x| plus |beta·y| bounds the rounding of both sides
    bound = abs(alpha) * (abs(sp) @ np.abs(x)) + abs(beta) * np.abs(y0)
    eps = np.finfo(dtype).eps
    assert (np.abs(got.numpy() - ref) <= 20 * eps * bound + eps).all()


@pytest.mark.parametrize("route", ROUTES, ids=[r.name for r in ROUTES])
def test_empty_rows_match_tpukk(route, rng):
    d = np.zeros((300, 300))
    d[0, 0], d[5, 3], d[299, 299], d[17, 250] = 1.0, 2.0, 3.0, -4.0
    Aj = jkc.CsrMatrix.from_scipy(sps.csr_matrix(d))
    At = _port(Aj)
    x = _vec(rng, 300, np.float64)
    jroute = J_ROUTE.get(route, jsp.SpmvAlgorithm[route.name])
    ref = np.asarray(jsp.spmv(Aj, jnp.asarray(x), algorithm=jroute))
    _close(spmv(At, torch.from_numpy(x), algorithm=route).numpy(), ref, Aj.to_scipy(), x,
           np.float64)
    np.testing.assert_allclose(ref, d @ x, rtol=1e-14)


@pytest.mark.parametrize("route", [SpmvAlgorithm.AUTO, SpmvAlgorithm.ELL, SpmvAlgorithm.ONEHOT,
                                   SpmvAlgorithm.SEGSUM], ids=lambda r: r.name)
def test_spmm_multivector_matches_tpukk(route, rng):
    for Aj in (jkc.generate_structured_laplacian(30, 30, dtype=np.float64),
               jkc.generate_random_csr(400, 300, 5, seed=2, dtype=np.float64)):
        X = _vec(rng, Aj.ncols, np.float64, 8)
        jroute = J_ROUTE.get(route, jsp.SpmvAlgorithm[route.name])
        ref = np.asarray(jsp.spmm(Aj, jnp.asarray(X), algorithm=jroute))
        Y = spmm(_port(Aj), torch.from_numpy(X), algorithm=route).numpy()
        for j in range(X.shape[1]):
            _close(Y[:, j], ref[:, j], Aj.to_scipy(), X[:, j], np.float64)


def test_auto_gate():
    lap = tkc.generate_structured_laplacian(40, 40, device=CPU)
    assert SpmvHandle(lap).algorithm == SpmvAlgorithm.DIA
    lap3 = tkc.generate_structured_laplacian(12, 12, 12, dtype=np.float64, device=CPU)
    assert SpmvHandle(lap3).algorithm == SpmvAlgorithm.DIA
    for dt in (np.float32, np.float64):
        rnd = tkc.generate_random_csr(2000, 2000, 8, seed=1, dtype=dt, device=CPU)
        assert SpmvHandle(rnd).algorithm == SpmvAlgorithm.ONEHOT
    assert SpmvHandle(rnd.astype(torch.bfloat16)).algorithm == SpmvAlgorithm.ELL
    tiny = tkc.generate_structured_laplacian(10, 10, device=CPU)
    assert SpmvHandle(tiny).algorithm == SpmvAlgorithm.DENSE
    # DS resolves to AUTO's route
    assert SpmvHandle(lap, SpmvAlgorithm.DS).algorithm == SpmvAlgorithm.DIA


def test_bf16_dia_route_matches_f32():
    A = tkc.generate_structured_laplacian(60, 60, dtype=np.float32, device=CPU)
    Ab = A.astype(torch.bfloat16)
    x = torch.linspace(-1, 1, A.ncols)
    assert SpmvHandle(Ab).algorithm == SpmvAlgorithm.DIA
    assert SpmvHandle(Ab)._plan("dia", torch.float32).diags.dtype == torch.float32
    torch.testing.assert_close(spmv(Ab, x), spmv(A, x), rtol=1e-6, atol=1e-6)


def test_handle_caches_plans_and_refuses_unported(rng):
    At = tkc.generate_random_csr(300, 300, 5, seed=4, dtype=np.float64, device=CPU)
    h = SpmvHandle(At)
    x = torch.from_numpy(_vec(rng, 300, np.float64))
    h(x)
    h(x)
    assert list(h._plans) == [("csr", torch.float64)]
    assert h(x.float()).dtype == torch.float32  # output cast to x's dtype
    hd = SpmvHandle(At.astype(np.float32), SpmvAlgorithm.DS)
    for mode in "NT":
        yd = hd(x.float(), mode=mode)
        assert yd.dtype == torch.float64
        sp = At.to_scipy().astype(np.float32).astype(np.float64)
        ref = (sp.T if mode == "T" else sp) @ x.float().double().numpy()
        np.testing.assert_allclose(yd.numpy(), ref, rtol=1e-12, atol=1e-12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpmvHandle(At, SpmvAlgorithm.BSR)
    Ac = At.with_values(At.values.to(torch.complex128))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpmvHandle(Ac)
