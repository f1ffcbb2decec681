"""tpukk_torch's Gauss-Seidel path against tpukk on the CPU (mirrors
tests/test_gauss_seidel.py).

Slice: ``GsHandle`` → ``gauss_seidel_symbolic`` → ``gauss_seidel_numeric`` →
forward / backward / symmetric sweeps and ``gauss_seidel_apply`` (POINT,
CLUSTER with MIS2 and Balloon, TWOSTAGE plain and ``compact_form``; ω = 1 and
1.2; ``x=None``, ``permuted=True``, a multivector of k = 4), and ``GsPrec``
inside ``pcg``.  Kernel module: K6's plain version (``gs_color_step_plain``)
against tpukk's color step on tpukk's own color blocks.  The SERIAL coloring,
the MIS2 aggregates and the Balloon clusters equal tpukk's, so both packages
sweep in one order; ``interop.gs_symbolic_from_numpy`` hands over colorings
that are computed only in tpukk.

Tolerance: |x − x_ref| ≤ tol_for(dtype)·max|x_ref| (tests/conftest.py's
10·eps): the products of a color block are summed in another order
(index_add_ against tpukk's padded-row sum), and a few sweeps carry that
rounding along.  The sequential-GS oracle is held at the same tolerance; the
multivector's columns are held to single-column applies at the same
tolerance; GsPrec-PCG to tpukk's iteration count and 1e-10.

K6's fused sweep (``gs_cuda.gs_sweep``): its plain version, and an emulation
of the kernel's step semantics (an unfilled working buffer whose zero ranges
read 0, scratch and copy steps, the result written only by final steps), are
held exactly (``torch.equal``) to the per-color loop of
``gs_color_step_plain`` that they replace; the step list itself to its
definition.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.sparse.linalg import spsolve_triangular

import tpukk.containers as jkc
import tpukk.sparse as jsp
from tpukk.sparse import gauss_seidel as jgs
from tpukk_torch.interop import csr_from_numpy, gs_symbolic_from_numpy
from tpukk_torch.sparse import (ClusteringAlgorithm, GsAlgorithm, GsHandle, GsPrec, JacobiPrec,
                                backward_sweep, forward_sweep, gauss_seidel_apply,
                                gauss_seidel_numeric, gauss_seidel_symbolic, pcg,
                                symmetric_sweep)
from tpukk_torch.sparse import gs_cuda, spmv_cuda
from tpukk_torch.sparse.gauss_seidel import _plan_in

from conftest import tol_for

CPU = "cpu"


def _port(Aj):
    return csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                          nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)


def _close(got, ref, dtype=np.float64):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol_for(dtype) * max(np.abs(ref).max(), 1e-300), err


def _shifted_lap(nx, shift, dtype=np.float64):
    sp = jkc.generate_structured_laplacian(nx, nx, dtype=dtype).to_scipy()
    sp.setdiag(sp.diagonal() + shift)
    return jkc.CsrMatrix.from_scipy(sp.tocsr())


# handle settings, each the same in both packages
VARIANTS = {
    "point": dict(algorithm="POINT"),
    "cluster_mis2": dict(algorithm="CLUSTER", clustering="MIS2"),
    "cluster_balloon": dict(algorithm="CLUSTER", clustering="BALLOON"),
    "twostage": dict(algorithm="TWOSTAGE"),
    "twostage_compact": dict(algorithm="TWOSTAGE", compact_form=True, inner_sweeps=3),
}


def _handles(variant, Aj, At, omega=1.0):
    kw = dict(VARIANTS[variant])
    alg, clu = kw.pop("algorithm"), kw.pop("clustering", None)
    hj = jgs.GsHandle(jgs.GsAlgorithm[alg],
                      clustering=None if clu is None else jgs.ClusteringAlgorithm[clu], **kw)
    ht = GsHandle(GsAlgorithm[alg],
                  clustering=None if clu is None else ClusteringAlgorithm[clu], **kw)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj, omega=omega)
    gauss_seidel_symbolic(ht, At)
    gauss_seidel_numeric(ht, At, omega=omega)
    return hj, ht


@pytest.fixture(scope="module")
def mats():
    # dd: past the DENSE size, so TWOSTAGE's L and U take the ONEHOT route
    return {"dd": jkc.generate_diag_dominant_csr(300, 5, dtype=np.float64, seed=11),
            "lap": _shifted_lap(12, 1.0)}


@pytest.mark.parametrize("omega", [1.0, 1.2])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sweeps_equal_tpukk(mats, variant, direction, omega, rng):
    for Aj in mats.values():
        At = _port(Aj)
        hj, ht = _handles(variant, Aj, At, omega)
        if variant.startswith(("point", "cluster")):
            np.testing.assert_array_equal(ht.order, hj.order)
        b = rng.standard_normal(Aj.nrows)
        x0 = rng.standard_normal(Aj.nrows)
        ref = jgs.gauss_seidel_apply(hj, Aj, jnp.asarray(x0), jnp.asarray(b), 2, direction)
        xt = torch.from_numpy(x0.copy())
        got = gauss_seidel_apply(ht, At, xt, torch.from_numpy(b), 2, direction)
        assert torch.equal(xt, torch.from_numpy(x0))  # x is not modified
        _close(got, ref)
        sweep = {"forward": forward_sweep, "backward": backward_sweep,
                 "symmetric": symmetric_sweep}[direction]
        _close(sweep(ht, At, None, torch.from_numpy(b), 1),
               jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 1, direction))


def test_point_forward_sweep_is_gs_in_color_order(mats, rng):
    """With the same order, multicolor GS is GS on the permuted matrix:
    x_p ← (D + L_p)⁻¹ (b_p − U_p·x_p) at ω = 1."""
    for Aj in mats.values():
        At = _port(Aj)
        h = GsHandle()
        gauss_seidel_symbolic(h, At)
        gauss_seidel_numeric(h, At)
        b, x0 = rng.standard_normal(Aj.nrows), rng.standard_normal(Aj.nrows)
        got = forward_sweep(h, At, torch.from_numpy(x0), torch.from_numpy(b)).numpy()
        o = h.order
        Ap = At.to_scipy()[o][:, o].tocsr()
        rhs = b[o] - sps.triu(Ap, k=1) @ x0[o]
        ref = np.empty_like(b)
        ref[o] = spsolve_triangular(sps.tril(Ap, k=0).tocsr(), rhs, lower=True)
        _close(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ["point", "cluster_mis2"])
def test_color_step_plain_equals_tpukk_step(variant, dtype, rng):
    """K6's plain version, one color step on each of tpukk's color blocks,
    uncoupled (POINT) and coupled (CLUSTER), k = 1 and 4, against tpukk's
    step (gauss_seidel.py:277-286) on the same permuted x.  The kernel's two
    modes are held to this plain version on the card (test_torch_cuda.py)."""
    Aj = jkc.CsrMatrix.from_scipy(_shifted_lap(14, 0.5).to_scipy().astype(dtype))
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At, omega=1.2)
    blocks = ht._blocks[torch.float32 if dtype == np.float32 else torch.float64]
    assert len(blocks) == len(hj.blocks)
    assert any(b.coupled for b in blocks) == (variant != "point")
    n = Aj.nrows
    for k in (1, 4):
        shape = (n,) if k == 1 else (n, k)
        for c, (bj, bt) in enumerate(zip(hj.blocks, blocks)):
            assert bt.start == bj.start and bt.nrows == bj.inv_diag.shape[0]
            np.testing.assert_array_equal(bt.inv_diag.numpy(), np.asarray(bj.inv_diag))
            xp = rng.standard_normal(shape).astype(dtype)
            bp = rng.standard_normal(shape).astype(dtype)
            s, e = bj.start, bj.start + bt.nrows
            cols = [xp] if k == 1 else [xp[:, j] for j in range(k)]
            bcols = [bp] if k == 1 else [bp[:, j] for j in range(k)]
            ref = []
            for xj, bjj in zip(cols, bcols):
                ax = jnp.sum(bj.vals * jnp.take(jnp.asarray(xj), bj.cols, axis=0), axis=1)
                xnew = (1.0 - 1.2) * xj[s:e] + 1.2 * bj.inv_diag * (bjj[s:e] - ax)
                ref.append(np.concatenate([xj[:s], np.asarray(xnew, dtype), xj[e:]]))
            ref = ref[0] if k == 1 else np.stack(ref, axis=1)
            got = gs_cuda.gs_color_step(bt, torch.from_numpy(xp.copy()), torch.from_numpy(bp), 1.2)
            _close(got, ref, dtype)


@pytest.mark.parametrize("variant", ["point", "cluster_mis2", "twostage"])
def test_multivector_k4_equals_single_columns_and_tpukk(mats, variant, rng, monkeypatch):
    Aj = mats["dd"]
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At)
    spmm_calls = []
    orig = spmv_cuda.csr_spmm
    monkeypatch.setattr(spmv_cuda, "csr_spmm", lambda p, X: spmm_calls.append(X.shape) or orig(p, X))
    B = rng.standard_normal((Aj.nrows, 4))
    X0 = rng.standard_normal((Aj.nrows, 4))
    for x0 in (None, X0):
        xt = None if x0 is None else torch.from_numpy(x0)
        got = gauss_seidel_apply(ht, At, xt, torch.from_numpy(B), 2)
        ref = jgs.gauss_seidel_apply(hj, Aj, None if x0 is None else jnp.asarray(x0),
                                     jnp.asarray(B), 2)
        _close(got, ref)
        for j in range(4):
            col = gauss_seidel_apply(ht, At, None if x0 is None else xt[:, j].contiguous(),
                                     torch.from_numpy(B[:, j].copy()), 2)
            _close(got[:, j], col.numpy())
    # TWOSTAGE's unbanded L and U take K7 on the ONEHOT route
    assert (len(spmm_calls) > 0) == (variant == "twostage")


def test_wide_multivector_goes_in_chunks_of_16(mats, rng):
    Aj = mats["lap"]
    At = _port(Aj)
    hj, ht = _handles("point", Aj, At)
    B = rng.standard_normal((Aj.nrows, 19))
    got = gauss_seidel_apply(ht, At, None, torch.from_numpy(B), 1)
    _close(got, jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(B), 1))


@pytest.mark.parametrize("variant", ["point", "cluster_balloon"])
def test_permuted_space_apply(mats, variant, rng):
    Aj = mats["dd"]
    At = _port(Aj)
    hj, ht = _handles(variant, Aj, At)
    b = rng.standard_normal(Aj.nrows)
    x_nat = gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 3)
    bp = torch.from_numpy(b[ht.order])
    x0 = torch.zeros_like(bp)
    xp = gauss_seidel_apply(ht, At, x0, bp, 3, permuted=True)
    assert torch.equal(x0, torch.zeros_like(bp))
    _close(xp.numpy()[ht.inv_order], x_nat.numpy())
    ref = jgs.gauss_seidel_apply(hj, Aj, jnp.zeros(Aj.nrows), jnp.asarray(b)[hj.order], 3,
                                 permuted=True)
    _close(xp, ref)


def test_gs_symbolic_from_numpy_takes_tpukk_colorings(mats, rng):
    """A VB coloring and a CLUSTER clustering computed in tpukk, handed over."""
    Aj = mats["dd"]
    At = _port(Aj)
    b = rng.standard_normal(Aj.nrows)
    hj = jgs.GsHandle(coloring=jgs.ColoringAlgorithm.VB)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj, omega=0.9)
    ht = GsHandle()
    gs_symbolic_from_numpy(ht, At, colors=np.asarray(hj.colors))
    gauss_seidel_numeric(ht, At, omega=0.9)
    np.testing.assert_array_equal(ht.order, hj.order)
    _close(gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 2),
           jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 2))
    hj = jgs.GsHandle(jgs.GsAlgorithm.CLUSTER)
    jgs.gauss_seidel_symbolic(hj, Aj)
    jgs.gauss_seidel_numeric(hj, Aj)
    for colors in (np.asarray(hj.colors), None):
        ht = GsHandle(GsAlgorithm.CLUSTER)
        gs_symbolic_from_numpy(ht, At, colors=colors, cluster_labels=hj.cluster_labels)
        gauss_seidel_numeric(ht, At)
        np.testing.assert_array_equal(ht.order, hj.order)
        _close(gauss_seidel_apply(ht, At, None, torch.from_numpy(b), 2),
               jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 2))


def test_error_decreases_every_sweep_f32(rng):
    """The reference's oracle (Test_Sparse_gauss_seidel.hpp) in f32, where the
    port sweeps in the matrix's dtype as tpukk does."""
    Aj = jkc.CsrMatrix.from_scipy(_shifted_lap(16, 1.0).to_scipy().astype(np.float32))
    At = _port(Aj)
    x_true = rng.standard_normal(Aj.nrows)
    b = (Aj.to_scipy().astype(np.float64) @ x_true).astype(np.float32)
    for variant in ("point", "cluster_mis2", "cluster_balloon", "twostage"):
        hj, ht = _handles(variant, Aj, At)
        x, errs = None, []
        for _ in range(5):
            x = gauss_seidel_apply(ht, At, x, torch.from_numpy(b), 1)
            assert x.dtype == torch.float32
            errs.append(np.linalg.norm(x.numpy() - x_true))
        assert all(e1 < e0 for e0, e1 in zip(errs, errs[1:])) and errs[-1] < 0.2 * errs[0]
        _close(x, jgs.gauss_seidel_apply(hj, Aj, None, jnp.asarray(b), 5), np.float32)


def test_gsprec_pcg_equals_tpukk_on_laplacian():
    Aj = jkc.generate_structured_laplacian(30, 30, dtype=np.float64)
    At = _port(Aj)
    b = np.random.default_rng(5).standard_normal(Aj.nrows)
    hj, ht = _handles("point", Aj, At)
    xj, sj = jsp.pcg(Aj, jnp.asarray(b), tol=1e-10, max_iters=500, prec=jsp.GsPrec(hj, Aj))
    xt, st = pcg(At, torch.from_numpy(b), tol=1e-10, max_iters=500, prec=GsPrec(ht, At))
    assert sj.converged and st.converged and st.num_iters == sj.num_iters
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()


def test_gsprec_takes_fewer_pcg_iterations_than_jacobi_on_fem():
    from tpukk_torch.containers import generate_fem2d_csr

    A = generate_fem2d_csr(800, seed=0, dtype=np.float64, device=CPU)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.nrows))
    h = GsHandle()
    gauss_seidel_symbolic(h, A)
    gauss_seidel_numeric(h, A)
    x, st = pcg(A, b, tol=1e-8, max_iters=3000, prec=GsPrec(h, A))
    _, sjac = pcg(A, b, tol=1e-8, max_iters=3000, prec=JacobiPrec(A))
    assert st.converged and sjac.converged and st.num_iters < sjac.num_iters
    r = b.numpy() - A.to_scipy() @ x.numpy()
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b.numpy())


def test_refuses_block_matrices_and_misuse():
    At = _port(jkc.generate_diag_dominant_csr(30, 3, dtype=np.float64, seed=8))
    with pytest.raises(NotImplementedError, match="A2"):
        gauss_seidel_symbolic(GsHandle(), object())
    h = GsHandle()
    with pytest.raises(Exception, match="symbolic first"):
        gauss_seidel_numeric(h, At)
    gauss_seidel_symbolic(h, At)
    with pytest.raises(Exception, match="numeric first"):
        gauss_seidel_apply(h, At, None, torch.ones(30, dtype=torch.float64))


# ---- K6's fused sweep: gs_sweep against the per-color loop it replaces -------

SWEEP_CASES = {
    "point_lap": ("POINT", lambda: _shifted_lap(14, 0.5)),        # uncoupled blocks
    "cluster_lap": ("CLUSTER", lambda: _shifted_lap(14, 0.5)),    # coupled blocks, 3 inner sweeps
    "point_dd": ("POINT", lambda: jkc.generate_diag_dominant_csr(300, 5, dtype=np.float64,
                                                                 seed=11)),  # non-symmetric
}


@pytest.fixture(scope="module")
def sweep_handles():
    out = {}
    for name, (alg, make) in SWEEP_CASES.items():
        At = _port(make())
        h = GsHandle(GsAlgorithm[alg], cluster_inner_sweeps=3)
        gauss_seidel_symbolic(h, At)
        gauss_seidel_numeric(h, At, omega=1.2)
        out[name] = h, At
    return out


def _sweep_inputs(h, x_given, k, dtype, seed):
    rng = np.random.default_rng(seed)
    n = h.order.shape[0]
    shape = (n,) if k == 1 else (n, k)
    b = torch.from_numpy(rng.standard_normal(shape).astype(dtype))
    x = torch.from_numpy(rng.standard_normal(shape).astype(dtype)) if x_given else None
    return x, b


def _per_color_loop(h, x, b, direction, num_sweeps, permuted):
    """The path gs_sweep replaces, written out from the handle: into color
    order, zeros for x None, gs_color_step_plain per color (and per inner
    sweep), back to natural order."""
    blocks = h._blocks[b.dtype]
    reps = h.cluster_inner_sweeps if h.algorithm == GsAlgorithm.CLUSTER else 1
    o = torch.from_numpy(h.order).long()
    bp = b if permuted else b[o]
    xp = torch.zeros_like(bp) if x is None else (x.clone() if permuted else x[o])
    halves = {"forward": [True], "backward": [False],
              "symmetric": [True, False]}[direction] * num_sweeps
    for fwd in halves:
        for blk in (blocks if fwd else blocks[::-1]):
            for _ in range(reps):
                gs_cuda.gs_color_step_plain(blk, xp, bp, h.omega)
    if permuted:
        return xp
    out = torch.empty_like(xp)
    out[o] = xp
    return out


def _emulate_steps(plan, x, b, omega, direction, num_sweeps, permuted):
    """The kernel's step semantics in torch ops: the working buffer, scratch
    and result start as NaN (no fill), a relaxation reads 0 in its step's
    zero range, and only final steps write the result."""
    host = plan.steps(direction, num_sweeps, x is not None).host
    o = plan.order.long()
    bp = b if permuted else b[o]
    work, scratch, res = (torch.full_like(bp, float("nan")) for _ in range(3))
    blocks = {blk.start: blk for blk in plan.blocks}
    for begin, end, mode, final, zlo, zhi, _, _ in host.tolist():
        if mode == gs_cuda.GATHER:
            work[begin:end] = (x if permuted else x[o])[begin:end]
            continue
        if mode == gs_cuda.COPY:
            work[begin:end] = val = scratch[begin:end]
        else:
            seen = work.clone()
            seen[zlo:zhi] = 0
            val = gs_cuda.gs_color_step_plain(blocks[begin], seen, bp, omega)[begin:end]
            (work if mode == gs_cuda.IN_PLACE else scratch)[begin:end] = val
        if final:
            res[begin:end] = val
    assert torch.equal(res, work)  # every row's last value is written out
    if permuted:
        return work
    out = torch.empty_like(res)
    out[o] = res
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("permuted", [False, True], ids=["natural", "permuted"])
@pytest.mark.parametrize("x_given", [False, True], ids=["x0", "x"])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_gs_sweep_plain_equals_per_color_loop(sweep_handles, case, direction, x_given, permuted,
                                              k, dtype):
    h, At = sweep_handles[case]
    x, b = _sweep_inputs(h, x_given, k, dtype, seed=k + 10 * x_given)
    plan = _plan_in(h, b.dtype)
    x_keep = None if x is None else x.clone()
    got = gs_cuda.gs_sweep(plan, x, b, h.omega, direction, 2, permuted)
    assert torch.equal(got, _per_color_loop(h, x, b, direction, 2, permuted))
    assert x is None or torch.equal(x, x_keep)
    if not permuted and dtype == np.float64:  # the matrix's dtype: apply is that one call
        assert torch.equal(gauss_seidel_apply(h, At, x, b, 2, direction), got)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("permuted", [False, True], ids=["natural", "permuted"])
@pytest.mark.parametrize("x_given", [False, True], ids=["x0", "x"])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_gs_sweep_steps_emulated_equal_per_color_loop(sweep_handles, case, direction, x_given,
                                                      permuted, k):
    """What only the kernel reads of the step list (zero ranges, scratch and
    copy steps, final flags), emulated with unfilled buffers, at one and at
    several chunks a step."""
    h, _ = sweep_handles[case]
    x, b = _sweep_inputs(h, x_given, k, np.float64, seed=3)
    plan = _plan_in(h, b.dtype)
    ref = _per_color_loop(h, x, b, direction, 2, permuted)
    for chunk_rows in (plan.chunk_rows, 7):
        p = dataclasses.replace(plan, chunk_rows=chunk_rows, _steps={})
        assert torch.equal(_emulate_steps(p, x, b, h.omega, direction, 2, permuted), ref)


def test_gs_sweep_plan_steps(sweep_handles):
    """The plan: src = dst = handle.order, the blocks' views tile the whole
    CSR, and the step lists of a POINT and a CLUSTER handle."""
    for name, (h, _) in sweep_handles.items():
        plan = h._plans[torch.float64]
        np.testing.assert_array_equal(plan.order.numpy(), h.order)
        n = h.order.shape[0]
        assert plan.offsets[0] == 0 and plan.offsets[-1] == n
        assert [blk.start for blk in plan.blocks] == list(plan.offsets[:-1])
        assert torch.equal(torch.cat([blk.csr.values for blk in plan.blocks]), plan.csr.values)
        assert torch.equal(torch.cat([blk.inv_diag for blk in plan.blocks]), plan.inv_diag)
        for blk in plan.blocks:
            ent = blk.csr.entries
            assert blk.coupled == bool(((ent >= blk.start) & (ent < blk.start + blk.nrows)).any())
        # a symmetric pattern's POINT blocks are uncoupled; CLUSTER's, and POINT's on
        # the non-symmetric dd pattern, are not
        assert any(plan.coupled) == (name != "point_lap")

    h, _ = sweep_handles["point_lap"]
    plan = h._plans[torch.float64]
    off, n, nb = plan.offsets, plan.n, len(plan.offsets) - 1
    host, nchunks = gs_cuda.sweep_steps(plan, "symmetric", 1, False)
    want = ([[off[c], off[c + 1], gs_cuda.IN_PLACE, 0, off[c], n] for c in range(nb)]
            + [[off[c], off[c + 1], gs_cuda.IN_PLACE, 1, 0, 0] for c in reversed(range(nb))])
    np.testing.assert_array_equal(host[:, :6], want)
    chunks = -(-(host[:, 1] - host[:, 0]) // plan.chunk_rows)
    np.testing.assert_array_equal(host[:, 6], np.r_[0, np.cumsum(chunks)[:-1]])
    np.testing.assert_array_equal(host[:, 7], np.r_[0, chunks[:-1]])
    assert nchunks == chunks.sum()
    host, _ = gs_cuda.sweep_steps(plan, "backward", 1, True)
    np.testing.assert_array_equal(host[0, :6], [0, n, gs_cuda.GATHER, 0, 0, 0])
    np.testing.assert_array_equal(host[1:, 2:6], [[gs_cuda.IN_PLACE, 1, 0, 0]] * nb)

    h, _ = sweep_handles["cluster_lap"]
    plan = _plan_in(h, torch.float64)
    assert plan.reps == 3
    host, _ = gs_cuda.sweep_steps(plan, "forward", 1, False)
    rows = iter(host[:, :6].tolist())
    for c in range(len(plan.offsets) - 1):
        s, e = int(plan.offsets[c]), int(plan.offsets[c + 1])
        for rep in range(3):
            zero = [s if rep == 0 else e, n]
            if plan.coupled[c]:
                assert next(rows) == [s, e, gs_cuda.TO_SCRATCH, 0, *zero]
                assert next(rows) == [s, e, gs_cuda.COPY, int(rep == 2), 0, 0]
            else:
                assert next(rows) == [s, e, gs_cuda.IN_PLACE, int(rep == 2), *zero]
    assert next(rows, None) is None
