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
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.sparse.linalg import spsolve_triangular

import tpukk.containers as jkc
import tpukk.sparse as jsp
from tpukk.sparse import gauss_seidel as jgs
from tpukk_torch.common import TpuKKError
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
    # block matrices are ported (tests/test_torch_bsr.py); what is neither a
    # CsrMatrix nor a BsrMatrix is refused
    with pytest.raises(TpuKKError, match="CsrMatrix or a BsrMatrix"):
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


# ---- K6's DIA route: the plan's rule, and its plain version against the CSR's ----

def _hpcg(m):
    """HPCG's 27-point operator on an m³ grid: 26 on the diagonal, −1 for
    each neighbour."""
    t = sps.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    sp = sps.kron(sps.kron(t, t), t).tocsr()
    sp.data[:] = -1.0
    sp.setdiag(26.0)
    return jkc.CsrMatrix.from_scipy(sp.tocsr())


def _fem30k():
    from tpukk_torch.containers import read_mtx
    return read_mtx(Path(__file__).resolve().parent.parent / "data" / "fem2d_30k.mtx.gz",
                    device=CPU)


# name: (algorithm, matrix, takes the route)
DIA_CASES = {
    "hpcg16": ("POINT", lambda: _port(_hpcg(16)), True),
    "lap": ("POINT", lambda: _port(_shifted_lap(20, 0.5)), True),
    "fem2d_30k": ("POINT", _fem30k, False),
    "cluster_hpcg16": ("CLUSTER", lambda: _port(_hpcg(16)), False),
}


@pytest.fixture(scope="module")
def dia_handles():
    out = {}
    for name, (alg, make, _) in DIA_CASES.items():
        At = make()
        h = GsHandle(GsAlgorithm[alg])
        gauss_seidel_symbolic(h, At)
        gauss_seidel_numeric(h, At, omega=1.1)
        out[name] = h, At
    return out


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_route_is_the_plans_rule(dia_handles, case):
    """The plan builds the layout exactly where its rule holds, and the
    layout holds each block's distinct offsets, the values and the masks."""
    h, _ = dia_handles[case]
    plan = h._plans[torch.float64]
    assert (plan.dia is not None) == DIA_CASES[case][2]
    rows = np.repeat(np.arange(plan.n), np.diff(plan.csr.row_map.numpy()))
    dist = plan.csr.entries.numpy().astype(np.int64) - rows
    blocks = list(zip(plan.offsets[:-1], plan.offsets[1:]))
    counts = [np.unique(dist[(rows >= s) & (rows < e)]).size for s, e in blocks]
    slots = sum(c * (e - s) for c, (s, e) in zip(counts, blocks))
    if plan.dia is None:
        assert (any(plan.coupled) or max(counts) > gs_cuda.DIA_SLOTS
                or slots * 8 >= dist.size * 12)
        return
    dia = plan.dia
    assert dia.ndiag.tolist() == counts and dia.values.numel() == slots
    assert slots * 8 < dist.size * 12  # the route's bytes: fewer than the CSR's
    if case == "hpcg16":
        assert counts == [26] * 8 and slots == 106_496
    if case == "lap":
        assert counts == [5] * (len(blocks))
    # every entry sits in its slot, every other slot is 0 with its mask bit clear
    dense = sps.csr_matrix((plan.csr.values.numpy(), plan.csr.entries.numpy(),
                            plan.csr.row_map.numpy()), shape=(plan.n, plan.n)).toarray()
    mask = dia.mask.numpy().view(np.uint32)
    for c, (s, e) in enumerate(blocks):
        offs = dia.offs[c, :counts[c]].numpy()
        np.testing.assert_array_equal(offs, np.unique(dist[(rows >= s) & (rows < e)]))
        vals = dia.values[int(dia.vbase[c]):int(dia.vbase[c]) + counts[c] * (e - s)].numpy()
        for d, off in enumerate(offs):
            r = np.arange(s, e)
            cols = r + off
            inside = (cols >= 0) & (cols < plan.n)
            want = np.zeros(e - s)
            want[inside] = dense[r[inside], cols[inside]]
            present = np.zeros(e - s, bool)
            present[inside] = dense[r[inside], cols[inside]] != 0
            np.testing.assert_array_equal(vals[d * (e - s):(d + 1) * (e - s)], want)
            np.testing.assert_array_equal((mask[s:e] >> d) & 1, present)


def test_dia_layout_weighs_bytes_at_each_width(dia_handles):
    """``to(dtype)`` keeps the layout where its bytes still pay at the new
    width: the 5-point Laplacian's 28 % padding pays in f32 and complex64,
    not in complex128 (16-byte values against 20 bytes an entry)."""
    h, _ = dia_handles["lap"]
    for dt, kept in ((torch.float32, True), (torch.complex64, True),
                     (torch.complex128, False)):
        plan = _plan_in(h, dt)
        assert (plan.dia is not None) == kept
        if kept:
            assert plan.dia.values.dtype == dt
    h, _ = dia_handles["hpcg16"]
    assert _plan_in(h, torch.complex128).dia is not None  # 14 % padding


def test_dia_layout_refuses_two_entries_on_one_slot():
    """A row with two entries on one offset (a repeated column) keeps the
    CSR: a slot holds one value.  The same rows without the repeat take the
    layout (each row its own block, one offset a block)."""
    n = 8
    order, offsets = np.arange(n), np.arange(n + 1)
    for repeat in (False, True):
        ent = np.r_[0, np.arange(n - 1)] if repeat else np.arange(n - 1)
        rm = np.r_[0, 0, np.arange(2, n + 1)] if repeat else np.r_[0, np.arange(n)]
        plan = gs_cuda.build_gs_sweep_plan(rm, ent, np.full(ent.size, -0.5), np.ones(n),
                                           offsets, order, CPU)
        assert (plan.dia is None) == repeat


def _dia_steps_hold(plan, x, b, omega, direction):
    """Each relaxation step of the DIA layout against the CSR's color step on
    the same input (the zero range read as 0, the rest of the working buffer
    NaN where not yet written), within ``step_error_bound``; returns the sum
    of the steps' largest bounds."""
    dia = plan.dia
    host = plan.steps(direction, 1, x is not None, dia=True).host
    o = plan.order.long()
    bp = b[o]
    work = torch.full_like(bp, float("nan"))
    blocks = {blk.start: (c, blk) for c, blk in enumerate(plan.blocks)}
    total = 0.0
    for begin, end, mode, _, zlo, zhi, _, _ in host.tolist():
        if mode == gs_cuda.GATHER:
            work[begin:end] = x[o][begin:end]
            continue
        c, blk = blocks[begin]
        seen = work.clone()
        seen[zlo:zhi] = 0
        want = gs_cuda.gs_color_step_plain(blk, seen.clone(), bp, omega)[begin:end]
        got = gs_cuda.gs_dia_step_plain(dia, c, work, bp, plan.inv_diag, omega, zlo, zhi)
        bound = gs_cuda.step_error_bound(blk, seen, bp, omega)
        assert bool(((got - want).abs() <= bound).all()), float(((got - want).abs() / bound).max())
        total += float(bound.max())
        work[begin:end] = want
    return total


@pytest.mark.parametrize("x_given", [False, True], ids=["x0", "x"])
@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("case,dtype", [
    ("hpcg16", torch.float32), ("hpcg16", torch.float64), ("hpcg16", torch.complex128),
    # the 5-point Laplacian's layout does not pay in complex128 (see above)
    ("lap", torch.float32), ("lap", torch.float64), ("lap", torch.complex64)],
    ids=["hpcg16-f32", "hpcg16-f64", "hpcg16-c128", "lap-f32", "lap-f64", "lap-c64"])
def test_gs_sweep_dia_plain_within_bound_of_csr(dia_handles, case, dtype, direction, x_given):
    """The DIA route's plain version (the layout in torch ops) against
    ``gs_sweep_plain`` on the CSR: every step within ``step_error_bound``'s
    20·eps rule, and the apply within the sum of its steps' bounds (a
    relaxation of a diagonally dominant row does not grow an error that
    reaches it)."""
    h, At = dia_handles[case]
    plan = _plan_in(h, dtype)
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.standard_normal(plan.n)).to(dtype)
    x = torch.from_numpy(rng.standard_normal(plan.n)).to(dtype) if x_given else None
    if dtype.is_complex:
        b = b + 0.5j * torch.from_numpy(rng.standard_normal(plan.n)).to(dtype)
    total = _dia_steps_hold(plan, x, b, h.omega, direction)
    got = gs_cuda.gs_sweep_dia(plan, x, b, h.omega, direction)  # the CPU runs the plain version
    want = gs_cuda.gs_sweep_plain(plan, x, b, h.omega, direction)
    assert float((got - want).abs().max()) <= total
    if dtype == torch.float64:
        assert torch.equal(gauss_seidel_apply(h, At, x, b, 1, direction), want)


@pytest.mark.parametrize("permuted", [False, True], ids=["natural", "permuted"])
@pytest.mark.parametrize("x_given", [False, True], ids=["x0", "x"])
@pytest.mark.parametrize("case", ["hpcg16", "lap"])
def test_gs_sweep_dia_ignores_what_the_buffer_held(dia_handles, case, x_given, permuted):
    """The working buffer is never filled: a padded slot, a column in the
    zero range and a row not yet written read nothing from it, so a buffer
    of NaN gives the same bits as one of zeros."""
    h, _ = dia_handles[case]
    plan = _plan_in(h, torch.float64)
    rng = np.random.default_rng(9)
    b = torch.from_numpy(rng.standard_normal(plan.n))
    x = torch.from_numpy(rng.standard_normal(plan.n)) if x_given else None
    outs = []
    for fill in (float("nan"), 0.0):
        plan.buffer("work", plan.n, b).fill_(fill)
        outs.append(gs_cuda.gs_sweep_dia_plain(plan, x, b, h.omega, "symmetric", 2, permuted))
    assert torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[0]).all())


class _FakeGsLibrary:
    """K6's C entries as a CUDA launch would reach them, each returning 0:
    what the wrappers decide, counted without a card."""

    def tpukk_gs_sweep(self, *args):
        return 0

    def tpukk_gs_sweep_dia(self, *args):
        return 0


@pytest.mark.parametrize("case,k,route", [("hpcg16", 1, "gs_sweep_dia"),
                                          ("lap", 1, "gs_sweep_dia"),
                                          ("hpcg16", 4, "gs_sweep"),
                                          ("fem2d_30k", 1, "gs_sweep"),
                                          ("cluster_hpcg16", 1, "gs_sweep")])
def test_gs_sweep_route_and_its_launch_counter(dia_handles, monkeypatch, case, k, route):
    """An apply on a plan with the layout and a vector b launches
    ``gs_sweep_dia`` once and ``gs_sweep`` never; a multivector b, and a
    plan without the layout, the other way round.  A ``GsPrec`` apply (the
    cell's) counts the same."""
    from tpukk_torch import _kernels
    h, At = dia_handles[case]
    monkeypatch.setattr(_kernels, "on_cuda", lambda t, name: True)
    monkeypatch.setattr(_kernels, "library", lambda name: _FakeGsLibrary())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    b = torch.ones((At.nrows,) if k == 1 else (At.nrows, k), dtype=torch.float64)
    gs_cuda.reset_launch_counts()
    gauss_seidel_apply(h, At, None, b)
    assert gs_cuda.launch_counts() == {"gs_color_step": 0, "gs_sweep": int(route == "gs_sweep"),
                                       "gs_sweep_dia": int(route == "gs_sweep_dia")}
    if k == 1:
        GsPrec(h, At).apply(b)
        assert gs_cuda.launch_counts()[route] == 2 and sum(gs_cuda.launch_counts().values()) == 2
    gs_cuda.reset_launch_counts()
