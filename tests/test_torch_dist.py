"""tpukk_torch.dist against tpukk.dist on the CPU (mirrors tests/test_dist.py
case for case, plus the plan builders).

The port runs on gloo across 4 CPU ranks (one ``ranks.RankPool`` for the
module, spawned once); tpukk runs on ``Mesh(devs[:4])`` of tests/conftest.py's
8 virtual devices.  The same seeded numpy inputs go to both.  Each rank gets
its shard of the plan and of every vector (``ranks.call_sharded``); the test
joins the ranks' shards and holds them to tpukk's whole vector:

* the plans exactly (partition, import lists, the K3 plans' local CSRs);
* SpMV within 20·eps·(|A||x|) elementwise;
* PCG and GMRES: iteration counts equal or within one (GMRES: one restart
  cycle), x within the solve tolerance of tpukk's and of the true solution;
* the GS sweeps within (n_c+1)·eps·(|A||x|+|b|) of tpukk's per sweep
  (n_c the colors).

The children import only torch, numpy, scipy and tpukk_torch: the jobs are
package functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from jax.sharding import Mesh

import tpukk.dist as jd
from tpukk.containers import CsrMatrix as JCsr
from tpukk.containers import generate_diag_dominant_csr as j_diag_dominant
from tpukk.containers import generate_structured_laplacian as j_laplacian
from tpukk.dist import gt_spmv as jgt
from tpukk.dist import halo as jhalo
import torch_dist_jobs
from tpukk_torch import dist as td
from tpukk_torch.common import TpuKKError
from tpukk_torch.containers import CsrMatrix as TCsr
from tpukk_torch.dist import gt_spmv as tgt
from tpukk_torch.dist import ranks

P = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices())
    assert devs.size >= P, "conftest must provide >=4 virtual devices"
    return Mesh(devs[:P], ("parts",))


@pytest.fixture(scope="module")
def pool():
    with ranks.RankPool(P, timeout=120.0) as p:
        yield p


def run(pool, entry, plan, vectors=(), **kw):
    """The entry point on every rank; its per-rank results."""
    return pool.run(ranks.call_sharded, entry, plan, list(vectors), device=CPU, **kw)


def joined(pool, entry, plan, vectors=(), **kw):
    return np.concatenate(run(pool, entry, plan, vectors, **kw))


def _pad(v, total):
    out = np.zeros(total, v.dtype)
    out[: v.shape[0]] = v
    return out


def both(sp):
    """The same scipy matrix as a tpukk and a port CsrMatrix."""
    sp = sps.csr_matrix(sp)
    sp.sort_indices()
    return JCsr.from_scipy(sp), TCsr.from_scipy(sp, device=CPU)


def _spmv_bound(sp, x, dtype):
    return 20 * np.finfo(dtype).eps * (abs(sp) @ np.abs(x.astype(np.float64)))


def _hold_spmv(y, ref, sp, x, dtype):
    assert y.shape == ref.shape
    assert (np.abs(y.astype(np.float64) - ref) <= _spmv_bound(sp, x, dtype) + 1e-300).all()


def test_dist_spmv_matches_scipy(mesh, pool, rng):
    JA = j_laplacian(20, 15, dtype=np.float64)
    JA, TA = both(JA.to_scipy())
    jplan = jd.partition_rows(JA, P)
    tplan = td.partition_rows(TA, P)
    for f in ("cols", "vals", "row_valid"):
        np.testing.assert_array_equal(getattr(tplan, f), np.asarray(getattr(jplan, f)))
    x = rng.standard_normal(JA.ncols)
    xp = _pad(x, tplan.padded_rows)
    y = joined(pool, "dist_spmv", tplan, [xp])[: JA.nrows]
    ref = np.asarray(jd.dist_spmv(jd.shard_partition(jplan, mesh), xp, mesh))[: JA.nrows]
    sp = JA.to_scipy()
    _hold_spmv(y, ref, sp, x, np.float64)
    _hold_spmv(y, sp @ x, sp, x, np.float64)


def test_dist_dot(mesh, pool, rng):
    x = rng.standard_normal(64)
    y = rng.standard_normal(64)
    got = run(pool, "dist_dot", None, [x, y])
    ref = float(np.asarray(jd.dist_dot(x, y, mesh)))
    assert len(set(got)) == 1  # the same on every rank
    assert abs(got[0] - ref) <= 64 * np.finfo(np.float64).eps * np.abs(x * y).sum()
    assert abs(got[0] - np.dot(x, y)) < 1e-10


def test_dist_cg_converges(mesh, pool, rng):
    JA, TA = both(j_laplacian(16, 16, dtype=np.float64).to_scipy())
    tplan = td.partition_rows(TA, P)
    jplan = jd.shard_partition(jd.partition_rows(JA, P), mesh)
    b = rng.standard_normal(JA.nrows)
    bp = _pad(b, tplan.padded_rows)
    state = (np.zeros_like(bp), bp.copy(), bp.copy(), float(bp @ bp))
    jstate = state
    step = jax.jit(lambda s: jd.dist_cg_step(jplan, s, mesh))
    r0 = np.linalg.norm(b)
    for _ in range(50):
        outs = run(pool, "dist_cg_step", tplan, [state])
        state = tuple(np.concatenate([o[i] for o in outs]) for i in range(3)) + (outs[0][3],)
        jstate = step(jstate)
    assert np.sqrt(state[1] @ state[1]) < 1e-6 * r0
    # the iterates stay within rounding of tpukk's
    assert np.abs(state[0] - np.asarray(jstate[0])).max() < 1e-8 * np.abs(state[0]).max()


def _pcg_pair(pool, mesh, jplan, tplan, b, **kw):
    """(port (x, iters, rel), tpukk's) for one solve."""
    jinv = kw.pop("jinv", None)
    outs = run(pool, "dist_pcg", tplan, [b], **kw)
    x = np.concatenate([o[0] for o in outs])
    assert len({(o[1], o[2]) for o in outs}) == 1  # the same counts on every rank
    jkw = dict(kw)
    if "inv_diag" in jkw:
        jkw["inv_diag"] = jnp.asarray(jinv)
    jx, jit, jrel = jd.dist_pcg(jplan, jnp.asarray(b), mesh, **jkw)
    return (x, outs[0][1], outs[0][2]), (np.asarray(jx), int(jit), float(jrel))


class TestDistPcg:
    def test_full_solve_matches_scipy(self, mesh, pool, rng):
        import scipy.sparse.linalg as spla

        JA, TA = both(j_laplacian(16, 16, dtype=np.float64).to_scipy())
        tplan = td.partition_rows(TA, P)
        jplan = jd.shard_partition(jd.partition_rows(JA, P), mesh)
        b = np.zeros(tplan.padded_rows)
        b[:JA.nrows] = rng.standard_normal(JA.nrows)
        (x, it, rel), (jx, jit, jrel) = _pcg_pair(pool, mesh, jplan, tplan, b, tol=1e-10,
                                                 max_iters=500)
        assert abs(it - jit) <= 1
        assert rel < 1e-9
        ref = spla.spsolve(JA.to_scipy().tocsc(), b[:JA.nrows])
        np.testing.assert_allclose(x[:JA.nrows], ref, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(x, jx, rtol=1e-8, atol=1e-10)

    def test_jacobi_precond_reduces_iters(self, mesh, pool, rng):
        A0 = j_diag_dominant(200, 4, dtype=np.float64, seed=6)
        sp = A0.to_scipy()
        sp = ((sp + sp.T) * 0.5 + sps.diags(np.full(200, 4.0))).tocsr()
        JA, TA = both(sp)
        tplan = td.partition_rows(TA, P)
        jplan = jd.shard_partition(jd.partition_rows(JA, P), mesh)
        b = np.zeros(tplan.padded_rows)
        b[:JA.nrows] = rng.standard_normal(JA.nrows)
        dinv = np.zeros(tplan.padded_rows)
        dinv[:JA.nrows] = 1.0 / sp.diagonal()
        (x1, it1, rel1), (_, jit1, _) = _pcg_pair(pool, mesh, jplan, tplan, b, tol=1e-10,
                                                 max_iters=400)
        (x2, it2, rel2), (jx2, jit2, _) = _pcg_pair(pool, mesh, jplan, tplan, b, tol=1e-10,
                                                   max_iters=400, inv_diag=dinv, jinv=dinv)
        assert rel2 < 1e-9
        assert it2 <= it1
        assert abs(it1 - jit1) <= 1 and abs(it2 - jit2) <= 1
        np.testing.assert_allclose(x2, jx2, rtol=1e-8, atol=1e-10)

    def test_halo_plan_variant(self, mesh, pool, rng):
        JA, TA = both(j_laplacian(12, 12, dtype=np.float64).to_scipy())
        tplan = td.build_halo_plan(TA, P)
        jplan = jd.shard_halo_plan(jd.build_halo_plan(JA, P), mesh)
        b = np.zeros(tplan.padded_rows)
        b[:JA.nrows] = rng.standard_normal(JA.nrows)
        (x, it, rel), (jx, jit, _) = _pcg_pair(pool, mesh, jplan, tplan, b, tol=1e-9,
                                              max_iters=600)
        assert rel < 1e-8 and abs(it - jit) <= 1
        r = JA.to_scipy() @ x[:JA.nrows] - b[:JA.nrows]
        assert np.linalg.norm(r) / np.linalg.norm(b[:JA.nrows]) < 1e-7
        np.testing.assert_allclose(x, jx, rtol=1e-7, atol=1e-9)


class TestDistGmres:
    def test_allgather_schedule(self, mesh, pool, rng):
        A0 = j_diag_dominant(120, 6, dtype=np.float64, seed=5)
        JA, TA = both(A0.to_scipy())
        tplan = td.partition_rows(TA, P)
        jplan = jd.shard_partition(jd.partition_rows(JA, P), mesh)
        b = rng.standard_normal(JA.nrows)
        bp = _pad(b, tplan.padded_rows)
        outs = run(pool, "dist_gmres", tplan, [bp], m=20, tol=1e-10, max_restarts=30)
        x = np.concatenate([o[0] for o in outs])
        it, rel = outs[0][1], outs[0][2]
        jx, jit, jrel = jd.dist_gmres(jplan, jnp.asarray(bp), mesh, m=20, tol=1e-10,
                                      max_restarts=30)
        assert rel <= 1e-10 and abs(it - jit) <= 20
        res = JA.to_scipy() @ x[:JA.nrows] - b
        assert np.abs(res).max() < 1e-8 * max(1, np.abs(b).max())
        np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-8, atol=1e-9)

    def test_halo_schedule_jacobi_prec(self, mesh, pool, rng):
        sp = j_laplacian(16, 12, dtype=np.float64).to_scipy().tocsr()
        sp.setdiag(sp.diagonal() + 1.0)
        JA, TA = both(sp)
        tplan = td.build_halo_plan(TA, P)
        jplan = jd.shard_halo_plan(jd.build_halo_plan(JA, P), mesh)
        rpp = tplan.rows_per_part
        b = rng.standard_normal(JA.nrows)
        bp = _pad(b, P * rpp)
        invd = _pad(1.0 / sp.diagonal(), P * rpp)
        outs = run(pool, "dist_gmres", tplan, [bp], m=25, tol=1e-9, max_restarts=40,
                   inv_diag=invd)
        x = np.concatenate([o[0] for o in outs])
        it, rel = outs[0][1], outs[0][2]
        jx, jit, jrel = jd.dist_gmres(jplan, jnp.asarray(bp), mesh, m=25, tol=1e-9,
                                      max_restarts=40, inv_diag=jnp.asarray(invd))
        assert rel <= 1e-9 and abs(it - jit) <= 25
        res = sp @ x[:JA.nrows] - b
        assert np.abs(res).max() < 1e-7 * max(1, np.abs(b).max())
        np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-7, atol=1e-8)


def _gt_plans(JA, TA):
    """(port host plan, tpukk's sharded plan) of the K3 schedule."""
    tplan = td.build_dist_gt_plan(TA, P)
    jplan = jd.build_dist_gt_plan(JA, P)
    assert jplan is not None and type(tplan).__name__ == type(jplan).__name__
    return tplan, jplan


def _gt_spmv_case(mesh, pool, rng, sp):
    JA, TA = both(sp)
    tplan, jplan = _gt_plans(JA, TA)
    x = rng.standard_normal(JA.ncols).astype(sp.dtype)
    xp = _pad(x, tplan.padded_rows)
    y = joined(pool, "dist_spmv_gt", tplan, [xp])[: JA.nrows]
    mesh_plan = jd.shard_dist_gt_plan(jplan, mesh)
    ref = np.asarray(jd.dist_spmv_gt(mesh_plan, jnp.asarray(xp), mesh))[: JA.nrows]
    _hold_spmv(y, ref.astype(np.float64), sp, x, sp.dtype)
    _hold_spmv(y, sp.astype(np.float64) @ x.astype(np.float64), sp, x, sp.dtype)
    return tplan, jplan


class TestDistGt:
    """The K3 schedule (gt_spmv.py): K3's plain version on the CPU ranks,
    tpukk's gather-table kernels in interpret mode."""

    def test_structured_matches_scipy(self, mesh, pool, rng):
        _gt_spmv_case(mesh, pool, rng, j_laplacian(40, 40, dtype=np.float32).to_scipy())

    def test_unstructured_matches_scipy(self, mesh, pool, rng):
        n, deg = 3000, 7
        r = np.repeat(np.arange(n), deg)
        c = rng.integers(0, n, n * deg)
        sp = sps.csr_matrix((rng.standard_normal(n * deg).astype(np.float32), (r, c)),
                            shape=(n, n))
        sp.sum_duplicates()
        _gt_spmv_case(mesh, pool, rng, sp)

    def test_pcg_through_gt_plan(self, mesh, pool, rng):
        JA, TA = both(j_laplacian(24, 24, dtype=np.float32).to_scipy())
        tplan, jplan = _gt_plans(JA, TA)
        b = np.zeros(tplan.padded_rows, np.float32)
        b[: JA.nrows] = rng.standard_normal(JA.nrows)
        (x, it, rel), (jx, jit, jrel) = _pcg_pair(
            pool, mesh, jd.shard_dist_gt_plan(jplan, mesh), tplan, b, tol=1e-5, max_iters=600)
        assert rel < 1e-4 and abs(it - jit) <= 1
        r = JA.to_scipy() @ x[: JA.nrows] - b[: JA.nrows]
        assert np.linalg.norm(r) / np.linalg.norm(b[: JA.nrows]) < 1e-3
        assert np.abs(x - jx).max() < 1e-3 * np.abs(jx).max()


class TestDistGtUneven:
    """n not divisible by the parts (padded tail rows)."""

    def test_non_divisible_rows(self, mesh, pool, rng):
        sp = j_laplacian(37, 37, dtype=np.float32).to_scipy()  # 1369
        assert sp.shape[0] % P != 0
        _gt_spmv_case(mesh, pool, rng, sp)

    def test_gs_gt_non_divisible(self, mesh, pool, rng):
        from jax.sharding import NamedSharding, PartitionSpec as JP

        JA, TA = both(j_laplacian(21, 21, dtype=np.float32).to_scipy())  # 441
        tplan = td.build_dist_gs_gt_plan(TA, P)
        jplan = jd.build_dist_gs_gt_plan(JA, P)
        spec = NamedSharding(mesh, JP("parts"))
        jplan = jax.tree_util.tree_map(lambda a: jax.device_put(a, spec), jplan)
        n = JA.nrows
        b = np.zeros(tplan.padded_rows, np.float32)
        b[:n] = rng.standard_normal(n).astype(np.float32)
        x0 = np.zeros(tplan.padded_rows, np.float32)
        x = joined(pool, "dist_gs_sweep", tplan, [x0, b], num_sweeps=2)
        jx = np.asarray(jd.dist_gs_sweep(jplan, jnp.asarray(x0), jnp.asarray(b), mesh,
                                         num_sweeps=2))
        sp = JA.to_scipy()
        assert np.linalg.norm(sp @ x[:n] - b[:n]) < np.linalg.norm(b[:n])
        # the same colors (VB on both sides), so the same iterate up to rounding
        assert np.abs(x[:n] - jx[:n]).max() < 1e-5 * max(1.0, np.abs(jx).max())


def test_multipart_accounting_traffic_scales_linearly():
    """The neighbour plan's exchange traffic scales O(P·H), and the port's
    accounting equals tpukk's but for the stream padding (none here)."""
    JA, TA = both(j_laplacian(120, 120, dtype=np.float32).to_scipy())
    acc = {}
    for p in (2, 4, 8):
        plan = td.build_dist_gt_plan2(TA, p)
        assert plan is not None
        acc[p] = td.dist_plan_accounting(plan)
        ref = jd.dist_plan_accounting(jd.build_dist_gt_plan2(JA, p))
        assert {k: v for k, v in acc[p].items() if k != "stream_pad_ratio"} == \
            {k: v for k, v in ref.items() if k != "stream_pad_ratio"}
    h4, h8 = acc[4]["halo_per_part"], acc[8]["halo_per_part"]
    assert h8 <= 1.5 * h4
    b4, b8 = acc[4]["bytes_exchanged"], acc[8]["bytes_exchanged"]
    assert b8 <= 2.8 * b4, (b4, b8)
    assert b8 >= 1.2 * b4
    for p, a in acc.items():
        assert a["stream_pad_ratio"] == 1.0
        assert a["row_pad_ratio"] >= 1.0
        assert a["padded_rows"] >= a["real_rows"]


def test_dist_gs_single_part_degenerates_to_single_device():
    """One part: the plan is the single-device colored GS with the SERIAL
    coloring (K6's fused sweep), equal to gauss_seidel_apply and to tpukk's
    one-part plan.  One rank needs no process group."""
    from tpukk.graph.coloring import ColoringAlgorithm as JCA
    from tpukk.sparse.gauss_seidel import (GsAlgorithm, GsHandle, gauss_seidel_apply,
                                           gauss_seidel_numeric, gauss_seidel_symbolic)

    JA, TA = both(j_laplacian(24, 24, dtype=np.float32).to_scipy())
    gp = td.build_dist_gs_gt_plan(TA, 1)
    assert gp.single is not None and gp.no_remote
    h = GsHandle(algorithm=GsAlgorithm.POINT, coloring=JCA.SERIAL)
    gauss_seidel_symbolic(h, JA)
    gauss_seidel_numeric(h, JA, 1.0)
    b = np.linspace(0.0, 1.0, JA.nrows).astype(np.float32)
    ref = np.asarray(gauss_seidel_apply(h, JA, None, jnp.asarray(b), 2, "symmetric"))
    shard = td.shard_dist_gs_plan(gp, rank=0, device=CPU)
    bpad = _pad(b, gp.padded_rows)
    xd = td.dist_gs_sweep(shard, torch.zeros(gp.padded_rows), torch.from_numpy(bpad),
                          num_sweeps=2)
    np.testing.assert_allclose(xd.numpy()[:JA.nrows], ref, rtol=1e-6, atol=1e-6)
    # the permuted layout: the same iterate through to_internal / to_natural
    jgp = jd.build_dist_gs_gt_plan(JA, 1)
    np.testing.assert_array_equal(gp.to_perm_idx[:JA.nrows], np.asarray(jgp.to_perm_idx)[
        :JA.nrows])


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_gt_plans_equal_tpukk(parts):
    """The K3 plans' exchange schedules and local CSRs (rows over x_ext, the
    interior/boundary split) equal tpukk's arrays, uneven n included."""
    sp = j_laplacian(37, 29, dtype=np.float32).to_scipy()
    JA, TA = both(sp)
    rm = np.asarray(JA.host_row_map(), np.int64)
    ent = np.asarray(JA.host_entries(), np.int64)
    vals = np.asarray(JA.host_values())
    n = JA.nrows
    plan = tgt.build_dist_gt_plan(TA, parts)
    rpp = plan.rows_per_part
    if isinstance(plan, tgt.DistGtPlan2):
        offsets, send_lists, rem_cols, rem_ids, H_off = jhalo.neighbor_import(
            rm, ent, n, parts, rpp)
        assert list(plan.offsets) == list(offsets) and plan.halo_total == sum(H_off)
        for got, ref in zip(plan.send_lists, send_lists):
            np.testing.assert_array_equal(got, ref)
        for p in range(parts):
            ji, jb = jgt._local_split_csrs(rm, ent, vals, p, n, rpp, rem_cols[p], rem_ids[p])
            for got, ref in ((plan.int_csr[p], ji), (plan.bnd_csr[p], jb)):
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g, r)
    else:
        send_idx, rem_cols, rem_ids, H = jhalo.import_index(rm, ent, n, parts, rpp)
        np.testing.assert_array_equal(plan.send_idx, send_idx)
        assert plan.halo == H and plan.ncols_ext == rpp + parts * H
        for p in range(parts):
            ref = jgt._local_csr_of_part(rm, ent, vals, p, n, rpp, rem_cols[p], rem_ids[p])
            for g, r in zip(plan.local_csr[p], ref):
                np.testing.assert_array_equal(g, r)


def test_all_to_all_plan_at_four_parts(mesh, pool, rng):
    """DistGtPlan (the padded all_to_all schedule) at four parts, where
    build_dist_gt_plan takes the neighbour plan: tpukk's import arrays and
    local CSRs, and y = A·x as tpukk's neighbour plan gives it."""
    sp = j_laplacian(37, 37, dtype=np.float32).to_scipy()
    JA, TA = both(sp)
    plan = tgt.build_all_to_all_plan(TA, P)
    rm = np.asarray(JA.host_row_map(), np.int64)
    ent = np.asarray(JA.host_entries(), np.int64)
    send_idx, rem_cols, rem_ids, H = jhalo.import_index(rm, ent, JA.nrows, P,
                                                        plan.rows_per_part)
    np.testing.assert_array_equal(plan.send_idx, send_idx)
    assert plan.halo == H and not plan.no_remote
    for p in range(P):
        ref = jgt._local_csr_of_part(rm, ent, np.asarray(JA.host_values()), p, JA.nrows,
                                     plan.rows_per_part, rem_cols[p], rem_ids[p])
        for g, r in zip(plan.local_csr[p], ref):
            np.testing.assert_array_equal(g, r)
    x = rng.standard_normal(JA.ncols).astype(np.float32)
    xp = _pad(x, plan.padded_rows)
    y = joined(pool, "dist_spmv_gt", plan, [xp])[: JA.nrows]
    ref = np.asarray(jd.dist_spmv_gt(jd.shard_dist_gt_plan(jd.build_dist_gt_plan(JA, P), mesh),
                                     jnp.asarray(xp), mesh))[: JA.nrows]
    _hold_spmv(y, ref.astype(np.float64), sp, x, np.float32)


def test_exports_match_tpukk():
    """tpukk_torch.dist exports the 29 names of tpukk.dist, and the package
    exports dist."""
    import tpukk_torch

    assert sorted(td.__all__) == sorted(jd.__all__) and len(td.__all__) == 29
    assert all(hasattr(td, n) for n in td.__all__)
    assert "dist" in tpukk_torch.__all__


# ---- PCG with the distributed multicolor Gauss-Seidel (DistGsPrec) --------

def _hpcg_tiny():
    """HPCG's 27-point operator on a 2 × 2 × 1 process grid of 6 × 5 × 4
    boxes (kkbench's builder), the parts in rank order: the port's K3 and
    Gauss-Seidel plans of the whole (SERIAL colors), and the SciPy matrix."""
    from kkbench.harness import concat_parts
    from kkbench.matrices import stencil27
    from tpukk_torch.graph import ColoringAlgorithm

    cfg = {"nx": 6, "ny": 5, "nz": 4, "diagonal": 26.0, "offdiagonal": -1.0,
           "dtype": "float64", "process_grid": [2, 2, 1]}
    whole = concat_parts([stencil27.build_part(cfg, "cpu", r, P) for r in range(P)])
    sp = sps.csr_matrix((whole["values"].numpy(), whole["entries"].numpy(),
                         whole["row_map"].numpy()), shape=(whole["nrows"], whole["ncols"]))
    TA = TCsr.from_scipy(sp, device=CPU)
    gs = td.build_dist_gs_gt_plan(TA, P, coloring=ColoringAlgorithm.SERIAL)
    plan = td.build_dist_gt_plan(TA, P)
    assert gs.rows_per_part == plan.rows_per_part == sp.shape[0] // P
    return plan, gs, sp


def _ref_prec(sp, colors):
    from kkbench.reference import prec_symgs

    return prec_symgs.Reference(sp, {"colors": colors}, "cpu", torch.float64)


def test_dist_gs_prec_is_the_global_colored_sweep(pool, rng):
    """DistGsPrec.apply on four ranks equals the plain global multicolor
    symmetric sweep from zero in the plan's colors (the benchmark's
    reference) within 1e-12 relative; its colors are a distance-1 coloring
    of the whole matrix."""
    from kkbench.reference import prec_symgs

    _, gs, sp = _hpcg_tiny()
    r = rng.standard_normal(sp.shape[0])
    outs = pool.run(torch_dist_jobs.gs_apply, gs, r)
    z = np.concatenate([o[0] for o in outs])
    colors = np.concatenate([o[1] for o in outs])
    assert prec_symgs.conflicts(sp, colors) == 0 and colors.max() == gs.num_colors
    z_ref = _ref_prec(sp, colors).apply(torch.from_numpy(r)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-12 * np.abs(z_ref).max()


def _gs_pcg(pool, rng, check_every=10):
    plan, gs, sp = _hpcg_tiny()
    b = sp @ rng.standard_normal(sp.shape[0])
    outs = pool.run(torch_dist_jobs.gs_pcg, plan, gs, b, tol=1e-8, max_iters=500,
                    check_every=check_every)
    assert len({(o[1], o[2]) for o in outs}) == 1  # every rank alike
    return plan, gs, sp, b, outs


def test_dist_pcg_with_gs_prec_matches_the_reference(pool, rng):
    """dist_pcg(prec=DistGsPrec, check_every=10) converges to 1e-8 in the
    iterations of the benchmark's plain PCG with the plain sweep."""
    from kkbench.reference import csr, pcg

    plan, gs, sp, b, outs = _gs_pcg(pool, rng)
    x = np.concatenate([o[0] for o in outs])
    its, rel = outs[0][1], outs[0][2]
    assert rel <= 1e-8 and its % 10 == 0
    colors = np.concatenate([o[4] for o in outs])
    bt = torch.from_numpy(b)
    x_ref, its_ref, ok = pcg.solve(csr.to_torch(sp, "cpu", torch.float64), bt,
                                   _ref_prec(sp, colors).apply, 1e-8,
                                   {"check_every": 10, "max_iters": 500})
    assert ok and its == its_ref
    assert np.linalg.norm(sp @ x - b) <= 1e-8 * np.linalg.norm(b) * 1.01
    assert np.abs(x - x_ref.numpy()).max() <= 1e-8 * np.abs(x_ref.numpy()).max()


def test_dist_pcg_jacobi_unchanged_bit_for_bit(pool, rng):
    """With inv_diag and check_every 1, dist_pcg gives bit for bit what its
    loop gave before it took prec and check_every."""
    plan, _, sp = _hpcg_tiny()
    b = rng.standard_normal(sp.shape[0])
    outs = pool.run(torch_dist_jobs.jacobi_pcg_now_and_before, plan, b,
                    1.0 / sp.diagonal(), 1e-10, 300)
    for (x, its, rel), (x0, its0, rel0) in outs:
        assert its == its0 and rel == rel0 and np.array_equal(x, x0)
    assert outs[0][0][2] <= 1e-10


def test_dist_pcg_counts_its_halo_exchanges(pool, rng):
    """dist.halo_exchanges: 2 × colors a preconditioner apply and one a
    SpMV, so 2 × colors + 1 an iteration and the apply before the loop;
    dist.halo_bytes: what those exchanges send to the other ranks."""
    plan, gs, _, _, outs = _gs_pcg(pool, rng)
    colors = gs.num_colors
    for _, its, _, counted, _, _ in outs:
        applies, spmvs = its + 1, its
        assert counted["dist.halo_exchanges"] == (2 * colors + 1) * its + 2 * colors
        gs_bytes = (P - 1) * gs.halo * 8
        spmv_bytes = (plan.halo_total if isinstance(plan, td.DistGtPlan2)
                      else (P - 1) * plan.halo) * 8
        assert counted["dist.halo_bytes"] == 2 * colors * applies * gs_bytes + spmvs * spmv_bytes


@pytest.mark.parametrize("jacobi, fails_on", [
    pytest.param(False, None, id="None"), pytest.param(False, 1, id="1"),
    pytest.param(True, None, id="jacobi-None"), pytest.param(True, 1, id="jacobi-1")])
def test_dist_pcg_graphed_blocks_are_the_blocks(pool, rng, jacobi, fails_on):
    """With a cache of graphs, dist_pcg replays a graph of a block from the
    first solve's second block on, which gives bit for bit the solves of the
    blocks run as they are, and counts the same halo exchanges and bytes;
    where one rank's capture fails, every rank runs its blocks as they are
    (the capture is a stand-in here, off the card).  With DistGsPrec or
    with Jacobi by inv_diag (a new preconditioner object every solve), the
    cache captures once over both solves and counts its blocks under
    dist_pcg.*."""
    plan, gs, sp = _hpcg_tiny()
    bs = [sp @ rng.standard_normal(sp.shape[0]) for _ in range(2)]
    inv_diag = 1.0 / sp.diagonal() if jacobi else None
    outs = pool.run(torch_dist_jobs.graphed_pcg, plan, gs, bs, fails_on=fails_on,
                    inv_diag=inv_diag, tol=1e-8, max_iters=500, check_every=10)
    for (plain, graphed), replayed, captures, counted in outs:
        assert replayed == (fails_on is None) and captures == 1
        for (x, its, rel), (x0, its0, rel0) in zip(graphed[0], plain[0]):
            assert its == its0 and rel == rel0 and rel <= 1e-8 and np.array_equal(x, x0)
        assert graphed[1] == plain[1]
        total = sum(its for _, its, _ in plain[0])
        colors = gs.num_colors
        exchanges = total if jacobi else (2 * colors + 1) * total + 2 * colors * len(bs)
        assert plain[1]["dist.halo_exchanges"] == exchanges
        blocks = total // 10
        assert counted == {"dist_pcg.blocks": blocks,
                           "dist_pcg.graph_replays": blocks - 1 if replayed else 0,
                           "dist_pcg.graph_captures": int(replayed),
                           "dist_pcg.graph_fallbacks": int(not replayed)}


def test_dist_pcg_recaptures_after_a_new_sweep_count(pool, rng):
    """A DistGsPrec whose sweeps change after its block was captured is no
    longer what the graph reads: the next solve with the same cache captures
    anew, and gives bit for bit the eager solve at the new sweep count."""
    plan, gs, sp = _hpcg_tiny()
    b = sp @ rng.standard_normal(sp.shape[0])
    outs = pool.run(torch_dist_jobs.resweep_pcg, plan, gs, b, tol=1e-8, max_iters=500,
                    check_every=10)
    for captures, ((x, its, rel), (x0, its0, rel0)) in outs:
        assert captures == [1, 2]
        assert its == its0 and rel == rel0 and rel <= 1e-8 and np.array_equal(x, x0)


def test_dist_pcg_cleared_graphs_hold_nothing(pool, rng):
    """Once the caller empties its dict of graphs, nothing of the cache is
    left alive (NCCL's teardown waits for every graph that captured its
    collectives), and the next solve captures anew."""
    plan, gs, sp = _hpcg_tiny()
    b = sp @ rng.standard_normal(sp.shape[0])
    outs = pool.run(torch_dist_jobs.cleared_pcg, plan, gs, b, tol=1e-8, max_iters=500,
                    check_every=10)
    assert outs == [(False, [1, 2])] * P


def test_dist_pcg_spans_nest(pool, rng):
    """tpukk::dist_pcg opens a solve; each check_every block is a
    tpukk::dist_pcg.block under it holding one .check; each preconditioner
    apply is a tpukk::dist.gs_apply and each exchange a
    tpukk::dist.halo_exchange inside the sweep or the SpMV."""
    _, gs, _, _, outs = _gs_pcg(pool, rng)
    colors = gs.num_colors
    for _, its, _, _, _, spans in outs:
        names = [n for n, _, _ in spans]
        assert names[0] == "tpukk::dist_pcg" and spans[0][1] is None
        assert all(solve == 1 for _, _, solve in spans)
        blocks = [i for i, n in enumerate(names) if n == "tpukk::dist_pcg.block"]
        assert len(blocks) == its // 10 and all(spans[i][1] == 0 for i in blocks)
        checks = [p for n, p, _ in spans if n == "tpukk::dist_pcg.check"]
        assert checks == blocks
        applies = [p for n, p, _ in spans if n == "tpukk::dist.gs_apply"]
        assert len(applies) == its + 1 and applies[0] == 0 and set(applies[1:]) == set(blocks)
        halo_parents = {names[p] for n, p, _ in spans if n == "tpukk::dist.halo_exchange"}
        assert halo_parents == {"tpukk::dist.dist_gs_sweep", "tpukk::dist.dist_spmv_gt"}
        assert names.count("tpukk::dist.halo_exchange") == (2 * colors + 1) * its + 2 * colors


def test_dist_gs_prec_takes_a_gs_gt_shard():
    """DistGsPrec takes a rank's shard of a DistGsGtPlan; dist_pcg takes one
    preconditioner; a one-part plan's colors are its handle's."""
    from tpukk_torch.dist.gauss_seidel import DistGsPrec

    plan, gs, _ = _hpcg_tiny()
    with pytest.raises(TpuKKError):
        DistGsPrec(gs)
    with pytest.raises(TpuKKError):
        DistGsPrec(td.shard_dist_gs_plan(td.build_dist_gs_plan(TCsr.from_scipy(
            j_laplacian(8, 8, dtype=np.float64).to_scipy(), device=CPU), P), rank=0, device=CPU))
    shard = td.shard_plan(plan, rank=0, device=CPU)
    prec = DistGsPrec(td.shard_dist_gs_plan(gs, rank=0, device=CPU))
    b = torch.ones(plan.rows_per_part, dtype=torch.float64)
    with pytest.raises(TpuKKError):
        td.dist_pcg(shard, b, prec=prec, inv_diag=b)
    sp = j_laplacian(12, 10, dtype=np.float64).to_scipy()
    one = td.build_dist_gs_gt_plan(TCsr.from_scipy(sp, device=CPU), 1)
    prec1 = DistGsPrec(td.shard_dist_gs_plan(one, rank=0, device=CPU))
    colors = prec1.colors()
    assert np.array_equal(colors[:sp.shape[0]], one.single) and not colors[sp.shape[0]:].any()
    r = torch.from_numpy(np.linspace(-1.0, 1.0, one.rows_per_part))
    z = prec1.apply(r).numpy()[:sp.shape[0]]
    z_ref = _ref_prec(sps.csr_matrix(sp), one.single).apply(r[:sp.shape[0]]).numpy()
    assert np.abs(z - z_ref).max() <= 1e-12 * np.abs(z_ref).max()
