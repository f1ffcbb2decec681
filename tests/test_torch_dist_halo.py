"""tpukk_torch.dist's halo SpMV, colored Gauss-Seidel and ring SpGEMM against
tpukk.dist on the CPU (mirrors tests/test_dist_halo.py case for case, plus
the host plans).

The port runs on gloo across 4 CPU ranks (one ``ranks.RankPool`` for the
module); tpukk on ``Mesh(devs[:4])``.  The same seeded numpy inputs go to
both; the tests join the ranks' shards and hold them to tpukk's whole result:

* the host plans (HaloPlan, the import lists, DistGsPlan, the ring's pair
  lists and C pattern) exactly, at 1, 2, 4 and 8 parts, uneven n included;
* SpMV within 20·eps·(|A||x|) elementwise;
* a GS sweep within (w+1)·eps·(|A||x|+|b|)/|diag| elementwise for each of
  its color steps (w the longest row), summed over the steps;
* the ring SpGEMM within (n_c+1)·eps·(|A||B|) elementwise (n_c the products
  of the entry), its pattern exactly; value reuse with 2·A gives exactly
  2·C.
"""
import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import tpukk.dist as jd
from tpukk.containers import CsrMatrix as JCsr
from tpukk.containers import generate_random_csr as j_random
from tpukk.containers import generate_structured_laplacian as j_laplacian
from tpukk.dist import halo as jhalo
from tpukk_torch import dist as td
from tpukk_torch.containers import CsrMatrix as TCsr
from tpukk_torch.dist import halo as thalo
from tpukk_torch.dist import ranks

P = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P]), ("parts",))


@pytest.fixture(scope="module")
def pool():
    with ranks.RankPool(P, timeout=120.0) as p:
        yield p


def run(pool, entry, plan, vectors=(), **kw):
    return pool.run(ranks.call_sharded, entry, plan, list(vectors), device=CPU, **kw)


def joined(pool, entry, plan, vectors=(), **kw):
    return np.concatenate(run(pool, entry, plan, vectors, **kw))


def _pad(v, total):
    out = np.zeros(total, v.dtype)
    out[: v.shape[0]] = v
    return out


def both(sp):
    sp = sps.csr_matrix(sp)
    sp.sort_indices()
    return JCsr.from_scipy(sp), TCsr.from_scipy(sp, device=CPU)


def _hold_spmv(y, ref, sp, x, dtype):
    bound = 20 * np.finfo(dtype).eps * (abs(sp) @ np.abs(x))
    assert y.shape == ref.shape
    assert (np.abs(y - ref) <= bound + 1e-300).all()


def test_halo_spmv_laplacian(mesh, pool, rng):
    JA, TA = both(j_laplacian(20, 15, dtype=np.float64).to_scipy())
    tplan = td.build_halo_plan(TA, P)
    x = rng.standard_normal(JA.ncols)
    xp = _pad(x, tplan.padded_rows)
    y = joined(pool, "dist_spmv_halo", tplan, [xp])[: JA.nrows]
    ref = np.asarray(jd.dist_spmv_halo(jd.shard_halo_plan(jd.build_halo_plan(JA, P), mesh),
                                       xp, mesh))[: JA.nrows]
    sp = JA.to_scipy()
    _hold_spmv(y, ref, sp, x, np.float64)
    _hold_spmv(y, sp @ x, sp, x, np.float64)


def test_halo_spmv_random_square(mesh, pool, rng):
    JA = j_random(90, 90, 5, seed=21, dtype=np.float64)
    JA, TA = both(JA.to_scipy())
    tplan = td.build_halo_plan(TA, P)
    x = rng.standard_normal(90)
    xp = _pad(x, tplan.padded_rows)
    y = joined(pool, "dist_spmv_halo", tplan, [xp])[:90]
    ref = np.asarray(jd.dist_spmv_halo(jd.shard_halo_plan(jd.build_halo_plan(JA, P), mesh),
                                       xp, mesh))[:90]
    sp = JA.to_scipy()
    _hold_spmv(y, ref, sp, x, np.float64)
    _hold_spmv(y, sp @ x, sp, x, np.float64)


def _sweep_bound(sp, x, b, dtype, steps):
    """(w+1)·eps·(|A||x|+|b|)/|diag| a color step, times the steps."""
    w = int(np.diff(sp.indptr).max())
    d = np.abs(sp.diagonal())
    return steps * (w + 1) * np.finfo(dtype).eps * (abs(sp) @ np.abs(x) + np.abs(b)) / d


def test_dist_gs_error_decreases(mesh, pool):
    rng = np.random.default_rng(7)  # local: the rate threshold is draw-sensitive
    sp = j_laplacian(16, 16, dtype=np.float64).to_scipy()
    sp.setdiag(sp.diagonal() + 1.0)
    JA, TA = both(sp.tocsr())
    tplan = td.build_dist_gs_plan(TA, P)
    jplan = jd.shard_dist_gs_plan(jd.build_dist_gs_plan(JA, P), mesh)
    x_true = rng.standard_normal(JA.nrows)
    b = sp @ x_true
    bp = _pad(b, tplan.padded_rows)
    x = jx = np.zeros(tplan.padded_rows)
    errs = []
    for _ in range(5):
        x = joined(pool, "dist_gs_sweep", tplan, [x, bp], num_sweeps=1, direction="symmetric")
        jx = np.asarray(jd.dist_gs_sweep(jplan, jx, bp, mesh, 1, "symmetric"))
        errs.append(np.linalg.norm(x[: JA.nrows] - x_true))
        bound = _sweep_bound(sp, x[: JA.nrows], b, np.float64, 2 * tplan.num_colors)
        assert (np.abs(x[: JA.nrows] - jx[: JA.nrows]) <= bound).all()
    assert all(b < a for a, b in zip(errs, errs[1:]))
    assert errs[-1] < 0.1 * errs[0]


def test_dist_gs_matches_single_device(pool, rng):
    """The distributed colored GS gives the single-device colored GS's
    iterate under the same (VB) coloring, within rounding."""
    from tpukk_torch.graph import ColoringAlgorithm
    from tpukk_torch.sparse import (GsAlgorithm, GsHandle, gauss_seidel_apply,
                                    gauss_seidel_numeric, gauss_seidel_symbolic)

    sp = j_laplacian(12, 12, dtype=np.float64).to_scipy()
    sp.setdiag(sp.diagonal() + 0.5)
    _, TA = both(sp.tocsr())
    b = rng.standard_normal(TA.nrows)
    gh = GsHandle(GsAlgorithm.POINT, ColoringAlgorithm.VB)
    gauss_seidel_symbolic(gh, TA)
    gauss_seidel_numeric(gh, TA)
    x_ref = gauss_seidel_apply(gh, TA, None, torch.from_numpy(b), 2, "forward").numpy()
    tplan = td.build_dist_gs_plan(TA, P, coloring=ColoringAlgorithm.VB)
    x = joined(pool, "dist_gs_sweep", tplan, [np.zeros(tplan.padded_rows),
                                              _pad(b, tplan.padded_rows)],
               num_sweeps=2, direction="forward")[: TA.nrows]
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)


def _ring_bound(A, B, dtype):
    """(n_c+1)·eps·(|A||B|) on C's pattern, n_c the products of each entry."""
    ones = lambda m: sps.csr_matrix((np.ones(m.nnz), m.indices, m.indptr), shape=m.shape)
    n_c = (ones(A) @ ones(B)).tocsr()
    mag = (abs(A) @ abs(B)).tocsr()
    n_c.sort_indices()
    mag.sort_indices()
    return n_c, (n_c.data + 1) * np.finfo(dtype).eps * mag.data


def _hold_ring(Cs, A, B, ref, dtype):
    pat, bound = _ring_bound(A, B, dtype)
    Cs.sort_indices()
    np.testing.assert_array_equal(Cs.indptr, pat.indptr)
    np.testing.assert_array_equal(Cs.indices, pat.indices)
    ref = ref.tocsr()
    ref.sort_indices()
    assert (np.abs(Cs.data - np.asarray(ref[pat.nonzero()]).reshape(-1)) <= bound).all()


def test_ring_spgemm(mesh, pool):
    JA = j_random(40, 60, 4, seed=1, dtype=np.float64)
    JB = j_random(60, 30, 3, seed=2, dtype=np.float64)
    (JA, TA), (JB, TB) = both(JA.to_scipy()), both(JB.to_scipy())
    tplan = td.build_ring_spgemm_plan(TA, TB, P)
    got = run(pool, "ring_spgemm_numeric", tplan)
    assert all((g != got[0]).nnz == 0 for g in got)  # the whole C on every rank
    C = jd.ring_spgemm_numeric(jd.shard_ring_spgemm_plan(jd.build_ring_spgemm_plan(JA, JB, P),
                                                          mesh), mesh)
    A, B = JA.to_scipy(), JB.to_scipy()
    _hold_ring(got[0], A, B, C.to_scipy(), np.float64)
    _hold_ring(got[0], A, B, A @ B, np.float64)
    plain = run(pool, "ring_spgemm_numeric", tplan, plain=True)[0]
    _hold_ring(plain, A, B, got[0], np.float64)


def test_ring_spgemm_value_reuse(mesh, pool):
    JA = j_random(30, 30, 3, seed=3, dtype=np.float64)
    JA, TA = both(JA.to_scipy())
    tplan = td.build_ring_spgemm_plan(TA, TA, P)
    C1 = run(pool, "ring_spgemm_numeric", tplan)[0]
    plan2 = dataclasses.replace(tplan, a_vals_pad=tplan.a_vals_pad * 2.0,
                                b_vals_pad=tplan.b_vals_pad * 3.0)
    C2 = run(pool, "ring_spgemm_numeric", plan2)[0]
    np.testing.assert_allclose(C2.data, 6 * C1.data, rtol=1e-12)
    plan3 = dataclasses.replace(tplan, a_vals_pad=tplan.a_vals_pad * 2.0)
    C3 = run(pool, "ring_spgemm_numeric", plan3)[0]
    np.testing.assert_array_equal(C3.data, 2 * C1.data)
    jplan = jd.shard_ring_spgemm_plan(jd.build_ring_spgemm_plan(JA, JA, P), mesh)
    jplan2 = dataclasses.replace(jplan, a_vals_pad=jplan.a_vals_pad * 2.0,
                                 b_vals_pad=jplan.b_vals_pad * 3.0)
    A = JA.to_scipy()
    _hold_ring(C2, 2 * A, 3 * A, jd.ring_spgemm_numeric(jplan2, mesh).to_scipy(), np.float64)


def test_dist_gs_gt_matches_ell_sweep(mesh, pool, rng):
    """The K6 sweep (DistGsGtPlan) equals the ELL sweep (DistGsPlan) under
    the same coloring, and tpukk's gather-table sweep, within rounding."""
    JA, TA = both(j_laplacian(20, 20, dtype=np.float32).to_scipy())
    n = JA.nrows
    gp = td.build_dist_gs_gt_plan(TA, P)
    ep = td.build_dist_gs_plan(TA, P)
    b = np.zeros(gp.padded_rows, np.float32)
    b[:n] = rng.standard_normal(n).astype(np.float32)
    x0 = np.zeros(gp.padded_rows, np.float32)
    xg = joined(pool, "dist_gs_sweep", gp, [x0, b], num_sweeps=2)
    xe = joined(pool, "dist_gs_sweep", ep, [x0, b], num_sweeps=2)
    sp = JA.to_scipy()
    bound = _sweep_bound(sp.astype(np.float64), np.abs(xe[:n]).astype(np.float64), b[:n],
                         np.float32, 4 * ep.num_colors)
    assert (np.abs(xg[:n] - xe[:n]) <= bound).all()
    spec = NamedSharding(mesh, JP("parts"))
    jgp = jax.tree_util.tree_map(lambda a: jax.device_put(a, spec),
                                 jd.build_dist_gs_gt_plan(JA, P))
    jx = np.asarray(jd.dist_gs_sweep(jgp, x0, b, mesh, num_sweeps=2))
    assert (np.abs(xg[:n] - jx[:n]) <= bound).all()
    assert np.linalg.norm(sp @ xg[:n] - b[:n]) < np.linalg.norm(b[:n])
    # chained sweeps in the permuted layout give the natural ones
    xp = joined(pool, "dist_gs_sweep", gp, [gp.to_internal(x0).numpy(),
                                            gp.to_internal(b).numpy()], num_sweeps=2,
                permuted=True)
    np.testing.assert_array_equal(gp.to_natural(xp).numpy(), xg)


def test_ring_spgemm_f32_k8_steps(mesh, pool):
    """f32 ring: every step's local product is K8 (its plain version on the
    CPU), against tpukk's pair-kernel ring and scipy."""
    JA = j_random(60, 60, 4, seed=7, dtype=np.float32)
    JA, TA = both(JA.to_scipy())
    tplan = td.build_ring_spgemm_plan(TA, TA, P)
    assert tplan.pk_meta is None and tplan.pk_streams is None  # TPU streams not carried
    C = run(pool, "ring_spgemm_numeric", tplan)[0]
    jC = jd.ring_spgemm_numeric(jd.shard_ring_spgemm_plan(jd.build_ring_spgemm_plan(JA, JA, P),
                                                           mesh), mesh)
    A = JA.to_scipy()
    _hold_ring(C, A, A, jC.to_scipy().astype(np.float64), np.float32)
    _hold_ring(C, A, A, A.astype(np.float64) @ A.astype(np.float64), np.float32)


def test_neighbor_import_schedule():
    """neighbor_import: a 1-D partitioned banded matrix has exactly the ±1
    part offsets, and the port's schedule equals tpukk's array for array."""
    JA, TA = both(j_laplacian(40, 40, dtype=np.float32).to_scipy())
    rm = JA.host_row_map().astype(np.int64)
    ent = JA.host_entries().astype(np.int64)
    n, parts = JA.nrows, 8
    rpp = -(-n // parts)
    rpp += (-rpp) % 8
    ni = thalo.neighbor_import(rm, ent, n, parts, rpp)
    ref = jhalo.neighbor_import(rm, ent, n, parts, rpp)
    offsets, send_lists, rem_cols, rem_ids, H_off = ni
    assert offsets == [1, parts - 1] == ref[0] and H_off == ref[4]
    for got, want in ((send_lists, ref[1]), (rem_cols, ref[2]), (rem_ids, ref[3])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    imports, _, _ = thalo._import_sets(rm, ent, n, parts, rpp)
    for p in range(parts):
        want = np.sort(np.concatenate([imports[p][q] for q in range(parts)]))
        np.testing.assert_array_equal(rem_cols[p], want)


UNEVEN = {"laplacian 37x29": lambda: j_laplacian(37, 29, dtype=np.float64).to_scipy(),
          "random 90": lambda: j_random(90, 90, 5, seed=21, dtype=np.float64).to_scipy()}


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(UNEVEN))
def test_host_plans_equal_tpukk(case, parts):
    """partition_rows, build_halo_plan, import_lists and import_index give
    tpukk's arrays exactly."""
    JA, TA = both(UNEVEN[case]())
    jp, tp = jd.partition_rows(JA, parts), td.partition_rows(TA, parts)
    for f in ("cols", "vals", "row_valid"):
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)))
    jh, th = jd.build_halo_plan(JA, parts), td.build_halo_plan(TA, parts)
    for f in ("send_idx", "int_cols", "int_vals", "int_rows", "bnd_cols", "bnd_vals",
              "bnd_rows"):
        np.testing.assert_array_equal(getattr(th, f), np.asarray(getattr(jh, f)))
    assert (th.rows_per_part, th.halo) == (jh.rows_per_part, jh.halo)
    rm = JA.host_row_map().astype(np.int64)
    ent = JA.host_entries().astype(np.int64)
    args = (rm, ent, JA.nrows, parts, th.rows_per_part)
    s, m, h = thalo.import_lists(*args)
    js, jm, jh_ = jhalo.import_lists(*args)
    np.testing.assert_array_equal(s, js)
    assert m == jm and h == jh_
    for g, w in zip(thalo.import_index(*args), jhalo.import_index(*args)):
        if isinstance(g, list):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("parts", [2, 4])
def test_dist_gs_plan_equals_tpukk(parts):
    """DistGsPlan (coloring, ELL color blocks, 1/diag) equals tpukk's."""
    sp = j_laplacian(20, 20, dtype=np.float64).to_scipy()
    sp.setdiag(sp.diagonal() + 0.5)
    JA, TA = both(sp.tocsr())
    jp, tp = jd.build_dist_gs_plan(JA, parts), td.build_dist_gs_plan(TA, parts)
    assert tp.num_colors == jp.num_colors
    np.testing.assert_array_equal(tp.send_idx, np.asarray(jp.send_idx))
    for f in ("color_cols", "color_vals", "color_rows", "color_invd"):
        for g, w in zip(getattr(tp, f), getattr(jp, f)):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_ring_plan_equals_tpukk(parts):
    """The ring's pair lists, paddings and C pattern equal tpukk's."""
    JA = j_random(40, 60, 4, seed=1, dtype=np.float64)
    JB = j_random(60, 30, 3, seed=2, dtype=np.float64)
    (JA, TA), (JB, TB) = both(JA.to_scipy()), both(JB.to_scipy())
    jp, tp = jd.build_ring_spgemm_plan(JA, JB, parts), td.build_ring_spgemm_plan(TA, TB, parts)
    for f in ("a_vals_pad", "b_vals_pad", "pair_a", "pair_b", "pair_c", "row_map_c",
              "entries_c", "nnz_c_local"):
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)))
    assert (tp.nc_max, tp.rows_per_part) == (jp.nc_max, jp.rows_per_part)
