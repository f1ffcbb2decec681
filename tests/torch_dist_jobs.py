"""Jobs for the ranks of tests/test_torch_dist.py that a single entry point
of ``ranks.call_sharded`` does not cover: a solve with the distributed
Gauss-Seidel preconditioner (two plans), the tracing a rank records,
``dist_pcg``'s loop as it was before it took ``prec`` and ``check_every``,
and its blocks replayed from a stand-in for a CUDA graph
(tests/cuda_graph_stand_in.py).  The ranks import this module by name to
run them, so it imports torch, numpy and tpukk_torch alone (no JAX)."""
import gc
import weakref

import numpy as np
import torch

from cuda_graph_stand_in import stand_in
from tpukk_torch.common import tracing
from tpukk_torch.dist import shard_plan
from tpukk_torch.dist.gauss_seidel import DistGsPrec
from tpukk_torch.dist.ranks import world
from tpukk_torch.dist.spmv import _dots, _nonzero, _spmv_fn_for, dist_dot, dist_pcg


def _rows(v: np.ndarray, rpp: int, rank: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v[rank * rpp:(rank + 1) * rpp]))


def gs_apply(gs_plan, r: np.ndarray):
    """The rank's z = M⁻¹r (``DistGsPrec`` on its shard) and its rows'
    colors."""
    rank, _ = world()
    prec = DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu"))
    return prec.apply(_rows(r, gs_plan.rows_per_part, rank)).numpy(), prec.colors()


def gs_pcg(plan, gs_plan, b: np.ndarray, **kw):
    """``dist_pcg`` with ``DistGsPrec`` on the rank, recorded: (x shard,
    iterations, relative residual, the halo exchanges and bytes it counted,
    its rows' colors, its spans as (name, parent, solve))."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    prec = DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu"))
    before = tracing.counters()
    with tracing.recording() as rec:
        x, its, rel = dist_pcg(shard, _rows(b, plan.rows_per_part, rank), prec=prec, **kw)
    after = tracing.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0)
               for k in ("dist.halo_exchanges", "dist.halo_bytes")}
    spans = [(s.name, s.parent, s.solve) for s in rec.spans]
    return x.numpy(), its, rel, counted, prec.colors(), spans


def _pcg_before(plan, b_shard, tol, max_iters, inv_diag, group=None):
    """``dist_pcg`` before ``prec`` and ``check_every``, line for line."""
    spmv = _spmv_fn_for(plan)

    def prec(r):
        return r if inv_diag is None else inv_diag * r

    bb = dist_dot(b_shard, b_shard, group)
    bb = float(bb) if float(bb) != 0 else 1.0
    tol2 = tol * tol * bb
    x = torch.zeros_like(b_shard)
    r = b_shard.clone()
    z = prec(r)
    p = z
    rz, rr = _dots(((r, z), (r, r)), group)
    k = 0
    while k < max_iters and float(rr) > tol2:
        Ap = spmv(plan, p, group)
        pAp = dist_dot(p, Ap, group)
        alpha = rz / _nonzero(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new, rr = _dots(((r, z), (r, r)), group)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k, float(np.sqrt(float(rr) / bb))


def jacobi_pcg_now_and_before(plan, b: np.ndarray, inv_diag: np.ndarray, tol: float,
                              max_iters: int):
    """The rank's (x, iterations, relative residual) from ``dist_pcg`` with
    ``inv_diag`` at ``check_every`` 1, and from the loop before."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    bs, ds = _rows(b, plan.rows_per_part, rank), _rows(inv_diag, plan.rows_per_part, rank)
    now = dist_pcg(shard, bs, tol=tol, max_iters=max_iters, inv_diag=ds, check_every=1)
    before = _pcg_before(shard, bs, tol, max_iters, ds)
    return [(x.numpy(), its, rel) for x, its, rel in (now, before)]


_GRAPH_COUNTERS = ("dist_pcg.blocks", "dist_pcg.graph_replays", "dist_pcg.graph_captures",
                   "dist_pcg.graph_fallbacks")


def graphed_pcg(plan, gs_plan, bs, fails_on=None, inv_diag=None, **kw):
    """Solves of each b in ``bs`` by ``dist_pcg`` on the rank, with
    ``DistGsPrec`` (or Jacobi by ``inv_diag``, one shard for all),
    without ``graphs`` and with one cache of them for all, its capture the
    stand-in (failing on rank ``fails_on``): per side, the rank's (x shard,
    iterations, relative residual) of each solve and the halo exchanges and
    bytes it counted in all; whether the cache's block was replayed; the
    stand-in's captures; the graphed side's block counters."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    if inv_diag is None:
        prec = dict(prec=DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu")))
    else:
        prec = dict(inv_diag=_rows(inv_diag, plan.rows_per_part, rank))
    names = ("dist.halo_exchanges", "dist.halo_bytes") + _GRAPH_COUNTERS
    with stand_in(fail=rank == fails_on) as calls:
        out, graphs = [], {}
        for cache in (None, graphs):
            before = tracing.counters()
            solves = [dist_pcg(shard, _rows(b, plan.rows_per_part, rank), graphs=cache, **prec,
                               **kw) for b in bs]
            after = tracing.counters()
            counted = {k: after.get(k, 0) - before.get(k, 0) for k in names}
            out.append(([(x.numpy(), its, rel) for x, its, rel in solves],
                        {k: counted[k] for k in names[:2]}))
    (st,) = graphs.values()
    return out, st.replay is not None, calls.n, {k: counted[k] for k in _GRAPH_COUNTERS}


def resweep_pcg(plan, gs_plan, b, **kw):
    """``dist_pcg`` with ``DistGsPrec`` and one cache of graphs (the
    stand-in's), a solve at 1 sweep, then one at 2 sweeps on the same
    preconditioner: the rank's stand-in captures after each solve, and the
    second solve's (x shard, iterations, relative residual) beside an eager
    solve's at 2 sweeps."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    prec = DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu"))
    bs = _rows(b, plan.rows_per_part, rank)
    graphs, captures = {}, []
    with stand_in() as calls:
        dist_pcg(shard, bs, prec=prec, graphs=graphs, **kw)
        captures.append(calls.n)
        prec.sweeps = 2
        graphed = dist_pcg(shard, bs, prec=prec, graphs=graphs, **kw)
        captures.append(calls.n)
    eager = dist_pcg(shard, bs, prec=prec, **kw)
    return captures, [(x.numpy(), its, rel) for x, its, rel in (graphed, eager)]


def cleared_pcg(plan, gs_plan, b, **kw):
    """``dist_pcg`` with ``DistGsPrec`` and one cache of graphs (the
    stand-in's): after a solve, ``graphs.clear()`` and a collection, whether
    the entry's x is still alive; the stand-in's captures after the solve
    and after a second solve on the emptied cache."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    prec = DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu"))
    bs = _rows(b, plan.rows_per_part, rank)
    graphs, captures = {}, []
    with stand_in() as calls:
        dist_pcg(shard, bs, prec=prec, graphs=graphs, **kw)
        captures.append(calls.n)
        x_of = weakref.ref(next(iter(graphs.values())).x)
        graphs.clear()
        gc.collect()
        alive = x_of() is not None
        dist_pcg(shard, bs, prec=prec, graphs=graphs, **kw)
        captures.append(calls.n)
    return alive, captures
