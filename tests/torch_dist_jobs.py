"""Jobs for the ranks of tests/test_torch_dist.py that a single entry point
of ``ranks.call_sharded`` does not cover: a solve with the distributed
Gauss-Seidel preconditioner (two plans), the tracing a rank records,
``dist_pcg``'s loop as it was before it took ``prec`` and ``check_every``,
and its blocks replayed from a stand-in for a CUDA graph.
The ranks import this module by name to run them, so it imports torch,
numpy and tpukk_torch alone (no JAX)."""
from types import SimpleNamespace

import numpy as np
import torch

from tpukk_torch.common import tracing
from tpukk_torch.dist import shard_plan
from tpukk_torch.dist import spmv as dist_spmv_mod
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


def _stand_in_capture(fails_on=None):
    """``dist_pcg``'s capture off the card: the capture runs the block's
    host code on copies of the buffers (so that none of its work lands, as
    none of a captured graph's does); a replay runs it on the buffers and
    takes back the counters it adds, as a graph's replay adds none itself.
    On rank ``fails_on`` the capture fails at its end."""
    def capture(block, st, device):
        block(SimpleNamespace(**{k: v.clone() if isinstance(v, torch.Tensor) else v
                                 for k, v in vars(st).items()}))
        if world()[0] == fails_on:
            return None

        def replay():
            before = tracing.counters()
            block(st)
            for n, v in tracing.counters().items():
                tracing.count(n, before.get(n, 0) - v)
        return replay
    return capture


def graphed_pcg(plan, gs_plan, bs, fails_on=None, **kw):
    """Solves of each b in ``bs`` by ``dist_pcg`` with ``DistGsPrec`` on the
    rank, without ``graphs`` and with one cache of them for all, its capture
    the stand-in: per side, the rank's (x shard, iterations, relative
    residual) of each solve and the halo exchanges and bytes it counted in
    all; and whether the cache's block was replayed."""
    rank, _ = world()
    shard = shard_plan(plan, rank=rank, device="cpu")
    prec = DistGsPrec(shard_plan(gs_plan, rank=rank, device="cpu"))
    real = dist_spmv_mod._capture
    dist_spmv_mod._capture = _stand_in_capture(fails_on)
    try:
        out, graphs = [], {}
        for cache in (None, graphs):
            before = tracing.counters()
            solves = [dist_pcg(shard, _rows(b, plan.rows_per_part, rank), prec=prec,
                               graphs=cache, **kw) for b in bs]
            after = tracing.counters()
            out.append(([(x.numpy(), its, rel) for x, its, rel in solves],
                        {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("dist.halo_exchanges", "dist.halo_bytes")}))
    finally:
        dist_spmv_mod._capture = real
    (st,) = graphs.values()
    return out, st.replay is not None
