"""Ring-scheduled distributed SpGEMM — counterpart of
``tpukk/dist/spgemm.py``: C = A·B with A, B and C row-partitioned over the
ranks, B's row panels rotating around a ring.

Plan (host symbolic, numpy): every scalar product of part p's C rows,
grouped by the part that owns its A column (the ring step that supplies
that B row) and padded to a common length — the ``pair_*`` arrays, equal to
``tpukk``'s.  C's pattern is the symbolic product (no entry is dropped by an
exact cancellation of values).

Numeric, on each rank: P steps; at step s the rank holds the B value panel
of part q = (p + s) mod P and runs K8 (``spgemm_cuda.spgemm_rows``) on the
product of its A rows' entries in part q's columns with that panel, into
its C pattern, adding the steps' results; then it passes the panel to rank
p − 1 (``all_to_all_single`` with one non-zero split: ``tpukk``'s
``ppermute``).  The shard builds one K8 row plan a step.  The take and
segment-sum schedule over the pair arrays (``tpukk``'s ``_local_ring``) is
the plain version (``plain=True``).  Finally the ranks' C values are
gathered and every rank returns the whole C, as ``tpukk``'s host assembly
does.  Same-pattern reuse: the plan depends only on patterns; new values go
in ``a_vals_pad``/``b_vals_pad``.

``pk_streams``/``pk_meta`` are the TPU placer's streams, not carried: they
stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..common import round_up
from ..common.tracing import annotate
from ..common.types import default_device
from ..containers import CsrMatrix
from ..sparse.spgemm_cuda import build_row_plan, spgemm_rows
from .ranks import all_gather, all_to_all, world
from .spmv import check_host, check_shard, shard_rank, to_dev

__all__ = ["RingSpgemmPlan", "build_ring_spgemm_plan", "shard_ring_spgemm_plan",
           "ring_spgemm_numeric"]


@dataclasses.dataclass
class RingSpgemmPlan:
    a_vals_pad: Any      # (P, NA) padded local A values
    b_vals_pad: Any      # (P, NB) padded local B values (the rotating panel)
    pair_a: Any          # (P, S, PM) indices into local a_vals_pad
    pair_b: Any          # (P, S, PM) indices into the currently-held panel
    pair_c: Any          # (P, S, PM) indices into local C values (pad -> NC)
    row_map_c: Any       # host np (n+1,) global C structure
    entries_c: Any       # host np (nnzC,)
    nnz_c_local: Any     # (P,) actual local C nnz
    nrows_c: int
    ncols_c: int
    n_parts: int
    rows_per_part: int
    nc_max: int
    pk_streams: Any = None
    pk_meta: tuple = None
    a_pattern: Any = None  # host (row_map, entries) of A
    b_pattern: Any = None  # host (row_map, entries) of B
    steps: Any = None      # a shard's per-step (K8 row plan, A entry ids, panel nnz)
    ring: Any = None       # a shard's (send splits, recv splits) of the panel
    rank: Any = None


@annotate("dist.build_ring_spgemm_plan")
def build_ring_spgemm_plan(A: CsrMatrix, B: CsrMatrix, n_parts: int) -> RingSpgemmPlan:
    assert A.ncols == B.nrows
    arm = A.host_row_map().astype(np.int64)
    aent = A.host_entries().astype(np.int64)
    avals = A.host_values()
    brm = B.host_row_map().astype(np.int64)
    bent = B.host_entries().astype(np.int64)
    bvals = B.host_values()

    rppA = -(-A.nrows // n_parts)
    rppB = -(-B.nrows // n_parts)

    # C's pattern: the product of the patterns (ones), sorted
    import scipy.sparse as sps

    ones = lambda rm, ent, shape: sps.csr_matrix((np.ones(ent.shape[0]), ent, rm), shape=shape)
    Cs = (ones(arm, aent, A.shape) @ ones(brm, bent, B.shape)).tocsr()
    Cs.sort_indices()
    crm, cent = Cs.indptr.astype(np.int64), Cs.indices.astype(np.int64)

    def rows(n, rpp, p):
        return min(n, p * rpp), min(n, (p + 1) * rpp)

    def span(rm, n, rpp, p):
        r0, r1 = rows(n, rpp, p)
        return rm[r0], rm[r1]

    def widest(rm, n, rpp):
        return max(1, max(int(hi - lo) for lo, hi in (span(rm, n, rpp, p)
                                                       for p in range(n_parts))))

    NA, NB, NC = widest(arm, A.nrows, rppA), widest(brm, B.nrows, rppB), widest(crm, A.nrows, rppA)
    a_pad = np.zeros((n_parts, NA), avals.dtype)
    b_pad = np.zeros((n_parts, NB), bvals.dtype)
    b_off = np.zeros(n_parts, np.int64)
    nnz_c_local = np.zeros(n_parts, np.int64)
    for p in range(n_parts):
        alo, ahi = span(arm, A.nrows, rppA, p)
        blo, bhi = span(brm, B.nrows, rppB, p)
        clo, chi = span(crm, A.nrows, rppA, p)
        a_pad[p, : ahi - alo] = avals[alo:ahi]
        b_pad[p, : bhi - blo] = bvals[blo:bhi]
        b_off[p] = blo
        nnz_c_local[p] = chi - clo

    # every product of part p's rows in (row, A entry, B entry) order, its C
    # entry found by key, then grouped by step (a stable sort keeps the order)
    ckey = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(crm)) * B.ncols + cent
    pairs = []
    for p in range(n_parts):
        alo, ahi = span(arm, A.nrows, rppA, p)
        clo = span(crm, A.nrows, rppA, p)[0]
        ea = np.arange(alo, ahi, dtype=np.int64)
        r0, r1 = rows(A.nrows, rppA, p)
        row_of = np.repeat(np.arange(r0, r1), np.diff(arm[r0:r1 + 1]))
        k = aent[ea]
        cnt = brm[k + 1] - brm[k]
        ea_r = np.repeat(ea, cnt)
        first = np.cumsum(cnt) - cnt
        eb = np.repeat(brm[k], cnt) + np.arange(int(cnt.sum())) - np.repeat(first, cnt)
        q = np.minimum(aent[ea_r] // rppB, n_parts - 1)
        ci = np.searchsorted(ckey, np.repeat(row_of, cnt) * B.ncols + bent[eb]) - clo
        step = (q - p) % n_parts
        o = np.argsort(step, kind="stable")
        bounds = np.searchsorted(step[o], np.arange(n_parts + 1))
        pairs.append([(ea_r[o[s0:s1]] - alo, eb[o[s0:s1]] - b_off[q[o[s0:s1]]], ci[o[s0:s1]])
                      for s0, s1 in zip(bounds[:-1], bounds[1:])])

    PM = round_up(max(1, max(len(pairs[p][s][0]) for p in range(n_parts)
                             for s in range(n_parts))), 8)
    pair_a = np.zeros((n_parts, n_parts, PM), np.int32)
    pair_b = np.zeros((n_parts, n_parts, PM), np.int32)
    pair_c = np.full((n_parts, n_parts, PM), NC, np.int32)  # pad -> NC (dropped)
    for p in range(n_parts):
        for s in range(n_parts):
            pa, pb, pc = pairs[p][s]
            pair_a[p, s, : len(pa)] = pa
            pair_b[p, s, : len(pb)] = pb
            pair_c[p, s, : len(pc)] = pc
    return RingSpgemmPlan(a_pad, b_pad, pair_a, pair_b, pair_c, Cs.indptr.astype(np.int32),
                          Cs.indices.astype(np.int32), nnz_c_local, A.nrows, B.ncols, n_parts,
                          rppA, NC, a_pattern=(arm, aent), b_pattern=(brm, bent))


@annotate("dist.shard_ring_spgemm_plan")
def shard_ring_spgemm_plan(plan: RingSpgemmPlan, rank=None, device=None, group=None):
    """The rank's values and pair lists on ``device`` (None: the CUDA
    device), and for each ring step K8's row plan of the step's product:
    the rank's A rows restricted to the columns of part q = (p + s) mod P
    (renumbered from q's first B row) times part q's B rows, into the rank's
    C pattern."""
    check_host(plan, "shard_ring_spgemm_plan")
    r, dev = shard_rank(rank, group), default_device(device)
    P = plan.n_parts
    arm, aent = plan.a_pattern
    brm, bent = plan.b_pattern
    nA, nB = arm.shape[0] - 1, brm.shape[0] - 1
    rppA, rppB = plan.rows_per_part, -(-nB // P)
    r0, r1 = min(nA, r * rppA), min(nA, (r + 1) * rppA)
    crm = plan.row_map_c.astype(np.int64)
    c_rm = to_dev((crm[r0:r1 + 1] - crm[r0]).astype(np.int32), dev)
    c_ent = to_dev(plan.entries_c[crm[r0]:crm[r1]], dev)
    rows = np.repeat(np.arange(r1 - r0), np.diff(arm[r0:r1 + 1]))
    cols = aent[arm[r0]:arm[r1]]
    owner = np.minimum(cols // rppB, P - 1)
    steps = []
    for s in range(P):
        q = (r + s) % P
        sel = np.nonzero(owner == q)[0]
        a_rm = np.zeros(r1 - r0 + 1, np.int64)
        np.cumsum(np.bincount(rows[sel], minlength=r1 - r0), out=a_rm[1:])
        q0, q1 = min(nB, q * rppB), min(nB, (q + 1) * rppB)
        b_rm = brm[q0:q1 + 1] - brm[q0]
        k8 = build_row_plan(to_dev(a_rm.astype(np.int32), dev),
                            to_dev((cols[sel] - q0).astype(np.int32), dev),
                            to_dev(b_rm.astype(np.int32), dev),
                            to_dev(bent[brm[q0]:brm[q1]].astype(np.int32), dev), c_rm, c_ent,
                            plan.ncols_c)
        steps.append((k8, to_dev(sel, dev, True), int(brm[q1] - brm[q0])))
    NB = plan.b_vals_pad.shape[1]
    send, recv = [0] * P, [0] * P
    send[(r - 1) % P] += NB
    recv[(r + 1) % P] += NB
    return dataclasses.replace(
        plan, a_vals_pad=to_dev(plan.a_vals_pad[r], dev),
        b_vals_pad=to_dev(plan.b_vals_pad[r], dev),
        pair_a=to_dev(plan.pair_a[r], dev, True), pair_b=to_dev(plan.pair_b[r], dev, True),
        pair_c=to_dev(plan.pair_c[r], dev, True), steps=tuple(steps), ring=(send, recv), rank=r)


@annotate("dist.ring_spgemm_numeric")
def ring_spgemm_numeric(plan: RingSpgemmPlan, group=None, plain: bool = False) -> CsrMatrix:
    """Run the ring on the rank's shard; every rank returns the whole C on
    its device.  Each step is one K8 launch (``plain``: the take and
    segment-sum over the step's pair list)."""
    check_shard(plan, "ring_spgemm_numeric")
    _, size = world(group)
    P, NC = plan.n_parts, plan.nc_max
    a = plan.a_vals_pad
    panel = plan.b_vals_pad
    nnz = int(plan.nnz_c_local[plan.rank])
    acc = torch.zeros(NC, dtype=a.dtype, device=a.device)
    for s in range(P):
        if plain:
            prod = a[plan.pair_a[s]] * panel[plan.pair_b[s]]
            acc = acc + torch.zeros(NC + 1, dtype=a.dtype, device=a.device).index_add_(
                0, plan.pair_c[s], prod)[:NC]
        else:
            k8, sel, nb = plan.steps[s]
            if k8.nnz_a:
                acc[:nnz] += spgemm_rows(k8, a[sel], panel[:nb].contiguous())
        if s + 1 < P:
            panel = all_to_all(panel, *plan.ring, group)
    c_all = all_gather(acc, group).reshape(size, NC)
    vals = torch.cat([c_all[p, :int(plan.nnz_c_local[p])] for p in range(P)])
    return CsrMatrix.from_arrays(plan.row_map_c, plan.entries_c, vals, nrows=plan.nrows_c,
                                 ncols=plan.ncols_c, device=a.device)
