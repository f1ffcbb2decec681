"""Supernodal sparse triangular solve — counterpart of
``tpukk/sparse/sptrsv_supernodal.py`` (the reference's SUPERNODAL_* SpTRSV
algorithms, sparse/src/KokkosSparse_sptrsv_supernode.hpp:87-140 and
sptrsv_handle.hpp:42-51).

Host symbolic: supernodes are detected from the triangle's pattern (columns j
and j+1 merge when the pattern below the diagonal of column j+1 is column
j's without row j+1, tested with two XOR hashes and counts, the same seed and
hashes as ``tpukk``, so the partitions are equal), or imported (a CHOLMOD
partition, split into runs of at most ``max_size``); the supernode quotient
DAG is level-scheduled by Kahn wavefronts.  Upper triangles are solved in the
index-reversed lower form (i -> n-1-i).  Two solve routes, picked by
``build_supernodal_plan(fused=...)``:

* **The fused reduction on K4** (``fused="auto"`` or True; f32 and f64).
  With L = D + P (D the block diagonal, P the panels) and z = D·x, the solve
  is the unit-lower system (I + P·D⁻¹)·z = b followed by x = D⁻¹·z.  Both
  become rows of one expanded DAG of exactly 2n rows: z-rows carry
  C = P·D⁻¹ (D⁻¹ taken in f64 on the host), x-rows carry −D⁻¹, in the
  values' dtype.  Its level count is the supernode level count plus one, and
  it is one ``LevelPlan`` for K4 (``sptrsv_cuda``).  A solve is one K4
  launch: the z-rows read b through ``src`` (the x-rows read 0, ``src`` -1),
  the x-rows write x through ``dst``.  ``tpukk``'s row split at 8 slots,
  its relay rows and its 1,024-row pseudo-levels exist for its wide Pallas
  kernel and are not carried: K4 takes a row of any length and a dependency
  of any distance.  ``tpukk``'s "auto" takes this route only where its
  Pallas kernel runs (a TPU, f32); the DAG exists on every device and in
  either dtype here, so "auto" is True.
* **The batched plan** (``fused=False``).  Each level is a few batched torch
  ops on the plan's device: a gather of b, ``torch.linalg.solve_triangular``
  over the level's (K, M, M) identity-padded diagonal blocks, a scatter of
  x, a batched panel product and a scatter-add of the update, with a dump
  slot at index n for padded lanes (``tpukk`` runs these as XLA ops, not
  Pallas).  It is the plain reference the DAG is held to.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sps
import torch

from ..common import check
from ..containers import torch_dtype
from .sptrsv_cuda import LevelPlan, build_level_plan, sptrsv_levels

__all__ = ["build_supernodal_plan", "build_supernodal_fused_plan", "supernodal_solve",
           "SupernodalPlan", "FusedSupernodalPlan"]


def _detect_supernodes(rows, cols, n, max_size=64):
    """Supernode id per column from strictly-lower triplets (rows > cols).

    Columns j, j+1 share a supernode iff the strictly-below-diagonal row
    pattern of column j+1 equals column j's minus {j+1}.  Multiset equality is
    tested with XOR hashes of per-row random keys (two independent draws;
    removal = XOR with the key) and pattern counts; runs longer than max_size
    are split."""
    rng = np.random.default_rng(0x5EED5)
    z1 = rng.integers(1, 2**62, n, dtype=np.int64)
    z2 = rng.integers(1, 2**62, n, dtype=np.int64)
    cnt = np.bincount(cols, minlength=n).astype(np.int64)
    h1 = np.zeros(n, np.int64)
    h2 = np.zeros(n, np.int64)
    if len(cols):
        order = np.argsort(cols, kind="stable")
        cs, rs = cols[order], rows[order]
        starts = np.nonzero(np.r_[True, cs[1:] != cs[:-1]])[0]
        segcols = cs[starts]
        h1[segcols] = np.bitwise_xor.reduceat(z1[rs], starts)
        h2[segcols] = np.bitwise_xor.reduceat(z2[rs], starts)
    first_sub = np.zeros(n, bool)      # (j+1) in pattern(col j)
    sub = rows == cols + 1
    first_sub[cols[sub]] = True
    j = np.arange(n - 1)
    in_s = first_sub[j]
    ok = (cnt[j + 1] == cnt[j] - in_s.astype(np.int64)) \
        & (h1[j + 1] == (h1[j] ^ np.where(in_s, z1[j + 1], 0))) \
        & (h2[j + 1] == (h2[j] ^ np.where(in_s, z2[j + 1], 0)))
    new_sn = np.r_[True, ~ok]
    run_id = np.cumsum(new_sn) - 1
    run_start = np.zeros(run_id[-1] + 1 if n else 0, np.int64)
    run_start[run_id[new_sn]] = np.nonzero(new_sn)[0]
    within = np.arange(n) - run_start[run_id]
    new_sn |= (within % max_size == 0)
    return np.cumsum(new_sn) - 1


def _split_partition(sn_of_col, max_size):
    """Re-number an imported monotone partition, splitting runs longer than
    max_size."""
    n = len(sn_of_col)
    if n == 0:
        return sn_of_col
    new_start = np.concatenate(([True], sn_of_col[1:] != sn_of_col[:-1]))
    run_id = np.cumsum(new_start) - 1
    run_first = np.nonzero(new_start)[0]
    within = np.arange(n) - run_first[run_id]
    return np.cumsum(new_start | (within % max_size == 0)) - 1


def _quotient_levels(sn_r, sn_c, nsn):
    """Kahn wavefront levels over the quotient DAG (edges sn_c -> sn_r,
    sn_c < sn_r); returns the 0-based level of each of the nsn nodes."""
    keep = sn_r != sn_c
    er, ec = sn_r[keep], sn_c[keep]
    if len(er):
        u = np.unique(er * np.int64(nsn) + ec)
        er, ec = u // nsn, u % nsn
    indeg = np.bincount(er, minlength=nsn)
    order = np.argsort(ec, kind="stable")
    out_r = er[order]
    out_ptr = np.zeros(nsn + 1, np.int64)
    np.cumsum(np.bincount(ec, minlength=nsn), out=out_ptr[1:])
    level = np.zeros(nsn, np.int64)
    frontier = np.nonzero(indeg == 0)[0]
    lv = 0
    while frontier.size:
        level[frontier] = lv
        starts, ends = out_ptr[frontier], out_ptr[frontier + 1]
        lens = ends - starts
        total = int(lens.sum())
        if total:
            base = np.repeat(starts, lens)
            within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            targets = out_r[base + within]
            indeg = indeg - np.bincount(targets, minlength=nsn)
            cand = np.unique(targets)
            frontier = cand[indeg[cand] == 0]
        else:
            frontier = np.empty(0, np.int64)
        lv += 1
    return level


def _lower_triplets(rm, ent, vals, n, lower):
    """(rows, cols, values) of tri(T) in the lower orientation: an upper
    triangle is index-reversed (i -> n-1-i)."""
    rm = np.asarray(rm, np.int64)
    ent = np.asarray(ent, np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rm))
    cols = ent
    if not lower:
        rows, cols = n - 1 - rows, n - 1 - cols
    tri = cols <= rows
    return rows[tri], cols[tri], np.asarray(vals)[tri]


def _partition(rows, cols, n, max_size, sn_of_col):
    """Supernode id per column: the imported partition split into runs of at
    most max_size, or detected from the strict pattern."""
    if sn_of_col is not None:
        return _split_partition(np.asarray(sn_of_col, np.int64), max_size)
    strict = cols < rows
    return _detect_supernodes(rows[strict], cols[strict], n, max_size)


@dataclasses.dataclass
class _SnLevel:
    D: torch.Tensor      # (K, M, M) diagonal blocks, identity-padded
    P: torch.Tensor      # (K, R, M) panels, zero-padded
    bidx: torch.Tensor   # (K, M) int64 rows of each block (pads -> the dump slot n)
    pidx: torch.Tensor   # (K, R) int64 rows the panel updates (pads -> n)


@dataclasses.dataclass
class SupernodalPlan:
    """The batched per-level plan (``fused=False``)."""

    levels: List[_SnLevel]
    n: int
    lower: bool
    reversed_: bool      # an upper triangle, solved index-reversed
    num_supernodes: int
    max_block: int
    dtype: torch.dtype

    @property
    def num_levels_sn(self) -> int:
        return len(self.levels)


@dataclasses.dataclass
class FusedSupernodalPlan:
    """The expanded unit-lower DAG of 2n rows as one K4 ``LevelPlan``.  K4's
    ``src`` (2n,) int32 gives the row of b each DAG row (in level order)
    reads, -1 for the x-rows, which read 0; ``dst`` (2n,) int32 the row of x
    each x-row writes, -1 for the z-rows.  Both fold in the index reversal
    of an upper triangle."""

    plan: LevelPlan
    src: torch.Tensor
    dst: torch.Tensor
    n: int
    reversed_: bool
    num_supernodes: int
    num_levels_sn: int   # supernode quotient levels
    num_rows_dag: int    # always 2n
    max_block: int
    dtype: torch.dtype

    @property
    def num_levels(self) -> int:
        """K4's level count over the expanded DAG."""
        return self.plan.num_levels


def _block_inverse(rows, cols, v, sn, sn_start, size):
    """D⁻¹ of every (lower-triangular, nonzero-diagonal) diagonal block as a
    block-diagonal scipy CSR in f64, exact zeros dropped: batched triangular
    solves against the identity on the host, blocks of one size together."""
    esn = sn[cols]
    dl = rows < sn_start[esn + 1]
    dr, dc, dv, ds = rows[dl], cols[dl], v[dl], esn[dl]
    out_r, out_c, out_v = [], [], []
    for s in np.unique(size):
        blocks = np.nonzero(size == s)[0]
        slot = np.full(len(size), -1, np.int64)
        slot[blocks] = np.arange(len(blocks))
        m = slot[ds] >= 0
        D = np.zeros((len(blocks), s, s))
        D[slot[ds[m]], dr[m] - sn_start[ds[m]], dc[m] - sn_start[ds[m]]] = dv[m]
        eye = torch.eye(int(s), dtype=torch.float64).expand(len(blocks), -1, -1)
        Dinv = torch.linalg.solve_triangular(torch.from_numpy(D), eye, upper=False).numpy()
        k, i, j = np.nonzero(Dinv)
        out_r.append(sn_start[blocks[k]] + i)
        out_c.append(sn_start[blocks[k]] + j)
        out_v.append(Dinv[k, i, j])
    n = len(sn)
    return sps.csr_matrix((np.concatenate(out_v), (np.concatenate(out_r), np.concatenate(out_c))),
                          shape=(n, n))


def build_supernodal_fused_plan(rm, ent, vals, n, lower=True, max_size=32, sn_of_col=None,
                                device=None) -> FusedSupernodalPlan | None:
    """The expanded-DAG plan of tri(T) for K4 (see ``FusedSupernodalPlan``),
    values in f64 for f64 input and in f32 otherwise.  Returns None only where
    the reduction does not exist: a missing or zero diagonal entry (a
    singular diagonal block)."""
    check(n > 0, "supernodal sptrsv: empty matrix")
    rows, cols, v = _lower_triplets(rm, ent, vals, n, lower)
    vdt = np.float64 if v.dtype == np.float64 else np.float32
    v = v.astype(np.float64)
    sn = _partition(rows, cols, n, max_size, sn_of_col)
    nsn = int(sn[-1]) + 1
    sn_start = np.zeros(nsn + 1, np.int64)
    np.cumsum(np.bincount(sn, minlength=nsn), out=sn_start[1:])
    size = np.diff(sn_start)
    diag = np.zeros(n)
    isd = rows == cols
    diag[rows[isd]] = v[isd]
    if not (diag != 0).all():
        return None
    Dinv = _block_inverse(rows, cols, v, sn, sn_start, size)
    # C = P·D⁻¹ over the panel entries (rows below their column's block)
    pm = rows >= sn_start[sn[cols] + 1]
    P = sps.csr_matrix((v[pm], (rows[pm], cols[pm])), shape=(n, n))
    C = (P @ Dinv).tocsr()
    C.eliminate_zeros()
    # rows 0..n-1: z (z_i + Σ C_ik z_k = b_i); rows n..2n-1: x (x_j − Σ D⁻¹_jk z_k = 0)
    zero = sps.csr_matrix((n, n))
    T = sps.vstack([sps.hstack([C, zero]), sps.hstack([-Dinv, zero])]).tocsr()
    T = (T + sps.identity(2 * n, format="csr")).tocsr()
    T.sort_indices()
    N = 2 * n
    r_all = np.repeat(np.arange(N, dtype=np.int64), np.diff(T.indptr))
    levels = _quotient_levels(r_all, T.indices.astype(np.int64), N) + 1
    plan = build_level_plan(T.indptr, T.indices, T.data.astype(vdt), N, levels, True,
                            device)
    order = np.argsort(levels, kind="stable")
    # z-row i takes b[i] and x-row n+j gives x[j] (reversed: b[n-1-i], x[n-1-j])
    nat = order if lower else np.where(order < n, n - 1 - order, 3 * n - 1 - order)
    src = np.where(order < n, nat, -1)
    dst = np.where(order >= n, nat - n, -1)
    lev_sn = _quotient_levels(sn[rows], sn[cols], nsn)

    def dev(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return FusedSupernodalPlan(
        plan=plan, src=dev(src), dst=dev(dst), n=n, reversed_=not lower,
        num_supernodes=nsn, num_levels_sn=int(lev_sn.max()) + 1, num_rows_dag=N,
        max_block=int(size.max()), dtype=torch_dtype(vdt))


def build_supernodal_plan(rm, ent, vals, n, lower=True, max_size=64, sn_of_col=None,
                          device=None, fused="auto"):
    """Host symbolic and numeric of the supernodal solve of tri(T) (CSR
    arrays with the diagonal stored); plans on ``device``.

    sn_of_col: an imported supernode partition (monotone id per column in
    the lower orientation, as ``sptrsv_cholmod`` gives it); runs longer than
    max_size are split.  fused: "auto" or True build the expanded DAG for K4
    (``FusedSupernodalPlan``, f32 or f64 values), False the batched plan
    (``SupernodalPlan``).  The fused route caps supernodes at 32 columns, as
    ``tpukk``'s does, so both packages build the same partition."""
    check(fused in ("auto", True, False),
          f"supernodal sptrsv: fused must be 'auto', True or False, got {fused!r}")
    vals = np.asarray(vals)
    if fused:
        fp = build_supernodal_fused_plan(rm, ent, vals, n, lower, min(max_size, 32), sn_of_col,
                                         device)
        check(fp is not None, "supernodal sptrsv: missing or zero diagonal entry")
        return fp
    rows, cols, v = _lower_triplets(rm, ent, vals, n, lower)
    sn_of_col = _partition(rows, cols, n, max_size, sn_of_col)
    nsn = int(sn_of_col[-1]) + 1 if n else 0
    sn_start = np.zeros(nsn + 1, np.int64)
    np.cumsum(np.bincount(sn_of_col, minlength=nsn), out=sn_start[1:])
    sn_size = np.diff(sn_start)

    level = _quotient_levels(sn_of_col[rows], sn_of_col[cols], nsn)
    nlev = int(level.max()) + 1 if nsn else 0

    esn = sn_of_col[cols]
    in_diag = rows < sn_start[esn + 1]
    diag = np.zeros(n, v.dtype)
    present = np.zeros(n, bool)
    isd = rows == cols
    diag[rows[isd]] = v[isd]
    present[rows[isd]] = True
    check(present.all(), "supernodal sptrsv: missing diagonal entry")
    check((diag != 0).all(), "supernodal sptrsv: zero diagonal entry")

    # panel rows: the distinct (supernode, row) pairs, ranked within their supernode
    pr, pc, pv_ = rows[~in_diag], cols[~in_diag], v[~in_diag]
    psn = esn[~in_diag]
    order = np.lexsort((pr, psn))
    psn_s, pr_s = psn[order], pr[order]
    newpair = np.r_[True, (psn_s[1:] != psn_s[:-1]) | (pr_s[1:] != pr_s[:-1])] \
        if len(psn_s) else np.empty(0, bool)
    pair_id = np.cumsum(newpair) - 1 if len(psn_s) else psn_s
    dist_sn = psn_s[newpair] if len(psn_s) else np.empty(0, np.int64)
    dist_row = pr_s[newpair] if len(psn_s) else np.empty(0, np.int64)
    sn_first_pair = np.r_[True, dist_sn[1:] != dist_sn[:-1]] if len(dist_sn) \
        else np.empty(0, bool)
    pair_base = np.zeros(len(dist_sn), np.int64)
    pair_base[sn_first_pair] = np.nonzero(sn_first_pair)[0]
    pair_base = np.maximum.accumulate(pair_base) if len(dist_sn) else pair_base
    rank_of_pair = np.arange(len(dist_sn)) - pair_base
    panel_cnt = np.bincount(dist_sn, minlength=nsn)

    # everything sorted by level once and sliced per level
    order_sn = np.argsort(level, kind="stable")
    lev_counts = np.bincount(level, minlength=nlev)
    lev_off = np.zeros(nlev + 1, np.int64)
    np.cumsum(lev_counts, out=lev_off[1:])
    rank_in_lev = np.empty(nsn, np.int64)
    rank_in_lev[order_sn] = np.arange(nsn) - np.repeat(lev_off[:-1], lev_counts)
    d_all = np.nonzero(in_diag)[0]
    d_lv = level[esn[d_all]]
    d_all = d_all[np.argsort(d_lv, kind="stable")]
    d_off = np.searchsorted(np.sort(d_lv), np.arange(nlev + 1))
    pcol_s, pval_s = pc[order], pv_[order]
    p_lv = level[psn_s]
    p_ord = np.argsort(p_lv, kind="stable")
    p_off = np.searchsorted(np.sort(p_lv), np.arange(nlev + 1))
    q_lv = level[dist_sn]
    q_ord = np.argsort(q_lv, kind="stable")
    q_off = np.searchsorted(np.sort(q_lv), np.arange(nlev + 1))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    levels = []
    for lv in range(nlev):
        sns = order_sn[lev_off[lv]:lev_off[lv + 1]]
        M = int(sn_size[sns].max())
        R = max(1, int(panel_cnt[sns].max(initial=0)))
        K = len(sns)
        sel = d_all[d_off[lv]:d_off[lv + 1]]
        dk = rank_in_lev[esn[sel]]
        s0 = sn_start[esn[sel]]
        D = np.zeros((K, M, M), v.dtype)
        D[:, np.arange(M), np.arange(M)] = 1
        D[dk, rows[sel] - s0, cols[sel] - s0] = v[sel]
        bidx = sn_start[sns][:, None] + np.arange(M)[None, :]
        bidx = np.where(np.arange(M)[None, :] < sn_size[sns][:, None], bidx, n)
        P = np.zeros((K, R, M), v.dtype)
        pidx = np.full((K, R), n, np.int64)
        e = p_ord[p_off[lv]:p_off[lv + 1]]
        P[rank_in_lev[psn_s[e]], rank_of_pair[pair_id[e]], pcol_s[e] - sn_start[psn_s[e]]] = \
            pval_s[e]
        q = q_ord[q_off[lv]:q_off[lv + 1]]
        pidx[rank_in_lev[dist_sn[q]], rank_of_pair[q]] = dist_row[q]
        levels.append(_SnLevel(dev(D), dev(P), dev(bidx.astype(np.int64)), dev(pidx)))
    return SupernodalPlan(levels, n, lower, not lower, nsn, int(sn_size.max(initial=1)),
                          torch_dtype(v.dtype))


def supernodal_solve(plan, b: torch.Tensor) -> torch.Tensor:
    """x with tri(T)·x = b, in b's dtype.  A fused plan is one K4 launch in
    the plan's dtype; a batched plan runs a handful of batched torch ops per
    level in the promotion of the plan's and b's dtypes."""
    check(isinstance(b, torch.Tensor) and b.ndim == 1 and b.shape[0] == plan.n,
          f"supernodal_solve: b must be a rank-1 tensor of {plan.n} rows")
    if isinstance(plan, FusedSupernodalPlan):
        bp = b.to(plan.dtype).contiguous()
        return sptrsv_levels(plan.plan, bp, src=plan.src, dst=plan.dst).to(b.dtype)
    dt = torch.promote_types(plan.dtype, b.dtype)
    bv = b.flip(0) if plan.reversed_ else b
    bw = torch.nn.functional.pad(bv.to(dt), (0, 1))
    xw = torch.zeros_like(bw)
    for L in plan.levels:
        X = torch.linalg.solve_triangular(L.D.to(dt), bw[L.bidx].unsqueeze(-1),
                                          upper=False).squeeze(-1)   # (K, M)
        xw[L.bidx] = X
        upd = torch.bmm(L.P.to(dt), X.unsqueeze(-1)).reshape(-1)      # (K·R,)
        bw.index_add_(0, L.pidx.reshape(-1), upd, alpha=-1)
    x = xw[:plan.n]
    return (x.flip(0) if plan.reversed_ else x).to(b.dtype)
