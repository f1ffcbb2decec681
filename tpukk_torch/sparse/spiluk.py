"""SpILUK — ILU(k) incomplete factorization, counterpart of
``tpukk/sparse/spiluk.py`` (the reference's sparse/src/KokkosSparse_spiluk.hpp,
:42 symbolic and :200 numeric, with the level-of-fill symbolic of
sparse/impl/KokkosSparse_spiluk_symbolic_impl.hpp:37-88).

Symbolic and numeric are host work, as in ``tpukk``: the C++ planners of
``csrc/host.cpp`` (``native.iluk_symbolic``, ``native.iluk_depth``,
``native.ilu_numeric``) compute the ILU(k) pattern, its entry-dependency
depth and the IKJ factorization in f64, and the factors are cast to A's dtype.
A failed build of the planners raises.  The pure-Python versions stay here
as the plain versions the tests hold the C++ against (``_iluk_pattern``,
``_ilu_numeric_plain``).

Returns L (unit lower, diagonal stored) and U (upper) as separate CSR
matrices on A's device.

The device value refresh (``build_iluk_refresh`` once per pattern, then
``spiluk_refresh`` per set of new values): the ILU(k) factors on a fixed
pattern are the unique fixed point of the Chow formulas restricted to it
(par_ilut's ``_SweepPlan``).  The plan schedules every pattern entry at its
dependency level (1 + the levels of the factors its products read; an L entry
also after its column's U diagonal), so one pass over the product pairs,
level by level in torch ops on the device, reproduces the IKJ factorization
with no host transfer of values.  A pattern deeper than 64 levels runs
``depth`` synchronous sweeps instead, which are exact too.  K5 puts the
level-ordered values back in pattern order.
"""
from __future__ import annotations

import bisect
from typing import Tuple

import numpy as np
import scipy.sparse as sps

import torch

from .. import native
from ..common import check
from ..common.permute import permute_gather
from ..common.tracing import annotate
from ..containers import CsrMatrix
from .par_ilut import _SweepPlan

__all__ = ["SpilukHandle", "spiluk_symbolic", "spiluk_numeric",
           "IlukRefreshPlan", "build_iluk_refresh", "spiluk_refresh", "refresh_to_csr"]


class SpilukHandle:
    """cf. spiluk_handle.hpp (fill level k, pattern, dependency depth)."""

    def __init__(self, fill_level: int = 0):
        self.fill_level = int(fill_level)
        self.is_symbolic_called = False
        self.pattern = None      # scipy csr pattern of L+U (with diagonal)
        self.depth = None        # entry-DAG depth of the pattern


def _iluk_pattern(A: sps.csr_matrix, k: int) -> sps.csr_matrix:
    """Plain version of ``native.iluk_symbolic``: the level-of-fill
    recurrence row by row (fill(i,j) = min over paths; entry kept if
    fill <= k), in Python."""
    n = A.shape[0]
    A = A.tocsr()
    A.sort_indices()
    INF = np.iinfo(np.int32).max
    rows_cols = []
    lvl_of: list = [None] * n
    for i in range(n):
        s, e = A.indptr[i], A.indptr[i + 1]
        cols = dict.fromkeys(A.indices[s:e].tolist(), 0)
        cols[i] = 0
        # IKJ update: for each kk < i in the row, merge row kk of U
        work = sorted(cols)
        wi = 0
        while wi < len(work):
            kk = work[wi]
            wi += 1
            if kk >= i:
                continue
            lik = cols[kk]
            if lik > k:
                continue
            for jj, lkj in zip(*lvl_of[kk]):
                if jj <= kk:
                    continue
                f = lik + lkj + 1
                if f <= k and f < cols.get(jj, INF):
                    if jj not in cols:
                        bisect.insort(work, jj)
                    cols[jj] = f
        keys = sorted(cols)
        cs = np.fromiter(keys, dtype=np.int64)
        lvl_of[i] = (cs, np.fromiter((cols[c] for c in keys), dtype=np.int64))
        rows_cols.append(cs)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(c) for c in rows_cols])
    indices = np.concatenate(rows_cols) if n else np.empty(0, np.int64)
    return sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=A.shape)


def _ilu_numeric_plain(sp: sps.csr_matrix, indptr, indices) -> np.ndarray:
    """Plain version of ``native.ilu_numeric``: dense-row-workspace IKJ
    factorization restricted to the pattern, f64, in Python."""
    n = sp.shape[0]
    vals = np.zeros(len(indices))
    w = np.zeros(n)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        w[:] = 0.0
        arow = sp.getrow(i)
        w[arow.indices] = arow.data
        for idx in range(s, e):
            kk = indices[idx]
            if kk >= i:
                break
            # l_ik = w_k / u_kk
            ks, ke = indptr[kk], indptr[kk + 1]
            kcols = indices[ks:ke]
            kvals = vals[ks:ke]
            lik = w[kk] / kvals[kcols == kk][0]
            w[kk] = lik
            upd = kcols > kk
            w[kcols[upd]] -= lik * kvals[upd]
        vals[s:e] = w[cols]
    return vals


@annotate("spiluk.spiluk_symbolic")
def spiluk_symbolic(handle: SpilukHandle, A: CsrMatrix) -> int:
    """ILU(k) pattern of A (host C++); returns its number of entries."""
    check(A.nrows == A.ncols, "spiluk: square matrix required")
    sp = A.to_scipy()
    indptr, indices = native.iluk_symbolic(sp.indptr, sp.indices, A.nrows, handle.fill_level)
    handle.pattern = sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=sp.shape)
    handle.depth = native.iluk_depth(indptr, indices, A.nrows)
    handle.is_symbolic_called = True
    return handle.pattern.nnz


@annotate("spiluk.spiluk_numeric")
def spiluk_numeric(handle: SpilukHandle, A: CsrMatrix) -> Tuple[CsrMatrix, CsrMatrix]:
    """Factor within the symbolic pattern (host C++, f64); returns (L unit
    lower with its diagonal stored, U), in A's dtype on A's device."""
    check(handle.is_symbolic_called, "spiluk_numeric: symbolic first")
    sp = A.to_scipy().tocsr()
    pat = handle.pattern
    vals = native.ilu_numeric(pat.indptr, pat.indices, sp.indptr, sp.indices,
                              sp.data.astype(np.float64), sp.shape[0])
    return _split_lu(sp, pat.indptr, pat.indices, vals, A)


def _split_lu(sp, indptr, indices, vals, A: CsrMatrix):
    n = sp.shape[0]
    LU = sps.csr_matrix((vals, indices.copy(), indptr.copy()), shape=sp.shape)
    L = (sps.tril(LU, k=-1).tocsr() + sps.identity(n, format="csr")).tocsr()
    U = sps.triu(LU, k=0).tocsr()
    L.sort_indices()
    U.sort_indices()
    dt = A.host_values().dtype
    return (CsrMatrix.from_scipy(L, value_dtype=dt, device=A.device),
            CsrMatrix.from_scipy(U, value_dtype=dt, device=A.device))


class IlukRefreshPlan:
    """Device plan of the exact ILU(k) value refresh on a fixed pattern,
    built once per symbolic pattern on A's device (see the module
    docstring).  ``levels`` holds the level schedule, or is None where the
    pattern is deeper than 64 levels and the refresh runs ``depth`` sweeps."""

    def __init__(self, handle: SpilukHandle, A: CsrMatrix):
        check(handle.is_symbolic_called, "build_iluk_refresh: symbolic first")
        Asp = A.to_scipy().tocsr()
        Asp.sort_indices()
        n = Asp.shape[0]
        pat = handle.pattern.tocsr()
        pat.sort_indices()
        sweep = _SweepPlan(sps.tril(pat, k=-1).tocsr(), sps.triu(pat, k=0).tocsr(), Asp,
                           A.device)
        check(sweep.nmiss == 0, "iluk pattern must contain A's pattern")
        self.sweep, self.n, self.device = sweep, n, A.device
        if handle.depth is None:
            handle.depth = native.iluk_depth(pat.indptr, pat.indices, n)
        self.depth = int(handle.depth)
        # pattern slot -> position among A's entries, -1 where the slot is fill
        akey = np.repeat(np.arange(n, dtype=np.int64), np.diff(Asp.indptr)) * n \
            + Asp.indices.astype(np.int64)

        def amap(rows, cols):
            want = rows.astype(np.int64) * n + cols.astype(np.int64)
            pos = np.minimum(np.searchsorted(akey, want), max(0, len(akey) - 1))
            hit = (akey[pos] == want) if len(akey) else np.zeros(len(want), bool)
            return np.where(hit, pos, -1)

        self.mapL_np = amap(sweep.rowL_np, sweep.colL_np)
        self.mapU_np = amap(sweep.rowU_np, sweep.colU_np)
        self.mapL = torch.from_numpy(self.mapL_np).to(A.device)
        self.mapU = torch.from_numpy(self.mapU_np).to(A.device)
        self.levels = self._level_schedule(sweep)

    def _level_schedule(self, s: _SweepPlan):
        """Entry levels by a fixpoint of grouped maxima over the product
        pairs, then the pairs and the L and U values sorted by level; None
        when the fixpoint takes more than 80 rounds or the depth exceeds 64
        (the sweep route then)."""
        nL, nU = s.nnzL, s.nnzU
        a_idx, b_idx, slot = s.pairs_np
        live = slot < nL + nU          # pairs that feed only the residual's targets go
        a_idx, b_idx, slot = a_idx[live], b_idx[live], slot[live]
        diag_pos = s.diag_slot_np
        colL = s.colL_np
        levL = np.ones(nL, np.int64)
        levU = np.ones(nU, np.int64)
        is_L = slot < nL
        tgt = np.where(is_L, slot, slot - nL)
        gstart = np.nonzero(np.r_[True, slot[1:] != slot[:-1]])[0] if len(slot) \
            else np.empty(0, np.int64)
        gtgt = slot[gstart]
        gL = gtgt < nL
        for _ in range(80):
            cand = 1 + np.maximum(levL[a_idx], levU[b_idx])
            gmax = np.maximum.reduceat(cand, gstart) if len(gstart) else cand
            nl, nu = levL.copy(), levU.copy()
            nl[gtgt[gL]] = np.maximum(levL[gtgt[gL]], gmax[gL])
            tu = gtgt[~gL] - nL
            nu[tu] = np.maximum(levU[tu], gmax[~gL])
            nl = np.maximum(nl, levU[diag_pos[colL]] + 1)
            if (nl == levL).all() and (nu == levU).all():
                break
            levL, levU = nl, nu
        else:
            return None
        depth = int(max(levL.max(initial=1), levU.max(initial=1)))
        if depth > 64:
            return None
        permL = np.argsort(levL, kind="stable")
        permU = np.argsort(levU, kind="stable")
        invL = np.empty(nL, np.int64)
        invL[permL] = np.arange(nL)
        invU = np.empty(nU, np.int64)
        invU[permU] = np.arange(nU)
        cL = np.searchsorted(levL[permL], np.arange(depth + 2))
        cU = np.searchsorted(levU[permU], np.arange(depth + 2))
        # pairs sorted by (target level, local segment); a level's segments are
        # its L entries, then its U entries
        t_lev = np.empty(len(slot), np.int64)
        t_new = np.empty(len(slot), np.int64)
        t_lev[is_L], t_new[is_L] = levL[tgt[is_L]], invL[tgt[is_L]]
        t_lev[~is_L], t_new[~is_L] = levU[tgt[~is_L]], invU[tgt[~is_L]]
        lseg = np.where(is_L, t_new - cL[t_lev], (cL[t_lev + 1] - cL[t_lev]) + t_new - cU[t_lev])
        po = np.lexsort((lseg, t_lev))
        p_off = np.searchsorted(t_lev[po], np.arange(depth + 2))
        ud = invU[diag_pos[colL]][permL]      # per level-ordered L entry: its U diagonal

        def dev(a, dt=np.int64):
            return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(self.device)

        return dict(depth=depth, a_idx=dev(invL[a_idx[po]]), b_idx=dev(invU[b_idx[po]]),
                    lseg=dev(lseg[po]), p_off=[int(x) for x in p_off],
                    cL=[int(x) for x in cL], cU=[int(x) for x in cU],
                    mapLp=dev(self.mapL_np[permL]), mapUp=dev(self.mapU_np[permU]), ud=dev(ud),
                    invL=dev(invL, np.int32), invU=dev(invU, np.int32))


@annotate("spiluk.build_iluk_refresh")
def build_iluk_refresh(handle: SpilukHandle, A: CsrMatrix) -> IlukRefreshPlan:
    return IlukRefreshPlan(handle, A)


def _restrict(avals, amap):
    """A's values on the pattern's slots, 0 on fill."""
    return torch.where(amap >= 0, avals[amap.clamp_min(0)], torch.zeros((), dtype=avals.dtype,
                                                                           device=avals.device))


@annotate("spiluk.spiluk_refresh")
def spiluk_refresh(plan: IlukRefreshPlan, a_values):
    """Exact device re-factorization for new values of A on the symbolic
    pattern (re-calling the reference numeric on updated values,
    KokkosSparse_spiluk.hpp:200).  ``a_values`` is A's CSR value array
    (sorted columns; a tensor or a numpy array); returns (l_values, u_values)
    on the plan's device, in the order of the pattern's strict-lower and
    upper entries."""
    av = a_values if isinstance(a_values, torch.Tensor) else torch.from_numpy(
        np.asarray(a_values))
    av = av.to(plan.device)
    L = plan.levels
    if L is None:
        s = plan.sweep
        aL, aU = _restrict(av, plan.mapL), _restrict(av, plan.mapU)
        lv, uv = aL, aU
        for _ in range(plan.depth):
            lv, uv = s.sweep(lv, uv, aL, aU)
        return lv, uv
    lv, uv = _restrict(av, L["mapLp"]), _restrict(av, L["mapUp"])
    cL, cU, p_off = L["cL"], L["cU"], L["p_off"]
    for lev in range(1, L["depth"] + 1):
        l0, l1, u0, u1 = cL[lev], cL[lev + 1], cU[lev], cU[lev + 1]
        nl = l1 - l0
        if nl == 0 and u1 == u0:
            continue
        s0, s1 = p_off[lev], p_off[lev + 1]
        seg = torch.zeros(nl + u1 - u0, dtype=av.dtype, device=av.device)
        seg.index_add_(0, L["lseg"][s0:s1], lv[L["a_idx"][s0:s1]] * uv[L["b_idx"][s0:s1]])
        if nl:
            udiag = uv[L["ud"][l0:l1]]
            udiag = torch.where(udiag != 0, udiag, torch.ones_like(udiag))
            lv[l0:l1] = (lv[l0:l1] - seg[:nl]) / udiag
        if u1 > u0:
            uv[u0:u1] -= seg[nl:]
    return permute_gather(L["invL"], lv), permute_gather(L["invU"], uv)


def refresh_to_csr(plan: IlukRefreshPlan, lv, uv, dtype=None):
    """(L, U) CsrMatrix on the plan's device from ``spiluk_refresh``'s output
    (a host round trip: for tests and interop; the hot path keeps lv and uv
    on the device)."""
    s = plan.sweep
    n = plan.n
    lvals, uvals = lv.cpu().numpy(), uv.cpu().numpy()
    dt = lvals.dtype if dtype is None else dtype
    L = sps.csr_matrix((lvals, (s.rowL_np, s.colL_np)), shape=(n, n))
    L = (L + sps.identity(n, dtype=dt)).tocsr()
    L.sort_indices()
    U = sps.csr_matrix((uvals, (s.rowU_np, s.colU_np)), shape=(n, n)).tocsr()
    U.sort_indices()
    return (CsrMatrix.from_scipy(L, value_dtype=dt, device=plan.device),
            CsrMatrix.from_scipy(U, value_dtype=dt, device=plan.device))
