"""PAR_ILUT — iterative threshold ILU (Anzt–Chow–Dongarra), counterpart of
``tpukk/sparse/par_ilut.py`` (the reference's
sparse/src/KokkosSparse_par_ilut.hpp:20-33 and
sparse/impl/KokkosSparse_par_ilut_numeric_impl.hpp: repeated {candidate
add, fixed-point sweep, threshold prune, sweep}).

* **One host symbolic per candidate pattern**: cand = pattern((L+I)·U) ∪ A,
  and a *sweep plan* (``_SweepPlan``) that lists, for every pattern entry
  (i, j), the products L_ik·U_kj of the Chow fixed-point update
      i > j :  L_ij = (A_ij − Σ_{k<j} L_ik U_kj) / U_jj
      i ≤ j :  U_ij =  A_ij − Σ_{k<i} L_ik U_kj
  sorted by target slot.
* **Each outer iteration on the device** (``_device_outer``), in torch ops:
  synchronous sweeps over the candidate pattern (the reference's
  deterministic ``async_update=false`` mode), the threshold prune to the
  fill budget by a device sort with U's diagonal kept, sweeps on the pruned
  pattern (realized as value masks), and the residual on A's pattern.  One
  scalar comes back to the host per iteration.
* **Candidate regrowth when capacity binds**: when the budget can never bind
  on the current candidates, the host regrows them from the kept pattern
  (cand' = pattern((L+I)·U) ∪ A ∪ cand), rebuilds the plan and carries the
  values over.

``tpukk`` pads every array to a few bucketed lengths so its jitted sweeps are
reused across outer iterations; torch has no compile cost, so the plan keeps
its true lengths.  Segment sums are ``index_add_`` (atomics on the card: the
order of a sum's terms may change from run to run).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..common import check
from ..common.tracing import annotate
from ..containers import CsrMatrix

__all__ = ["ParIlutHandle", "par_ilut", "par_ilut_symbolic", "par_ilut_numeric"]


class ParIlutHandle:
    """cf. par_ilut_handle.hpp: max_iters, residual norm tolerance, fill-in
    limit (fill_factor × nnz(A)), sweeps per phase."""

    def __init__(self, max_iters: int = 5, residual_tol: float = 1e-2,
                 fill_factor: float = 2.0, sweeps_per_iter: int = 2):
        self.max_iters = int(max_iters)
        self.residual_tol = float(residual_tol)
        self.fill_factor = float(fill_factor)
        self.sweeps_per_iter = int(sweeps_per_iter)
        self.is_symbolic_called = False
        self.final_residual = float("nan")
        self.num_iters = 0


@annotate("par_ilut.par_ilut_symbolic")
def par_ilut_symbolic(handle: ParIlutHandle, A: CsrMatrix) -> int:
    """Symbolic phase: the initial pattern is A's triangles (the numeric
    phase builds its candidate patterns itself)."""
    check(A.nrows == A.ncols, "par_ilut: square matrix required")
    handle.is_symbolic_called = True
    return A.nnz


def _pattern(csr):
    p = csr.copy()
    p.data = np.ones_like(p.data)
    return p


def _find(keys, want):
    """Position of each wanted key in the sorted keys, and whether it is
    there."""
    pos = np.minimum(np.searchsorted(keys, want), max(0, len(keys) - 1))
    hit = (keys[pos] == want) if len(keys) else np.zeros(len(want), bool)
    return pos, hit


class _SweepPlan:
    """Host-built schedule for one (patL, patU) pattern pair, device arrays
    on ``device``.

    Targets are [L entries (CSR order), U entries, A entries missing from
    both]: every retained product pair maps to its target slot (``a_idx``
    into L's values, ``b_idx`` into U's, ``slot``, sorted by slot), with the
    per-target A value (``aL``, ``aU``, ``aM``), the U-diagonal slot of each
    row (``diag_slot``), L's columns (``colL``) and the target of each A
    entry (``a_pos``, for the residual on A's pattern)."""

    def __init__(self, patL, patU, Asp, device):
        n = patL.shape[0]
        Lrm = patL.indptr.astype(np.int64)
        Lent = patL.indices.astype(np.int64)
        Urm = patU.indptr.astype(np.int64)
        Uent = patU.indices.astype(np.int64)
        nnzL, nnzU = len(Lent), len(Uent)
        rowL = np.repeat(np.arange(n), Lrm[1:] - Lrm[:-1])
        rowU = np.repeat(np.arange(n), Urm[1:] - Urm[:-1])

        # product pairs: (i,k) in strict L × (k,j) in U
        expand = (Urm[1:] - Urm[:-1])[Lent]
        P = int(expand.sum())
        a_idx = np.repeat(np.arange(nnzL), expand)
        b_start = np.repeat(Urm[Lent], expand)
        within = np.arange(P) - np.repeat(np.cumsum(expand) - expand, expand)
        b_idx = b_start + within
        i = np.repeat(rowL, expand)
        k = Lent[a_idx]
        j = Uent[b_idx]
        # k<i and k<=j hold structurally; the lower-target sum needs k<j strict
        keep = ~((i > j) & (k == j))
        a_idx, b_idx, i, j = a_idx[keep], b_idx[keep], i[keep], j[keep]
        keyL = rowL * n + Lent
        keyU = rowU * n + Uent
        key = i * n + j
        low = i > j
        slot = np.empty(len(key), np.int64)
        posL, okL = _find(keyL, key[low])
        posU, okU = _find(keyU, key[~low])
        slot[low] = np.where(okL, posL, -1)
        slot[~low] = np.where(okU, nnzL + posU, -1)

        Acsr = Asp.tocsr()
        ar = np.repeat(np.arange(n, dtype=np.int64), np.diff(Acsr.indptr))
        akey = ar * n + Acsr.indices.astype(np.int64)
        aL, aU = (np.where(hit, Acsr.data[pos], 0).astype(Acsr.dtype)
                  for pos, hit in (_find(akey, keyL), _find(akey, keyU)))
        diag_pos = np.searchsorted(keyU, np.arange(n) * n + np.arange(n))
        # A entries pruned out of the L/U pattern still carry their LU
        # products, for the residual: extra targets past nnzL + nnzU
        alow = akey % n < akey // n
        apos = np.empty(len(akey), np.int64)
        pl, hl = _find(keyL, akey[alow])
        pu, hu = _find(keyU, akey[~alow])
        apos[alow] = np.where(hl, pl, -1)
        apos[~alow] = np.where(hu, nnzL + pu, -1)
        miss = apos < 0
        miss_keys = akey[miss]
        M = len(miss_keys)
        apos[miss] = nnzL + nnzU + np.arange(M)
        dead = slot < 0
        if M and dead.any():
            pm, hm = _find(miss_keys, key[dead])
            slot[dead] = np.where(hm, nnzL + nnzU + pm, -1)
        keep2 = slot >= 0
        a_idx, b_idx, slot = a_idx[keep2], b_idx[keep2], slot[keep2]
        order = np.argsort(slot, kind="stable")

        def dev(a, dt=None):
            return torch.from_numpy(np.ascontiguousarray(a if dt is None else a.astype(dt))) \
                .to(device)

        self.n, self.nnzL, self.nnzU, self.nmiss = n, nnzL, nnzU, M
        self.a_idx = dev(a_idx[order])
        self.b_idx = dev(b_idx[order])
        self.slot = dev(slot[order])
        self.aL, self.aU, self.aM = dev(aL), dev(aU), dev(Acsr.data[miss])
        self.diag_slot = dev(diag_pos)
        self.colL = dev(Lent)
        self.a_pos = dev(apos)
        self.rowL_np, self.colL_np = rowL, Lent
        self.rowU_np, self.colU_np = rowU, Uent
        self.diag_slot_np = diag_pos
        self.pairs_np = (a_idx[order], b_idx[order], slot[order])

    def segment_sums(self, lv, uv):
        """Σ L_ik·U_kj per target: (nnzL + nnzU + nmiss,)."""
        out = torch.zeros(self.nnzL + self.nnzU + self.nmiss, dtype=lv.dtype, device=lv.device)
        return out.index_add_(0, self.slot, lv[self.a_idx] * uv[self.b_idx])

    def sweep(self, lv, uv, aL, aU, mL=None, mU=None):
        """One synchronous Chow sweep; masks (where given) keep pruned slots 0."""
        s = self.segment_sums(lv, uv)
        udiag = uv[self.diag_slot]
        udiag = torch.where(udiag != 0, udiag, torch.ones_like(udiag))
        new_l = (aL - s[:self.nnzL]) / udiag[self.colL]
        new_u = aU - s[self.nnzL:self.nnzL + self.nnzU]
        if mL is not None:
            new_l, new_u = new_l * mL, new_u * mU
        return new_l, new_u


def _threshold(absv, budget, nnz):
    """The budget-th largest magnitude: 0 when the budget keeps everything,
    the largest when it keeps nothing (``tpukk``'s clamped index)."""
    if budget >= nnz:
        return torch.zeros((), dtype=absv.dtype, device=absv.device)
    return torch.sort(absv).values[min(nnz - budget, nnz - 1)]


def _device_outer(plan: _SweepPlan, is_diag_u, lvals, uvals, n_sweeps, budget_l, budget_u):
    """One outer iteration over the candidate pattern: n_sweeps sweeps,
    threshold prune to the fill budget (U's diagonal kept), n_sweeps sweeps
    on the pruned pattern, and the residual ‖A − L·U‖ on A's pattern.
    Returns (lv, uv, mL, mU, residual norm as a 0-d tensor)."""
    lv, uv = lvals, uvals
    for _ in range(n_sweeps):
        lv, uv = plan.sweep(lv, uv, plan.aL, plan.aU)
    absl, absu = lv.abs(), uv.abs()
    tl = _threshold(absl, budget_l, plan.nnzL)
    # budget_u is net of U's diagonals, which are always kept; 0 keeps only them
    if budget_u <= 0:
        tu = torch.full((), float("inf"), dtype=uv.dtype, device=uv.device)
    else:
        tu = _threshold(torch.where(is_diag_u, torch.zeros_like(absu), absu), budget_u,
                        plan.nnzU)
    # a floor representable in f32 (1e-300 would be 0 there and prune nothing)
    floor = torch.tensor(1e-37, dtype=lv.dtype, device=lv.device)
    mL = (absl >= torch.maximum(tl, floor)).to(lv.dtype)
    mU = torch.maximum((absu >= torch.maximum(tu, floor)).to(uv.dtype), is_diag_u.to(uv.dtype))
    lv, uv = lv * mL, uv * mU
    for _ in range(n_sweeps):
        lv, uv = plan.sweep(lv, uv, plan.aL, plan.aU, mL, mU)
    # R_ij = A_ij − Σ L_ik U_kj, with the solved term (L_ij·U_jj for i > j,
    # U_ij for i ≤ j); A entries outside the pattern carry the bare sum
    s = plan.segment_sums(lv, uv)
    nL, nU = plan.nnzL, plan.nnzU
    lu_full = torch.cat([s[:nL] + lv * uv[plan.diag_slot][plan.colL], s[nL:nL + nU] + uv,
                         s[nL + nU:]])
    r = (torch.cat([plan.aL, plan.aU, plan.aM]) - lu_full)[plan.a_pos]
    return lv, uv, mL, mU, torch.sqrt(torch.sum(r * r))


def _grow_candidates(patL, patU, Asp, prev=None):
    """cand = pattern((L+I)·U) ∪ A [∪ prev] — the add_candidates role."""
    n = Asp.shape[0]
    cand = (_pattern(patL.tocsr()) + sps.identity(n)) @ _pattern(patU.tocsr()) + _pattern(Asp)
    if prev is not None:
        cand = cand + prev
    cand = _pattern(cand.tocsr())
    cand.sort_indices()
    return cand


def _setup_plan(handle, cand, Asp, carryL, carryU, device):
    """The sweep plan of a candidate pattern, U's diagonal mask, the budgets
    and the initial values (A's, or those carried from the previous plan as
    (rows, cols, values))."""
    n = Asp.shape[0]
    plan = _SweepPlan(sps.tril(cand, k=-1).tocsr(), sps.triu(cand, k=0).tocsr(), Asp, device)
    lvals = plan.aL.cpu().numpy().copy()
    uvals = plan.aU.cpu().numpy().copy()
    if carryL is not None:
        _scatter_carry(lvals, plan.rowL_np, plan.colL_np, n, *carryL)
    if carryU is not None:
        _scatter_carry(uvals, plan.rowU_np, plan.colU_np, n, *carryU)
    d = plan.diag_slot_np
    uvals[d] = np.where(uvals[d] != 0, uvals[d], 1.0)
    is_diag_u = plan.rowU_np == plan.colU_np
    budget = int(handle.fill_factor * Asp.nnz)
    budget_l = min(budget // 2, plan.nnzL)
    # U's diagonal is always kept: deduct it from the off-diagonal budget
    budget_u = min(max(0, budget - budget // 2 - int(is_diag_u.sum())), plan.nnzU)
    return (plan, torch.from_numpy(is_diag_u).to(device), budget_l, budget_u,
            torch.from_numpy(lvals).to(device), torch.from_numpy(uvals).to(device))


def _scatter_carry(dest, rows, cols, n, crows, ccols, cvals):
    """Overwrite dest slots (keyed by row·n+col) with carried values at
    matching keys."""
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    pos, hit = _find(key, crows.astype(np.int64) * n + ccols.astype(np.int64))
    dest[pos[hit]] = cvals[hit]


@annotate("par_ilut.par_ilut_numeric")
def par_ilut_numeric(handle: ParIlutHandle, A: CsrMatrix) -> Tuple[CsrMatrix, CsrMatrix]:
    """The threshold ILU of A: (L unit lower with its diagonal stored, U), in
    A's dtype on A's device.  The first candidate pattern is
    pattern((tril(A)+I)·triu(A)) ∪ A; every outer iteration runs on the
    device, and the host regrows the candidates only while the budget cannot
    bind on them."""
    check(handle.is_symbolic_called, "par_ilut_numeric: symbolic first")
    Asp = A.to_scipy().tocsr()
    Asp.sort_indices()
    n = Asp.shape[0]
    dt = Asp.data.dtype
    dev = A.device
    patL = sps.tril(Asp, k=-1).tocsr()
    patU = (sps.triu(Asp, k=0) + sps.identity(n, dtype=dt)).tocsr()
    cand = _grow_candidates(_pattern(patL), _pattern(patU), Asp)
    plan, is_diag_u, budget_l, budget_u, lv, uv = _setup_plan(handle, cand, Asp, None, None, dev)

    anorm = float(np.sqrt((Asp.data.astype(np.float64) ** 2).sum()))
    res = float("inf")
    it = 0
    mL = mU = None
    for it in range(1, handle.max_iters + 1):
        lv, uv, mL, mU, rnorm = _device_outer(plan, is_diag_u, lv, uv, handle.sweeps_per_iter,
                                              budget_l, budget_u)
        res = float(rnorm) / max(anorm, 1e-30)
        if res <= handle.residual_tol:
            break
        # capacity binds ⇔ the budget can never bind ⇒ the pattern wants to grow
        nondiag_u = plan.nnzU - int(is_diag_u.sum())
        if it < handle.max_iters and (budget_l >= plan.nnzL or budget_u >= nondiag_u):
            lnp, unp = lv.cpu().numpy(), uv.cpu().numpy()
            kL = (mL.cpu().numpy() > 0) & (lnp != 0)
            kU = mU.cpu().numpy() > 0
            curL = sps.csr_matrix((np.ones(int(kL.sum())), (plan.rowL_np[kL], plan.colL_np[kL])),
                                  shape=(n, n))
            curU = sps.csr_matrix((np.ones(int(kU.sum())), (plan.rowU_np[kU], plan.colU_np[kU])),
                                  shape=(n, n))
            cand2 = _grow_candidates(curL, curU, Asp, prev=cand)
            if cand2.nnz <= cand.nnz:
                continue  # the pattern has converged: iterate in place
            cand = cand2
            plan_old = plan
            plan, is_diag_u, budget_l, budget_u, lv, uv = _setup_plan(
                handle, cand, Asp,
                (plan_old.rowL_np[kL], plan_old.colL_np[kL], lnp[kL]),
                (plan_old.rowU_np[kU], plan_old.colU_np[kU], unp[kU]), dev)
    handle.final_residual = res
    handle.num_iters = it
    lvals, uvals = lv.cpu().numpy(), uv.cpu().numpy()
    keepL = (mL.cpu().numpy() > 0) & (lvals != 0)
    keepU = mU.cpu().numpy() > 0
    L = sps.csr_matrix((lvals[keepL], (plan.rowL_np[keepL], plan.colL_np[keepL])), shape=(n, n))
    L = (L + sps.identity(n, dtype=dt)).tocsr()
    L.sort_indices()
    U = sps.csr_matrix((uvals[keepU], (plan.rowU_np[keepU], plan.colU_np[keepU])),
                       shape=(n, n)).tocsr()
    U.sort_indices()
    return (CsrMatrix.from_scipy(L, value_dtype=dt, device=dev),
            CsrMatrix.from_scipy(U, value_dtype=dt, device=dev))


@annotate("par_ilut.par_ilut")
def par_ilut(A: CsrMatrix, **kw) -> Tuple[CsrMatrix, CsrMatrix]:
    h = ParIlutHandle(**kw)
    par_ilut_symbolic(h, A)
    return par_ilut_numeric(h, A)
