"""Banded (DIA) SpGEMM — counterpart of ``tpukk/sparse/spgemm_dia.py``.

A product of banded matrices is an offset convolution of their diagonals,

    C[r, r+o] = Σ_{(i,j): oa_i + ob_j = o}  Ad[i, r] · Bd[j, r + oa_i],

kA·kB shifted multiply-adds of (n,) vectors: no pairs, no gathers.  C's
pattern is the clipped band, which equals the exact structural product when
every stored diagonal of A and B is full; otherwise it is a superset with
explicit zeros.  So the route is opt-in (``SpgemmAlgorithm.DIA``), and KK
routes here by itself only when ``dia_operands_exact`` holds.

The host plan is ``tpukk``'s.  The numeric phase runs in torch ops on the
operands' device: ``tpukk``'s bf16 one-hot permutation matmuls and its
one-hot expansion plan exist because of Mosaic's slow transposes and
scatters and are not carried.  No Pallas kernel runs on this route.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..containers import CsrMatrix, StaticCrsGraph
from .spmv_impl import detect_dia_offsets

__all__ = ["DiaSpgemmPlan", "build_dia_spgemm_plan", "dia_spgemm_numeric",
           "dia_operands_exact"]


def dia_operands_exact(A: CsrMatrix, B: CsrMatrix, max_diags: int = 32) -> bool:
    """True iff both operands are DIA-able and every stored diagonal is
    structurally full: the case where the clipped-band pattern equals the
    exact structural product (safe for automatic routing)."""
    for M in (A, B):
        # a matrix with <= max_diags diagonals has nnz <= max_diags*min(n,m)
        if M.nnz > max_diags * min(M.nrows, M.ncols):
            return False
        offs = detect_dia_offsets(M, max_diags=max_diags)
        if offs is None:
            return False
        n, m = M.nrows, M.ncols
        rows = np.repeat(np.arange(n), np.diff(M.host_row_map()))
        d = M.host_entries() - rows
        counts = {int(o): int(c) for o, c in zip(*np.unique(d, return_counts=True))}
        for o in offs:
            full = min(n, m - o) - max(0, -o)
            if counts.get(int(o), 0) != full:
                return False
    return True


@dataclasses.dataclass
class _DiaRefresh:
    """Operand values -> (k, n) row-indexed diagonals, rebuilt at each
    numeric call (same pattern, new values).  Rows [R0, R1) carry the full
    band and refresh by one reshape of the CSR values; the other entries
    through an indexed copy."""

    offsets: Tuple[int, ...]
    n: int
    m: int
    R0: int
    R1: int
    rm0: int         # CSR value range backing the reshape
    rm1: int
    src: np.ndarray  # CSR value positions of the remaining entries
    tgt: np.ndarray  # their flat (row*k + offset index) targets


def _build_refresh(M: CsrMatrix, offsets: np.ndarray) -> _DiaRefresh:
    n, m = M.nrows, M.ncols
    k = len(offsets)
    rm = M.host_row_map().astype(np.int64)
    ent = M.host_entries().astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rm))
    oidx = np.searchsorted(offsets, ent - rows)
    full = np.diff(rm) == k
    # longest contiguous full-band run (a single run in the exact case)
    R0 = R1 = 0
    if full.any():
        f = np.r_[False, full, False]
        starts = np.nonzero(f[1:] & ~f[:-1])[0]
        ends = np.nonzero(~f[1:] & f[:-1])[0]
        best = np.argmax(ends - starts)
        R0, R1 = int(starts[best]), int(ends[best])
    inside = (rows >= R0) & (rows < R1)
    src = np.nonzero(~inside)[0].astype(np.int64)
    tgt = (rows[src] * k + oidx[src]).astype(np.int64)
    return _DiaRefresh(tuple(int(o) for o in offsets), n, m, R0, R1, int(rm[R0]), int(rm[R1]),
                       src, tgt)


def _refresh_diags(r: _DiaRefresh, values: torch.Tensor, src: torch.Tensor,
                   tgt: torch.Tensor) -> List[torch.Tensor]:
    """k (n,) diagonals from the operand's current values (src, tgt: r's
    index arrays on the values' device)."""
    k = len(r.offsets)
    flat = torch.zeros(r.n * k, dtype=values.dtype, device=values.device)
    if r.R1 > r.R0:
        flat[r.R0 * k:r.R1 * k] = values[r.rm0:r.rm1]
    if len(r.src):
        flat[tgt] = values[src]
    d = flat.reshape(r.n, k).T
    return [d[i] for i in range(k)]


@dataclasses.dataclass
class DiaSpgemmPlan:
    a_refresh: _DiaRefresh
    b_refresh: _DiaRefresh
    offsets_c: Tuple[int, ...]                        # sorted
    groups: Tuple[Tuple[Tuple[int, int], ...], ...]  # per C offset: (i, j) pairs
    row_map: np.ndarray                               # clipped-band CSR pattern
    entries: np.ndarray
    R0: int                                           # rows [R0, R1): full band
    R1: int
    top_idx: np.ndarray                               # flat (n, kC) indices of
    bot_idx: np.ndarray                               # the boundary rows' values
    nrows: int
    ncols: int
    nnz_c: int
    # C's graph and the index arrays on the device of the last numeric call
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def device_arrays(self, device: torch.device) -> dict:
        if self._dev.get("device") != device:
            t = {k: torch.from_numpy(v).to(device) for k, v in (
                ("top", self.top_idx), ("bot", self.bot_idx),
                ("a_src", self.a_refresh.src), ("a_tgt", self.a_refresh.tgt),
                ("b_src", self.b_refresh.src), ("b_tgt", self.b_refresh.tgt))}
            t["graph"] = StaticCrsGraph.from_arrays(self.row_map, self.entries, self.nrows,
                                                    self.ncols, device=device)
            self._dev = dict(device=device, **t)
        return self._dev


def build_dia_spgemm_plan(A: CsrMatrix, B: CsrMatrix,
                          max_diags: int = 32) -> Optional[DiaSpgemmPlan]:
    """Host symbolic phase.  None if either operand is not DIA-able or the
    pair count is too large to unroll."""
    offs_a = detect_dia_offsets(A, max_diags=max_diags)
    offs_b = detect_dia_offsets(B, max_diags=max_diags)
    if offs_a is None or offs_b is None:
        return None
    if len(offs_a) * len(offs_b) > 2048:
        return None
    n, m, p = A.nrows, A.ncols, B.ncols
    oa = np.asarray(offs_a)
    ob = np.asarray(offs_b)
    offsets_c = np.unique(oa[:, None] + ob[None, :])
    kC = len(offsets_c)
    groups: List[List[Tuple[int, int]]] = [[] for _ in range(kC)]
    oc_index = {int(o): t for t, o in enumerate(offsets_c)}
    # per-pair valid row interval [lo, hi): r in [0,n), r+oa_i in [0,m), r+o in [0,p)
    los = np.empty((len(oa), len(ob)), np.int64)
    his = np.empty_like(los)
    for i, ai in enumerate(oa):
        for j, bj in enumerate(ob):
            o = int(ai + bj)
            groups[oc_index[o]].append((i, j))
            los[i, j] = max(0, -int(ai), -o)
            his[i, j] = min(n, m - int(ai), p - o)
    # per-offset merged row coverage
    unions = []
    for t in range(kC):
        iv = sorted((int(los[i, j]), int(his[i, j])) for (i, j) in groups[t])
        merged = []
        for lo, hi in iv:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        unions.append(merged)
    if any(not u for u in unions):
        return None
    # interior: rows where every offset is covered by a single run
    R0 = max(u[0][0] for u in unions)
    R1 = min(u[-1][1] for u in unions)
    for u in unions:  # a hole inside [R0, R1) would break the reshape
        for (lo, hi), (lo2, _hi2) in zip(u, u[1:]):
            if hi > R0 and lo2 < R1:
                R0 = R1 = 0
                break
    if R1 < R0:
        R0 = R1 = 0

    def _boundary(rows: np.ndarray):
        """present[r_local, t] for the given rows."""
        pres = np.zeros((len(rows), kC), bool)
        for t in range(kC):
            for lo, hi in unions[t]:
                pres[:, t] |= (rows >= lo) & (rows < hi)
        return pres

    top_rows = np.arange(0, R0)
    bot_rows = np.arange(R1, n)
    ptop = _boundary(top_rows)
    pbot = _boundary(bot_rows)
    # entries ascend with offset, hence with column
    lengths = np.full(n, kC, np.int64)
    lengths[:R0] = ptop.sum(axis=1)
    lengths[R1:] = pbot.sum(axis=1)
    row_map = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=row_map[1:])
    nnz_c = int(row_map[-1])
    entries = np.empty(nnz_c, np.int64)
    if R1 > R0:
        cols_int = (np.arange(R0, R1)[:, None] + offsets_c[None, :]).reshape(-1)
        entries[row_map[R0]:row_map[R1]] = cols_int
    ti = np.nonzero(ptop)
    entries[:row_map[R0]] = top_rows[ti[0]] + offsets_c[ti[1]]
    bi = np.nonzero(pbot)
    entries[row_map[R1]:] = bot_rows[bi[0]] + offsets_c[bi[1]]
    top_idx = (top_rows[ti[0]] * kC + ti[1]).astype(np.int64)
    bot_idx = (bot_rows[bi[0]] * kC + bi[1]).astype(np.int64)
    return DiaSpgemmPlan(_build_refresh(A, oa), _build_refresh(B, ob),
                         tuple(int(o) for o in offsets_c), tuple(tuple(g) for g in groups),
                         row_map, entries, int(R0), int(R1), top_idx, bot_idx, n, p, nnz_c)


def _dia_numeric_vals(plan: DiaSpgemmPlan, ad, bd, dev: dict) -> torch.Tensor:
    """Offset convolution of the diagonals, then C's values in CSR order."""
    oa, n, m = plan.a_refresh.offsets, plan.nrows, plan.a_refresh.m
    L = max(0, -min(oa))
    R = max(0, n + max(oa) - m)
    bpad = [torch.nn.functional.pad(d, (L, R)) for d in bd]
    cdiags = []
    for t in range(len(plan.offsets_c)):
        acc = None
        for (i, j) in plan.groups[t]:
            term = ad[i] * bpad[j][oa[i] + L:oa[i] + L + n]
            acc = term if acc is None else acc + term
        cdiags.append(acc)
    flat = torch.stack(cdiags, dim=1).reshape(-1)     # (n*kC,) row-major
    kC = len(plan.offsets_c)
    parts = []
    if len(plan.top_idx):
        parts.append(flat[dev["top"]])
    if plan.R1 > plan.R0:
        parts.append(flat[plan.R0 * kC:plan.R1 * kC])
    if len(plan.bot_idx):
        parts.append(flat[dev["bot"]])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def dia_spgemm_numeric(plan: DiaSpgemmPlan, A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """Numeric phase on the operands' device: refresh both operands'
    diagonals from their current values, convolve, extract C's values."""
    dev = plan.device_arrays(A.device)
    dt = torch.promote_types(A.dtype, B.dtype)
    ad = _refresh_diags(plan.a_refresh, A.values.to(dt), dev["a_src"], dev["a_tgt"])
    bd = _refresh_diags(plan.b_refresh, B.values.to(dt), dev["b_src"], dev["b_tgt"])
    return CsrMatrix.from_graph(dev["graph"], _dia_numeric_vals(plan, ad, bd, dev).to(A.dtype))
