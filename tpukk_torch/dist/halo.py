"""Halo-exchange planner — counterpart of ``tpukk/dist/halo.py``: the
Import/Export machinery the reference delegates to Tpetra, computed on the
host with numpy from the CSR row partition; every array equals ``tpukk``'s.

Plan layout (all arrays stacked on a leading parts axis, uniform shapes →
one pytree shardable over the mesh):

* x is row-partitioned: part p owns x[p*rpp : (p+1)*rpp].
* send_idx[p, q, H]: local indices part p gathers and sends to part q
  (padded with 0; padding slots send x_local[0], harmlessly ignored).
* After the exchange (``all_to_all_single``), part p holds recv[q, H] = what q sent to p; its
  extended vector is x_ext = concat(x_local, recv.flat), and every column id
  of its rows was remapped at plan time into x_ext coordinates.
* Rows are split interior (no remote columns) / boundary, stored as separate
  ELL blocks so the interior product can overlap the exchange.

``shard_halo_plan`` (``spmv.py``) takes one rank's slice onto a device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..common import round_up
from ..containers import CsrMatrix

__all__ = ["HaloPlan", "build_halo_plan", "import_lists", "import_index", "neighbor_import"]


@dataclasses.dataclass
class HaloPlan:
    # exchange
    send_idx: Any      # (P, P, H) int32 local indices to send
    # interior rows
    int_cols: Any      # (P, Ri, Wi) x_ext indices
    int_vals: Any      # (P, Ri, Wi)
    int_rows: Any      # (P, Ri) local row slot of each interior row (pads -> Rl)
    # boundary rows
    bnd_cols: Any      # (P, Rb, Wb)
    bnd_vals: Any      # (P, Rb, Wb)
    bnd_rows: Any      # (P, Rb)
    nrows: int
    ncols: int
    n_parts: int
    rows_per_part: int
    halo: int          # H
    rank: Any = None   # a rank's shard: its slices as tensors on its device

    @property
    def padded_rows(self) -> int:
        return self.n_parts * self.rows_per_part


def _import_sets(rm, ent, n, n_parts, rpp):
    """Per-part import sets + the packed send schedule — the Tpetra-Import
    analog shared by the SpMV, GS and gather-table distributed plans."""
    part_of = lambda g: np.minimum(g // rpp, n_parts - 1)
    imports = [[np.empty(0, np.int64)] * n_parts for _ in range(n_parts)]
    H = 1
    for p in range(n_parts):
        lo, hi = p * rpp, min(n, (p + 1) * rpp)
        if lo >= hi:
            continue
        cols = ent[rm[lo]:rm[hi]]
        remote = cols[part_of(cols) != p]
        if remote.size:
            uniq = np.unique(remote)
            src = part_of(uniq)
            for q in range(n_parts):
                imp = uniq[src == q]
                imports[p][q] = imp
                H = max(H, imp.size)
    H = round_up(H, 8)
    send_idx = np.zeros((n_parts, n_parts, H), np.int32)
    for p in range(n_parts):
        for q in range(n_parts):
            imp = imports[p][q]
            # q sends x_local_q[imp - q*rpp] to p
            send_idx[q, p, :imp.size] = (imp - q * rpp).astype(np.int32)
    return imports, send_idx, H


def import_lists(rm, ent, n, n_parts, rpp):
    """(send_idx[(q,p,H)], ext_map per part {global col -> x_ext id}, H)."""
    imports, send_idx, H = _import_sets(rm, ent, n, n_parts, rpp)
    ext_map = [dict() for _ in range(n_parts)]
    for p in range(n_parts):
        for q in range(n_parts):
            for h, g in enumerate(imports[p][q]):
                ext_map[p][int(g)] = rpp + q * H + h
    return send_idx, ext_map, H


def import_index(rm, ent, n, n_parts, rpp):
    """Vectorized form of the ext map: (send_idx, rem_cols, rem_ids, H) with
    rem_cols[p] globally sorted remote column ids of part p and rem_ids[p]
    their x_ext slots — remap via
    rem_ids[p][np.searchsorted(rem_cols[p], c)] (O(nnz log) instead of the
    per-entry dict lookups of import_lists)."""
    imports, send_idx, H = _import_sets(rm, ent, n, n_parts, rpp)
    rem_cols, rem_ids = [], []
    for p in range(n_parts):
        # part-q blocks are disjoint ascending global ranges -> concat sorted
        rem_cols.append(np.concatenate(
            [imports[p][q] for q in range(n_parts)]
            or [np.empty(0, np.int64)]))
        rem_ids.append(np.concatenate(
            [rpp + q * H + np.arange(len(imports[p][q]), dtype=np.int64)
             for q in range(n_parts)] or [np.empty(0, np.int64)]))
    return send_idx, rem_cols, rem_ids, H


def neighbor_import(rm, ent, n, n_parts, rpp, max_offsets: int = 8):
    """Neighbor exchange schedule: O(Σ_d H_d) traffic instead of the padded
    all_to_all's O(P·H_max) per part.

    Returns (offsets, send_lists, rem_cols, rem_ids, H_per_offset) or None
    when the communication pattern is denser than max_offsets distinct part
    offsets (callers keep the all_to_all).  For offset d (index k), part q
    sends H_k values to part (q − d) mod P; part p's halo block k holds
    its imports from part (p + d) mod P.  x_ext = [x_local | block_0 | …];
    rem_cols[p] (sorted global ids) + rem_ids[p] realize the remap."""
    imports, _, _ = _import_sets(rm, ent, n, n_parts, rpp)
    P = n_parts
    traffic = {}
    for p in range(P):
        for q in range(P):
            if p != q and imports[p][q].size:
                d = (q - p) % P
                traffic[d] = max(traffic.get(d, 0), imports[p][q].size)
    offsets = sorted(traffic)
    if len(offsets) > max_offsets:
        return None
    H_off = [round_up(traffic[d], 8) for d in offsets]
    bases = np.concatenate(([0], np.cumsum(H_off))).astype(np.int64)
    send_lists = []
    for k, d in enumerate(offsets):
        sl = np.zeros((P, H_off[k]), np.int32)
        for q in range(P):
            p = (q - d) % P
            imp = imports[p][q]
            sl[q, :imp.size] = (imp - q * rpp).astype(np.int32)
        send_lists.append(sl)
    rem_cols, rem_ids = [], []
    for p in range(P):
        cols_p, ids_p = [], []
        for k, d in enumerate(offsets):
            q = (p + d) % P
            imp = imports[p][q]
            cols_p.append(imp)
            ids_p.append(rpp + bases[k]
                         + np.arange(imp.size, dtype=np.int64))
        cols_p = (np.concatenate(cols_p) if cols_p
                  else np.empty(0, np.int64))
        ids_p = (np.concatenate(ids_p) if ids_p
                 else np.empty(0, np.int64))
        o = np.argsort(cols_p)
        rem_cols.append(cols_p[o])
        rem_ids.append(ids_p[o])
    return offsets, send_lists, rem_cols, rem_ids, H_off


def build_halo_plan(A: CsrMatrix, n_parts: int, row_block: int = 8) -> HaloPlan:
    """Block row partition with import lists (square matrices: x partitioned
    like the rows)."""
    assert A.nrows == A.ncols, "halo plan: square matrices (x ~ row partition)"
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries().astype(np.int64)
    vals = A.host_values()
    n = A.nrows
    rpp = round_up(-(-n // n_parts), row_block)

    part_of = lambda g: np.minimum(g // rpp, n_parts - 1)
    send_idx, ext_map, H = import_lists(rm, ent, n, n_parts, rpp)

    # ---- row blocks (interior/boundary) per part ---------------------------
    def build_blocks(p):
        lo, hi = p * rpp, min(n, (p + 1) * rpp)
        rows = np.arange(lo, hi)
        if rows.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lens = rm[rows + 1] - rm[rows]
        is_boundary = np.zeros(rows.size, bool)
        for j, r in enumerate(rows):
            c = ent[rm[r]:rm[r + 1]]
            is_boundary[j] = (part_of(c) != p).any()
        return rows[~is_boundary], rows[np.where(is_boundary)[0]]

    def ell_of(p, rows, width_min=1):
        lo = p * rpp
        lens = (rm[rows + 1] - rm[rows]) if rows.size else np.zeros(0, np.int64)
        w = max(width_min, int(lens.max(initial=1)))
        nr = rows.size
        cols2d = np.zeros((nr, w), np.int64)
        vals2d = np.zeros((nr, w), vals.dtype)
        for j, r in enumerate(rows):
            s, e = rm[r], rm[r + 1]
            c = ent[s:e]
            local = part_of(c) == p
            mapped = np.where(local, c - lo, 0)
            for t, (cc, isl) in enumerate(zip(c, local)):
                if not isl:
                    mapped[t] = ext_map[p][int(cc)]
            cols2d[j, : e - s] = mapped
            vals2d[j, : e - s] = vals[s:e]
        return cols2d, vals2d, (rows - lo)

    per_part = [build_blocks(p) for p in range(n_parts)]
    Ri = max(1, max(len(pp[0]) for pp in per_part))
    Rb = max(1, max(len(pp[1]) for pp in per_part))
    # uniform widths across parts
    Wi = Wb = 1
    cache = {}
    for p in range(n_parts):
        ir, br = per_part[p]
        ic, iv, irl = ell_of(p, np.asarray(ir, np.int64))
        bc, bv, brl = ell_of(p, np.asarray(br, np.int64))
        cache[p] = (ic, iv, irl, bc, bv, brl)
        Wi = max(Wi, ic.shape[1])
        Wb = max(Wb, bc.shape[1])
    Ri = round_up(Ri, row_block)
    Rb = round_up(Rb, row_block)

    int_cols = np.zeros((n_parts, Ri, Wi), np.int32)
    int_vals = np.zeros((n_parts, Ri, Wi), vals.dtype)
    int_rows = np.full((n_parts, Ri), rpp, np.int32)   # pad slot -> scratch row
    bnd_cols = np.zeros((n_parts, Rb, Wb), np.int32)
    bnd_vals = np.zeros((n_parts, Rb, Wb), vals.dtype)
    bnd_rows = np.full((n_parts, Rb), rpp, np.int32)
    for p in range(n_parts):
        ic, iv, irl, bc, bv, brl = cache[p]
        int_cols[p, : ic.shape[0], : ic.shape[1]] = ic
        int_vals[p, : iv.shape[0], : iv.shape[1]] = iv
        int_rows[p, : irl.size] = irl
        bnd_cols[p, : bc.shape[0], : bc.shape[1]] = bc
        bnd_vals[p, : bv.shape[0], : bv.shape[1]] = bv
        bnd_rows[p, : brl.size] = brl
    return HaloPlan(send_idx, int_cols, int_vals, int_rows, bnd_cols, bnd_vals, bnd_rows,
                    n, A.ncols, n_parts, rpp, H)
