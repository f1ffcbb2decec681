"""Distributed SpMV on K3 — counterpart of ``tpukk/dist/gt_spmv.py``, whose
local products are the gather-table Pallas kernels (``_gi4_call_batched``,
``_dlp_call_batched``) inside ``shard_map``.

* Each part p gets its own local CSR: rows [p·rpp, (p+1)·rpp), columns
  remapped into x_ext = [x_local | halo] coordinates through the import
  lists (``halo.import_index``).  A rank's shard holds it as a K3 plan
  (``spmv_cuda.build_csr_plan``) on its device.
* ``dist_spmv_gt``: gather the send lists from x_local, exchange them with
  one ``all_to_all_single``, then K3 (``csr_spmv``) on x_ext.
* ``DistGtPlan2`` splits each local matrix by entry: the interior block
  (local columns) runs K3 on x_local alone, the boundary block (halo
  columns only) K3 on the received halo, and y is their sum.  Its exchange
  is the neighbour schedule (``halo.neighbor_import``): for offset d, part q
  sends H_d values to part (q − d) mod P.  All offsets go in one
  ``all_to_all_single`` (a rank sends to one rank per offset, and zero
  values to the others); the shard renumbers the boundary block's columns
  from ``tpukk``'s offset-major halo to the rank-major order the exchange
  delivers, so the received values need no reordering.

The TPU stream layout is not carried (``build_stacked_streams``,
``_pad_stack``, the VMEM caps ``_OH_SRC``/``_X_VMEM_CAP``): K3 needs no
uniform stream shapes across parts, so no builder returns None for them and
nothing is padded (``pad_ratio`` is 1.0).  The local values keep the
matrix's dtype, where ``tpukk`` casts them to f32.
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
from ..sparse.spmv_cuda import build_csr_plan, csr_spmv
from .halo import import_index, neighbor_import
from .ranks import exchange
from .spmv import check_host, check_shard, halo_exchange, shard_rank, to_dev

__all__ = ["DistGtPlan", "DistGtPlan2", "build_dist_gt_plan",
           "build_dist_gt_plan2", "dist_spmv_gt", "shard_dist_gt_plan", "dist_plan_accounting"]


@dataclasses.dataclass
class DistGtPlan:
    """Per-part local CSRs over x_ext + the padded all_to_all schedule.

    send_idx (P, P, H): what part p sends part q; ``local_csr``: per part
    (row_map (rpp+1,), entries, values) host arrays.  A rank's shard holds
    its flat send list and its K3 plan (``csr``) on its device."""

    send_idx: Any
    local_csr: Any
    nrows: int           # global rows
    ncols: int           # global cols
    n_parts: int
    rows_per_part: int
    halo: int            # H
    ncols_ext: int       # rpp + n_parts * H
    pad_ratio: float = 1.0  # the port's own padding: none
    layout: str = "csr"  # K3
    no_remote: bool = False  # no part imports anything: no exchange
    csr: Any = None      # a shard's K3 plan (over x_local alone where no_remote)
    rank: Any = None

    @property
    def padded_rows(self) -> int:
        return self.n_parts * self.rows_per_part


def _local_csr_of_part(rm, ent, vals, p, n, rpp, rem_cols, rem_ids):
    """Part p's rows as host CSR arrays over x_ext coordinates (vectorized
    remap), in the values' dtype."""
    lo, hi = p * rpp, min(n, (p + 1) * rpp)
    nr_real = max(0, hi - lo)
    if nr_real == 0:
        return (np.zeros(rpp + 1, np.int64), np.zeros(0, np.int64),
                np.zeros(0, vals.dtype))
    s, e = rm[lo], rm[hi]
    c = ent[s:e]
    v = vals[s:e]
    local = (c >= lo) & (c < lo + rpp)
    mapped = np.where(local, c - lo, 0)
    if rem_cols.size:
        ridx = np.searchsorted(rem_cols, c[~local])
        mapped[~local] = rem_ids[ridx]
    rm_p = np.zeros(rpp + 1, np.int64)
    rm_p[: nr_real + 1] = rm[lo: hi + 1] - s
    rm_p[nr_real + 1:] = rm_p[nr_real]
    return rm_p, mapped, v


@dataclasses.dataclass
class DistGtPlan2:
    """Neighbour exchange + interior/boundary split by entry.

    send_lists: per offset (P, H_k) int32; ``int_csr`` / ``bnd_csr``: per
    part host CSR arrays, the boundary block over the offset-major halo
    [0, halo_total).  A rank's shard holds its K3 plans (``int_plan``,
    ``bnd_plan``, the latter over the rank-major halo), its send list in
    rank order of destination, and the exchange's splits."""

    send_lists: Any
    int_csr: Any
    bnd_csr: Any
    offsets: Any         # tuple of part offsets
    nrows: int
    ncols: int
    n_parts: int
    rows_per_part: int
    halo_total: int      # Σ_d H_d
    pad_ratio: float = 1.0
    int_plan: Any = None
    bnd_plan: Any = None
    send: Any = None
    send_splits: Any = None
    recv_splits: Any = None
    rank: Any = None

    @property
    def padded_rows(self) -> int:
        return self.n_parts * self.rows_per_part


def _local_split_csrs(rm, ent, vals, p, n, rpp, rem_cols, rem_ids):
    """Part p's rows split by entry into (interior CSR over local columns,
    boundary CSR over offset-major halo columns [0, Ht))."""
    lo, hi = p * rpp, min(n, (p + 1) * rpp)
    nr_real = max(0, hi - lo)
    empty = (np.zeros(rpp + 1, np.int64), np.zeros(0, np.int64),
             np.zeros(0, vals.dtype))
    if nr_real == 0:
        return empty, empty
    s, e = rm[lo], rm[hi]
    c = ent[s:e]
    v = vals[s:e]
    rows = np.repeat(np.arange(nr_real, dtype=np.int64),
                     np.diff(rm[lo:hi + 1]).astype(np.int64))
    local = (c >= lo) & (c < lo + rpp)

    def csr_of(mask, cols):
        rm_p = np.zeros(rpp + 1, np.int64)
        np.add.at(rm_p[1:], rows[mask], 1)
        np.cumsum(rm_p, out=rm_p)
        return rm_p, cols, v[mask]

    int_csr = csr_of(local, (c[local] - lo))
    if rem_cols.size:
        ridx = np.searchsorted(rem_cols, c[~local])
        bnd_cols = rem_ids[ridx] - rpp
    else:
        bnd_cols = np.zeros(0, np.int64)
    bnd_csr = csr_of(~local, bnd_cols)
    return int_csr, bnd_csr


def _host_arrays(A: CsrMatrix):
    return (np.asarray(A.host_row_map(), np.int64), np.asarray(A.host_entries(), np.int64),
            np.asarray(A.host_values()))


@annotate("dist.build_dist_gt_plan2")
def build_dist_gt_plan2(A: CsrMatrix, n_parts: int, row_block: int = 8) -> "DistGtPlan2 | None":
    """Neighbour-exchange overlap plan; None when the communication pattern
    is dense (more than 8 part offsets), as in ``tpukk``."""
    assert A.nrows == A.ncols, "dist gt plan: square matrices"
    rm, ent, vals = _host_arrays(A)
    n = A.nrows
    rpp = round_up(-(-n // n_parts), row_block)
    ni = neighbor_import(rm, ent, n, n_parts, rpp)
    if ni is None:
        return None
    offsets, send_lists, rem_cols, rem_ids, H_off = ni
    splits = [_local_split_csrs(rm, ent, vals, p, n, rpp, rem_cols[p], rem_ids[p])
              for p in range(n_parts)]
    return DistGtPlan2(tuple(send_lists), tuple(s[0] for s in splits),
                       tuple(s[1] for s in splits), tuple(offsets), n, A.ncols, n_parts, rpp,
                       int(sum(H_off)))


@annotate("dist.build_dist_gt_plan")
def build_dist_gt_plan(A: CsrMatrix, n_parts: int, row_block: int = 8):
    """The distributed K3 plan: ``DistGtPlan2`` where more than one part has
    a sparse neighbour pattern, else ``DistGtPlan``."""
    assert A.nrows == A.ncols, "dist gt plan: square matrices"
    if n_parts > 1:
        p2 = build_dist_gt_plan2(A, n_parts, row_block)
        if p2 is not None:
            return p2
    return build_all_to_all_plan(A, n_parts, row_block)


def build_all_to_all_plan(A: CsrMatrix, n_parts: int, row_block: int = 8) -> DistGtPlan:
    """``DistGtPlan``: the padded all_to_all schedule whatever the pattern."""
    rm, ent, vals = _host_arrays(A)
    n = A.nrows
    rpp = round_up(-(-n // n_parts), row_block)
    send_idx, rem_cols, rem_ids, H = import_index(rm, ent, n, n_parts, rpp)
    locals_ = tuple(_local_csr_of_part(rm, ent, vals, p, n, rpp, rem_cols[p], rem_ids[p])
                    for p in range(n_parts))
    return DistGtPlan(send_idx, locals_, n, A.ncols, n_parts, rpp, H, rpp + n_parts * H,
                      no_remote=all(rc.size == 0 for rc in rem_cols))


def _k3_plan(csr, nrows: int, ncols: int, dev: torch.device):
    rm, ent, vals = csr
    A = CsrMatrix.from_arrays(rm, ent, vals, nrows=nrows, ncols=ncols, device=dev)
    return build_csr_plan(A, A.dtype)


@annotate("dist.shard_dist_gt_plan")
def shard_dist_gt_plan(plan, rank=None, device=None, group=None):
    """The rank's part of a ``DistGtPlan`` or ``DistGtPlan2`` on ``device``
    (None: the CUDA device), its local blocks as K3 plans; the host arrays
    of every part are not kept."""
    check_host(plan, "shard_dist_gt_plan")
    r, dev = shard_rank(rank, group), default_device(device)
    P, rpp = plan.n_parts, plan.rows_per_part
    if isinstance(plan, DistGtPlan):
        ncols = rpp if plan.no_remote else plan.ncols_ext
        return dataclasses.replace(plan, send_idx=to_dev(plan.send_idx[r].reshape(-1), dev, True),
                                   csr=_k3_plan(plan.local_csr[r], rpp, ncols, dev),
                                   local_csr=None, rank=r)
    # destination and source of each offset's block on this rank
    H = [int(sl.shape[1]) for sl in plan.send_lists]
    dst = [(r - d) % P for d in plan.offsets]
    src = [(r + d) % P for d in plan.offsets]
    send_splits, recv_splits = [0] * P, [0] * P
    for k in range(len(H)):
        send_splits[dst[k]], recv_splits[src[k]] = H[k], H[k]
    by_dst = sorted(range(len(H)), key=lambda k: dst[k])
    send = np.concatenate([plan.send_lists[k][r] for k in by_dst] or [np.zeros(0, np.int32)])
    # boundary columns: offset-major block k at bases[k] -> rank-major at rbase[k]
    bases = np.r_[0, np.cumsum(H)].astype(np.int64)
    order = sorted(range(len(H)), key=lambda k: src[k])
    rbase = np.zeros(len(H), np.int64)
    rbase[order] = np.r_[0, np.cumsum([H[k] for k in order])[:-1]] if H else []
    rm, cols, vals = plan.bnd_csr[r]
    blk = np.searchsorted(bases, cols, side="right") - 1
    cols = cols - bases[blk] + rbase[blk] if cols.size else cols
    return dataclasses.replace(
        plan, int_plan=_k3_plan(plan.int_csr[r], rpp, rpp, dev),
        bnd_plan=_k3_plan((rm, cols, vals), rpp, max(plan.halo_total, 1), dev),
        send=to_dev(send, dev, True), send_splits=send_splits, recv_splits=recv_splits,
        send_lists=None, int_csr=None, bnd_csr=None, rank=r)


@annotate("dist.dist_spmv_gt")
def dist_spmv_gt(plan, x_shard: torch.Tensor, group=None) -> torch.Tensor:
    """y = A·x on the rank's rows: one halo exchange, then K3 on the local
    block (``DistGtPlan``: over x_ext, or x_local where no part imports
    anything, as at one part; ``DistGtPlan2``: the interior block over
    x_local plus the boundary block over the received halo)."""
    check_shard(plan, "dist_spmv_gt")
    if isinstance(plan, DistGtPlan2):
        y = csr_spmv(plan.int_plan, x_shard)
        if plan.halo_total == 0:
            return y
        recv = exchange(x_shard[plan.send], plan.send_splits, plan.recv_splits, group)
        return y + csr_spmv(plan.bnd_plan, recv)
    if plan.no_remote:
        return csr_spmv(plan.csr, x_shard)
    recv = halo_exchange(x_shard, plan.send_idx, plan.halo, plan.n_parts, group)
    return csr_spmv(plan.csr, torch.cat([x_shard, recv]))


def dist_plan_accounting(plan) -> dict:
    """Multi-part overhead accounting for a ``DistGtPlan2``: the quantities
    that predict behaviour at more parts without running them.

    * bytes_exchanged: Σ over offsets of P · H_k · 4, the neighbour
      exchange's payload a SpMV (O(P·H), not the padded all_to_all's
      O(P²·H_max));
    * halo_per_part: Σ_d H_k (values each part imports);
    * stream_pad_ratio: padded over real entries of the local blocks that
      the kernels read; the port pads nothing, so 1.0 (``tpukk``'s TPU
      streams pad to common super-step counts);
    * padded_rows / real rows: the row-block padding of the partition.
    """
    P = plan.n_parts
    Hs = [int(sl.shape[1]) for sl in plan.send_lists]
    return dict(
        n_parts=P,
        offsets=list(plan.offsets),
        halo_per_offset=Hs,
        halo_per_part=int(plan.halo_total),
        bytes_exchanged=int(P * sum(Hs) * 4),
        stream_pad_ratio=float(plan.pad_ratio),
        padded_rows=int(plan.padded_rows),
        real_rows=int(plan.nrows),
        row_pad_ratio=float(plan.padded_rows / max(plan.nrows, 1)),
    )
