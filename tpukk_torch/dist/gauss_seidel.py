"""Distributed colored Gauss-Seidel — counterpart of
``tpukk/dist/gauss_seidel.py``: a row-partitioned matrix, a global
distance-1 coloring, and one halo exchange before each color's update, so
that every rank reads fresh remote x values and the sweep is exactly the
sequential colored GS ordering, not a block-Jacobi approximation.

* ``DistGsPlan``: per color, ELL blocks of each part's rows of that color
  (x_ext column ids, the diagonal dropped), equal to ``tpukk``'s; its sweep
  gathers and updates in torch ops, as ``tpukk``'s ``jnp.take`` schedule.
* ``DistGsGtPlan``: each part's rows laid out color-block permuted, so each
  color's owned rows on a rank are one contiguous range [off_c, off_c +
  n_pc) of the permuted x_ext = [permuted local | halo].  A color step is
  then K6's ``gs_color_step`` on a ``GsBlock`` whose CSR columns index
  x_ext: no row mask and no kernel of its own (``tpukk`` runs
  ``_gi4_gs_fused_batched`` with a mask over padded color blocks).  Color
  blocks are padded to a common size across parts in multiples of
  ``row_block`` rows (``tpukk`` pads them to 4096 for its TPU kernel
  groups); pad rows are never updated.
* One part: the plan is the single-device colored GS with the SERIAL
  coloring (a ``GsHandle``), and a sweep is K6's fused ``gs_sweep``, one
  launch an apply.

A sweep runs on one rank and takes and returns the rank's shards of x and
b: its ``rows_per_part`` natural rows, or its ``rpp_perm`` permuted rows
with ``permuted=True`` (``DistGsGtPlan`` only); ``to_internal`` and
``to_natural`` convert a shard, or on the host plan the whole padded
vector.

``DistGsPrec`` is the sweep as a preconditioner of ``dist_pcg``: z = M⁻¹r,
symmetric sweeps from zero on a ``DistGsGtPlan`` shard, the global
multicolor Gauss-Seidel in the plan's color order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..common import TpuKKError, round_up
from ..common.tracing import annotate, profile_region
from ..common.types import default_device
from ..containers import CsrMatrix
from ..graph.coloring import ColoringAlgorithm, graph_color
from ..sparse import gs_cuda
from ..sparse.spmv_cuda import CsrPlan, lanes_per_row
from .halo import import_index, import_lists
from .spmv import check_host, check_shard, halo_exchange, shard_rank, to_dev

__all__ = ["DistGsPlan", "DistGsGtPlan", "DistGsPrec", "build_dist_gs_plan",
           "build_dist_gs_gt_plan", "shard_dist_gs_plan", "dist_gs_sweep"]


@dataclasses.dataclass
class DistGsPlan:
    send_idx: Any            # (P, P, H)
    color_cols: tuple        # per color: (P, Rc, Wc) x_ext ids (diag excluded)
    color_vals: tuple        # per color: (P, Rc, Wc)
    color_rows: tuple        # per color: (P, Rc) local row slot (pad -> rpp)
    color_invd: tuple        # per color: (P, Rc)
    nrows: int
    n_parts: int
    rows_per_part: int
    halo: int
    omega: float
    rank: Any = None         # a rank's shard: its slices as tensors on its device

    @property
    def padded_rows(self):
        return self.n_parts * self.rows_per_part

    @property
    def num_colors(self):
        return len(self.color_cols)


@annotate("dist.build_dist_gs_plan")
def build_dist_gs_plan(A: CsrMatrix, n_parts: int, omega: float = 1.0,
                       row_block: int = 8,
                       coloring: ColoringAlgorithm = ColoringAlgorithm.VB) -> DistGsPlan:
    assert A.nrows == A.ncols
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries().astype(np.int64)
    vals = A.host_values()
    n = A.nrows
    rpp = round_up(-(-n // n_parts), row_block)
    send_idx, ext_map, H = import_lists(rm, ent, n, n_parts, rpp)
    colors = graph_color(A, coloring)
    ncolors = int(colors.max())
    part_of = lambda g: min(int(g) // rpp, n_parts - 1)

    color_cols, color_vals, color_rows, color_invd = [], [], [], []
    for c in range(1, ncolors + 1):
        rows_c = np.nonzero(colors == c)[0]
        by_part = [rows_c[(rows_c // rpp).clip(max=n_parts - 1) == p] for p in range(n_parts)]
        Rc = round_up(max(1, max(r.size for r in by_part)), row_block)
        lens = rm[rows_c + 1] - rm[rows_c] if rows_c.size else np.zeros(0, np.int64)
        Wc = max(1, int(lens.max(initial=1)))
        cc = np.zeros((n_parts, Rc, Wc), np.int32)
        cv = np.zeros((n_parts, Rc, Wc), vals.dtype)
        cr = np.full((n_parts, Rc), rpp, np.int32)
        cd = np.zeros((n_parts, Rc), vals.dtype)
        for p in range(n_parts):
            lo = p * rpp
            for j, r in enumerate(by_part[p]):
                s, e = rm[r], rm[r + 1]
                cseg, vseg = ent[s:e], vals[s:e]
                t = 0
                diag = 0.0
                for ccol, vval in zip(cseg, vseg):
                    if ccol == r:
                        diag = vval
                        continue
                    cc[p, j, t] = (ccol - lo) if part_of(ccol) == p else ext_map[p][int(ccol)]
                    cv[p, j, t] = vval
                    t += 1
                cr[p, j] = r - lo
                cd[p, j] = 1.0 / diag if diag != 0 else 0.0
        color_cols.append(cc)
        color_vals.append(cv)
        color_rows.append(cr)
        color_invd.append(cd)
    return DistGsPlan(send_idx, tuple(color_cols), tuple(color_vals), tuple(color_rows),
                      tuple(color_invd), n, n_parts, rpp, H, float(omega))


@dataclasses.dataclass
class DistGsGtPlan:
    """Color-block permuted local rows, one CSR a (color, part) over the
    permuted x_ext, for K6.

    ``color_blocks[c][p]``: (row_map, columns, values, inv_diag) host arrays
    of part p's rows of color c, the diagonal dropped; ``rcs``/``offs``: each
    color block's rows (common to the parts) and first permuted row;
    ``to_perm_idx``/``from_perm_idx``: the whole-vector converters (the
    sentinel slot is an appended zero).  A rank's shard holds ``blocks``
    (one ``gs_cuda.GsBlock`` a color), its send list, and its own
    converters; the one-part plan holds ``single`` (host: the SERIAL colors;
    shard: the ``GsHandle``)."""

    send_idx: Any             # (P, P, H): permuted local ids to send
    color_blocks: tuple
    to_perm_idx: Any          # (P*rpp_perm,) natural-ext -> permuted
    from_perm_idx: Any        # (P*rpp,) permuted-ext -> natural
    rcs: tuple
    offs: tuple
    nrows: int
    n_parts: int
    rows_per_part: int        # natural rows per part
    rpp_perm: int             # permuted rows per part = sum(rcs)
    halo: int
    ncols_ext: int
    omega: float
    no_remote: bool = False   # no part imports anything: no exchange
    single: Any = None
    matrix: Any = None        # one part: the matrix the handle is built on
    blocks: Any = None
    rank: Any = None

    @property
    def padded_rows(self):
        return self.n_parts * self.rows_per_part

    @property
    def padded_perm_rows(self):
        return self.n_parts * self.rpp_perm

    @property
    def num_colors(self):
        if self.single is not None:
            return int(np.max(self.single)) if self.rank is None else len(
                self.single.color_offsets) - 1
        return len(self.color_blocks if self.blocks is None else self.blocks)

    # -- layout converters (outside a chain of sweeps) -------------------
    def to_internal(self, x_natural):
        """Natural padded rows -> color-blocked permuted rows: a rank's
        shard on a shard plan, the whole padded vector on the host plan."""
        return _gather_with_zero(x_natural, self.to_perm_idx)

    def to_natural(self, x_perm):
        return _gather_with_zero(x_perm, self.from_perm_idx)


def _gather_with_zero(x, idx):
    x = torch.as_tensor(x)
    xe = torch.cat([x, torch.zeros(1, dtype=x.dtype, device=x.device)])
    return xe[torch.as_tensor(idx, device=x.device).long()]


def _build_single_part_plan(A, omega, row_block, coloring):
    """One part: the single-device colored GS with the SERIAL coloring
    (the reference would not start its MPI machinery for one rank either).
    The internal layout is the handle's color order; its pad rows follow."""
    from ..sparse.gauss_seidel import GsAlgorithm, GsHandle, gauss_seidel_symbolic

    h = GsHandle(algorithm=GsAlgorithm.POINT, coloring=ColoringAlgorithm.SERIAL)
    gauss_seidel_symbolic(h, A)
    n = A.nrows
    rpp = round_up(n, row_block)
    to_perm = np.full(rpp, rpp, np.int64)       # pads -> appended zero
    to_perm[:n] = h.order
    from_perm = np.full(rpp, rpp, np.int64)
    from_perm[:n] = h.inv_order
    return DistGsGtPlan(
        send_idx=np.zeros((1, 1, 0), np.int32), color_blocks=(), to_perm_idx=to_perm,
        from_perm_idx=from_perm, rcs=(), offs=(), nrows=n, n_parts=1, rows_per_part=rpp,
        rpp_perm=rpp, halo=0, ncols_ext=rpp, omega=float(omega), no_remote=True,
        single=np.asarray(h.colors), matrix=A)


@annotate("dist.build_dist_gs_gt_plan")
def build_dist_gs_gt_plan(A: CsrMatrix, n_parts: int, omega: float = 1.0,
                          row_block: int = 8,
                          coloring: ColoringAlgorithm = ColoringAlgorithm.VB,
                          ) -> DistGsGtPlan:
    """The distributed colored-GS plan for K6: local rows laid out color-block
    permuted (a common block size a color across parts), each (color, part)
    block a CSR over the permuted x_ext, with 1/diag."""
    assert A.nrows == A.ncols
    if n_parts == 1:
        return _build_single_part_plan(A, omega, row_block, coloring)
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries().astype(np.int64)
    vals = np.asarray(A.host_values())
    n = A.nrows
    rpp = round_up(-(-n // n_parts), row_block)
    send_idx, rem_cols, rem_ids, H = import_index(rm, ent, n, n_parts, rpp)
    colors = graph_color(A, coloring)
    ncolors = int(colors.max())
    lens_all = rm[1:] - rm[:-1]
    rows_all = np.repeat(np.arange(n, dtype=np.int64), lens_all)
    diag = np.zeros(n, vals.dtype)
    dsel = rows_all == ent
    diag[rows_all[dsel]] = vals[dsel]

    # by_part_color[p][c-1] = global row ids of color c in part p, ascending
    by_part_color = []
    for p in range(n_parts):
        lo, hi = p * rpp, min(n, (p + 1) * rpp)
        col_p = colors[lo:hi]
        by_part_color.append([lo + np.nonzero(col_p == c)[0] for c in range(1, ncolors + 1)])
    rcs = tuple(round_up(max(1, max(by_part_color[p][c].size for p in range(n_parts))),
                         row_block) for c in range(ncolors))
    offs = tuple(int(np.sum(rcs[:c], dtype=np.int64)) for c in range(ncolors))
    rpp_perm = int(sum(rcs))
    ncols_ext = rpp_perm + n_parts * H

    # inv_perm[p]: natural local row -> permuted local position
    inv_perm = [np.full(rpp, rpp_perm, np.int64) for _ in range(n_parts)]
    for p in range(n_parts):
        for ci, rows_pc in enumerate(by_part_color[p]):
            inv_perm[p][rows_pc - p * rpp] = offs[ci] + np.arange(rows_pc.size)
    L_nat, L_perm = n_parts * rpp, n_parts * rpp_perm
    to_perm = np.full(L_perm, L_nat, np.int64)
    from_perm = np.full(L_nat, L_perm, np.int64)
    for p in range(n_parts):
        lo, hi = p * rpp, min(n, (p + 1) * rpp)
        orig_loc = np.arange(hi - lo, dtype=np.int64)
        newpos = inv_perm[p][orig_loc]
        to_perm[p * rpp_perm + newpos] = p * rpp + orig_loc
        from_perm[p * rpp + orig_loc] = p * rpp_perm + newpos
    # the send schedule in permuted local coordinates
    send_perm = np.zeros_like(send_idx)
    for q in range(n_parts):
        send_perm[q] = inv_perm[q][send_idx[q].astype(np.int64)].astype(send_idx.dtype)

    color_blocks = []
    for ci in range(ncolors):
        per_part = []
        for p in range(n_parts):
            lo = p * rpp
            rows_pc = by_part_color[p][ci]
            lens = lens_all[rows_pc]
            tot = int(lens.sum())
            base = np.cumsum(lens) - lens
            pos = np.arange(tot) - np.repeat(base, lens) + np.repeat(rm[rows_pc], lens)
            cseg, vseg = ent[pos], vals[pos]
            keep = cseg != np.repeat(rows_pc, lens)          # drop the diagonal
            jrow = np.repeat(np.arange(rows_pc.size, dtype=np.int64), lens)[keep]
            cseg, vseg = cseg[keep], vseg[keep]
            rm_pc = np.zeros(rows_pc.size + 1, np.int64)
            np.cumsum(np.bincount(jrow, minlength=rows_pc.size), out=rm_pc[1:])
            local = (cseg >= lo) & (cseg < lo + rpp)
            mapped = np.where(local, inv_perm[p][np.where(local, cseg - lo, 0)], 0)
            if rem_cols[p].size and (~local).any():
                ridx = np.searchsorted(rem_cols[p], cseg[~local])
                # remote x_ext ids move from the natural base to the permuted one
                mapped[~local] = rem_ids[p][ridx] - rpp + rpp_perm
            dloc = diag[rows_pc]
            with np.errstate(divide="ignore"):
                invd = np.where(dloc != 0, 1.0 / np.where(dloc == 0, 1, dloc), 0).astype(
                    vals.dtype)
            per_part.append((rm_pc, mapped, vseg, invd))
        color_blocks.append(tuple(per_part))
    no_remote = all(rc.size == 0 for rc in rem_cols)
    return DistGsGtPlan(send_perm, tuple(color_blocks), to_perm, from_perm, rcs, offs, n,
                        n_parts, rpp, rpp_perm, H, ncols_ext, float(omega), no_remote)


def _gs_block(block, start: int, ncols: int, dev: torch.device) -> gs_cuda.GsBlock:
    rm, cols, vals, invd = block
    nr = rm.shape[0] - 1
    coupled = bool(((cols >= start) & (cols < start + nr)).any())
    if coupled:
        raise TpuKKError("dist GS: a color block refers to its own rows (not a distance-1 "
                         "coloring)")
    csr = CsrPlan(to_dev(rm.astype(np.int32), dev), to_dev(cols.astype(np.int32), dev),
                  to_dev(vals, dev), nr, ncols, lanes_per_row(cols.shape[0], nr))
    return gs_cuda.GsBlock(csr, to_dev(invd, dev), int(start), False)


@annotate("dist.shard_dist_gs_plan")
def shard_dist_gs_plan(plan, rank=None, device=None, group=None):
    """The rank's part of a ``DistGsPlan`` or ``DistGsGtPlan`` on ``device``
    (None: the CUDA device); the host arrays of every part are not kept."""
    check_host(plan, "shard_dist_gs_plan")
    r, dev = shard_rank(rank, group), default_device(device)
    if isinstance(plan, DistGsPlan):
        rpp = plan.rows_per_part
        return dataclasses.replace(
            plan, send_idx=to_dev(plan.send_idx[r].reshape(-1), dev, True),
            color_cols=tuple(to_dev(c[r], dev, True) for c in plan.color_cols),
            color_vals=tuple(to_dev(c[r], dev) for c in plan.color_vals),
            color_rows=tuple(to_dev(c[r], dev, True) for c in plan.color_rows),
            color_invd=tuple(to_dev(c[r], dev) for c in plan.color_invd), rank=r)
    if plan.single is not None:
        from ..sparse.gauss_seidel import (GsAlgorithm, GsHandle, gauss_seidel_numeric,
                                           set_color_order)

        A = plan.matrix
        A = CsrMatrix.from_arrays(A.host_row_map(), A.host_entries(), A.host_values_full(),
                                  nrows=A.nrows, ncols=A.ncols, device=dev)
        h = GsHandle(algorithm=GsAlgorithm.POINT, coloring=ColoringAlgorithm.SERIAL)
        set_color_order(h, A, plan.single)
        gauss_seidel_numeric(h, A, plan.omega)
        return dataclasses.replace(plan, single=h, matrix=A,
                                   to_perm_idx=to_dev(plan.to_perm_idx, dev, True),
                                   from_perm_idx=to_dev(plan.from_perm_idx, dev, True), rank=r)
    P, rpp, rppp = plan.n_parts, plan.rows_per_part, plan.rpp_perm
    # this rank's converters: its slice of the whole-vector ones, made local
    to_p = plan.to_perm_idx[r * rppp:(r + 1) * rppp]
    to_p = np.where(to_p == P * rpp, rpp, to_p - r * rpp)
    from_p = plan.from_perm_idx[r * rpp:(r + 1) * rpp]
    from_p = np.where(from_p == P * rppp, rppp, from_p - r * rppp)
    blocks = tuple(_gs_block(cb[r], off, plan.ncols_ext, dev)
                   for cb, off in zip(plan.color_blocks, plan.offs))
    return dataclasses.replace(plan, send_idx=to_dev(plan.send_idx[r].reshape(-1), dev, True),
                               blocks=blocks, color_blocks=None,
                               to_perm_idx=to_dev(to_p, dev, True),
                               from_perm_idx=to_dev(from_p, dev, True), rank=r)


def _local_sweep(plan: DistGsPlan, x, b, reverse: bool, group):
    rpp, omega = plan.rows_per_part, plan.omega
    order = range(plan.num_colors - 1, -1, -1) if reverse else range(plan.num_colors)
    for c in order:
        recv = halo_exchange(x, plan.send_idx, plan.halo, plan.n_parts, group)
        x_ext = torch.cat([x, recv])
        rows = plan.color_rows[c]
        ax = torch.sum(plan.color_vals[c] * x_ext[plan.color_cols[c]], dim=1)
        safe = torch.clamp(rows, max=rpp - 1)
        xnew = (1.0 - omega) * x[safe] + omega * plan.color_invd[c] * (b[safe] - ax)
        xpad = torch.cat([x, torch.zeros(1, dtype=x.dtype, device=x.device)])
        xpad[rows] = xnew.to(x.dtype)
        x = xpad[:rpp]
    return x


def _local_sweep_k6(plan: DistGsGtPlan, xe, be, reverse: bool, group):
    """One direction on the permuted x_ext = [local | halo]: before each
    color, the halo refreshed by the exchange; then K6 on the color's
    block (in place: a distance-1 color block reads none of its rows)."""
    rppp = plan.rpp_perm
    order = reversed(plan.blocks) if reverse else plan.blocks
    for blk in order:
        if not plan.no_remote:
            xe[rppp:] = halo_exchange(xe, plan.send_idx, plan.halo, plan.n_parts, group)
        gs_cuda.gs_color_step(blk, xe, be, plan.omega)
    return xe


@annotate("dist.dist_gs_sweep")
def dist_gs_sweep(plan, x_shard, b_shard, num_sweeps: int = 1,
                  direction: str = "symmetric", permuted: bool = False, group=None):
    """Colored GS sweeps on the rank's shards of x and b (natural padded
    rows; with ``permuted`` and a ``DistGsGtPlan``, its permuted rows, and
    the result stays there); returns the new shard of x."""
    check_shard(plan, "dist_gs_sweep")
    if direction not in ("forward", "backward", "symmetric"):
        raise TpuKKError(f"dist_gs_sweep: unknown direction {direction!r}")
    fwd = direction in ("forward", "symmetric")
    bwd = direction in ("backward", "symmetric")
    if isinstance(plan, DistGsPlan):
        x = x_shard
        for _ in range(num_sweeps):
            if fwd:
                x = _local_sweep(plan, x, b_shard, False, group)
            if bwd:
                x = _local_sweep(plan, x, b_shard, True, group)
        return x
    if plan.single is not None:
        from ..sparse.gauss_seidel import gauss_seidel_apply

        n = plan.nrows
        out = gauss_seidel_apply(plan.single, plan.matrix, x_shard[:n].contiguous(),
                                 b_shard[:n].contiguous(), num_sweeps, direction, permuted)
        return torch.cat([out, x_shard.new_zeros(x_shard.shape[0] - n)])
    x = x_shard if permuted else plan.to_internal(x_shard)
    b = b_shard if permuted else plan.to_internal(b_shard)
    xe = x.new_zeros(plan.ncols_ext)
    be = b.new_zeros(plan.ncols_ext)
    xe[:plan.rpp_perm] = x
    be[:plan.rpp_perm] = b
    for _ in range(num_sweeps):
        if fwd:
            xe = _local_sweep_k6(plan, xe, be, False, group)
        if bwd:
            xe = _local_sweep_k6(plan, xe, be, True, group)
    x = xe[:plan.rpp_perm].clone()
    return x if permuted else plan.to_natural(x)


class DistGsPrec:
    """z = M⁻¹r on the rank's shard of r: ``sweeps`` symmetric colored
    Gauss-Seidel sweeps from x = 0 on a shard of a ``DistGsGtPlan`` (the
    forward half over the colors, then the backward half, the halo
    refreshed before each color), which is the global multicolor
    Gauss-Seidel in the plan's color order.  Each apply is the region
    ``tpukk::dist.gs_apply``."""

    def __init__(self, plan: DistGsGtPlan, sweeps: int = 1, group=None):
        check_shard(plan, "DistGsPrec")
        if not isinstance(plan, DistGsGtPlan):
            raise TpuKKError(f"DistGsPrec: a DistGsGtPlan shard, not {type(plan).__name__}")
        self.plan, self.sweeps, self.group = plan, int(sweeps), group

    def colors(self) -> np.ndarray:
        """The 1-based color of each of the rank's natural rows (pad rows:
        0), read from the plan's layout."""
        plan = self.plan
        if plan.single is not None:
            colors = np.zeros(plan.rows_per_part, np.int32)
            colors[:plan.nrows] = np.asarray(plan.single.colors)
            return colors
        pos = plan.from_perm_idx.cpu().numpy()
        color = np.searchsorted(np.asarray(plan.offs), pos, side="right").astype(np.int32)
        return np.where(pos < plan.rpp_perm, color, 0)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        with profile_region("tpukk::dist.gs_apply"):
            return dist_gs_sweep(self.plan, torch.zeros_like(r), r, self.sweeps, "symmetric",
                                 group=self.group)
