"""CUDA kernel wrappers for colored Gauss-Seidel — counterpart of
``_gi4_gs_fused_batched`` in ``tpukk/sparse/spmv_pallas.py``, which
``tpukk``'s sweep runs once per color.

K6 (``csrc/gs.cu``) has three entries, in f32, f64, complex64 and
complex128, for a vector or a row-major (n, k) multivector with k ≤ 16; each
relaxes a row as ``x ← (1−ω)·x + ω·invd·(b − A_offdiag·x)`` (ω real, invd =
1/diag in the values' dtype):

* ``gs_sweep``: a whole apply in one launch — every color step of every
  half-sweep, with the permutations into and out of color order (b read
  through ``order``, the result written through it) and the zero start
  (rows not yet written read 0) folded in.  ``gauss_seidel_apply`` runs its
  POINT and CLUSTER sweeps on it.
* ``gs_sweep_dia``: the same apply on the plan's index-free layout
  (``GsDiaLayout``), for a vector b; ``gs_sweep`` hands it the apply where
  the plan has the layout and b is one column.
* ``gs_color_step``: one color block's update on its rows of the
  color-permuted x, one launch.  It is ``gs_sweep``'s yardstick on the card
  (``gs_sweep_per_color``: K5 into color order, a fill, a launch per color
  step at the sweep's lanes per row, K5 back, equal to ``gs_sweep``'s CSR
  route bit for bit), and the color step that the distributed sweep maps
  onto.

A ``GsSweepPlan`` is the off-diagonal CSR of the whole color-permuted matrix
(columns renamed to the permuted space, no padding) with 1/diag, the block
row offsets, and per block whether it is ``coupled``: whether a row of the
block refers to a row of the same block.  An uncoupled block (every block of
a distance-1 coloring) is relaxed in place; a coupled one (a CLUSTER block)
into a scratch buffer that a second step copies into x, so its products all
read the old x, as in ``tpukk``.  The plan turns a direction and a number of
sweeps into a list of steps (``sweep_steps``) and keeps, per list, the device
state the kernel orders its steps with, and the working buffers, so a plan
serves one sweep at a time.  Its ``blocks`` are ``GsBlock`` views of the same
arrays, one per color, for ``gs_color_step``.

The sweep reads A as bytes bound it: on the CSR, each entry's value and its
4-byte column, twice a symmetric sweep, by groups of lanes a row.  Where the
rows of each color block have their entries on a few constant offsets
(permuted column − permuted row), as a stencil has in a structured coloring
(HPCG's 27 points in 8 parity colors: 26 offsets a block), the plan also
builds ``dia``, a layout of no indices: a block's values diagonal-major, one
thread a row reading consecutive values and gathering x at consecutive rows,
and a 32-bit mask a row for the slots that hold an entry.  The plan builds it
(``dia_layout``, torch ops on its device) where every block is uncoupled,
holds at most ``DIA_SLOTS`` offsets and has one entry a slot, and where it
reads fewer bytes than the CSR (padded slots × w + 4n against stored entries
× (w + 4) + 4n); ``to(dtype)`` weighs the bytes again at the new width.  Its
sweep also skips, from x = 0, every slot whose column the zero range holds.
It sums a row in slot order, so it differs from the CSR route by rounding
alone: ``gs_sweep_dia_plain`` is held to ``gs_sweep_plain`` within
``step_error_bound``.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CPU tensor it runs its plain version
(``gs_sweep_plain`` whatever the route, ``gs_sweep_dia_plain``,
``gs_color_step_plain``).  On a CUDA tensor it launches the kernel on the
current stream or raises: there is no fallback.  It adds one to its
``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..common import check, tracing
from ..common.permute import permute_gather, permute_plain
from .spmv_cuda import CsrPlan, csr_spmm_plain, lanes_per_row

__all__ = ["GsBlock", "gs_color_step", "gs_color_step_plain",
           "step_error_bound", "GsSweepPlan", "build_gs_sweep_plan", "sweep_steps", "gs_sweep",
           "gs_sweep_plain", "gs_sweep_per_color", "GsDiaLayout", "dia_layout", "gs_sweep_dia",
           "gs_sweep_dia_plain", "gs_dia_step_plain", "GS_MAX_K", "DIA_SLOTS", "DIA_CHUNK_ROWS",
           "KERNELS", "launch_counts", "reset_launch_counts"]

GS_MAX_K = 16  # columns of K6's register panel
DIA_SLOTS = 32  # offsets a color block may hold on K6's DIA route: one bit each of a row's mask
DIA_CHUNK_ROWS = 128  # rows a chunk ticket covers on the DIA route: a CUDA block, a row a thread


@dataclasses.dataclass
class GsBlock:
    """One color block of the permuted matrix, off-diagonal part."""

    csr: CsrPlan            # nrows × n, permuted-space column ids, no diagonal
    inv_diag: torch.Tensor  # (nrows,) in the values' dtype, 0 where the diagonal is 0
    start: int              # first row of the block in the permuted order
    coupled: bool           # a row of the block refers to a row of the block

    @property
    def nrows(self) -> int:
        return self.csr.nrows

    def to(self, dtype: torch.dtype) -> "GsBlock":
        """The same block with values and inv_diag in ``dtype``."""
        return dataclasses.replace(self, csr=dataclasses.replace(
            self.csr, values=self.csr.values.to(dtype)), inv_diag=self.inv_diag.to(dtype))


# a step of a sweep, int32 x 8 (csrc/gs.cu): rows [begin, end), mode, whether
# it writes the result, the zero range [zero_lo, zero_hi) (rows not yet
# written when the apply starts from x = 0), its first chunk ticket, and the
# chunks of the step before it that it waits on
STEP_FIELDS = ("begin", "end", "mode", "final", "zero_lo", "zero_hi", "chunk0", "wait")
GATHER, IN_PLACE, TO_SCRATCH, COPY = range(4)
DIRECTIONS = {"forward": (True,), "backward": (False,), "symmetric": (True, False)}
STATE_LINE = 32  # int32 counters a 128-byte line: K6's state keeps one a line


@dataclasses.dataclass
class SweepSteps:
    """One step list of a plan: host and device copies, and K6's state for
    it (int32: the ticket, the blocks-out count and each step's done count,
    each on its own 128-byte line)."""

    host: np.ndarray
    steps: torch.Tensor
    state: torch.Tensor
    nchunks: int


@dataclasses.dataclass
class GsDiaLayout:
    """K6's index-free operand layout of a sweep plan (``gs_sweep_dia``):
    for each color block c its distinct offsets (permuted column − permuted
    row), ascending, and its off-diagonal values diagonal-major,
    ``values[vbase[c] + d·nrows_c + i]`` for slot d of the block's row i, 0
    in a padded slot; a 32-bit mask a row marks the slots that hold an
    entry."""

    starts: torch.Tensor   # (blocks+1,) int32: the blocks' first rows
    offs: torch.Tensor     # (blocks, DIA_SLOTS) int32: each block's offsets, 0 past them
    vbase: torch.Tensor    # (blocks,) int64: each block's first value
    values: torch.Tensor   # (slots,) in the plan's dtype
    mask: torch.Tensor     # (n,) int32: bit d set where slot d of the row holds an entry
    ndiag: np.ndarray      # (blocks,) the number of offsets of each block

    @property
    def max_diags(self) -> int:
        return int(self.ndiag.max(initial=0))


def _dia_pays(slots: int, stored: int, itemsize: int) -> bool:
    """The route's rule on bytes: padded slots × w + a 4-byte mask a row
    against the CSR's stored entries × (w + 4) + 4-byte row pointers."""
    return slots * itemsize < stored * (itemsize + 4)


def dia_layout(csr: CsrPlan, offsets: np.ndarray, coupled) -> GsDiaLayout | None:
    """K6's DIA layout of a sweep plan's CSR (color blocks at ``offsets``),
    built in torch ops on the CSR's device; None where the CSR route stays:
    a coupled block, a block of more than ``DIA_SLOTS`` offsets, two entries
    of a row on one offset, or no fewer bytes than the CSR."""
    n, stored = csr.nrows, csr.entries.numel()
    if n == 0 or stored == 0 or any(coupled):
        return None
    dev = csr.entries.device
    starts = torch.from_numpy(np.asarray(offsets, np.int64)).to(dev)
    sizes = starts.diff()
    nb = sizes.numel()
    rows = torch.repeat_interleave(torch.arange(n, device=dev), csr.row_map.diff().long())
    blk = torch.repeat_interleave(torch.arange(nb, device=dev), sizes)[rows]
    # (block, offset) as one key: the distinct keys, ascending, are each
    # block's offsets in order, and an entry's slot is its key's rank within
    # the block
    key = blk * (2 * n) + (csr.entries.long() - rows + n)
    ukey, inv = torch.unique(key, return_inverse=True)
    del key
    ublk = torch.div(ukey, 2 * n, rounding_mode="floor")
    ndiag = torch.bincount(ublk, minlength=nb)
    if int(ndiag.max()) > DIA_SLOTS:
        return None
    first = torch.cumsum(ndiag, 0) - ndiag
    slot = inv - first[blk]
    del inv
    span = ndiag * sizes
    slots = int(span.sum())
    if not _dia_pays(slots, stored, csr.values.element_size()):
        return None
    vbase = torch.cumsum(span, 0) - span
    pos = vbase[blk] + slot * sizes[blk] + (rows - starts[blk])
    del blk
    taken = torch.zeros(slots, dtype=torch.bool, device=dev)
    taken[pos] = True
    if int(taken.sum()) != stored:
        return None
    del taken
    values = torch.zeros(slots, dtype=csr.values.dtype, device=dev)
    values[pos] = csr.values
    del pos
    mask = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, rows, 1 << slot)
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask).to(torch.int32)
    offs = torch.zeros(nb * DIA_SLOTS, dtype=torch.int32, device=dev)
    offs[ublk * DIA_SLOTS + torch.arange(ukey.numel(), device=dev) - first[ublk]] = (
        ukey - ublk * (2 * n) - n).to(torch.int32)
    return GsDiaLayout(starts.to(torch.int32), offs.view(nb, DIA_SLOTS), vbase, values, mask,
                       ndiag.cpu().numpy())


@dataclasses.dataclass
class GsSweepPlan:
    """The off-diagonal part of the whole color-permuted matrix, for K6."""

    csr: CsrPlan             # n × n, permuted-space columns; group: the sweep's lanes per row
    inv_diag: torch.Tensor   # (n,) in the values' dtype, 0 where the diagonal is 0
    offsets: np.ndarray      # (blocks+1,) row offsets of the (non-empty) color blocks
    entry_offsets: np.ndarray  # (blocks+1,) the blocks' first entries
    coupled: tuple           # per block: a row of the block refers to a row of the block
    order: torch.Tensor      # (n,) int32: xp[i] = x[order[i]], the sweep's src and dst
    reps: int = 1            # relaxations of each block per half-sweep (CLUSTER's inner sweeps)
    chunk_rows: int = 0      # rows a chunk ticket covers
    dia: GsDiaLayout | None = None  # the index-free layout, where the plan's rule takes it
    _blocks: list = dataclasses.field(default=None, repr=False)
    _steps: dict = dataclasses.field(default_factory=dict, repr=False)
    _bufs: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.csr.nrows

    @property
    def blocks(self) -> list:
        """Each color block as a ``GsBlock`` on views of the plan's arrays,
        at the block's own lanes per row (``gs_color_step``'s operands)."""
        if self._blocks is None:
            self._blocks = []
            for c, (s, e) in enumerate(zip(self.offsets[:-1], self.offsets[1:])):
                p0, p1 = int(self.entry_offsets[c]), int(self.entry_offsets[c + 1])
                csr = CsrPlan((self.csr.row_map[s:e + 1] - p0).contiguous(),
                              self.csr.entries[p0:p1], self.csr.values[p0:p1], int(e - s),
                              self.n, lanes_per_row(p1 - p0, int(e - s)))
                self._blocks.append(GsBlock(csr, self.inv_diag[s:e], int(s), self.coupled[c]))
        return self._blocks

    @property
    def coupled_rows(self) -> int:
        """Rows of the largest coupled block: the scratch K6 needs per column."""
        return max((int(e - s) for s, e, c in zip(self.offsets[:-1], self.offsets[1:],
                                                  self.coupled) if c), default=0)

    def to(self, dtype: torch.dtype) -> "GsSweepPlan":
        """The same plan with values and inv_diag in ``dtype``; index arrays
        shared, its own state and buffers; the DIA layout kept where its
        bytes still pay at the new width."""
        dia = self.dia
        if dia is not None:
            w = torch.empty((), dtype=dtype).element_size()
            dia = (dataclasses.replace(dia, values=dia.values.to(dtype))
                   if _dia_pays(dia.values.numel(), self.csr.values.numel(), w) else None)
        return dataclasses.replace(
            self, csr=dataclasses.replace(self.csr, values=self.csr.values.to(dtype), _rows=None),
            inv_diag=self.inv_diag.to(dtype), dia=dia, _blocks=None, _steps={}, _bufs={})

    def steps(self, direction: str, num_sweeps: int, x_given: bool,
              dia: bool = False) -> SweepSteps:
        """The step list of an apply on the CSR route or (``dia``) the DIA
        route, built once per (direction, sweeps, x given, reps, chunk rows)."""
        key = (direction, num_sweeps, x_given, self.reps,
               DIA_CHUNK_ROWS if dia else self.chunk_rows)
        st = self._steps.get(key)
        if st is None:
            host, nchunks = sweep_steps(self, direction, num_sweeps, x_given, dia)
            dev = self.order.device
            st = self._steps[key] = SweepSteps(
                host, torch.from_numpy(host).to(dev),
                torch.zeros((2 + host.shape[0]) * STATE_LINE, dtype=torch.int32, device=dev),
                nchunks)
        return st

    def buffer(self, name: str, numel: int, like: torch.Tensor) -> torch.Tensor:
        """A flat buffer of at least ``numel`` elements in like's dtype, kept
        by the plan (no fill) and grown for a wider multivector."""
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < numel:
            buf = self._bufs[name] = torch.empty(numel, dtype=like.dtype, device=like.device)
        return buf


def chunk_passes(max_block_rows: int) -> int:
    """Passes of a CUDA block's rows (256 threads / G) that one chunk ticket
    covers: 1, and 3 where a color block holds over 100,000 rows, so that a
    chunk amortises its two barriers and its release; fewer, longer chunks
    slow small blocks, where a step waits on its slowest chunk
    (scripts/k6_sweep_torch.py on the H100, PERF.md)."""
    return 3 if max_block_rows > 100_000 else 1


def build_gs_sweep_plan(row_map, entries, values, inv_diag, offsets, order,
                        device) -> GsSweepPlan:
    """Plan from host arrays of the color-permuted matrix without its
    diagonal: ``row_map`` (n+1,), ``entries`` in the permuted space,
    ``values``, ``inv_diag`` (n,), the color blocks' row ``offsets`` (empty
    blocks dropped here) and the color ``order``; with the DIA layout where
    ``dia_layout`` finds one."""
    rm = np.asarray(row_map, np.int64)
    ent = np.ascontiguousarray(entries, np.int32)
    n = rm.shape[0] - 1
    offsets = np.unique(np.asarray(offsets, np.int64))
    coupled = tuple(bool(((ent[rm[s]:rm[e]] >= s) & (ent[rm[s]:rm[e]] < e)).any())
                    for s, e in zip(offsets[:-1], offsets[1:]))
    group = lanes_per_row(ent.shape[0], n)
    csr = CsrPlan(torch.from_numpy(rm.astype(np.int32)).to(device), torch.from_numpy(ent).to(device),
                  torch.from_numpy(np.ascontiguousarray(values)).to(device), n, n, group)
    return GsSweepPlan(csr, torch.from_numpy(np.ascontiguousarray(inv_diag)).to(device), offsets,
                       rm[offsets], coupled,
                       torch.from_numpy(np.ascontiguousarray(order, np.int32)).to(device),
                       chunk_rows=chunk_passes(int(np.diff(offsets).max(initial=0)))
                       * (256 // group), dia=dia_layout(csr, offsets, coupled))


def sweep_steps(plan: GsSweepPlan, direction: str, num_sweeps: int, x_given: bool,
                dia: bool = False) -> tuple:
    """The steps of an apply, in order, as a (steps, 8) int32 array (fields
    ``STEP_FIELDS``), and the number of chunks, of the plan's
    ``chunk_rows`` or (``dia``) ``DIA_CHUNK_ROWS``.  Given x, a gather into
    color order comes first; otherwise the first half-sweep reads 0 for the rows
    not yet written: on a block's first relaxation its own rows and the
    blocks after it (before it, backward), on its later ones only those.
    The last half-sweep's last write of each row is marked final."""
    check(direction in DIRECTIONS, f"gs_sweep: unknown direction {direction!r}")
    check(num_sweeps >= 1, f"gs_sweep: num_sweeps must be at least 1, got {num_sweeps}")
    n, off, nb = plan.n, plan.offsets, len(plan.offsets) - 1
    halves = _halves(direction, num_sweeps)
    rows = [[0, n, GATHER, 0, 0, 0]] if x_given else []
    for h, fwd in enumerate(halves):
        first, last = h == 0 and not x_given, h == len(halves) - 1
        for c in (range(nb) if fwd else range(nb - 1, -1, -1)):
            s, e = int(off[c]), int(off[c + 1])
            for rep in range(plan.reps):
                zero = (0, 0)
                if first:
                    zero = (s if rep == 0 else e, n) if fwd else (0, e if rep == 0 else s)
                final = int(last and rep == plan.reps - 1)
                if plan.coupled[c]:
                    rows += [[s, e, TO_SCRATCH, 0, *zero], [s, e, COPY, final, 0, 0]]
                else:
                    rows.append([s, e, IN_PLACE, final, *zero])
    st = np.array(rows, np.int64).reshape(-1, 6)
    chunks = -(-(st[:, 1] - st[:, 0]) // (DIA_CHUNK_ROWS if dia else plan.chunk_rows))
    chunk0 = np.cumsum(chunks) - chunks
    wait = np.r_[0, chunks[:-1]][:len(chunks)]
    return np.column_stack([st, chunk0, wait]).astype(np.int32), int(chunks.sum())


def _as_columns(v: torch.Tensor) -> torch.Tensor:
    return v if v.ndim == 2 else v[:, None]


def gs_color_step_plain(blk: GsBlock, x: torch.Tensor, b: torch.Tensor,
                        omega: float) -> torch.Tensor:
    """Plain version of K6: the block's products from the old x (K7's plain
    version), then the update written into x's block rows."""
    xm, bm = _as_columns(x), _as_columns(b)
    s, e = blk.start, blk.start + blk.nrows
    ax = csr_spmm_plain(blk.csr, xm)
    xm[s:e] = (1.0 - omega) * xm[s:e] + omega * blk.inv_diag[:, None] * (bm[s:e] - ax)
    return x


def step_error_bound(blk: GsBlock, x: torch.Tensor, b: torch.Tensor,
                     omega: float) -> torch.Tensor:
    """Per-element bound on two evaluations of one color step that sum the
    block's products in different orders: 20·eps·(|1−ω|·|x| +
    |ω·invd|·(|b| + |A_offdiag|·|x|)) on the block's rows, x the old x; the
    shape of x's block rows."""
    s, e = blk.start, blk.start + blk.nrows
    abs_csr = dataclasses.replace(blk.csr, values=blk.csr.values.abs())
    ax = csr_spmm_plain(abs_csr, _as_columns(x.abs()))
    bound = (abs(1.0 - omega) * _as_columns(x.abs())[s:e]
             + abs(omega) * blk.inv_diag.abs()[:, None] * (_as_columns(b.abs())[s:e] + ax))
    return 20 * torch.finfo(x.dtype).eps * (bound if x.ndim == 2 else bound[:, 0])


def gs_color_step(blk: GsBlock, x: torch.Tensor, b: torch.Tensor, omega: float,
                  scratch: torch.Tensor | None = None) -> torch.Tensor:
    """K6: update the block's rows of the permuted x (a vector, or row-major
    (n, k) with k ≤ 16) and return x.  An uncoupled block is updated in
    place; a coupled one is written to the front of ``scratch`` (a flat
    buffer of at least nrows·k elements in x's dtype on x's device, kept by
    the caller across steps) or, without one, to a new buffer, and then
    copied into x.  The plain version has one mode and needs no buffer."""
    check(x.ndim in (1, 2) and x.shape == b.shape,
          f"gs_color_step: x {tuple(x.shape)} and b {tuple(b.shape)} must be one (n,) or (n, k) shape")
    k = 1 if x.ndim == 1 else x.shape[1]
    check(1 <= k <= GS_MAX_K, f"gs_color_step: 1 to {GS_MAX_K} columns, got {k}")
    check(blk.start + blk.nrows <= x.shape[0],
          f"gs_color_step: block rows [{blk.start}, {blk.start + blk.nrows}) beyond x's "
          f"{x.shape[0]} rows")
    csr = blk.csr
    check(csr.ncols == x.shape[0], f"gs_color_step: block of {csr.ncols} columns, x has "
          f"{x.shape[0]} rows")
    _kernels.check_operand(x, "gs_color_step", csr.values.dtype, csr.values.device)
    _kernels.check_operand(b, "gs_color_step", csr.values.dtype, csr.values.device)
    check(blk.inv_diag.dtype == csr.values.dtype and csr.row_map.device == x.device
          and csr.entries.device == x.device and blk.inv_diag.device == x.device,
          "gs_color_step: block arrays must be on x's device, inv_diag in the values' dtype")
    code = _kernels.dtype_code(x.dtype, _kernels.COMPLEX_DTYPE_CODE, "gs_color_step")
    if not _kernels.on_cuda(x, "gs_color_step"):
        return gs_color_step_plain(blk, x, b, omega)
    check(csr.row_map.dtype == torch.int32 and csr.entries.dtype == torch.int32
          and csr.row_map.is_contiguous() and csr.entries.is_contiguous()
          and csr.values.is_contiguous() and blk.inv_diag.is_contiguous(),
          "gs_color_step: block arrays must be contiguous, row_map/entries int32")
    if blk.nrows == 0:
        return x
    rows = slice(blk.start, blk.start + blk.nrows)
    if not blk.coupled:
        out = x[rows]
    elif scratch is None:
        out = torch.empty_like(x[rows])
    else:
        check(scratch.dtype == x.dtype and scratch.device == x.device
              and scratch.ndim == 1 and scratch.numel() >= blk.nrows * k,
              f"gs_color_step: scratch must be a flat {x.dtype} buffer on {x.device} of at "
              f"least {blk.nrows * k} elements")
        out = scratch[:blk.nrows * k].view(x[rows].shape)
    err = _kernels.library("gs").tpukk_gs_color_step(
        code, csr.group, csr.row_map.data_ptr(), csr.entries.data_ptr(),
        csr.values.data_ptr(), blk.inv_diag.data_ptr(), b.data_ptr(), x.data_ptr(),
        out.data_ptr(), blk.start, blk.nrows, k, float(omega), _kernels.stream_of(x))
    _kernels.check_launch(err, "gs_color_step")
    tracing.count("launches.gs_color_step")
    if blk.coupled:
        x[rows] = out
    return x


def _halves(direction: str, num_sweeps: int) -> list:
    return [fwd for _ in range(num_sweeps) for fwd in DIRECTIONS[direction]]


def gs_sweep_plain(plan: GsSweepPlan, x, b: torch.Tensor, omega: float,
                   direction: str = "symmetric", num_sweeps: int = 1,
                   permuted: bool = False) -> torch.Tensor:
    """Plain version of ``gs_sweep``: the step list in torch ops — b (and a
    given x) gathered through ``order``, ``gs_color_step_plain`` for each
    relaxation step (it is out of place, so a copy step has nothing left to
    do), x from zeros when not given, and the result scattered back through
    ``order``."""
    host = plan.steps(direction, num_sweeps, x is not None).host
    idx = None if permuted else plan.order
    bp = b if idx is None else permute_plain(idx, b)
    if x is None:
        xp = torch.zeros_like(bp)
    else:
        xp = x.clone() if idx is None else permute_plain(idx, x)
    blocks = {blk.start: blk for blk in plan.blocks}
    for begin, _, mode, *_ in host.tolist():
        if mode in (IN_PLACE, TO_SCRATCH):
            gs_color_step_plain(blocks[begin], xp, bp, omega)
    if idx is None:
        return xp
    out = torch.empty_like(xp)
    out[idx.long()] = xp
    return out


def gs_sweep(plan: GsSweepPlan, x, b: torch.Tensor, omega: float, direction: str = "symmetric",
             num_sweeps: int = 1, permuted: bool = False) -> torch.Tensor:
    """K6's fused sweep: ``num_sweeps`` forward, backward or symmetric
    sweeps of A·x = b from x (None: from zero), in one launch; returns the
    new x (a vector, or row-major (n, k) with k ≤ 16) and leaves x as it is.
    b and x are in natural order, read and written through the plan's
    ``order``; with ``permuted`` they are in color order already.  On the
    card a vector b on a plan with a DIA layout goes to ``gs_sweep_dia`` and
    every other apply runs on the CSR; on the CPU every apply runs
    ``gs_sweep_plain``."""
    check(b.ndim in (1, 2) and b.shape[0] == plan.n,
          f"gs_sweep: b must be ({plan.n},) or ({plan.n}, k), got {tuple(b.shape)}")
    k = 1 if b.ndim == 1 else b.shape[1]
    check(1 <= k <= GS_MAX_K, f"gs_sweep: 1 to {GS_MAX_K} columns, got {k}")
    check(x is None or x.shape == b.shape, "gs_sweep: x and b shapes differ")
    dt, dev = plan.csr.values.dtype, plan.csr.values.device
    _kernels.check_operand(b, "gs_sweep", dt, dev)
    if x is not None:
        _kernels.check_operand(x, "gs_sweep", dt, dev)
    code = _kernels.dtype_code(b.dtype, _kernels.COMPLEX_DTYPE_CODE, "gs_sweep")
    if not _kernels.on_cuda(b, "gs_sweep"):
        return gs_sweep_plain(plan, x, b, omega, direction, num_sweeps, permuted)
    if plan.dia is not None and k == 1:
        return gs_sweep_dia(plan, x, b, omega, direction, num_sweeps, permuted)
    st = plan.steps(direction, num_sweeps, x is not None)
    out = torch.empty_like(b)
    if plan.n == 0:
        return out
    # permuted: the result is the working buffer; else the plan keeps one
    work = out if permuted else plan.buffer("work", plan.n * k, b)
    scratch = plan.buffer("scratch", plan.coupled_rows * k, b) if plan.coupled_rows else None
    idx = None if permuted else plan.order.data_ptr()
    csr = plan.csr
    err = _kernels.library("gs").tpukk_gs_sweep(
        code, csr.group, csr.row_map.data_ptr(), csr.entries.data_ptr(),
        csr.values.data_ptr(), plan.inv_diag.data_ptr(), st.steps.data_ptr(), st.host.shape[0],
        st.nchunks, plan.chunk_rows, b.data_ptr(), None if x is None else x.data_ptr(), idx, idx,
        work.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if permuted else out.data_ptr(), st.state.data_ptr(), k, float(omega),
        _kernels.stream_of(b))
    _kernels.check_launch(err, "gs_sweep")
    tracing.count("launches.gs_sweep")
    return out


def gs_dia_step_plain(dia: GsDiaLayout, c: int, work: torch.Tensor, bp: torch.Tensor,
                      inv_diag: torch.Tensor, omega: float, zero_lo: int = 0,
                      zero_hi: int = 0) -> torch.Tensor:
    """One relaxation of color block ``c`` on the DIA layout in torch ops,
    from the color-ordered vector ``work``: the block's new rows.  A slot
    whose mask bit is clear, or whose column lies in [zero_lo, zero_hi), is
    neither read nor added, and x reads 0 there, so garbage in ``work``
    outside what the step reads does not reach the result."""
    s, e = int(dia.starts[c]), int(dia.starts[c + 1])
    nd, dev = int(dia.ndiag[c]), work.device
    rows = torch.arange(s, e, device=dev)
    cols = rows[None, :] + dia.offs[c, :nd].long()[:, None]
    live = ((dia.mask[s:e].long()[None, :] >> torch.arange(nd, device=dev)[:, None]) & 1) == 1
    live &= (cols < zero_lo) | (cols >= zero_hi)
    vb = int(dia.vbase[c])
    vals = dia.values[vb:vb + nd * (e - s)].view(nd, e - s)
    xs = work[cols.clamp(0, work.shape[0] - 1)]
    ax = torch.where(live, vals * xs, torch.zeros((), dtype=work.dtype, device=dev)).sum(0)
    xo = torch.where((rows >= zero_lo) & (rows < zero_hi),
                     torch.zeros((), dtype=work.dtype, device=dev), work[s:e])
    return (1.0 - omega) * xo + omega * inv_diag[s:e] * (bp[s:e] - ax)


def gs_sweep_dia_plain(plan: GsSweepPlan, x, b: torch.Tensor, omega: float,
                       direction: str = "symmetric", num_sweeps: int = 1,
                       permuted: bool = False) -> torch.Tensor:
    """Plain version of ``gs_sweep_dia``: its step list on the layout in
    torch ops, with the kernel's semantics — the plan's working buffer as it
    is (never filled), each step's zero range read as 0 (``gs_dia_step_plain``),
    only final steps writing the result."""
    dia = plan.dia
    host = plan.steps(direction, num_sweeps, x is not None, dia=True).host
    idx = None if permuted else plan.order.long()
    bp = b if idx is None else b[idx]
    out = torch.empty_like(b)
    work = out if permuted else plan.buffer("work", plan.n, b)[:plan.n]
    block_of = {start: c for c, start in enumerate(dia.starts.tolist())}
    for begin, end, mode, final, zlo, zhi, _, _ in host.tolist():
        if mode == GATHER:
            work[begin:end] = (x if idx is None else x[idx])[begin:end]
            continue
        work[begin:end] = gs_dia_step_plain(dia, block_of[begin], work, bp, plan.inv_diag,
                                            omega, zlo, zhi)
        if final and idx is not None:
            out[idx[begin:end]] = work[begin:end]
    return out


def gs_sweep_dia(plan: GsSweepPlan, x, b: torch.Tensor, omega: float,
                 direction: str = "symmetric", num_sweeps: int = 1,
                 permuted: bool = False) -> torch.Tensor:
    """K6's fused sweep on the plan's DIA layout, for a vector b: the
    arguments, steps and result of ``gs_sweep``, one launch, the products
    summed in slot order."""
    dia = plan.dia
    check(dia is not None, "gs_sweep_dia: the plan has no DIA layout")
    check(b.ndim == 1 and b.shape[0] == plan.n,
          f"gs_sweep_dia: b must be ({plan.n},), got {tuple(b.shape)}")
    check(x is None or x.shape == b.shape, "gs_sweep_dia: x and b shapes differ")
    dt, dev = dia.values.dtype, dia.values.device
    _kernels.check_operand(b, "gs_sweep_dia", dt, dev)
    if x is not None:
        _kernels.check_operand(x, "gs_sweep_dia", dt, dev)
    code = _kernels.dtype_code(b.dtype, _kernels.COMPLEX_DTYPE_CODE, "gs_sweep_dia")
    st = plan.steps(direction, num_sweeps, x is not None, dia=True)
    if not _kernels.on_cuda(b, "gs_sweep_dia"):
        return gs_sweep_dia_plain(plan, x, b, omega, direction, num_sweeps, permuted)
    out = torch.empty_like(b)
    work = out if permuted else plan.buffer("work", plan.n, b)
    idx = None if permuted else plan.order.data_ptr()
    err = _kernels.library("gs").tpukk_gs_sweep_dia(
        code, dia.max_diags, dia.starts.data_ptr(), len(dia.ndiag), dia.offs.data_ptr(),
        dia.vbase.data_ptr(), dia.values.data_ptr(), dia.mask.data_ptr(),
        plan.inv_diag.data_ptr(), st.steps.data_ptr(), st.host.shape[0], st.nchunks,
        DIA_CHUNK_ROWS, b.data_ptr(), None if x is None else x.data_ptr(), idx, idx,
        work.data_ptr(), None if permuted else out.data_ptr(), st.state.data_ptr(),
        float(omega), _kernels.stream_of(b))
    _kernels.check_launch(err, "gs_sweep_dia")
    tracing.count("launches.gs_sweep_dia")
    return out


def gs_sweep_per_color(plan: GsSweepPlan, x, b: torch.Tensor, omega: float,
                       direction: str = "symmetric", num_sweeps: int = 1,
                       permuted: bool = False) -> torch.Tensor:
    """The path ``gs_sweep`` replaces, kept as its yardstick on the card: K5
    into color order, a fill (x None), one ``gs_color_step`` launch per color
    step at the plan's lanes per row (CLUSTER's coupled blocks out of place),
    K5 back.  On the card it equals ``gs_sweep``'s CSR route bit for bit."""
    k = 1 if b.ndim == 1 else b.shape[1]
    idx = None if permuted else plan.order
    bp = b if idx is None else permute_gather(idx, b)
    if x is None:
        xp = torch.zeros_like(bp)
    else:
        xp = x.clone() if idx is None else permute_gather(idx, x)
    scratch = (torch.empty(plan.coupled_rows * k, dtype=b.dtype, device=b.device)
               if plan.coupled_rows else None)
    blocks = [dataclasses.replace(blk, csr=dataclasses.replace(blk.csr, group=plan.csr.group))
              for blk in plan.blocks]
    for fwd in _halves(direction, num_sweeps):
        for blk in (blocks if fwd else reversed(blocks)):
            for _ in range(plan.reps):
                gs_color_step(blk, xp, bp, omega, scratch)
    if idx is None:
        return xp
    inv = torch.empty_like(idx)
    inv[idx.long()] = torch.arange(plan.n, dtype=idx.dtype, device=idx.device)
    return permute_gather(inv, xp)


KERNELS = (gs_color_step, gs_sweep, gs_sweep_dia)


def launch_counts() -> dict:
    """The registry's ``launches.<kernel>`` counters of this module's kernels."""
    return tracing.launch_counts(KERNELS)


def reset_launch_counts() -> None:
    tracing.reset_launch_counts(KERNELS)
