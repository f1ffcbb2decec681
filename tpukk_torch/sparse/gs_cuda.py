"""CUDA kernel wrappers for colored Gauss-Seidel — counterpart of
``_gi4_gs_fused_batched`` in ``tpukk/sparse/spmv_pallas.py``, which
``tpukk``'s sweep runs once per color.

K6 (``csrc/gs.cu``) has two entries, f32 and f64, for a vector or a
row-major (n, k) multivector with k ≤ 16; both relax a row as
``x ← (1−ω)·x + ω·invd·(b − A_offdiag·x)`` with the same arithmetic:

* ``gs_sweep``: a whole apply in one launch — every color step of every
  half-sweep, with the permutations into and out of color order (b read
  through ``order``, the result written through it) and the zero start
  (rows not yet written read 0) folded in.  ``gauss_seidel_apply`` runs its
  POINT and CLUSTER sweeps on it.
* ``gs_color_step``: one color block's update on its rows of the
  color-permuted x, one launch.  It is ``gs_sweep``'s yardstick on the card
  (``gs_sweep_per_color``: K5 into color order, a fill, a launch per color
  step at the sweep's lanes per row, K5 back, equal to ``gs_sweep`` bit for
  bit), and the color step that the distributed sweep maps onto.

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

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CPU tensor it runs its plain version (``gs_sweep_plain``,
``gs_color_step_plain``).  On a CUDA tensor it launches the kernel on the
current stream or raises: there is no fallback.  It adds one to its
``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..common import check
from ..common.permute import permute_gather, permute_plain
from .spmv_cuda import CsrPlan, csr_spmm_plain, lanes_per_row

__all__ = ["GsBlock", "gs_color_step", "gs_color_step_plain",
           "step_error_bound", "GsSweepPlan", "build_gs_sweep_plan", "sweep_steps", "gs_sweep",
           "gs_sweep_plain", "gs_sweep_per_color", "GS_MAX_K", "KERNELS", "launch_counts",
           "reset_launch_counts"]

GS_MAX_K = 16  # columns of K6's register panel


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
        shared, its own state and buffers."""
        return dataclasses.replace(
            self, csr=dataclasses.replace(self.csr, values=self.csr.values.to(dtype), _rows=None),
            inv_diag=self.inv_diag.to(dtype), _blocks=None, _steps={}, _bufs={})

    def steps(self, direction: str, num_sweeps: int, x_given: bool) -> SweepSteps:
        """The step list of an apply, built once per (direction, sweeps,
        x given, reps, chunk rows)."""
        key = (direction, num_sweeps, x_given, self.reps, self.chunk_rows)
        st = self._steps.get(key)
        if st is None:
            host, nchunks = sweep_steps(self, direction, num_sweeps, x_given)
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
    blocks dropped here) and the color ``order``."""
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
                       * (256 // group))


def sweep_steps(plan: GsSweepPlan, direction: str, num_sweeps: int, x_given: bool) -> tuple:
    """The steps of an apply, in order, as a (steps, 8) int32 array (fields
    ``STEP_FIELDS``), and the number of chunks.  Given x, a gather into color
    order comes first; otherwise the first half-sweep reads 0 for the rows
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
    chunks = -(-(st[:, 1] - st[:, 0]) // plan.chunk_rows)
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
        _kernels.DTYPE_CODE[x.dtype], csr.group, csr.row_map.data_ptr(), csr.entries.data_ptr(),
        csr.values.data_ptr(), blk.inv_diag.data_ptr(), b.data_ptr(), x.data_ptr(),
        out.data_ptr(), blk.start, blk.nrows, k, float(omega), _kernels.stream_of(x))
    _kernels.check_launch(err, "gs_color_step")
    gs_color_step.launches += 1
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
    ``order``; with ``permuted`` they are in color order already."""
    check(b.ndim in (1, 2) and b.shape[0] == plan.n,
          f"gs_sweep: b must be ({plan.n},) or ({plan.n}, k), got {tuple(b.shape)}")
    k = 1 if b.ndim == 1 else b.shape[1]
    check(1 <= k <= GS_MAX_K, f"gs_sweep: 1 to {GS_MAX_K} columns, got {k}")
    check(x is None or x.shape == b.shape, "gs_sweep: x and b shapes differ")
    dt, dev = plan.csr.values.dtype, plan.csr.values.device
    _kernels.check_operand(b, "gs_sweep", dt, dev)
    if x is not None:
        _kernels.check_operand(x, "gs_sweep", dt, dev)
    st = plan.steps(direction, num_sweeps, x is not None)
    if not _kernels.on_cuda(b, "gs_sweep"):
        return gs_sweep_plain(plan, x, b, omega, direction, num_sweeps, permuted)
    out = torch.empty_like(b)
    if plan.n == 0:
        return out
    # permuted: the result is the working buffer; else the plan keeps one
    work = out if permuted else plan.buffer("work", plan.n * k, b)
    scratch = plan.buffer("scratch", plan.coupled_rows * k, b) if plan.coupled_rows else None
    idx = None if permuted else plan.order.data_ptr()
    csr = plan.csr
    err = _kernels.library("gs").tpukk_gs_sweep(
        _kernels.DTYPE_CODE[b.dtype], csr.group, csr.row_map.data_ptr(), csr.entries.data_ptr(),
        csr.values.data_ptr(), plan.inv_diag.data_ptr(), st.steps.data_ptr(), st.host.shape[0],
        st.nchunks, plan.chunk_rows, b.data_ptr(), None if x is None else x.data_ptr(), idx, idx,
        work.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if permuted else out.data_ptr(), st.state.data_ptr(), k, float(omega),
        _kernels.stream_of(b))
    _kernels.check_launch(err, "gs_sweep")
    gs_sweep.launches += 1
    return out


def gs_sweep_per_color(plan: GsSweepPlan, x, b: torch.Tensor, omega: float,
                       direction: str = "symmetric", num_sweeps: int = 1,
                       permuted: bool = False) -> torch.Tensor:
    """The path ``gs_sweep`` replaces, kept as its yardstick on the card: K5
    into color order, a fill (x None), one ``gs_color_step`` launch per color
    step at the plan's lanes per row (CLUSTER's coupled blocks out of place),
    K5 back.  On the card it equals ``gs_sweep`` bit for bit."""
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


KERNELS = (gs_color_step, gs_sweep)
gs_color_step.launches = 0
gs_sweep.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
