"""The gather-table probe's kernel — counterpart of the three Pallas kernels
of ``scripts/probe_ss_cost.py`` (``make_base`` :40, ``make_packed_opt`` :76,
``make_mt4`` :121), which measure the per-super-step cost of ``tpukk``'s
gather-table SpMV layout.

A ``ProbePlan`` holds one synthetic schedule: ``n_ss`` super-steps of B
chunks each; step g writes output block ``dst[g]`` (one (8, 128) tile, or
four for "mt4"), overwriting it when ``first[g]`` and accumulating
otherwise; chunk j of step g gathers from source block s (rows 32·s to
32·s+31 of x) through an (8, 128) index row pair (gt, lo), or one packed
stream pk = gt << 13 | lo, and multiplies by an (8, 128) value row.

K9 walks one chunk list a lane, a lane being an output tile (a block, or one
of mt4's four sub-tiles of a block).  The host builds the lists once
(``lane_ptr``, ``lane_rec``): the chunks of the lane's steps in (g, j)
order, mt4's chunks under their own sub-tile only, each record holding the
chunk, its source block and whether it ends its step.  Steps before a
block's last first step are left out (that step overwrites what they
wrote), and so are a lane's steps without a chunk after it (they add +0);
the lane's y then starts at +0 and adds each step's sum.  That is the plain
version's y bit for bit: a sum that starts at +0 is never -0, so +0 + acc
is acc and y + 0 is y.

``probe_gather_acc`` is K9's wrapper (``csrc/probe.cu``): on a CPU tensor it
runs the plain version ``probe_plain`` (the same arithmetic as a torch loop
over super-steps); on a CUDA tensor it launches the kernel or raises.  It
adds one to its ``launches`` count each time it launches the kernel, and
nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tracing
from .errors import check

__all__ = ["ProbePlan", "build_probe_plan", "lane_lists", "probe_gather_acc", "probe_plain",
           "VARIANTS", "SRC_ROWS", "KERNELS", "launch_counts", "reset_launch_counts"]

SRC_ROWS = 32                                  # rows of one source block of x
VARIANTS = {"base": 1, "packed_opt": 1, "mt4": 4}   # output tiles per block


@dataclasses.dataclass
class ProbePlan:
    """Device arrays of one probe schedule (see the module docstring).
    ``gt`` holds pk for the packed variants, and ``lo`` is then None."""

    variant: str
    B: int
    n_ss: int
    n_blocks: int
    n_src: int               # source blocks of x: x is (32·n_src, 128)
    src: torch.Tensor        # (n_ss·B,) int32; mt4: s << 2 | sub-tile
    first: torch.Tensor      # (n_ss,) int32
    gt: torch.Tensor         # (8·B·n_ss, 128) int32
    lo: torch.Tensor | None  # (8·B·n_ss, 128) int32
    v: torch.Tensor          # (8·B·n_ss, 128) f32
    lane_ptr: torch.Tensor   # (n_blocks·tiles + 1,) int32: lane L's records
    lane_rec: torch.Tensor   # (records, 2) int32: chunk, s << 1 | ends its step
    dst: np.ndarray          # (n_ss,) host output block of every step
    first_host: np.ndarray   # (n_ss,) host copy of first, for the plain version

    @property
    def tiles(self) -> int:
        return VARIANTS[self.variant]

    @property
    def packed(self) -> bool:
        return self.lo is None

    @property
    def out_rows(self) -> int:
        return self.n_blocks * 8 * self.tiles

    def stream_bytes(self) -> int:
        """Bytes of the streamed index and value rows."""
        return sum(t.numel() * 4 for t in (self.gt, self.lo, self.v) if t is not None)


def build_probe_plan(variant: str, dst, src, first, v, gt=None, lo=None, pk=None, *,
                     n_blocks: int, n_src: int, device) -> ProbePlan:
    """Plan from host arrays: dst, first (n_ss,); src (n_ss·B,) (for "mt4"
    s << 2 | sub-tile); v and either gt and lo ("base") or pk (the packed
    variants), each (8·B·n_ss, 128).  Indices are checked here on the host
    (x has n_src source blocks), since K9 trusts them."""
    check(variant in VARIANTS, f"probe: unknown variant {variant!r}")
    dst = np.asarray(dst, np.int64)
    n_ss = dst.shape[0]
    src = np.asarray(src, np.int64)
    check(n_ss > 0 and src.shape[0] % n_ss == 0, "probe: src must hold B chunks a step")
    B = src.shape[0] // n_ss
    shape = (8 * B * n_ss, 128)
    check(v.shape == shape, f"probe: v must be {shape}")
    check(bool(((dst >= 0) & (dst < n_blocks)).all()), "probe: dst outside the output blocks")
    s = src >> 2 if variant == "mt4" else src
    check(bool(((s >= 0) & (s < n_src)).all()), "probe: src outside x's source blocks")
    if variant == "base":
        check(gt is not None and lo is not None and pk is None, "probe: base takes gt and lo")
        idx, lo_ = np.asarray(gt), np.asarray(lo)
        gt_vals, lo_vals = idx, lo_
    else:
        check(pk is not None and gt is None and lo is None, f"probe: {variant} takes pk")
        idx, lo_ = np.asarray(pk), None
        gt_vals, lo_vals = 8 * (idx >> 16) + ((idx >> 13) & 7), idx & 1023
    check(idx.shape == shape and (lo_ is None or lo_.shape == shape),
          f"probe: index streams must be {shape}")
    check(bool(((gt_vals >= 0) & (gt_vals < SRC_ROWS)).all()
               and ((lo_vals >= 0) & (lo_vals < 128)).all()),
          "probe: gt must lie in [0, 32) and lo in [0, 128)")
    lane_ptr, lane_rec = lane_lists(dst, np.asarray(first, np.int64), src, B,
                                    n_blocks, VARIANTS[variant])

    def dev(a, dt=np.int32):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)

    return ProbePlan(variant=variant, B=B, n_ss=n_ss, n_blocks=n_blocks, n_src=n_src,
                     src=dev(src), first=dev(first), gt=dev(idx),
                     lo=None if lo_ is None else dev(lo_), v=dev(v, np.float32),
                     lane_ptr=dev(lane_ptr), lane_rec=dev(lane_rec), dst=dst,
                     first_host=np.asarray(first, np.int64))


def lane_lists(dst: np.ndarray, first: np.ndarray, src: np.ndarray, B: int, n_blocks: int,
               tiles: int):
    """K9's chunk list a lane (lane = block·tiles + sub-tile): ``lane_ptr``
    (n_blocks·tiles + 1,) and ``lane_rec`` (records, 2), each record the
    chunk g·B + j and s << 1 | (it is the lane's last chunk of step g), in
    (g, j) order within a lane.  A block's steps before its last first step
    are dropped, and so are steps that give a lane no chunk (module
    docstring)."""
    n_ss = dst.shape[0]
    g = np.arange(n_ss)
    cut = np.full(n_blocks, -1, np.int64)
    np.maximum.at(cut, dst[first != 0], g[first != 0])
    chunk = np.flatnonzero(np.repeat(g >= cut[dst], B))      # the kept steps' chunks
    step = chunk // B
    lane = dst[step] * tiles + (src[chunk] & 3 if tiles == 4 else 0)
    order = np.argsort(lane, kind="stable")                    # chunk order within a lane
    chunk, step, lane = chunk[order], step[order], lane[order]
    ends = np.ones(chunk.shape[0], np.int64)
    ends[:-1] = (lane[1:] != lane[:-1]) | (step[1:] != step[:-1])
    s = src[chunk] >> 2 if tiles == 4 else src[chunk]
    lane_ptr = np.zeros(n_blocks * tiles + 1, np.int64)
    np.cumsum(np.bincount(lane, minlength=n_blocks * tiles), out=lane_ptr[1:])
    return lane_ptr, np.stack([chunk, (s << 1) | ends], axis=1)


def _gathered(plan: ProbePlan, x: torch.Tensor) -> torch.Tensor:
    """v ⊙ xg of every chunk: (n_ss·B, 8, 128)."""
    nch = plan.n_ss * plan.B
    idx = plan.gt.long().view(nch, 8, 128)
    if plan.packed:
        lo = idx & 1023
        gt_row = 8 * (idx >> 16) + ((idx >> 13) & 7)
    else:
        lo = plan.lo.long().view(nch, 8, 128)
        gt_row = idx
    s = plan.src.long()
    if plan.variant == "mt4":
        s = s >> 2
    gi = torch.gather(gt_row, 2, lo)                  # gt[r, lo[r, c]]
    rows = s.view(nch, 1, 1) * SRC_ROWS + gi
    return plan.v.view(nch, 8, 128) * x[rows, lo]


def probe_plain(plan: ProbePlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: every chunk's products at once, each step's sum
    over its chunks in order, then a loop over the super-steps."""
    con = _gathered(plan, x).view(plan.n_ss, plan.B, 8, 128)
    tiles = plan.tiles
    acc = torch.zeros(plan.n_ss, tiles, 8, 128, dtype=x.dtype, device=x.device)
    sub = (plan.src.long() & 3).view(plan.n_ss, plan.B) if tiles == 4 else None
    steps = torch.arange(plan.n_ss, device=x.device)
    for j in range(plan.B):
        q = sub[:, j] if tiles == 4 else 0
        acc[steps, q] = acc[steps, q] + con[:, j]
    acc = acc.view(plan.n_ss, tiles * 8, 128)
    y = torch.zeros(plan.n_blocks, tiles * 8, 128, dtype=x.dtype, device=x.device)
    for g, (d, f) in enumerate(zip(plan.dst.tolist(), plan.first_host.tolist())):
        y[d] = acc[g] if f else y[d] + acc[g]
    return y.view(plan.out_rows, 128)


def probe_gather_acc(plan: ProbePlan, x: torch.Tensor) -> torch.Tensor:
    """K9: the probe's output y (n_blocks·8·tiles, 128) f32 from x
    (32·n_src, 128) f32."""
    from .. import _kernels

    check(x.ndim == 2 and tuple(x.shape) == (SRC_ROWS * plan.n_src, 128),
          f"probe_gather_acc: x must be ({SRC_ROWS * plan.n_src}, 128), got {tuple(x.shape)}")
    _kernels.check_operand(x, "probe_gather_acc", torch.float32, plan.v.device)
    if not _kernels.on_cuda(x, "probe_gather_acc"):
        return probe_plain(plan, x)
    check(all(t.is_contiguous() for t in (plan.gt, plan.lo, plan.v, plan.lane_rec)
              if t is not None), "probe_gather_acc: the plan's arrays must be contiguous")
    y = torch.empty(plan.out_rows, 128, dtype=torch.float32, device=x.device)
    err = _kernels.library("probe").tpukk_probe_gather_acc(
        int(plan.packed), x.data_ptr(), plan.lane_ptr.data_ptr(),
        plan.lane_rec.data_ptr(), plan.gt.data_ptr(),
        None if plan.lo is None else plan.lo.data_ptr(), plan.v.data_ptr(), y.data_ptr(),
        plan.n_blocks * plan.tiles, _kernels.stream_of(x))
    _kernels.check_launch(err, "probe_gather_acc")
    tracing.count("launches.probe_gather_acc")
    return y


KERNELS = (probe_gather_acc,)


def launch_counts() -> dict:
    """The registry's ``launches.<kernel>`` counters of this module's kernels."""
    return tracing.launch_counts(KERNELS)


def reset_launch_counts() -> None:
    tracing.reset_launch_counts(KERNELS)
