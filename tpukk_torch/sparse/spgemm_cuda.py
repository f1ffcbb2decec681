"""CUDA kernel wrapper for the SpGEMM numeric phase — counterpart of
``tpukk/sparse/spgemm_pallas.py``.

One hand-written kernel closes the seven Pallas kernels of that file:

* ``spgemm_rows`` (K8, ``csrc/spgemm.cu``): C's values on C's pattern,
  ``C[i, j] = Σ_k A[i, k]·B[k, j]``, f32, f64, complex64 and complex128, a
  group of lanes a C row with an accumulator in shared memory — replaces the flat, dst-lane, gather-table
  and packed pair layouts (``_onehot_pair_call``, ``_dl_pair_call``,
  ``_dl_pair_call_batched``, ``_gt_pair_call``, ``_gtp_pk_call``) and the
  sort-based pipeline's ``_expand3_call`` and ``_rowperm3a_call``, which all
  compute this function from a pair plan.  Each C entry is summed from 0 in
  (A entry, B entry) order, the pair plan's order, so the kernel and its plain
  version give the same bits; a complex product is formed from its parts,
  (ar·br − ai·bi, ar·bi + ai·br), each operation rounded on its own, in both.

The wrapper checks device, dtype, shape and contiguity and raises on anything
else.  On a CPU tensor it runs the plain version beside it
(``spgemm_rows_plain``).  On a CUDA tensor it launches the kernel on the
current stream or raises: there is no fallback.  It adds one to its
``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..common import TpuKKError, check, tracing
from ..containers import expand_row_ids

__all__ = ["SpgemmRowPlan", "build_row_plan", "check_pattern", "spgemm_rows", "spgemm_rows_plain",
           "product_rn",
           "ROW_LANES", "SLOT_CAP", "KERNELS", "launch_counts", "reset_launch_counts"]

ROW_LANES = (1, 2, 4, 8, 16, 32)  # lanes a C row: the kernel's bins
SLOT_CAP = 6144             # shared slots a block (48 KB f32, 72 KB f64 and
#                             complex64, 120 KB complex128: the launch opts in)
_B_PER_LANE = 2             # a group's lanes: the longest B row of its A entries over this
ROW_THREADS = 1 << 17       # threads a launch keeps busy at least: few rows get more lanes
_MAX_BINS = 7               # kMaxBins in spgemm.cu: ROW_LANES in shared memory, 32 in global


@dataclasses.dataclass
class SpgemmRowPlan:
    """K8's plan for C = A·B on one device: A's, B's and C's patterns (int32,
    C's columns sorted within a row) and the rows that hold a C entry,
    ordered by bin (``order``), with the bin table the kernel takes by value
    (``table``: host int32, laid out as ``csrc/spgemm.cu``'s launch reads it)."""

    a_row_map: torch.Tensor
    a_entries: torch.Tensor
    b_row_map: torch.Tensor
    b_entries: torch.Tensor
    c_row_map: torch.Tensor
    c_entries: torch.Tensor
    ncols: int               # B's columns
    order: torch.Tensor      # (rows with a C entry,) int32, by bin
    table: np.ndarray        # host int32 bin table
    bins: list               # per bin: dict(lanes, rows, slots), for reports
    dups: bool               # some row of B repeats a column
    _expand: tuple = dataclasses.field(default=None, repr=False)

    @property
    def nnz_a(self) -> int:
        return int(self.a_entries.shape[0])

    @property
    def nnz_b(self) -> int:
        return int(self.b_entries.shape[0])

    @property
    def nnz_c(self) -> int:
        return int(self.c_entries.shape[0])

    @property
    def nrows(self) -> int:
        return int(self.c_row_map.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.c_row_map.device

    def expand(self):
        """(a_idx, b_idx, c_idx, ranks) of every product in (A entry, B entry)
        order: its A and B entry (int64), its C entry, and the products by
        rank among their C entry's (ranks[j]: the j-th product of each C entry
        that has one); built on first use by the plain version, whose calls
        then launch no host work (so a CUDA graph can hold them)."""
        if self._expand is None:
            self._expand = _expand_products(self)
        return self._expand


def build_row_plan(a_row_map, a_entries, b_row_map, b_entries, c_row_map, c_entries,
                   ncols: int) -> SpgemmRowPlan:
    """K8's plan from the three patterns (int32 tensors on one device), with
    torch ops on that device.

    A C row gets L lanes, the least of ROW_LANES at which the block's 256 / L
    rows fit SLOT_CAP shared slots and the rows give the launch ROW_THREADS
    threads: one lane, which adds the row's products one by one, keeps the
    most rows in flight.  A row of a group gets at least half as many lanes
    as the longest B row its entries of A name has entries (KKMEM's rule
    from the B-row length): more lanes would leave most idle, fewer would
    add a lane's products one by one.  A row of more than SLOT_CAP · 32 / 256 C
    entries accumulates in global memory (the last bin).  Records whether a
    row of B repeats a column (a group then leaves a row's products to one
    lane).  Checks that the patterns fit one another, since the kernel's
    reads do not."""
    arrays = (a_row_map, a_entries, b_row_map, b_entries, c_row_map, c_entries)
    dev = c_row_map.device
    check(all(t.device == dev and t.dtype == torch.int32 and t.ndim == 1 for t in arrays),
          "spgemm row plan: patterns must be rank-1 int32 on one device")
    arm, aent, brm, bent, crm, cent = (t.contiguous() for t in arrays)
    nrows, kdim = arm.shape[0] - 1, brm.shape[0] - 1
    check(nrows >= 0 and kdim >= 0 and crm.shape[0] == nrows + 1,
          "spgemm row plan: row map lengths do not match (A and C have the same rows)")
    for name, rm, ent in (("A", arm, aent), ("B", brm, bent), ("C", crm, cent)):
        check(int(rm[0]) == 0 and int(rm[-1]) == ent.shape[0] and bool((rm[1:] >= rm[:-1]).all()),
              f"spgemm row plan: {name}'s row map does not rise from 0 to its entries")
    for name, ent, bound in (("A", aent, kdim), ("B", bent, ncols), ("C", cent, ncols)):
        check(ent.numel() == 0 or (int(ent.min()) >= 0 and int(ent.max()) < bound),
              f"spgemm row plan: a column of {name} lies outside [0, {bound})")
    c_len = (crm[1:] - crm[:-1]).long()
    b_len = (brm[1:] - brm[:-1]).long()
    b_most = torch.zeros(nrows, dtype=torch.int64, device=dev).scatter_reduce_(
        0, expand_row_ids(arm, aent.shape[0]), b_len[aent.long()], reduce="amax")
    live = torch.nonzero(c_len > 0).reshape(-1)
    need = ((c_len * 256 + SLOT_CAP - 1) // SLOT_CAP).clamp_min(
        -(-ROW_THREADS // max(live.numel(), 1)))
    need = torch.where(need > 1, torch.maximum(need, (b_most + _B_PER_LANE - 1) // _B_PER_LANE),
                       need)
    bin_of = sum((need > L).long() for L in ROW_LANES[:-1])  # lanes ROW_LANES[bin_of]
    bin_of[c_len > SLOT_CAP * ROW_LANES[-1] // 256] = len(ROW_LANES)
    key = bin_of[live]
    order = live[torch.argsort(key, stable=True)]
    counts = torch.bincount(key, minlength=_MAX_BINS).tolist()
    slots = torch.zeros(_MAX_BINS, dtype=torch.int64, device=dev).scatter_reduce_(
        0, key, c_len[live], reduce="amax").tolist()
    b_keys = expand_row_ids(brm, bent.shape[0]) * max(ncols, 1) + bent.long()
    dups = bool(torch.unique(b_keys).numel() < b_keys.numel())
    table = np.zeros(3 + _MAX_BINS + 4 * _MAX_BINS, np.int32)
    bins, block, first = [], 0, 0
    for b in range(_MAX_BINS):
        if counts[b] == 0:
            continue
        L = ROW_LANES[min(b, len(ROW_LANES) - 1)]
        stride = 0 if b == len(ROW_LANES) else int(slots[b])
        n = len(bins)
        table[2 + n] = block
        table[3 + _MAX_BINS + 4 * n: 7 + _MAX_BINS + 4 * n] = (first, counts[b], L, stride)
        bins.append(dict(lanes=L, rows=counts[b], slots=stride, global_memory=stride == 0))
        block += -(-counts[b] // (256 // L))
        first += counts[b]
    table[0], table[1] = len(bins), int(dups)
    table[2 + len(bins)] = block
    check(block < 2**31, "spgemm row plan: too many blocks for one launch")
    return SpgemmRowPlan(arm, aent, brm, bent, crm, cent, int(ncols),
                         order.to(torch.int32).contiguous(), table, bins, dups)


def check_pattern(plan: SpgemmRowPlan) -> None:
    """Raise where C's pattern lacks a column that A·B reaches: K8 finds a
    product's slot by a binary search and does not check what it finds."""
    _expand_products(plan)


def _expand_products(plan: SpgemmRowPlan):
    """Every product of C = A·B in (A entry, B entry) order, as
    ``spgemm.symbolic_plain`` expands them, with its slot in C's row found by
    ``searchsorted``; raises if C's pattern lacks a product's column."""
    dev = plan.device
    arm, aent, brm = plan.a_row_map.long(), plan.a_entries.long(), plan.b_row_map.long()
    expand = (brm[1:] - brm[:-1])[aent]
    P = int(expand.sum())
    a_idx = torch.repeat_interleave(torch.arange(aent.shape[0], device=dev), expand,
                                    output_size=P)
    within = torch.arange(P, device=dev) - torch.repeat_interleave(
        torch.cumsum(expand, 0) - expand, expand, output_size=P)
    b_idx = brm[aent][a_idx] + within
    rows = expand_row_ids(arm, aent.shape[0])[a_idx]
    width = max(plan.ncols, 1)
    ckey = expand_row_ids(plan.c_row_map, plan.nnz_c) * width + plan.c_entries.long()
    key = rows * width + plan.b_entries.long()[b_idx]
    c_idx = torch.searchsorted(ckey, key)
    if P and (int(c_idx.max()) >= plan.nnz_c or not bool((ckey[c_idx] == key).all())):
        raise TpuKKError("spgemm_rows: C's pattern lacks a column that A·B reaches")
    # rank of each product among its C entry's, in expansion order
    by_c = torch.argsort(c_idx, stable=True)
    counts = torch.bincount(c_idx, minlength=plan.nnz_c)
    rank = torch.empty(P, dtype=torch.int64, device=dev)
    rank[by_c] = torch.arange(P, device=dev) - (torch.cumsum(counts, 0) - counts)[c_idx[by_c]]
    by_rank = torch.argsort(rank, stable=True)
    ranks = torch.split(by_rank, torch.bincount(rank).tolist()) if P else ()
    return a_idx, b_idx, c_idx, ranks


def spgemm_rows_plain(plan: SpgemmRowPlan, a_vals: torch.Tensor,
                      b_vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the rounded products, added into each C entry
    from 0 in (A entry, B entry) order, one rank of products at a time (the
    j-th product of every C entry), so it gives the kernel's bits.  A
    complex product is formed from its parts as the kernel forms it."""
    a_idx, b_idx, c_idx, ranks = plan.expand()
    prod = product_rn(a_vals[a_idx], b_vals[b_idx])
    out = torch.zeros(plan.nnz_c, dtype=prod.dtype, device=prod.device)
    for seg in ranks:
        c = c_idx[seg]
        out[c] = out[c] + prod[seg]
    return out


def product_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b elementwise; complex as (ar·br − ai·bi, ar·bi + ai·br), each
    operation a torch op of its own (rounded on its own: no FMA), which is
    K8's formula and order (``spgemm.cu``'s mul_rn)."""
    if not a.dtype.is_complex:
        return a * b
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def spgemm_rows(plan: SpgemmRowPlan, a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """K8: C's values (nnz_c,) for A's and B's values of one dtype, f32,
    f64, complex64 or complex128, on the plan's device."""
    check(a_vals.ndim == 1 and b_vals.ndim == 1, "spgemm_rows: values must be rank-1")
    code = _kernels.dtype_code(a_vals.dtype, _kernels.COMPLEX_DTYPE_CODE, "spgemm_rows")
    _kernels.check_operand(a_vals, "spgemm_rows", a_vals.dtype, plan.device)
    _kernels.check_operand(b_vals, "spgemm_rows", a_vals.dtype, plan.device)
    # the kernel does not bounds-check its reads: the values must fit the patterns
    check(a_vals.shape[0] == plan.nnz_a and b_vals.shape[0] == plan.nnz_b,
          f"spgemm_rows: values of lengths ({a_vals.shape[0]}, {b_vals.shape[0]}), "
          f"plan made for ({plan.nnz_a}, {plan.nnz_b})")
    if not _kernels.on_cuda(a_vals, "spgemm_rows"):
        return spgemm_rows_plain(plan, a_vals, b_vals)
    c = torch.empty(plan.nnz_c, dtype=a_vals.dtype, device=a_vals.device)
    if plan.nnz_c == 0:
        return c
    err = _kernels.library("spgemm").tpukk_spgemm_rows(
        code, plan.a_row_map.data_ptr(), plan.a_entries.data_ptr(),
        a_vals.data_ptr(), plan.b_row_map.data_ptr(), plan.b_entries.data_ptr(),
        b_vals.data_ptr(), plan.c_row_map.data_ptr(), plan.c_entries.data_ptr(), c.data_ptr(),
        plan.order.data_ptr(), plan.table.ctypes.data, _kernels.stream_of(a_vals))
    _kernels.check_launch(err, "spgemm_rows")
    tracing.count("launches.spgemm_rows")
    return c


KERNELS = (spgemm_rows,)


def launch_counts() -> dict:
    """The registry's ``launches.<kernel>`` counters of this module's kernels."""
    return tracing.launch_counts(KERNELS)


def reset_launch_counts() -> None:
    tracing.reset_launch_counts(KERNELS)
