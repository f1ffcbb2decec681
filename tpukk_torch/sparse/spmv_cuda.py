"""CUDA kernel wrappers for SpMV — counterpart of ``tpukk/sparse/spmv_pallas.py``.

Four hand-written kernels (``tpukk_torch/csrc``) close the 16 Pallas kernels
of the SpMV and SpMM paths; the Gauss-Seidel color step of ``spmv_pallas.py``
is K6 (``gs_cuda.py``):

* ``dia_spmv`` (K1, ``csrc/dia.cu``): banded SpMV in f32 and f64 — replaces
  ``_dia_call`` and the double-single ``_dia_ds_call``.
* ``dia_spmm`` (K2, ``csrc/dia.cu``): banded SpMM, one diagonal pass for all
  k columns — replaces ``_dia_mv_call``.
* ``csr_spmv`` (K3, ``csrc/csr.cu``): unstructured CSR SpMV, sum or max, f32
  and f64, a block a tile of the plan's entry-balanced tiles of whole rows
  (``build_csr_tiles``), read through L1 or, for a matrix that streams from
  device memory, past it — replaces the seven one-hot/gather-table layouts
  behind ``onehot_spmv`` and the double-single ``_gi4_ds_call_batched``.
* ``csr_spmm`` (K7, ``csrc/csr.cu``): unstructured CSR SpMM for row-major X
  of shape (ncols, k), 1 ≤ k ≤ 16, one pass over A for all k columns, f32 and
  f64: a group of lanes a row, column lanes reading X's rows with vector
  loads and entry slots sharing the row's entries (``spmm_geometry``) —
  replaces the five multi-RHS layouts behind ``onehot_spmm``
  (``_dl_mm_call``, ``_dl_mm_call_batched``, ``_onehot_spmm_call``,
  ``_gt_mm_call_batched``, ``_pk_mm_call_batched``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CPU tensor it runs the kernel's plain version, which
lives beside it (``dia_plain``, ``csr_plain``, ``csr_spmm_plain``).  On a CUDA tensor it launches
the kernel on the current stream or raises: there is no fallback.  It adds one
to its ``launches`` count each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..common import check
from ..containers import CsrMatrix, expand_row_ids
from .spmv_impl import DiaPlan, apply_dia

__all__ = [
    "CsrPlan",
    "build_csr_plan",
    "build_csr_tiles",
    "csr_tile_entries",
    "lanes_per_row",
    "dia_spmv",
    "dia_spmm",
    "csr_spmv",
    "csr_spmm",
    "dia_plain",
    "csr_plain",
    "csr_spmm_plain",
    "SpmmGeometry",
    "spmm_geometry",
    "SPMM_MAX_K",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

_DTYPE_CODE = _kernels.DTYPE_CODE
_REDUCE_CODE = {"sum": 0, "max": 1}
_stream = _kernels.stream_of
_check_launch = _kernels.check_launch
_check_operand = _kernels.check_operand
_on_cuda = _kernels.on_cuda


# ----------------------------------------------------------------------
# K1 / K2: DIA
# ----------------------------------------------------------------------

def dia_plain(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and K2: shifted-slice sums (``apply_dia``)."""
    return apply_dia(plan, x)


def _check_dia(plan: DiaPlan, x: torch.Tensor, ndim: int, name: str) -> None:
    check(x.ndim == ndim, f"{name}: x must be rank-{ndim}, got rank {x.ndim}")
    check(x.shape[0] == plan.ncols, f"{name}: x has {x.shape[0]} rows, plan {plan.ncols} cols")
    check(plan.diags.dtype in _DTYPE_CODE, f"{name}: plan dtype {plan.diags.dtype} not f32/f64")
    check(len(plan.offsets) <= 256, f"{name}: at most 256 diagonals")
    _check_operand(x, name, plan.diags.dtype, plan.diags.device)
    check(plan.diags.is_contiguous() and plan.offsets_dev.device == x.device,
          f"{name}: plan arrays must be contiguous and on x's device")


def dia_spmv(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """K1: y = A·x for a DiaPlan and vector x (plan dtype, same device)."""
    _check_dia(plan, x, 1, "dia_spmv")
    if not _on_cuda(x, "dia_spmv"):
        return dia_plain(plan, x)
    y = torch.empty(plan.nrows, dtype=x.dtype, device=x.device)
    if plan.nrows == 0:
        return y
    err = _kernels.library("dia").tpukk_dia_spmv(
        _DTYPE_CODE[x.dtype], plan.diags.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.offsets), x.data_ptr(), y.data_ptr(), plan.nrows, plan.ncols, _stream(x))
    _check_launch(err, "dia_spmv")
    dia_spmv.launches += 1
    return y


def dia_spmm(plan: DiaPlan, X: torch.Tensor) -> torch.Tensor:
    """K2: Y = A·X for a DiaPlan and row-major X of shape (ncols, k), any k."""
    _check_dia(plan, X, 2, "dia_spmm")
    if not _on_cuda(X, "dia_spmm"):
        return dia_plain(plan, X)
    k = X.shape[1]
    Y = torch.empty((plan.nrows, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    err = _kernels.library("dia").tpukk_dia_spmm(
        _DTYPE_CODE[X.dtype], plan.diags.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.offsets), X.data_ptr(), Y.data_ptr(), plan.nrows, plan.ncols, k, _stream(X))
    _check_launch(err, "dia_spmm")
    dia_spmm.launches += 1
    return Y


# ----------------------------------------------------------------------
# K3: CSR
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CsrPlan:
    """The CSR arrays in the compute dtype, the lanes per row, and K3's tiles.

    ``group`` is the vector length of the row panel that K6 runs (K7 takes its
    lanes from ``spmm_geometry``).
    ``tiles`` is K3's table, (ntiles, 4) int32 records (first row, rows, first
    entry, entries) of runs of whole rows, built once by ``build_csr_plan`` on
    the plan's device (``build_csr_tiles``).  A plan made elsewhere, such as
    K6's per-color and fused-sweep plans (``gs_cuda.py``), has no tiles and
    never reaches ``csr_spmv``, which refuses it.
    """

    row_map: torch.Tensor   # (nrows+1,) int32
    entries: torch.Tensor   # (nnz,) int32
    values: torch.Tensor    # (nnz,) f32/f64
    nrows: int
    ncols: int
    group: int              # lanes per row: 1, 2, 4, 8, 16 or 32
    tiles: torch.Tensor = None  # (ntiles, 4) int32, K3's tile table
    streamed: bool = False  # K3 reads colidx and vals past L1 (else through it)
    long_rows: bool = False  # some tile is one row of more than csr_tile_entries(streamed)
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    def rows(self) -> torch.Tensor:
        """(nnz,) int64 row ids, built on first use by the plain version."""
        if self._rows is None:
            self._rows = expand_row_ids(self.row_map, self.entries.shape[0])
        return self._rows


def lanes_per_row(nnz: int, nrows: int) -> int:
    """The largest power of two not above the mean entries per row, in
    [1, 32] — the vector length rule of KokkosSparse_spmv_impl.hpp:135-154."""
    mean = nnz / max(nrows, 1)
    g = 1
    while g * 2 <= min(mean, 32):
        g *= 2
    return g


# K3's choice, the better of its two modes in scripts/k3_sweep_torch.py on the
# H100 (PERF.md §6, K3): a matrix whose colidx and vals pass STREAM_BYTES
# streams from device memory, so it is read past L1 in tiles of 1024 entries;
# any other is read through L1 in tiles of 512.
STREAM_BYTES = 32 << 20
TILE_ROWS = 256  # rows a K3 tile holds at most: a row start a thread


def csr_tile_entries(streamed: bool) -> int:
    """Entries a K3 tile holds at most, but a tile of one long row."""
    return 1024 if streamed else 512


def build_csr_tiles(row_map: torch.Tensor, tile_entries: int) -> torch.Tensor:
    """K3's tile table: runs of whole rows as (first row, rows, first entry,
    entries) int32 records, on row_map's device, with torch ops only.

    A row longer than tile_entries / 8 is a tile of its own (the kernel reads
    one longer than tile_entries in pieces).  The package's plans use caps of
    512 and 1024; scripts/k3_sweep_torch.py also times 256.  Every other tile holds at most
    tile_entries entries: the boundaries are the first rows that start at or
    after each multiple of a step of tile_entries · 7/8, so a tile's rows
    start within one step and its last row, not being long, ends within an
    eighth more.  A run longer than TILE_ROWS rows (the empty rows of a
    selection matrix) is then cut every TILE_ROWS rows from its start.
    """
    check(tile_entries in (256, 512, 1024),
          f"csr tiles: entry cap {tile_entries} not 256, 512 or 1024")
    dev = row_map.device
    rm = row_map.to(torch.int64)
    nrows = rm.shape[0] - 1
    if nrows == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    long_len = tile_entries // 8
    step = tile_entries - long_len
    longs = torch.nonzero(rm[1:] - rm[:-1] > long_len).reshape(-1)
    bounds = torch.unique(torch.cat([
        torch.searchsorted(rm, torch.arange(0, int(rm[-1]), step, device=dev)),
        longs, longs + 1, torch.tensor([0, nrows], device=dev)]))
    first, end = bounds[:-1], bounds[1:]
    cuts = (end - first + TILE_ROWS - 1) // TILE_ROWS
    run = torch.repeat_interleave(torch.arange(first.shape[0], device=dev), cuts)
    nth = torch.arange(run.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(cuts, 0) - cuts, cuts)
    first = first[run] + nth * TILE_ROWS
    end = torch.minimum(first + TILE_ROWS, end[run])
    return torch.stack([first, end - first, rm[first], rm[end] - rm[first]], 1).to(
        torch.int32).contiguous()


def build_csr_plan(A: CsrMatrix, dtype: torch.dtype, streamed: bool | None = None) -> CsrPlan:
    """The plan of K3 and K7 for A in dtype, on A's arrays where they already
    have the dtype.  K3 streams past L1 when colidx and vals pass STREAM_BYTES;
    ``streamed`` pins the mode instead (the tests and scripts/k3_sweep_torch.py
    run both on small matrices)."""
    check(dtype in _DTYPE_CODE, f"csr plan: dtype {dtype} not f32/f64")
    if streamed is None:
        streamed = A.nnz * (4 + torch.finfo(dtype).bits // 8) > STREAM_BYTES
    cap = csr_tile_entries(streamed)
    tiles = build_csr_tiles(A.row_map, cap)
    return CsrPlan(A.row_map, A.entries, A.values.to(dtype).contiguous(), A.nrows, A.ncols,
                   lanes_per_row(A.nnz, A.nrows), tiles, bool(streamed),
                   bool((tiles[:, 3] > cap).any()))


def csr_plain(plan: CsrPlan, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Plain version of K3: ``index_add_`` (sum) or ``scatter_reduce`` amax
    over 0 (max) of the per-entry products."""
    prod = plan.values * x[plan.entries.long()]
    y = torch.zeros(plan.nrows, dtype=prod.dtype, device=x.device)
    if reduce == "sum":
        return y.index_add_(0, plan.rows(), prod)
    return y.scatter_reduce_(0, plan.rows(), prod, reduce="amax", include_self=True)


def csr_spmv(plan: CsrPlan, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """K3: y = A·x, or the (max, ×) row reduction with neutral 0."""
    check(reduce in _REDUCE_CODE, f"csr_spmv: reduce must be 'sum' or 'max', got {reduce!r}")
    check(x.ndim == 1, f"csr_spmv: x must be rank-1, got rank {x.ndim}")
    check(x.shape[0] == plan.ncols, f"csr_spmv: x has {x.shape[0]} rows, plan {plan.ncols} cols")
    _check_operand(x, "csr_spmv", plan.values.dtype, plan.values.device)
    check(plan.row_map.device == x.device and plan.entries.device == x.device,
          "csr_spmv: plan arrays must be on x's device")
    if not _on_cuda(x, "csr_spmv"):
        return csr_plain(plan, x, reduce)
    check(plan.row_map.dtype == torch.int32 and plan.entries.dtype == torch.int32
          and plan.row_map.is_contiguous() and plan.entries.is_contiguous(),
          "csr_spmv: row_map/entries must be contiguous int32")
    check(plan.tiles is not None and plan.tiles.device == x.device
          and plan.tiles.dtype == torch.int32 and plan.tiles.is_contiguous(),
          "csr_spmv: the plan has no tile table on x's device (use build_csr_plan)")
    y = torch.empty(plan.nrows, dtype=x.dtype, device=x.device)
    if plan.nrows == 0:
        return y
    err = _kernels.library("csr").tpukk_csr_spmv(
        _DTYPE_CODE[x.dtype], _REDUCE_CODE[reduce], int(plan.streamed), int(plan.long_rows),
        plan.tiles.data_ptr(), plan.tiles.shape[0], plan.row_map.data_ptr(),
        plan.entries.data_ptr(), plan.values.data_ptr(), x.data_ptr(), y.data_ptr(), _stream(x))
    _check_launch(err, "csr_spmv")
    csr_spmv.launches += 1
    return y


# ----------------------------------------------------------------------
# K7: CSR SpMM
# ----------------------------------------------------------------------

SPMM_MAX_K = 16  # columns K7 takes
# Threads the H100 holds resident (132 SMs × 2,048): K7 adds entry slots to a
# matrix with too few rows to fill them, while each slot still gets an entry.
SPMM_FILL_THREADS = 132 * 2048


@dataclasses.dataclass(frozen=True)
class SpmmGeometry:
    """How K7 lays a row over a warp's lanes: ``cols`` column lanes each read
    ``vec`` consecutive values of X's row with one load, ``slots`` entry slots
    of ``cols`` lanes take different entries of the row, so a row has
    slots·cols lanes and a warp 32 // (slots·cols) rows."""

    vec: int
    cols: int
    slots: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def spmm_geometry(mean_entries: float, nrows: int, k: int, itemsize: int,
                  x_offset: int = 0) -> SpmmGeometry:
    """K7's geometry for a matrix of ``nrows`` rows of ``mean_entries``
    entries on average, X with k columns of ``itemsize`` bytes starting
    ``x_offset`` bytes past a 16-byte boundary.

    vec: the widest of 16 bytes, 8, or one value that divides k and X's
    offset (a row of X must start on a vector boundary).  cols: the power of
    two of column lanes that covers k.  slots: a slot takes max(4, cols)
    entries a step (U·C in csr.cu's kernel); the slots double while each
    still fills half a step, then while the rows do not fill
    ``SPMM_FILL_THREADS`` and each slot still gets an entry, up to 32 lanes
    a row (scripts/k7_sweep_torch.py --geometries on the H100, PERF.md: the
    best or within 1 % of it on the paths' three shapes)."""
    check(1 <= k <= SPMM_MAX_K and itemsize in (4, 8),
          f"spmm geometry: k {k} not in 1..{SPMM_MAX_K} or itemsize {itemsize} not 4/8")
    vec = 16 // itemsize
    while vec > 1 and (k % vec or x_offset % (vec * itemsize)):
        vec //= 2
    cols = _pow2_at_least(-(-k // vec))
    per_slot = max(4, cols)
    slots = 1
    while cols * slots < 32 and slots * per_slot <= mean_entries:
        slots *= 2
    while (cols * slots < 32 and nrows * cols * slots < SPMM_FILL_THREADS
           and 2 * slots <= mean_entries):
        slots *= 2
    return SpmmGeometry(vec, cols, slots)


def csr_spmm_plain(plan: CsrPlan, X: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: ``index_add_`` of the per-entry row products."""
    prod = plan.values[:, None] * X[plan.entries.long()]
    Y = torch.zeros((plan.nrows, X.shape[1]), dtype=prod.dtype, device=X.device)
    return Y.index_add_(0, plan.rows(), prod)


def csr_spmm(plan: CsrPlan, X: torch.Tensor, geometry: SpmmGeometry | None = None
             ) -> torch.Tensor:
    """K7: Y = A·X for row-major X of shape (ncols, k), 1 ≤ k ≤ 16.
    ``geometry`` pins the kernel's lanes (the card tests and
    scripts/k7_sweep_torch.py); by default ``spmm_geometry`` picks them."""
    check(X.ndim == 2, f"csr_spmm: X must be rank-2, got rank {X.ndim}")
    check(X.shape[0] == plan.ncols, f"csr_spmm: X has {X.shape[0]} rows, plan {plan.ncols} cols")
    k = X.shape[1]
    check(1 <= k <= SPMM_MAX_K, f"csr_spmm: X must have 1 to {SPMM_MAX_K} columns, got {k}")
    _check_operand(X, "csr_spmm", plan.values.dtype, plan.values.device)
    check(plan.row_map.device == X.device and plan.entries.device == X.device,
          "csr_spmm: plan arrays must be on X's device")
    if not _on_cuda(X, "csr_spmm"):
        return csr_spmm_plain(plan, X)
    check(plan.row_map.dtype == torch.int32 and plan.entries.dtype == torch.int32
          and plan.row_map.is_contiguous() and plan.entries.is_contiguous(),
          "csr_spmm: row_map/entries must be contiguous int32")
    Y = torch.empty((plan.nrows, k), dtype=X.dtype, device=X.device)
    if plan.nrows == 0:
        return Y
    size = X.element_size()
    g = geometry or spmm_geometry(plan.entries.shape[0] / plan.nrows, plan.nrows, k, size,
                                  X.data_ptr() % 16)
    check(k % g.vec == 0 and X.data_ptr() % (g.vec * size) == 0,
          f"csr_spmm: {g} does not fit X (k {k}, {X.data_ptr() % 16} bytes past 16)")
    err = _kernels.library("csr").tpukk_csr_spmm(
        _DTYPE_CODE[X.dtype], g.vec, g.cols, g.slots.bit_length() - 1,
        plan.row_map.data_ptr(), plan.entries.data_ptr(), plan.values.data_ptr(), X.data_ptr(),
        Y.data_ptr(), plan.nrows, k, _stream(X))
    _check_launch(err, "csr_spmm")
    csr_spmm.launches += 1
    return Y


# ----------------------------------------------------------------------
# launch counts
# ----------------------------------------------------------------------

KERNELS = (dia_spmv, dia_spmm, csr_spmv, csr_spmm)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
