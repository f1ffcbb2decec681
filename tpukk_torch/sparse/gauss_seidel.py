"""Gauss-Seidel / SOR smoothers — counterpart of
``tpukk/sparse/gauss_seidel.py`` (sparse/src/KokkosSparse_gauss_seidel.hpp:
symbolic :46, numeric :175, apply :465/707/952; the GSAlgorithm taxonomy of
gauss_seidel_handle.hpp:30).

* POINT (the reference's color-permuted PSGS,
  KokkosSparse_gauss_seidel_impl.hpp:128,199): symbolic colors the graph and
  orders the rows color by color; numeric cuts the permuted matrix into one
  CSR block per color (diagonal removed, columns in the permuted space, no
  padding) with 1/diag; apply runs one K6 ``gs_color_step`` launch per color,
  in place, since no row of a distance-1 color block refers to another.
* CLUSTER (cluster_gauss_seidel_impl.hpp): vertices are clustered (MIS2
  aggregation or Balloon), the cluster graph is colored, and a cluster's
  vertices share its color.  Each color block is updated
  ``cluster_inner_sweeps`` times from the block's old x (Jacobi within the
  block, ``tpukk``'s semantics): K6 out of place, into a buffer made once at
  numeric time and copied back.
* TWOSTAGE (KokkosSparse_twostage_gauss_seidel_impl.hpp:120-256): the
  triangular solves approximated by inner Jacobi-Richardson sweeps, all on
  SpMV/SpMM handles (K1/K2 on banded factors, K3/K7 on the others), with the
  ``compact_form`` option.

The permutations into and out of color order are K5 ``static_permute``
launches on plans built once at symbolic time; ``permuted=True`` keeps x and
b in the permuted space for chained applies.  A rank-2 b sweeps its columns
together (K6 takes up to 16; wider ones go in chunks of 16) where ``tpukk``
vmaps the single-column sweep.  Block (BSR) Gauss-Seidel raises, naming
ROADMAP A2.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..common import check
from ..common.permute import build_permute_plan, static_permute
from ..common.tracing import annotate
from ..containers import CsrMatrix
from ..graph.coloring import ColoringAlgorithm, color_sets, graph_color
from . import gs_cuda
from .spmv import SpmvHandle, _compute_dtype

__all__ = ["GsAlgorithm", "ClusteringAlgorithm", "GsHandle", "gauss_seidel_symbolic",
           "gauss_seidel_numeric", "forward_sweep", "backward_sweep", "symmetric_sweep",
           "gauss_seidel_apply"]

_BSR = "block (BSR) Gauss-Seidel waits on the BSR route (ROADMAP queue A, item A2)"


class GsAlgorithm(enum.Enum):
    POINT = "point"        # color-permuted PSGS
    TWOSTAGE = "twostage"  # inner-Jacobi classical GS
    CLUSTER = "cluster"    # MIS2-clustered GS (cluster_gauss_seidel_impl.hpp)


class ClusteringAlgorithm(enum.Enum):
    """cf. gauss_seidel_handle.hpp:32 {CLUSTER_MIS2, BALLOON}."""

    MIS2 = "mis2"
    BALLOON = "balloon"


class GsHandle:
    """cf. KokkosKernels_Handle::create_gs_handle (:581-627)."""

    def __init__(self, algorithm: GsAlgorithm = GsAlgorithm.POINT,
                 coloring: ColoringAlgorithm = ColoringAlgorithm.SERIAL,
                 inner_sweeps: int = 2,
                 clustering: Optional[ClusteringAlgorithm] = None,
                 cluster_inner_sweeps: int = 3,
                 compact_form: bool = False):
        self.algorithm = algorithm
        self.coloring_algorithm = coloring
        self.inner_sweeps = inner_sweeps  # twostage inner Jacobi count
        self.compact_form = compact_form  # twostage: complement-matrix rhs
        self.clustering = clustering or ClusteringAlgorithm.MIS2
        self.cluster_inner_sweeps = cluster_inner_sweeps
        self.is_symbolic_called = False
        self.is_numeric_called = False
        # POINT / CLUSTER
        self.colors = None
        self.color_offsets = None
        self.order = None           # permuted order (old index per position)
        self.inv_order = None
        self.cluster_labels = None
        self._to_perm = None        # K5 plans: natural → permuted, and back
        self._from_perm = None
        self._blocks = {}           # dtype → list of GsBlock
        self._coupled_rows = 0      # rows of the largest coupled block
        self._scratch = {}          # dtype → K6's out-of-place buffer
        self.omega = 1.0
        # TWOSTAGE
        self._tw = None


def _check_csr(A) -> None:
    if not isinstance(A, CsrMatrix):
        raise NotImplementedError(_BSR)
    check(A.nrows == A.ncols, "gauss_seidel: square matrix required")


@annotate("gauss_seidel_symbolic")
def gauss_seidel_symbolic(handle: GsHandle, A: CsrMatrix):
    """Coloring and the color order (cf. gauss_seidel.hpp:46 →
    graph_color_symbolic); CLUSTER clusters first."""
    _check_csr(A)
    if handle.algorithm == GsAlgorithm.POINT:
        set_color_order(handle, A, graph_color(A, handle.coloring_algorithm))
    elif handle.algorithm == GsAlgorithm.CLUSTER:
        labels = (_mis2_labels(A) if handle.clustering == ClusteringAlgorithm.MIS2
                  else _balloon_clustering(A))
        set_color_order(handle, A, _cluster_colors(handle, A, labels), labels)
    handle.is_symbolic_called = True


def set_color_order(handle: GsHandle, A: CsrMatrix, colors, cluster_labels=None) -> None:
    """The symbolic state from per-vertex colors (1-based): the order is
    color-major, and with ``cluster_labels`` cluster-major within a color
    (cluster_gauss_seidel_impl.hpp:114-164); the K5 plans are built here."""
    colors = np.asarray(colors).astype(np.int32)
    n = A.nrows
    offsets, order = color_sets(colors)
    if cluster_labels is not None:
        cluster_labels = np.asarray(cluster_labels).astype(np.int32)
        order = np.lexsort((np.arange(n), cluster_labels, colors)).astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(n, dtype=order.dtype)
    handle.colors, handle.color_offsets, handle.order, handle.inv_order = (
        colors, offsets, order, inv)
    handle.cluster_labels = cluster_labels
    # xp[i] = x[order[i]]; x[j] = xp[inv[j]]
    handle._to_perm = build_permute_plan(order, A.device)
    handle._from_perm = build_permute_plan(inv, A.device)
    handle._blocks, handle._scratch = {}, {}
    handle.is_symbolic_called = True


def _mis2_labels(A: CsrMatrix) -> np.ndarray:
    from ..graph.mis2 import graph_mis2_aggregate

    return graph_mis2_aggregate(A)


def _balloon_clustering(A: CsrMatrix, target_size: int = 8) -> np.ndarray:
    """Balloon clustering (KokkosSparse_partitioning_impl.hpp:42-91 role):
    seed every ceil(n/target)-th vertex, grow balloons by BFS rounds until
    every vertex is claimed."""
    rm = A.host_row_map()
    ent = A.host_entries()
    n = A.nrows
    n_clusters = max(1, -(-n // target_size))
    labels = np.full(n, -1, np.int64)
    seeds = np.linspace(0, n - 1, n_clusters).astype(np.int64)
    labels[seeds] = np.arange(n_clusters)
    rows = np.repeat(np.arange(n), rm[1:] - rm[:-1])
    big = np.iinfo(np.int64).max
    while (labels == -1).any():
        lab_n = np.where(labels[ent] >= 0, labels[ent], big)
        best = np.full(n, big)
        np.minimum.at(best, rows, lab_n)
        adopt = (labels == -1) & (best != big)
        if adopt.any():
            labels[adopt] = best[adopt]
        else:
            labels[np.nonzero(labels == -1)[0][0]] = labels.max() + 1
    return labels.astype(np.int32)


def _cluster_colors(handle: GsHandle, A: CsrMatrix, labels: np.ndarray) -> np.ndarray:
    """Per-vertex colors: the coloring of the cluster graph Pᵀ·A·P (diagonal
    set), each vertex taking its cluster's color."""
    import scipy.sparse as sps

    nc = int(labels.max()) + 1
    n = A.nrows
    P = sps.csr_matrix((np.ones(n), (np.arange(n), labels)), shape=(n, nc))
    cg = (P.T @ A.to_scipy() @ P).tocsr()
    cg.setdiag(1.0)
    cg.sort_indices()
    ccolors = graph_color(CsrMatrix.from_scipy(cg.astype(np.float64), device=A.device),
                          handle.coloring_algorithm)
    return ccolors[labels]


@annotate("gauss_seidel_numeric")
def gauss_seidel_numeric(handle: GsHandle, A: CsrMatrix, omega: float = 1.0):
    """One CSR block per color of the permuted matrix, off-diagonal part, and
    1/diag (cf. gauss_seidel.hpp:175); TWOSTAGE builds its SpMV handles."""
    _check_csr(A)
    check(handle.is_symbolic_called, "gauss_seidel_numeric: symbolic first")
    handle.omega = float(omega)
    if handle.algorithm == GsAlgorithm.TWOSTAGE:
        _twostage_numeric(handle, A)
    else:
        blocks = _color_blocks(handle, A)
        handle._blocks = {blocks[0].csr.values.dtype: blocks}
        handle._coupled_rows = max((blk.nrows for blk in blocks if blk.coupled), default=0)
        handle._scratch = {}
        _scratch_in(handle, blocks[0].inv_diag, 1)
    handle.is_numeric_called = True


def _color_blocks(handle: GsHandle, A: CsrMatrix) -> list:
    """``tpukk``'s numeric phase (gauss_seidel.py:193-241) without the ELL
    padding: the rows of each color, their entries in CSR order with the
    diagonal dropped (and summed into diag), columns renamed by inv_order."""
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries()
    vals = A.host_values()  # bf16 values arrive widened to f32
    if vals.dtype not in (np.float32, np.float64):
        raise NotImplementedError("complex Gauss-Seidel waits on complex SpMV "
                                  "(ROADMAP queue A, item A3)")
    order, inv, offsets = handle.order, handle.inv_order, handle.color_offsets
    blocks = []
    for c in range(len(offsets) - 1):
        rows = order[offsets[c]:offsets[c + 1]].astype(np.int64)
        if rows.size == 0:
            continue
        lens = rm[rows + 1] - rm[rows]
        first = np.zeros(rows.size + 1, np.int64)
        np.cumsum(lens, out=first[1:])
        local = np.repeat(np.arange(rows.size), lens)
        pos = rm[rows][local] + (np.arange(first[-1]) - first[local])
        cseg, vseg = ent[pos], vals[pos]
        is_diag = cseg == rows[local]
        diag = np.zeros(rows.size, vals.dtype)
        np.add.at(diag, local[is_diag], vseg[is_diag])
        keep = ~is_diag
        brm = np.zeros(rows.size + 1, np.int64)
        np.cumsum(np.bincount(local[keep], minlength=rows.size), out=brm[1:])
        with np.errstate(divide="ignore"):
            inv_diag = np.where(diag != 0, 1.0 / diag, 0.0).astype(vals.dtype)
        blocks.append(gs_cuda.build_gs_block(brm, inv[cseg[keep]], vseg[keep], inv_diag,
                                             int(offsets[c]), A.nrows, A.device))
    return blocks


def _twostage_numeric(handle: GsHandle, A: CsrMatrix) -> None:
    import scipy.sparse as sps

    sp = A.to_scipy()
    D = sp.diagonal()
    L = sps.tril(sp, k=-1).tocsr()
    U = sps.triu(sp, k=1).tocsr()
    L.sort_indices()
    U.sort_indices()
    vdt = A.host_values().dtype
    with np.errstate(divide="ignore"):
        inv_diag = np.where(D != 0, 1.0 / D, 0.0).astype(vdt)
    handle._tw = dict(
        inv_diag=torch.from_numpy(inv_diag).to(A.device),
        L=SpmvHandle(CsrMatrix.from_scipy(L, value_dtype=vdt, device=A.device)),
        U=SpmvHandle(CsrMatrix.from_scipy(U, value_dtype=vdt, device=A.device)),
        A=SpmvHandle(A),
    )


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _blocks_in(handle: GsHandle, dtype: torch.dtype) -> list:
    blocks = handle._blocks.get(dtype)
    if blocks is None:
        base = next(iter(handle._blocks.values()))
        blocks = handle._blocks[dtype] = [blk.to(dtype) for blk in base]
    return blocks


def _scratch_in(handle: GsHandle, x: torch.Tensor, k: int) -> Optional[torch.Tensor]:
    """K6's out-of-place buffer in x's dtype, for the largest coupled block
    times k columns: made once per dtype and grown for a wider multivector;
    None when no block is coupled."""
    need = handle._coupled_rows * k
    if need == 0:
        return None
    buf = handle._scratch.get(x.dtype)
    if buf is None or buf.numel() < need:
        buf = handle._scratch[x.dtype] = torch.empty(need, dtype=x.dtype, device=x.device)
    return buf


def _point_half_sweep(handle: GsHandle, xp: torch.Tensor, bp: torch.Tensor,
                      forward: bool) -> torch.Tensor:
    """One forward or backward colored sweep of the permuted xp, in place:
    one K6 launch per color block (``cluster_inner_sweeps`` per block for
    CLUSTER, the inner relaxation of the intra-cluster coupling)."""
    omega = handle.omega
    reps = handle.cluster_inner_sweeps if handle.algorithm == GsAlgorithm.CLUSTER else 1
    blocks = _blocks_in(handle, xp.dtype)
    scratch = _scratch_in(handle, xp, 1 if xp.ndim == 1 else xp.shape[1])
    for blk in (blocks if forward else reversed(blocks)):
        for _ in range(reps):
            gs_cuda.gs_color_step(blk, xp, bp, omega, scratch)
    return xp


def _twostage_half_sweep(handle: GsHandle, x: torch.Tensor, b: torch.Tensor,
                         forward: bool) -> torch.Tensor:
    """(D + L) z = r (forward) or (D + U) z = r (backward) approximated by
    inner Jacobi-Richardson sweeps (twostage_gauss_seidel_impl.hpp:120-256).
    compact_form (isCompactForm(), same file :120) builds the rhs from the
    complement matrix only — b − U·x forward — and the inner solve returns
    the new iterate, skipping the full-A residual SpMV."""
    tw = handle._tw
    omega = handle.omega
    invD = tw["inv_diag"].to(x.dtype)
    if x.ndim == 2:
        invD = invD[:, None]
    T = tw["L"] if forward else tw["U"]
    if handle.compact_form:
        C = tw["U"] if forward else tw["L"]  # complement of (T + D)
        rhs = b - C(x)
        z = invD * rhs
        for _ in range(handle.inner_sweeps):
            z = invD * (rhs - T(z))
        return (1.0 - omega) * x + omega * z
    r = b - tw["A"](x)
    z = invD * r
    for _ in range(handle.inner_sweeps):
        z = invD * (r - T(z))
    return x + omega * z


@annotate("forward_sweep")
def forward_sweep(handle: GsHandle, A: CsrMatrix, x, b, num_sweeps: int = 1):
    return gauss_seidel_apply(handle, A, x, b, num_sweeps, "forward")


@annotate("backward_sweep")
def backward_sweep(handle: GsHandle, A: CsrMatrix, x, b, num_sweeps: int = 1):
    return gauss_seidel_apply(handle, A, x, b, num_sweeps, "backward")


@annotate("symmetric_sweep")
def symmetric_sweep(handle: GsHandle, A: CsrMatrix, x, b, num_sweeps: int = 1):
    return gauss_seidel_apply(handle, A, x, b, num_sweeps, "symmetric")


@annotate("gauss_seidel_apply")
def gauss_seidel_apply(handle: GsHandle, A: CsrMatrix, x, b, num_sweeps: int = 1,
                       direction: str = "symmetric", permuted: bool = False):
    """Sweeps on A·x = b; returns the new x in x's dtype (b's when x is
    None, the init_zero_x_vector flag).  x is not modified.  A rank-2 b of
    shape (n, k) sweeps every column, each as the single-column apply would.

    permuted=True (POINT/CLUSTER): x and b are already in the handle's color
    order and the result stays there — the convention for chained smoother
    applies; convert once with ``handle.order`` / ``inv_order``."""
    check(handle.is_numeric_called, "gauss_seidel_apply: numeric first")
    check(direction in ("forward", "backward", "symmetric"),
          f"gauss_seidel_apply: unknown direction {direction!r}")
    check(b.ndim in (1, 2) and b.shape[0] == A.nrows and b.device == A.device,
          f"gauss_seidel_apply: b must be ({A.nrows},) or ({A.nrows}, k) on {A.device}")
    check(x is None or x.shape == b.shape, "gauss_seidel_apply: x and b shapes differ")
    out_dtype = b.dtype if x is None else x.dtype  # tpukk's result dtype
    if b.ndim == 2 and b.shape[1] > gs_cuda.GS_MAX_K and handle.algorithm != GsAlgorithm.TWOSTAGE:
        w = gs_cuda.GS_MAX_K
        return torch.cat([gauss_seidel_apply(handle, A, None if x is None else x[:, j:j + w],
                                             b[:, j:j + w], num_sweeps, direction, permuted)
                          for j in range(0, b.shape[1], w)], dim=1)
    dt = _compute_dtype(A, b)
    b = b.to(dt).contiguous()
    fwd = direction in ("forward", "symmetric")
    bwd = direction in ("backward", "symmetric")
    if handle.algorithm == GsAlgorithm.TWOSTAGE:
        x = torch.zeros_like(b) if x is None else x.to(dt)
        for _ in range(num_sweeps):
            if fwd:
                x = _twostage_half_sweep(handle, x, b, True)
            if bwd:
                x = _twostage_half_sweep(handle, x, b, False)
        return x.to(out_dtype)
    # POINT / CLUSTER: sweep the permuted copy xp in place
    if permuted:
        xp = torch.zeros_like(b) if x is None else x.to(dt, copy=True).contiguous()
        bp = b
    else:
        bp = static_permute(handle._to_perm, b)
        xp = (torch.zeros_like(b) if x is None
              else static_permute(handle._to_perm, x.to(dt).contiguous()))
    for _ in range(num_sweeps):
        if fwd:
            _point_half_sweep(handle, xp, bp, True)
        if bwd:
            _point_half_sweep(handle, xp, bp, False)
    if not permuted:
        xp = static_permute(handle._from_perm, xp)
    return xp.to(out_dtype)
