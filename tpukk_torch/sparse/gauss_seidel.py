"""Gauss-Seidel / SOR smoothers — counterpart of
``tpukk/sparse/gauss_seidel.py`` (sparse/src/KokkosSparse_gauss_seidel.hpp:
symbolic :46, numeric :175, apply :465/707/952; the GSAlgorithm taxonomy of
gauss_seidel_handle.hpp:30).

* POINT (the reference's color-permuted PSGS,
  KokkosSparse_gauss_seidel_impl.hpp:128,199): symbolic colors the graph and
  orders the rows color by color; numeric builds the sweep plan of K6
  (``gs_cuda.GsSweepPlan``: the permuted matrix's off-diagonal CSR, cut into
  one block per color, columns in the permuted space, no padding, with
  1/diag); an apply is one K6 ``gs_sweep`` launch that runs every color step
  of every half-sweep in order, each block in place, since no row of a
  distance-1 color block refers to another.
* CLUSTER (cluster_gauss_seidel_impl.hpp): vertices are clustered (MIS2
  aggregation or Balloon), the cluster graph is colored, and a cluster's
  vertices share its color.  Each color block is updated
  ``cluster_inner_sweeps`` times from the block's old x (Jacobi within the
  block, ``tpukk``'s semantics): out of place, into a buffer the plan keeps,
  then copied back, both steps inside the same launch.
* TWOSTAGE (KokkosSparse_twostage_gauss_seidel_impl.hpp:120-256): the
  triangular solves approximated by inner Jacobi-Richardson sweeps, all on
  SpMV/SpMM handles (K1/K2 on banded factors, K3/K7 on the others), with the
  ``compact_form`` option.

The permutations into and out of color order are folded into that launch
(b and a given x read through the color order, the result written through
it), and so is the zero start (rows not yet written read 0, no fill);
``permuted=True`` keeps x and b in the permuted space for chained applies.
A rank-2 b sweeps its columns
together (K6 takes up to 16; wider ones go in chunks of 16) where ``tpukk``
vmaps the single-column sweep.

* Block (BSR) Gauss-Seidel (the reference's block_gauss_seidel,
  Test_Sparse_block_gauss_seidel.hpp), for a ``BsrMatrix``: symbolic colors
  the block graph; numeric inverts the b×b diagonal blocks in one batch
  (``torch.linalg.inv``) and builds ``SpmvHandle(A)``; each color of each
  half-sweep is one matvec of that handle (one K1 launch where the block
  graph is banded, AUTO's DIA route) and batched block updates
  x_c ← (1-ω)·x_c + ω·D_c⁻¹·((b - A·x)_c + D_c·x_c), as in ``tpukk``.
  A multivector b takes the handle's K2 launch a color on that route.

Every form takes f32, f64, complex64 and complex128 values, and a complex b
on a real handle (the promotion ``tpukk`` gives it): the plan, 1/diag, the
triangles and the diagonal blocks keep the values' complex dtype, and ω
stays real.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..common import check
from ..common.tracing import annotate, profile_region
from ..containers import BsrMatrix, CsrMatrix, StaticCrsGraph
from ..graph.coloring import ColoringAlgorithm, color_sets, graph_color
from . import gs_cuda
from .spmv import SpmvHandle, _compute_dtype

__all__ = ["GsAlgorithm", "ClusteringAlgorithm", "GsHandle", "gauss_seidel_symbolic",
           "gauss_seidel_numeric", "forward_sweep", "backward_sweep", "symmetric_sweep",
           "gauss_seidel_apply"]


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
        self._plans = {}            # dtype → gs_cuda.GsSweepPlan
        self.omega = 1.0
        # TWOSTAGE
        self._tw = None
        # block (BSR): diagonal blocks, their inverses, the SpMV handle, color sets
        self._blk = None

    @property
    def _blocks(self) -> dict:
        """dtype → the sweep plan's color blocks (``gs_cuda.GsBlock``)."""
        return {dt: plan.blocks for dt, plan in self._plans.items()}


def _check_matrix(A) -> None:
    check(isinstance(A, (CsrMatrix, BsrMatrix)),
          "gauss_seidel: a CsrMatrix or a BsrMatrix is required")
    check(A.nrows == A.ncols, "gauss_seidel: square matrix required")


@annotate("gauss_seidel_symbolic")
def gauss_seidel_symbolic(handle: GsHandle, A):
    """Coloring and the color order (cf. gauss_seidel.hpp:46 →
    graph_color_symbolic); CLUSTER clusters first.  A BsrMatrix routes to
    block GS (the reference's block_gauss_seidel overloads): its block graph
    is colored."""
    _check_matrix(A)
    if isinstance(A, BsrMatrix):
        graph = StaticCrsGraph.from_arrays(A.host_row_map(), A.host_entries(), A.n_block_rows,
                                           A.n_block_cols, device=A.device)
        set_color_order(handle, graph, graph_color(graph, handle.coloring_algorithm))
        return
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
    (cluster_gauss_seidel_impl.hpp:114-164)."""
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
    handle._plans = {}
    handle._blk = None
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
def gauss_seidel_numeric(handle: GsHandle, A, omega: float = 1.0):
    """K6's sweep plan: the permuted matrix's off-diagonal part, one CSR
    block per color, and 1/diag (cf. gauss_seidel.hpp:175); TWOSTAGE builds
    its SpMV handles; a BsrMatrix its diagonal blocks and their inverses."""
    _check_matrix(A)
    check(handle.is_symbolic_called, "gauss_seidel_numeric: symbolic first")
    handle.omega = float(omega)
    if isinstance(A, BsrMatrix):
        _block_numeric(handle, A)
    elif handle.algorithm == GsAlgorithm.TWOSTAGE:
        _twostage_numeric(handle, A)
    else:
        with profile_region("tpukk::gs_sweep_plan"):
            plan = _sweep_plan(handle, A)
        handle._plans = {plan.csr.values.dtype: plan}
    handle.is_numeric_called = True


def _sweep_plan(handle: GsHandle, A: CsrMatrix) -> gs_cuda.GsSweepPlan:
    """``tpukk``'s numeric phase (gauss_seidel.py:193-241) without the ELL
    padding, for all colors at once: the rows in color order, their entries
    in CSR order with the diagonal dropped (and summed into diag), columns
    renamed by inv_order.  The values keep their dtype (complex too);
    1/diag is taken in it."""
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries()
    vals = A.host_values()  # bf16 values arrive widened to f32
    rows = handle.order.astype(np.int64)
    n = rows.size
    lens = rm[rows + 1] - rm[rows]
    first = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=first[1:])
    local = np.repeat(np.arange(n), lens)
    pos = rm[rows][local] + (np.arange(first[-1]) - first[local])
    cseg, vseg = ent[pos], vals[pos]
    is_diag = cseg == rows[local]
    diag = np.zeros(n, vals.dtype)
    np.add.at(diag, local[is_diag], vseg[is_diag])
    keep = ~is_diag
    prm = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(local[keep], minlength=n), out=prm[1:])
    with np.errstate(divide="ignore"):
        inv_diag = np.where(diag != 0, 1.0 / diag, 0.0).astype(vals.dtype)
    return gs_cuda.build_gs_sweep_plan(prm, handle.inv_order[cseg[keep]], vseg[keep], inv_diag,
                                       handle.color_offsets, handle.order, A.device)


def _block_numeric(handle: GsHandle, A: BsrMatrix) -> None:
    """The diagonal block of each block row (``tpukk``'s check and message
    where one lacks it), their inverses in one batch, and for each color its
    block rows with their D and D⁻¹, in the compute dtype."""
    rm = A.host_row_map().astype(np.int64)
    ent = A.host_entries()
    nb = A.n_block_rows
    rows = np.repeat(np.arange(nb), np.diff(rm))
    dpos = np.full(nb, -1, np.int64)
    hits = np.nonzero(ent == rows)[0]
    dpos[rows[hits]] = hits
    check(bool((dpos >= 0).all()), "block GS: every block row needs a diagonal block")
    dt = torch.promote_types(A.dtype, torch.float32)
    D = A.values.to(dt)[torch.from_numpy(dpos).to(A.device)]
    Dinv = torch.linalg.inv(D)
    sets = []
    for c in range(len(handle.color_offsets) - 1):
        I = torch.from_numpy(handle.order[handle.color_offsets[c]:handle.color_offsets[c + 1]]
                             .astype(np.int64)).to(A.device)
        sets.append((I, D[I], Dinv[I]))
    handle._blk = dict(h=SpmvHandle(A), sets=sets, bs=A.block_size)


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

def _plan_in(handle: GsHandle, dtype: torch.dtype) -> gs_cuda.GsSweepPlan:
    """The sweep plan in ``dtype`` (converted once), with the handle's
    relaxations per block."""
    plan = handle._plans.get(dtype)
    if plan is None:
        plan = handle._plans[dtype] = next(iter(handle._plans.values())).to(dtype)
    plan.reps = handle.cluster_inner_sweeps if handle.algorithm == GsAlgorithm.CLUSTER else 1
    return plan


def _block_half_sweep(handle: GsHandle, x: torch.Tensor, b: torch.Tensor,
                      forward: bool) -> torch.Tensor:
    """One half-sweep of block GS over the colors in order (or reversed),
    x updated in place: a color is one matvec and batched block updates."""
    blk, omega = handle._blk, handle.omega
    nb = x.shape[0] // blk["bs"]
    xb = x.view(nb, blk["bs"], -1)
    for I, D, Dinv in (blk["sets"] if forward else reversed(blk["sets"])):
        r = (b - blk["h"].matvec(x)).view(nb, blk["bs"], -1)
        xI = xb[I]
        xc = torch.bmm(Dinv.to(x.dtype), r[I] + torch.bmm(D.to(x.dtype), xI))
        xb.index_copy_(0, I, (1.0 - omega) * xI + omega * xc)
    return x


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
def gauss_seidel_apply(handle: GsHandle, A, x, b, num_sweeps: int = 1,
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
    fwd = direction in ("forward", "symmetric")
    bwd = direction in ("backward", "symmetric")
    if handle._blk is not None:
        # block GS: x and b stay in the natural order (permuted is not used)
        dt = _compute_dtype(A, b)
        b = b.to(dt).contiguous()
        x = torch.zeros_like(b) if x is None else x.to(dt, copy=True).contiguous()
        for _ in range(num_sweeps):
            if fwd:
                x = _block_half_sweep(handle, x, b, True)
            if bwd:
                x = _block_half_sweep(handle, x, b, False)
        return x.to(out_dtype)
    if b.ndim == 2 and b.shape[1] > gs_cuda.GS_MAX_K and handle.algorithm != GsAlgorithm.TWOSTAGE:
        w = gs_cuda.GS_MAX_K
        return torch.cat([gauss_seidel_apply(handle, A, None if x is None else x[:, j:j + w],
                                             b[:, j:j + w], num_sweeps, direction, permuted)
                          for j in range(0, b.shape[1], w)], dim=1)
    dt = _compute_dtype(A, b)
    b = b.to(dt).contiguous()
    if handle.algorithm == GsAlgorithm.TWOSTAGE:
        x = torch.zeros_like(b) if x is None else x.to(dt)
        for _ in range(num_sweeps):
            if fwd:
                x = _twostage_half_sweep(handle, x, b, True)
            if bwd:
                x = _twostage_half_sweep(handle, x, b, False)
        return x.to(out_dtype)
    # POINT / CLUSTER: one K6 launch
    if num_sweeps == 0:
        return (torch.zeros_like(b) if x is None else x.to(dt, copy=True)).to(out_dtype)
    xin = None if x is None else x.to(dt).contiguous()
    return gs_cuda.gs_sweep(_plan_in(handle, dt), xin, b, handle.omega, direction, num_sweeps,
                            permuted).to(out_dtype)
