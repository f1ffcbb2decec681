"""Distance-1 and distance-2 graph coloring — counterpart of
``tpukk/graph/coloring.py`` (graph/src/KokkosGraph_Distance1Color.hpp:28 with
the taxonomy of Distance1ColorHandle.hpp:28-41, and
graph/src/KokkosGraph_Distance2Color.hpp).

SERIAL is the host greedy of ``csrc/host.cpp``.  The other algorithms run
``tpukk``'s speculative rounds on the graph's device: each round every
uncolored vertex takes the smallest color absent among its neighbors, then
conflicts are demoted by Knuth-hash priority (VB, VBBIT, EB), or a vertex
waits while a neighbor of higher priority is uncolored (VBD, VBDBIT).  The
priorities, the demotion rule and the round loop are ``tpukk``'s, so on one
graph the colors are ``tpukk``'s, element for element.  The loop runs on the
host, with one device→host read per round (at most 64 rounds).

The neighbor-color gather of a round takes one of three forms, by the same
gates as ``tpukk``:

* offsets (≥ 4096 rows, at most 24 distinct column offsets: meshes and
  stencils): one ``torch.roll`` of the color vector per offset;
* selection matrix (an ELL table of ≥ 32768 slots): one K3 ``csr_spmv`` of
  the colors (as f32, exact below 2^24) through the 0/1 matrix
  S[(i·w + j), cols[i, j]], the SpMV that ``tpukk`` runs through its one-hot
  kernel;
* ELL: an indexed gather of the padded adjacency.

A vertex still uncolored after the rounds sends the whole graph to the serial
greedy, as in ``tpukk``: an algorithmic fallback, not a device one.
"""
from __future__ import annotations

import enum
import time

import numpy as np
import torch

from .. import native
from ..common import tracing
from ..common.tracing import annotate

__all__ = ["ColoringAlgorithm", "graph_color", "graph_color_d2", "verify_coloring",
           "color_sets", "serial_greedy_plain"]

_MAX_COLORS = 128
_MAX_ROUNDS = 64


class ColoringAlgorithm(enum.Enum):
    """Taxonomy of Distance1ColorHandle.hpp:28-41, two behaviors (as in
    ``tpukk``): VB / VBBIT / EB are the speculative rounds with hash-priority
    demotion; VBD / VBDBIT the deterministic wavefront."""
    SERIAL = "serial"
    VB = "vb"
    VBBIT = "vbbit"
    VBD = "vbd"
    VBDBIT = "vbdbit"
    EB = "eb"


def _adjacency(graph) -> tuple:
    return graph.host_row_map(), graph.host_entries(), graph.nrows


def _ell_pad(rm, ent, nrows):
    deg = (rm[1:] - rm[:-1]).astype(np.int64)
    w = max(1, int(deg.max(initial=1)))
    pos = rm[:-1, None].astype(np.int64) + np.arange(w)[None, :]
    mask = np.arange(w)[None, :] < deg[:, None]
    pos = np.minimum(pos, max(0, len(ent) - 1))
    return np.where(mask, ent[pos], -1).astype(np.int32)


def serial_greedy_plain(rm, ent, nrows) -> np.ndarray:
    """Plain version of the host greedy (``tpukk``'s no-toolchain loop)."""
    colors = np.zeros(nrows, np.int32)  # 0 = uncolored; colors 1-based
    for v in range(nrows):
        nbr = ent[rm[v]:rm[v + 1]]
        used = set(colors[nbr[nbr != v]].tolist())
        c = 1
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _priorities(idx: np.ndarray) -> np.ndarray:
    """``tpukk``'s Knuth-mix hash priorities, int32 with wrap-around."""
    return (idx.astype(np.int64) * np.int64(-1640531527)).astype(np.int32) ^ np.int32(0x5BF03635)


def _beats(valid, nbr_i, idx) -> np.ndarray:
    """(n, w) bool: the neighbor in the slot wins over the vertex (higher
    hash, or an equal hash and a larger index)."""
    pri = _priorities(idx)
    nbr_pri = np.where(valid, pri[np.clip(nbr_i, 0, len(idx) - 1)], 0)
    beats = (nbr_pri > pri[:, None]) | ((nbr_pri == pri[:, None])
                                        & (np.where(valid, nbr_i, -1) > idx[:, None]))
    return beats & valid


def _vb_loop(gather, nbr_beats: torch.Tensor, n: int, deterministic: bool) -> torch.Tensor:
    """``tpukk``'s round loop (coloring.py:205-268): one gather per round
    (demote the previous round's conflicts and recolor from one snapshot),
    until a round changes nothing or 64 rounds have run; then a last
    conflict demotion.  ``gather(colors) -> (n, w) int32`` neighbor colors,
    0 for empty slots."""
    dev = nbr_beats.device
    n_words = (_MAX_COLORS + 32) // 32
    ncand = 32 * n_words  # tpukk's bitmask words cover colors [0, ncand)
    colors = torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)

    def first_free(nbr_colors):
        forb = torch.zeros((n, ncand + 1), dtype=torch.bool, device=dev)
        slot = torch.where(nbr_colors < ncand, nbr_colors, ncand).long()
        forb[rows[:, None], slot] = True
        forb[:, 0] = True
        free = ~forb[:, :ncand]
        ff = torch.argmax(free.to(torch.int8), dim=1).to(torch.int32)
        return torch.where(free.any(dim=1), ff, _MAX_COLORS)

    for _ in range(_MAX_ROUNDS):
        nbr_colors = gather(colors)
        if deterministic:
            blocked = (nbr_beats & (nbr_colors == 0)).any(dim=1)
            assign = (colors == 0) & ~blocked
            n_changed = int(assign.sum())
            colors = torch.where(assign, first_free(nbr_colors), colors)
        else:
            conflict = ((nbr_colors == colors[:, None]) & nbr_beats
                        & (colors[:, None] != 0)).any(dim=1)
            colors = torch.where(conflict, 0, colors)
            n_changed = int(conflict.sum()) + int((colors == 0).sum())
            colors = torch.where(colors == 0, first_free(nbr_colors), colors)
        if n_changed == 0:
            break
    nbr_colors = gather(colors)
    conflict = ((nbr_colors == colors[:, None]) & nbr_beats & (colors[:, None] != 0)).any(dim=1)
    return torch.where(conflict, 0, colors)


def _vb_ell(cols_ell: np.ndarray, dev, deterministic: bool) -> np.ndarray:
    """Rounds with the gather as an indexed read of the ELL adjacency."""
    n = cols_ell.shape[0]
    idx = np.arange(n, dtype=np.int64)
    valid = (cols_ell >= 0) & (cols_ell != idx[:, None])
    beats = torch.from_numpy(_beats(valid, cols_ell.astype(np.int64), idx)).to(dev)
    cols = torch.from_numpy(np.maximum(cols_ell, 0).astype(np.int64)).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)

    def gather(colors):
        return torch.where(valid_t, colors[cols], 0)

    return _vb_loop(gather, beats, n, deterministic).cpu().numpy()


def _vb_offsets(rm, ent, nrows, max_offsets: int = 24):
    """(offsets, valid (n, K), beats (n, K)) when the graph has at most
    ``max_offsets`` distinct non-self column offsets, else None
    (``tpukk``'s coloring.py:135-179, one O(nnz) host pass)."""
    rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(rm).astype(np.int64))
    ent64 = ent.astype(np.int64)
    non_self = ent64 != rows
    offs = (ent64 - rows)[non_self]
    # a sampled candidate set and one verification pass instead of sorting
    # all nnz offsets
    if offs.size > 200_000:
        samp = np.unique(offs[:: max(1, offs.size // 100_000)])
        if len(samp) > max_offsets:
            return None
        pos = np.searchsorted(samp, offs)
        ok = (pos < len(samp)) & (samp[np.minimum(pos, len(samp) - 1)] == offs)
        uniq = samp if ok.all() else np.unique(offs)
    else:
        uniq = np.unique(offs)
    if len(uniq) > max_offsets:
        return None
    K = max(1, len(uniq))
    mask = np.zeros((nrows, K), bool)
    if len(uniq):
        mask[rows[non_self], np.searchsorted(uniq, offs)] = True
    idx = np.arange(nrows, dtype=np.int64)
    nbr_i = idx[:, None] + (uniq[None, :] if len(uniq) else 0)
    inb = mask & (nbr_i >= 0) & (nbr_i < nrows)
    return tuple(int(d) for d in uniq), inb, _beats(inb, nbr_i, idx)


def _vb_rolled(offsets, valid: np.ndarray, beats: np.ndarray, dev,
               deterministic: bool) -> np.ndarray:
    """Rounds with the gather as one roll of the colors per offset:
    nbr_color[i, k] = colors[i + offsets[k]], masked by ``valid``."""
    n, w = valid.shape
    valid_t = torch.from_numpy(valid).to(dev)

    def gather(colors):
        if not offsets:
            return torch.zeros((n, w), dtype=torch.int32, device=dev)
        cols = torch.stack([torch.roll(colors, -d) for d in offsets], dim=1)
        return torch.where(valid_t, cols, 0)

    return _vb_loop(gather, torch.from_numpy(beats).to(dev), n, deterministic).cpu().numpy()


def _vb_selection(cols_ell: np.ndarray, dev, deterministic: bool) -> np.ndarray:
    """Rounds with the gather as one K3 SpMV of the colors through the
    selection matrix S[(i·w + j), cols[i, j]] = 1 (one entry or none per
    row: empty and self slots have none, so they gather 0)."""
    from ..containers import CsrMatrix  # lazy: sparse imports graph
    from ..sparse import spmv_cuda

    n, w = cols_ell.shape
    idx = np.arange(n, dtype=np.int64)
    valid = (cols_ell >= 0) & (cols_ell != idx[:, None])
    vflat = valid.reshape(-1)
    rm_s = np.zeros(n * w + 1, np.int64)
    np.cumsum(vflat, out=rm_s[1:])
    ent_s = cols_ell.reshape(-1)[vflat]
    S = CsrMatrix.from_arrays(rm_s, ent_s, np.ones(len(ent_s), np.float32), nrows=n * w,
                              ncols=n, device=dev)
    plan = spmv_cuda.build_csr_plan(S, torch.float32)
    beats = torch.from_numpy(_beats(valid, cols_ell.astype(np.int64), idx)).to(dev)

    def gather(colors):
        return spmv_cuda.csr_spmv(plan, colors.to(torch.float32)).reshape(n, w).to(torch.int32)

    return _vb_loop(gather, beats, n, deterministic).cpu().numpy()


@annotate("graph_color")
def graph_color(graph, algorithm: ColoringAlgorithm = ColoringAlgorithm.VB, *,
                _selection: bool = False) -> np.ndarray:
    """1-based colors per vertex (host int32).  The rounds run on the graph's
    device.  ``_selection=True`` sends any graph through the selection-matrix
    gather, as ``tpukk``'s ``_interpret=True`` does with its one-hot kernel.
    Sets the gauges ``graph.colors`` (distinct colors) and ``graph.color_s``
    (the call's host seconds)."""
    t = time.perf_counter()
    colors = _color(graph, algorithm, _selection)
    tracing.set("graph.color_s", time.perf_counter() - t)
    tracing.set("graph.colors", int(np.count_nonzero(np.bincount(colors)[1:])))
    return colors


def _color(graph, algorithm: ColoringAlgorithm, _selection: bool) -> np.ndarray:
    rm, ent, nrows = _adjacency(graph)
    if algorithm == ColoringAlgorithm.SERIAL:
        return native.d1_greedy_color(rm, ent, nrows)
    det = algorithm in (ColoringAlgorithm.VBD, ColoringAlgorithm.VBDBIT)
    dev = graph.row_map.device
    colors = None
    if nrows >= 4096 and not _selection:
        off = _vb_offsets(rm, ent, nrows)
        if off is not None:
            colors = _vb_rolled(*off, dev, det)
            if (colors == 0).any():
                colors = None
    if colors is not None:
        return colors
    cols_ell = _ell_pad(rm, ent, nrows)
    if cols_ell.size >= 32768 or _selection:
        colors = _vb_selection(cols_ell, dev, det)
    else:
        colors = _vb_ell(cols_ell, dev, det)
    if (colors == 0).any():  # pathological: the serial greedy colors it
        return native.d1_greedy_color(rm, ent, nrows)
    return colors


def _csr_transpose_pattern(rm, ent, n, m):
    """Pattern-only CSR transpose (counting sort), host."""
    counts = np.bincount(ent, minlength=m)
    t_rm = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=t_rm[1:])
    order = np.argsort(ent, kind="stable")
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(rm).astype(np.int64))
    return t_rm.astype(np.int32), rows[order].astype(np.int32)


@annotate("graph_color_d2")
def graph_color_d2(graph, algorithm: ColoringAlgorithm = ColoringAlgorithm.VB) -> np.ndarray:
    """Distance-2 coloring by the host greedy of ``csrc/host.cpp``: two-hop
    neighborhoods are walked with an O(n) stamped workspace and G² is never
    formed (Distance2Color_impl.hpp's forbidden arrays).  A square graph is
    symmetrized first; for a rectangular one, rows that share a column
    conflict.  ``algorithm`` is accepted for ``tpukk``'s signature: like
    ``tpukk`` with its native library, every algorithm runs the greedy."""
    rm = np.asarray(graph.host_row_map())
    ent = np.asarray(graph.host_entries())
    n, m = graph.nrows, graph.ncols
    if n == m:
        import scipy.sparse as sps

        pat = sps.csr_matrix((np.ones(len(ent), np.float32), ent, rm), shape=(n, m))
        pat = (pat + pat.T).tocsr()
        pat.sort_indices()
        return native.d2_greedy_color(pat.indptr, pat.indices, n, include_d1=True)
    t_rm, t_ent = _csr_transpose_pattern(rm, ent, n, m)
    return native.d2_greedy_color(rm, ent, n, t_rm, t_ent, m, include_d1=False)


def verify_coloring(graph, colors: np.ndarray) -> bool:
    """No vertex shares its color with a neighbor, and every vertex is
    colored (cf. kk_is_d1_coloring_valid, Test_Graph_graph_color.hpp:135-167);
    vectorized over the edges."""
    rm, ent, nrows = _adjacency(graph)
    colors = np.asarray(colors)
    if (colors <= 0).any():
        return False
    rows = np.repeat(np.arange(nrows), np.diff(rm).astype(np.int64))
    other = ent != rows
    return not bool((colors[ent[other]] == colors[rows[other]]).any())


def color_sets(colors: np.ndarray):
    """Group vertices by color: (color_offsets, vertex_order), the color_adj
    permutation of colored Gauss-Seidel (gauss_seidel_impl.hpp)."""
    order = np.argsort(colors, kind="stable")
    ncolors = int(colors.max())
    counts = np.bincount(colors, minlength=ncolors + 1)[1:]
    offsets = np.zeros(ncolors + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, order.astype(np.int32)
