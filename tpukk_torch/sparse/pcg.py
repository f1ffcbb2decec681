"""Preconditioned CG — counterpart of ``tpukk/sparse/pcg.py`` (the solver
program of the reference's perf_test/sparse/KokkosSparse_pcg.cpp).

The same iteration, the same ``where(pAp == 0, 1, pAp)`` guards and the same
``check_every`` blocking as ``tpukk``, so iteration counts match wherever
rounding does not steer CG (on ill-conditioned matrices two summation orders
can converge a block apart, tests/test_torch_pcg.py).  α, β and
the dot products stay 0-d device tensors: the only host syncs are one for
‖b‖ and one per ``check_every`` block, to read the residual norm.

Where ``A`` is an ``SpmvHandle`` (the caller keeps it between solves) and b
lies on a CUDA device, a block is one CUDA graph's replay (``pcg``): the
graph, its buffers and its pool live in a cache entry that goes with the
handle.
"""
from __future__ import annotations

import dataclasses
import threading
import types
import weakref
from typing import Optional

import torch

from ..common.cuda_graph import block_state, capture_block, replay_block
from ..common.cuda_graph import capture as _capture
from ..common.tracing import annotate, count, profile_region
from .preconditioner import IdentityPrec, Preconditioner
from .spmv import SpmvHandle

__all__ = ["PcgStats", "pcg", "pcg_initial_state", "pcg_iteration", "pcg_iteration_body"]

# a check_every block of iterations, and inside it the residual read (the
# block's one host sync); no region inside an iteration
BLOCK_REGION = "tpukk::pcg.block"
CHECK_REGION = "tpukk::pcg.check"


@dataclasses.dataclass
class PcgStats:
    num_iters: int
    end_rel_res: float
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.conj(a) * b)


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def pcg_iteration_body(Ah: SpmvHandle, prec: Preconditioner):
    """One PCG iteration in ``tpukk``'s scan-body convention:
    ``body(carry, _) -> ((x, r, p, rz), None)``.  Unlike ``pcg_iteration``
    it builds new x, r and p, so the returned carry never aliases the one it
    was given (the solver rows of a benchmark replay one carry)."""

    def body(carry, _):
        x, r, p, rz = carry
        Ap = Ah(p)
        alpha = rz / _nonzero(_dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec.apply(r)
        rz_new = _dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        return (x, r, p, rz_new), None

    return body


@annotate("pcg_initial_state")
def pcg_initial_state(Ah: SpmvHandle, prec: Preconditioner, b: torch.Tensor,
                      x: torch.Tensor, into=None):
    """(x, r, p, rz) with r = b - A·x, p = M⁻¹r, rz = r·p.  p is a fresh
    tensor: the iteration updates it in place.  ``into``: buffers r, p and
    0-d rz (as ``pcg``'s graphs read) that take the state in place."""
    if into is None:
        r = b - Ah(x)
        z = prec.apply(r)
        return (x, r, z.clone(), _dot(r, z))
    r = torch.sub(b, Ah(x), out=into.r)
    z = prec.apply(r)
    return (x, r, into.p.copy_(z), into.rz.copy_(_dot(r, z)))


def pcg_iteration(Ah: SpmvHandle, prec: Preconditioner, state):
    """One PCG iteration on (x, r, p, rz).  x, r and p are updated in place
    where ``tpukk``'s scan body builds new arrays: they belong to the solve,
    and this saves three vector allocations per iteration."""
    x, r, p, rz = state
    Ap = Ah(p)
    alpha = rz / _nonzero(_dot(p, Ap))
    x.add_(alpha * p)
    r.sub_(alpha * Ap)
    z = prec.apply(r)
    rz_new = _dot(r, z)
    beta = rz_new / _nonzero(rz)
    p.mul_(beta).add_(z)
    return (x, r, p, rz_new)


# the devices on which pcg replays its blocks as CUDA graphs
_GRAPH_DEVICES = ("cuda",)
# a caller-held SpmvHandle -> {key: entry}: the entries go with the handle
_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# the preconditioner of ``prec=None``: one object, so that its entry is found again
_IDENTITY = IdentityPrec()


def _graph_for(A, prec, b: torch.Tensor, check_every: int):
    """The cache entry of a solve (``common.cuda_graph.block_state``, with
    the preconditioner held weakly and its ``_operands`` held): where A is a
    caller-held ``SpmvHandle`` and b lies on a CUDA device, the entry of
    (prec, check_every, b's dtype, shape and device, ``pcg_iteration`` as
    the module now has it, the thread and its stream on b's device), made
    anew where a captured graph no longer reads the preconditioner's
    operands; else None.  The handle's own plans are built once and kept."""
    if not isinstance(A, SpmvHandle) or b.device.type not in _GRAPH_DEVICES:
        return None
    entries = _graphs.setdefault(A, {})
    for k in [k for k, g in entries.items() if g.prec() is None]:
        del entries[k]  # its graph may read what died with its preconditioner
    stream = torch.cuda.current_stream(b.device).cuda_stream if b.device.type == "cuda" else None
    key = (id(prec), check_every, b.dtype, tuple(b.shape), b.device, pcg_iteration,
           threading.get_ident(), stream)
    g = entries.get(key)
    if g is None or g.prec() is not prec or (g.replay is not None and not _same(g.held, prec)):
        g = entries[key] = block_state(b)
        g.prec, g.held = weakref.ref(prec), None
    return g


def _operands(prec) -> tuple:
    """What a graph of ``prec.apply`` is replayed on: ``prec.operands()``
    (a ``Preconditioner``), or the attributes of an object that has
    ``apply`` alone (``CholmodSolve``, ``SuperLUSolve``)."""
    if isinstance(prec, Preconditioner):
        return prec.operands()
    return tuple(getattr(prec, "__dict__", {}).values())


def _same(held, prec) -> bool:
    now = _operands(prec)
    return len(now) == len(held) and all(o is h for o, h in zip(now, held))


@annotate("pcg")
def pcg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        max_iters: int = 500, prec: Optional[Preconditioner] = None,
        check_every: int = 10):
    """Solve A·x = b; returns (x, PcgStats).  ``A`` is a CsrMatrix or an
    SpmvHandle; ``b`` lies on the matrix's device.

    With ``A`` an SpmvHandle and b on a CUDA device, the blocks of
    ``check_every`` iterations (the preconditioner's applies among them) are
    captured once as one CUDA graph for each (handle, prec, check_every, b's
    dtype, shape and device, thread, and that thread's stream on b's
    device), kept with the handle, and replayed in this solve and the later
    ones: the same kernels on the same values, issued by one launch a block.
    So solves at once on one handle and prec from two threads, or on two
    streams, each have graphs and buffers of their own.  The first block
    runs as it is, and the capture follows it.  A preconditioner whose
    ``operands`` are no longer the captured ones (a new numeric phase)
    captures anew; where the capture fails (an apply that syncs the host)
    the key's blocks run as they are.  Each replay adds to the counters what
    the block's host code added (``launches.*``); the counters
    ``pcg.blocks``, ``pcg.graph_replays``, ``pcg.graph_captures`` and
    ``pcg.graph_fallbacks`` tell how often that happens.  The regions
    ``tpukk::pcg.block`` and ``tpukk::pcg.check`` wrap every block and
    residual read; the regions inside a block are entered only where it
    runs as it is and at the capture, not in a replay."""
    Ah = A if isinstance(A, SpmvHandle) else SpmvHandle(A)
    prec = prec or _IDENTITY
    # the solve's x, r, p and r·z: the cache entry's where its blocks are graphed
    st = g = _graph_for(A, prec, b, check_every)
    if g is None:
        x = torch.zeros_like(b) if x0 is None else x0.clone()
    elif x0 is None:
        x = g.x.zero_()
    else:
        x = g.x.copy_(x0)
    bnorm = float(torch.sqrt(torch.abs(_dot(b, b)))) or 1.0
    x, r, p, rz = pcg_initial_state(Ah, prec, b, x, into=g)
    if g is None:
        st = types.SimpleNamespace(x=x, r=r, p=p, rz=rz)

    def block(st):
        state = (st.x, st.r, st.p, st.rz)
        for _ in range(check_every):
            state = pcg_iteration(Ah, prec, state)
        # x, r and p were updated in place; a graph's r·z goes into its buffer
        if g is None:
            st.rz = state[3]
        else:
            st.rz.copy_(state[3])

    iters = 0
    rel = float("inf")
    while iters < max_iters:
        with profile_region(BLOCK_REGION):
            if g is not None and g.replay is not None:
                replay_block(g)
                count("pcg.graph_replays")
            else:
                block(st)
                if g is not None and not g.tried:
                    capture_block(g, block, b.device, _capture)
                    g.held = _operands(prec) if g.replay is not None else None
                    count("pcg.graph_captures" if g.replay is not None
                          else "pcg.graph_fallbacks")
            count("pcg.blocks")
            iters += check_every
            with profile_region(CHECK_REGION):
                rel = float(torch.sqrt(torch.abs(_dot(st.r, st.r)))) / bnorm
        if rel <= tol:
            break
    return (st.x if g is None else st.x.clone()), PcgStats(iters, rel, rel <= tol)
