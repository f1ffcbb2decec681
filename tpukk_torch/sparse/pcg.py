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
import types
import weakref
from typing import Optional

import torch

from ..common.cuda_graph import entry, run_blocks
from ..common.tracing import annotate
from .preconditioner import IdentityPrec, Preconditioner
from .spmv import SpmvHandle

__all__ = ["PcgStats", "pcg", "pcg_initial_state", "pcg_iteration", "pcg_iteration_body"]


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
    ``body(carry, _) -> ((x, r, p, rz), None)``: ``pcg_iteration`` on copies
    of x, r and p, so the returned carry never aliases the one it was given
    (the solver rows of a benchmark replay one carry)."""

    def body(carry, _):
        x, r, p, rz = carry
        return pcg_iteration(Ah, prec, (x.clone(), r.clone(), p.clone(), rz)), None

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


# a caller-held SpmvHandle -> {key: entry}: the entries go with the handle
_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# the preconditioner of ``prec=None``: one object, so that its entry is found again
_IDENTITY = IdentityPrec()


@annotate("pcg")
def pcg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        max_iters: int = 500, prec: Optional[Preconditioner] = None,
        check_every: int = 10):
    """Solve A·x = b; returns (x, PcgStats).  ``A`` is a CsrMatrix or an
    SpmvHandle; ``b`` lies on the matrix's device.

    With ``A`` an SpmvHandle and b on a CUDA device, each block of
    ``check_every`` iterations (the preconditioner's applies among them) but
    the first solve's first is one CUDA graph's replay
    (``common.cuda_graph.run_blocks``): the same kernels on the same values,
    issued by one launch a block.  Its cache entry goes with the handle, one
    for each (prec, check_every, ``pcg_iteration``, b's dtype, shape and
    device, thread, and that thread's stream on b's device), so solves at
    once from two threads or on two streams each have graphs and buffers of
    their own.  A preconditioner whose ``operands`` are no longer the
    captured ones (a new numeric phase) captures anew; where the capture
    fails (an apply that syncs the host) the key's blocks run as they are.
    The counters ``pcg.blocks``, ``pcg.graph_replays``,
    ``pcg.graph_captures`` and ``pcg.graph_fallbacks`` tell which ran; the
    regions ``tpukk::pcg.block`` and ``tpukk::pcg.check`` wrap every block
    and residual read."""
    Ah = A if isinstance(A, SpmvHandle) else SpmvHandle(A)
    prec = prec or _IDENTITY
    # the solve's x, r, p and r·z: the cache entry's where its blocks are graphed
    g = entry(_graphs.setdefault(A, {}) if isinstance(A, SpmvHandle) else None,
              (check_every, pcg_iteration), b, prec)
    if g is None:
        x = torch.zeros_like(b) if x0 is None else x0.clone()
    elif x0 is None:
        x = g.x.zero_()
    else:
        x = g.x.copy_(x0)
    bnorm = float(torch.sqrt(torch.abs(_dot(b, b)))) or 1.0
    x, r, p, rz = pcg_initial_state(Ah, prec, b, x, into=g)
    st = types.SimpleNamespace(x=x, r=r, p=p, rz=rz) if g is None else g

    def block(st):
        state = (st.x, st.r, st.p, st.rz)
        for _ in range(check_every):
            state = pcg_iteration(Ah, prec, state)
        # x, r and p were updated in place; a graph's r·z goes into its buffer
        if g is None:
            st.rz = state[3]
        else:
            st.rz.copy_(state[3])

    def check(st):
        rel = float(torch.sqrt(torch.abs(_dot(st.r, st.r)))) / bnorm
        return rel, rel <= tol

    iters, rel = run_blocks("pcg", block, check, st, g is not None, check_every, max_iters)
    return (st.x if g is None else st.x.clone()), PcgStats(iters, rel, rel <= tol)
