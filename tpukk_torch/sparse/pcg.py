"""Preconditioned CG — counterpart of ``tpukk/sparse/pcg.py`` (the solver
program of the reference's perf_test/sparse/KokkosSparse_pcg.cpp).

The same iteration, the same ``where(pAp == 0, 1, pAp)`` guards and the same
``check_every`` blocking as ``tpukk``, so iteration counts match wherever
rounding does not steer CG (on ill-conditioned matrices two summation orders
can converge a block apart, tests/test_torch_pcg.py).  α, β and
the dot products stay 0-d device tensors: the only host syncs are one for
‖b‖ and one per ``check_every`` block, to read the residual norm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..common.tracing import annotate, profile_region
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
                      x: torch.Tensor):
    """(x, r, p, rz) with r = b - A·x, p = M⁻¹r, rz = r·p.  p is a fresh
    tensor: the iteration updates it in place."""
    r = b - Ah(x)
    z = prec.apply(r)
    return (x, r, z.clone(), _dot(r, z))


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


@annotate("pcg")
def pcg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        max_iters: int = 500, prec: Optional[Preconditioner] = None,
        check_every: int = 10):
    """Solve A·x = b; returns (x, PcgStats).  ``A`` is a CsrMatrix or an
    SpmvHandle; ``b`` lies on the matrix's device."""
    Ah = A if isinstance(A, SpmvHandle) else SpmvHandle(A)
    prec = prec or IdentityPrec()
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = float(torch.sqrt(torch.abs(_dot(b, b)))) or 1.0
    state = pcg_initial_state(Ah, prec, b, x)
    iters = 0
    rel = float("inf")
    while iters < max_iters:
        with profile_region(BLOCK_REGION):
            for _ in range(check_every):
                state = pcg_iteration(Ah, prec, state)
            iters += check_every
            with profile_region(CHECK_REGION):
                rel = float(torch.sqrt(torch.abs(_dot(state[1], state[1])))) / bnorm
        if rel <= tol:
            break
    return state[0], PcgStats(iters, rel, rel <= tol)
