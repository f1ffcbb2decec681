"""Preconditioned conjugate gradients (Hestenes-Stiefel with a
preconditioner), from x0 = 0.  The residual norm is read every
``check_every`` iterations, the cadence the mix states for the port, so
that iteration counts compare."""
from __future__ import annotations

import torch


def solve(At, b: torch.Tensor, prec, tol: float, mix: dict):
    """(x, iterations, converged)."""
    check_every = int(mix.get("check_every", 10))
    max_iters = int(mix["max_iters"])
    x = torch.zeros_like(b)
    r = b.clone()
    z = prec(r)
    p = z.clone()
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.vector_norm(b))
    its, rel = 0, float("inf")
    while its < max_iters:
        for _ in range(check_every):
            Ap = torch.mv(At, p)
            alpha = rz / torch.dot(p, Ap)
            x += alpha * p
            r -= alpha * Ap
            z = prec(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        its += check_every
        rel = float(torch.linalg.vector_norm(r)) / bnorm
        if rel <= tol:
            break
    return x, its, rel <= tol
