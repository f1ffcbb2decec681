"""Restarted GMRES(m) with the preconditioner applied on the left, from
x0 = 0: Arnoldi with classical Gram-Schmidt applied twice, the small
least-squares problem solved on the host, and the true relative residual
‖b − A·x‖ / ‖b‖ checked at each restart, so that iteration counts (in
multiples of m) compare with the port's."""
from __future__ import annotations

import numpy as np
import torch


def _cycle(At, b, x0, prec, m: int):
    z = prec(b - torch.mv(At, x0))
    beta = torch.linalg.vector_norm(z)
    V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    V[0] = z / beta
    for j in range(m):
        w = prec(torch.mv(At, V[j]))
        Vj = V[:j + 1]
        h = Vj @ w
        w = w - Vj.T @ h
        h2 = Vj @ w
        w = w - Vj.T @ h2
        H[:j + 1, j] = h + h2
        hn = torch.linalg.vector_norm(w)
        H[j + 1, j] = hn
        V[j + 1] = w / torch.where(hn == 0, torch.ones_like(hn), hn)
    Hh = H.double().cpu().numpy()
    rhs = np.zeros(m + 1)
    rhs[0] = float(beta)
    y = np.linalg.lstsq(Hh, rhs, rcond=None)[0]
    return x0 + V[:m].T @ torch.from_numpy(y).to(b.device, b.dtype)


def solve(At, b: torch.Tensor, prec, tol: float, mix: dict):
    """(x, iterations, converged)."""
    m = min(int(mix["m"]), b.shape[0])
    x = torch.zeros_like(b)
    bnorm = float(torch.linalg.vector_norm(b))
    its, rel = 0, float("inf")
    for _ in range(int(mix["max_restarts"])):
        x = _cycle(At, b, x, prec, m)
        its += m
        rel = float(torch.linalg.vector_norm(b - torch.mv(At, x))) / bnorm
        if rel <= tol:
            break
    return x, its, rel <= tol
