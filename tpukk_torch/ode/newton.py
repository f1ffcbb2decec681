"""Newton solver for small nonlinear systems — counterpart of
``tpukk/ode/newton.py`` (the reference's ode/src/KokkosODE_Newton.hpp, used
by BDF).  The Jacobian is ``torch.func.jacfwd`` of f unless ``jac`` is given,
as ``tpukk`` uses ``jax.jacfwd``; each step solves with ``torch.linalg``."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..common.tracing import annotate
from .runge_kutta import _as_state

__all__ = ["NewtonResult", "newton_solve"]


class NewtonResult(NamedTuple):
    x: torch.Tensor
    converged: torch.Tensor
    num_iters: torch.Tensor


@annotate("ode.newton_solve")
def newton_solve(f: Callable, x0, *, jac: Callable = None, max_iters: int = 50,
                 rel_tol: float = 1e-10, abs_tol: float = 1e-12, args=(), device=None):
    """Solve f(x, *args) = 0 by full Newton steps x ← x − J(x)⁻¹·f(x) until
    |f(x)| ≤ abs_tol + rel_tol·|x| or ``max_iters`` steps.  x0 a tensor keeps
    its device; anything else goes to default_device(device)."""
    x = _as_state(x0, device)
    jac_fn = ((lambda v: jac(v, *args)) if jac is not None
              else torch.func.jacfwd(lambda v: f(v, *args)))
    it, done = 0, False
    while not done and it < max_iters:
        dx = torch.linalg.solve(torch.as_tensor(jac_fn(x), dtype=x.dtype, device=x.device),
                                f(x, *args))
        x = x - dx
        done = bool(torch.linalg.vector_norm(f(x, *args))
                    <= abs_tol + rel_tol * torch.linalg.vector_norm(x))
        it += 1
    return NewtonResult(x, torch.tensor(done, device=x.device),
                        torch.tensor(it, dtype=torch.int32, device=x.device))
