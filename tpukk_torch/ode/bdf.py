"""Implicit BDF integrators — counterpart of ``tpukk/ode/bdf.py`` (the
reference's ode/src/KokkosODE_BDF.hpp).

* ``bdf_solve``: fixed-step BDF-k (k = 1..6) with Newton inner solves
  (``newton_solve``, Jacobians by ``torch.func.jacfwd``); the first steps
  ramp the order up through lower-order BDF steps.
* ``bdf_solve_adaptive``: variable order (1..5) and step (BDFSolve,
  KokkosODE_BDF.hpp:137-184), the Shampine-Reichelt modified BDF on the
  backward-difference matrix D, rescaled by ``_change_D`` when h changes,
  errors in ``_rms_norm``; ``tpukk``'s formulation line by line.
* ``bdf_solve_adaptive_batched``: B systems at once, the port's counterpart
  of ``jax.vmap`` over ``tpukk``'s adaptive solver: each system carries its
  own t, h, order, D, equal-step count, steps, attempts and status as
  tensors with B first, a finished system is masked out, and the loop runs
  until all are done, so each takes exactly the steps it would take alone.
  ``f`` is one system's (evaluated through ``torch.func.vmap``, tensor
  ``args`` batched on axis 0); ``bdf_solve_adaptive`` is this at B = 1.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..common.tracing import annotate
from .newton import newton_solve
from .runge_kutta import _as_state, arg_dims, batched_fun, single_fun

__all__ = ["BDFAdaptiveResult", "BDFResult", "bdf_solve", "bdf_solve_adaptive",
           "bdf_solve_adaptive_batched"]

# BDF-k:  sum_{j=0..k} alpha_j y_{n+1-j} = h beta f(t_{n+1}, y_{n+1})
_BDF_ALPHA = {
    1: ([1.0, -1.0], 1.0),
    2: ([3.0 / 2, -2.0, 1.0 / 2], 1.0),
    3: ([11.0 / 6, -3.0, 3.0 / 2, -1.0 / 3], 1.0),
    4: ([25.0 / 12, -4.0, 3.0, -4.0 / 3, 1.0 / 4], 1.0),
    5: ([137.0 / 60, -5.0, 5.0, -10.0 / 3, 5.0 / 4, -1.0 / 5], 1.0),
    6: ([147.0 / 60, -6.0, 15.0 / 2, -20.0 / 3, 15.0 / 4, -6.0 / 5, 1.0 / 6], 1.0),
}


class BDFResult(NamedTuple):
    y: torch.Tensor
    converged: torch.Tensor


@annotate("ode.bdf_solve")
def bdf_solve(f: Callable, y0, t0: float, t1: float, num_steps: int, order: int = 2, args=(),
              newton_iters: int = 20, device=None):
    """Integrate y' = f(t, y, *args) with ``num_steps`` fixed steps of
    BDF-``order`` (cf. KokkosODE::BDF::Solve)."""
    if not 1 <= order <= 6:
        raise ValueError("bdf: order in [1,6]")
    y0 = _as_state(y0, device)
    h = (t1 - t0) / num_steps
    hist = [y0] * (order + 1)   # hist[0] the newest
    ok = True

    def step_k(k, hist, t_next):
        alpha, beta = _BDF_ALPHA[k]

        def residual(y):
            acc = alpha[0] * y
            for j in range(1, k + 1):
                acc = acc + alpha[j] * hist[j - 1]
            return acc - h * beta * f(t_next, y, *args)

        return newton_solve(residual, hist[0], max_iters=newton_iters, rel_tol=1e-12,
                            abs_tol=1e-12)

    for i in range(num_steps):
        k = min(i + 1, order)
        res = step_k(k, hist, torch.tensor(t0 + (i + 1) * h, dtype=y0.dtype, device=y0.device))
        ok = ok and bool(res.converged)
        hist = [res.x] + hist[:-1]
    return BDFResult(hist[0], torch.tensor(ok, device=y0.device))


# ---------------------------------------------------------------------------
# adaptive order and step
# ---------------------------------------------------------------------------

_MAX_ORDER = 5
_NEWTON_MAXITER = 4

_KAPPA = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
_GAMMA = np.hstack((0.0, np.cumsum(1.0 / np.arange(1, _MAX_ORDER + 1))))
_ALPHA = (1 - _KAPPA) * _GAMMA
_ERR_CONST = _KAPPA * _GAMMA + 1.0 / np.arange(1, _MAX_ORDER + 2)
_P = _MAX_ORDER + 3


class BDFAdaptiveResult(NamedTuple):
    y: torch.Tensor
    status: torch.Tensor      # 0 ok, 1 failed (step underflow / attempt cap)
    num_steps: torch.Tensor   # accepted steps


def _change_D(D, k, factor):
    """D[:, :k+1] ← (R(factor)·R(1))ᵀ·D for each system (scipy's
    _bdf.change_D); rows past k untouched.  D (B, P, n), k and factor (B,)."""
    dt, dev = D.dtype, D.device
    i = torch.arange(_P, dtype=dt, device=dev)[:, None]
    j = torch.arange(_P, dtype=dt, device=dev)[None, :]

    def R_of(fac):
        M = torch.where((i >= 1) & (j >= 1), (i - 1 - fac[:, None, None] * j)
                        / torch.clamp(i, min=1), torch.zeros((), dtype=dt, device=dev))
        M = torch.where(i == 0, torch.ones((), dtype=dt, device=dev), M)
        return torch.cumprod(M, dim=1)

    RU = R_of(factor) @ R_of(torch.ones_like(factor))
    rows = torch.arange(_P, device=dev)[:, None]
    cols = torch.arange(_P, device=dev)[None, :]
    inside = (rows <= k[:, None, None]) & (cols <= k[:, None, None])
    RUm = torch.where(inside, RU, (rows == cols).to(dt))
    return RUm.mT @ D


def _rms_norm(x, scale):
    return torch.sqrt(torch.mean((x / scale) ** 2, dim=-1))


def _sel(mask, a, b):
    """a where mask (B,), else b, for tensors with B first."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _bdf_adaptive(fun, jac, y0, t0, t1, rtol, atol, initial_step, max_step, max_steps):
    """The batched adaptive BDF of y0 (B, n); fun(t (B,), y (B, n)) and its
    Jacobian jac(t, y) (B, n, n)."""
    nb, n = y0.shape
    fdt, dev = y0.dtype, y0.device
    pad = lambda a: torch.as_tensor(np.pad(a, (0, _P - len(a))), dtype=fdt, device=dev)
    gamma, alpha, err_const = pad(_GAMMA), pad(_ALPHA), pad(_ERR_CONST)
    eye = torch.eye(n, dtype=fdt, device=dev)
    ar = torch.arange(_P, device=dev)
    bi = torch.arange(nb, device=dev)

    tt0 = torch.full((nb,), t0, dtype=fdt, device=dev)
    f0 = fun(tt0, y0)
    # initial step: the reference's initial_step_size (BDF.hpp:184) / scipy's h_start
    scale0 = atol + rtol * y0.abs()
    d0 = _rms_norm(y0, scale0)
    d1 = _rms_norm(f0, scale0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    h0 = torch.minimum(h0, torch.full_like(h0, (t1 - t0) * 0.1))
    y1 = y0 + h0[:, None] * f0
    d2 = _rms_norm(fun(tt0 + h0, y1) - f0, scale0) / h0
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6), (0.01 / dm) ** (1.0 / 2.0))
    h = (torch.minimum(100 * h0, h1) if initial_step is None
         else torch.full_like(h0, initial_step))
    h = torch.clamp(h, 1e-12, min(max_step, float(t1 - t0)))

    D = torch.zeros((nb, _P, n), dtype=fdt, device=dev)
    D[:, 0] = y0
    D[:, 1] = h[:, None] * f0
    t = tt0
    k = torch.ones(nb, dtype=torch.long, device=dev)
    n_eq = torch.zeros(nb, dtype=torch.int32, device=dev)
    steps = torch.zeros(nb, dtype=torch.int32, device=dev)
    attempts = torch.zeros(nb, dtype=torch.int32, device=dev)
    status = torch.zeros(nb, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    min_step = 1e-13 * float(t1 - t0)
    reach = t1 - 1e-12 * max(abs(t1), 1.0)
    inf = torch.tensor(math.inf, dtype=fdt, device=dev)

    while not bool(done.all()):
        run = ~done
        # clip h to the remaining interval (and rescale D for the new h)
        h_new = torch.clamp(h, max=float(max_step))
        h_new = torch.minimum(h_new, t1 - t)
        Dc = _change_D(D, k, h_new / h)
        hc = h_new
        t_new = t + hc
        # predict
        ordmask = (ar[None, :] <= k[:, None])[:, :, None]
        y_pred = torch.sum(torch.where(ordmask, Dc, torch.zeros((), dtype=fdt, device=dev)), 1)
        scale = atol + rtol * y_pred.abs()
        gk = torch.where((ar[None] >= 1) & (ar[None] <= k[:, None]), gamma[None],
                         torch.zeros((), dtype=fdt, device=dev))
        ak = alpha[k]
        psi = (Dc * (gk / ak[:, None])[:, :, None]).sum(1)
        c = hc / ak
        # Newton on d:  c·f(t_new, y_pred + d) − psi − d = 0
        A = eye - c[:, None, None] * jac(t_new, y_pred)
        LU, piv, _ = torch.linalg.lu_factor_ex(A)
        d = torch.zeros_like(y_pred)
        y = y_pred
        conv = torch.zeros(nb, dtype=torch.bool, device=dev)
        rate = torch.zeros(nb, dtype=fdt, device=dev)
        dnp = torch.zeros(nb, dtype=fdt, device=dev)
        for m in range(_NEWTON_MAXITER):
            F = c[:, None] * fun(t_new, y) - psi - d
            dy = torch.linalg.lu_solve(LU, piv, F[:, :, None])[:, :, 0]
            dn = _rms_norm(dy, scale)
            if m > 0:
                rate = dn / torch.clamp(dnp, min=1e-300)
            d = d + dy
            y = y + dy
            conv = conv | (dn <= 1e-10)
            if m > 0:
                conv = conv | ((rate < 1.0) & (rate / (1 - rate) * dn < 1e-3))
            dnp = dn
        err_norm = _rms_norm(err_const[k][:, None] * d, scale)
        accept = conv & (err_norm <= 1.0)

        # rejected: shrink h (a Newton failure by 0.5, an error by err^(-1/(k+1)))
        kf = k.to(fdt)
        fac_rej = torch.where(conv, torch.clamp(0.9 * err_norm ** (-1.0 / (kf + 1)), 0.1, 0.9),
                              torch.full_like(err_norm, 0.5))
        D_rej = _change_D(Dc, k, fac_rej)
        h_rej = hc * fac_rej

        # accepted: shift D, maybe change order and step
        D_acc = Dc.clone()
        Dk2 = d - Dc[bi, torch.clamp(k + 1, max=_P - 1)]
        k2 = k + 2
        has2 = k2 < _P
        D_acc[bi[has2], k2[has2]] = Dk2[has2]
        D_acc[bi, k + 1] = d
        for jj in range(_P - 2, -1, -1):   # D[j] += D[j+1] for j = k..0
            upd = (jj <= k)[:, None]
            D_acc[:, jj] = torch.where(upd, D_acc[:, jj] + D_acc[:, jj + 1], D_acc[:, jj])
        n_eq_acc = n_eq + 1

        # order and step change after k+1 equal steps (scipy's rule)
        km1 = torch.clamp(k - 1, min=0)
        kp2 = torch.clamp(k + 2, max=_P - 1)
        em = torch.where(k > 1, _rms_norm(err_const[km1][:, None] * D_acc[bi, k], scale), inf)
        ep = torch.where(k < _MAX_ORDER,
                         _rms_norm(err_const[torch.clamp(k + 1, max=_P - 1)][:, None]
                                   * D_acc[bi, kp2], scale), inf)
        errs = torch.stack([em, err_norm, ep], -1)
        pw = torch.stack([1.0 / kf, 1.0 / (kf + 1), 1.0 / (kf + 2)], -1)
        facs = torch.where(errs > 0, errs ** -pw, inf)
        best = torch.argmax(facs, -1)
        k_new = torch.clamp(k + best - 1, 1, _MAX_ORDER)
        factor = torch.clamp(0.9 * facs.gather(-1, best[:, None])[:, 0], 0.1, 10.0)
        D_ord = _change_D(D_acc, k_new, factor)
        do_order = accept & (n_eq_acc >= k + 1)
        D_acc2 = _sel(do_order, D_ord, D_acc)
        h_acc = torch.where(do_order, hc * factor, hc)
        k_acc = torch.where(do_order, k_new, k)
        n_eq2 = torch.where(do_order, torch.zeros_like(n_eq_acc), n_eq_acc)

        t_out = torch.where(accept, t_new, t)
        h_out = torch.where(accept, h_acc, h_rej)
        k_out = torch.where(accept, k_acc, k)
        D_out = _sel(accept, D_acc2, D_rej)
        n_eq_out = torch.where(accept, n_eq2, torch.zeros_like(n_eq2))
        steps_out = steps + accept.to(torch.int32)
        attempts_out = attempts + 1
        fail = (h_out < min_step) | (attempts_out >= max_steps)
        reached = t_out >= reach
        # a finished system keeps its state
        t, h, k = (torch.where(run, a, b) for a, b in ((t_out, t), (h_out, h), (k_out, k)))
        D = _sel(run, D_out, D)
        n_eq, steps, attempts = (torch.where(run, a, b) for a, b in
                                 ((n_eq_out, n_eq), (steps_out, steps),
                                  (attempts_out, attempts)))
        status = torch.where(run, (fail & ~reached).to(torch.int32), status)
        done = done | (run & (reached | fail))
    return BDFAdaptiveResult(D[:, 0], status, steps)


def _single_jac(f, args, dtype):
    def jac(t, y):
        J = torch.func.jacfwd(lambda v: torch.as_tensor(f(t[0], v, *args)).to(dtype))(y[0])
        return J[None]
    return jac


def _batched_jac(f, args, dtype):
    dims = arg_dims(args)
    one = torch.func.jacfwd(lambda t, y, *a: torch.as_tensor(f(t, y, *a)).to(dtype), argnums=1)
    vj = torch.func.vmap(one, in_dims=dims)
    return lambda t, y: vj(t, y, *args)


@annotate("ode.bdf_solve_adaptive")
def bdf_solve_adaptive(f: Callable, y0, t0: float, t1: float, *, rtol: float = 1e-6,
                       atol: float = 1e-9, initial_step: float = None,
                       max_step: float = np.inf, max_steps: int = 10_000, args=(),
                       device=None):
    """Adaptive BDF1..5 (cf. BDFSolve, KokkosODE_BDF.hpp:159): the solution
    at t1, a status (0 ok, 1 failed) and the accepted steps; f(t, y, *args)
    → dy/dt, its Jacobian by ``torch.func.jacfwd``."""
    y0 = _as_state(y0, device)
    r = _bdf_adaptive(single_fun(f, args, y0.dtype), _single_jac(f, args, y0.dtype), y0[None],
                      t0, t1, rtol, atol, initial_step, max_step, max_steps)
    return BDFAdaptiveResult(r.y[0], r.status[0], r.num_steps[0])


@annotate("ode.bdf_solve_adaptive_batched")
def bdf_solve_adaptive_batched(f: Callable, y0, t0: float, t1: float, *, rtol: float = 1e-6,
                               atol: float = 1e-9, initial_step: float = None,
                               max_step: float = np.inf, max_steps: int = 10_000, args=(),
                               device=None):
    """``bdf_solve_adaptive`` of B systems y0 (B, n) at once, ``f`` of one
    system and its tensor ``args`` batched on axis 0: what ``jax.vmap`` of
    ``tpukk``'s ``bdf_solve_adaptive`` gives, with y (B, n), status and
    num_steps (B,)."""
    y0 = _as_state(y0, device)
    return _bdf_adaptive(batched_fun(f, args, y0.dtype), _batched_jac(f, args, y0.dtype), y0,
                         t0, t1, rtol, atol, initial_step, max_step, max_steps)
