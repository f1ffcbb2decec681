"""Explicit Runge-Kutta family — counterpart of ``tpukk/ode/runge_kutta.py``
(the reference's ode/src/KokkosODE_RungeKutta.hpp with the tableaus of
KokkosODE_RungeKuttaTables_impl.hpp: RKFE, RKEH, RKF12, RKBS, RK4, RKF45,
RKCK, RKDP, VER56, copied exactly, and its adaptive step controller).

``rk_solve`` integrates one system; ``rk_solve_batched`` integrates B
systems y0 (B, n) with the same per-system ``f`` (evaluated through
``torch.func.vmap``, its tensor ``args`` batched on their first axis), the
port's counterpart of ``jax.vmap`` over ``tpukk``'s ``rk_solve``: every
system carries its own t, h, step count and status as (B,) tensors, a
finished system is masked out, and the loop runs until all are done, so
each system takes exactly the steps it would take alone.  ``rk_solve`` is
the batched form at B = 1.  Arrays that are not tensors go to
``default_device(device)``, the CUDA device unless ``device="cpu"``; a
tensor y0 keeps its device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..common.tracing import annotate
from ..common.types import default_device

__all__ = ["RKType", "ButcherTableau", "tableau", "rk_solve", "rk_solve_batched",
           "ODESolverStatus", "RKResult"]


class RKType(enum.Enum):
    RKFE = "rkfe"     # forward Euler (1 stage)
    RKEH = "rkeh"     # Euler-Heun 1(2)
    RKF12 = "rkf12"   # Fehlberg 1(2)
    RKBS = "rkbs"     # Bogacki-Shampine 2(3)
    RK4 = "rk4"       # classic RK4
    RKF45 = "rkf45"   # Fehlberg 4(5)
    RKCK = "rkck"     # Cash-Karp 4(5)
    RKDP = "rkdp"     # Dormand-Prince 4(5)
    VER56 = "ver56"   # Verner 5(6)


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    a: tuple      # lower-triangular stage coefficients (tuple of tuples)
    b: tuple      # solution weights
    bhat: tuple   # embedded (lower-order) weights, or None
    c: tuple      # nodes
    order: int

    @property
    def stages(self) -> int:
        return len(self.b)


def _t(*rows):
    return tuple(tuple(float(x) for x in r) for r in rows)


_TABLEAUS = {}


def _register(kind, a, b, bhat, c, order):
    _TABLEAUS[kind] = ButcherTableau(
        _t(*a), tuple(map(float, b)),
        None if bhat is None else tuple(map(float, bhat)),
        tuple(map(float, c)), order)


_register(RKType.RKFE, [[0.0]], [1.0], None, [0.0], 1)
_register(RKType.RKEH, [[0.0], [1.0]], [0.5, 0.5], [1.0, 0.0], [0.0, 1.0], 2)
_register(RKType.RKF12,
          [[0.0], [0.5], [1.0 / 256, 255.0 / 256]],
          [1.0 / 512, 255.0 / 256, 1.0 / 512],
          [1.0 / 256, 255.0 / 256, 0.0],
          [0.0, 0.5, 1.0], 2)
_register(RKType.RKBS,
          [[0.0], [0.5], [0.0, 0.75], [2 / 9, 1 / 3, 4 / 9]],
          [2 / 9, 1 / 3, 4 / 9, 0.0],
          [7 / 24, 1 / 4, 1 / 3, 1 / 8],
          [0.0, 0.5, 0.75, 1.0], 3)
_register(RKType.RK4,
          [[0.0], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
          [1 / 6, 1 / 3, 1 / 3, 1 / 6], None,
          [0.0, 0.5, 0.5, 1.0], 4)
_register(RKType.RKF45,
          [[0.0], [0.25], [3 / 32, 9 / 32],
           [1932 / 2197, -7200 / 2197, 7296 / 2197],
           [439 / 216, -8.0, 3680 / 513, -845 / 4104],
           [-8 / 27, 2.0, -3544 / 2565, 1859 / 4104, -11 / 40]],
          [16 / 135, 0.0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55],
          [25 / 216, 0.0, 1408 / 2565, 2197 / 4104, -1 / 5, 0.0],
          [0.0, 0.25, 3 / 8, 12 / 13, 1.0, 0.5], 5)
_register(RKType.RKCK,
          [[0.0], [0.2], [3 / 40, 9 / 40], [0.3, -0.9, 1.2],
           [-11 / 54, 2.5, -70 / 27, 35 / 27],
           [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096]],
          [37 / 378, 0.0, 250 / 621, 125 / 594, 0.0, 512 / 1771],
          [2825 / 27648, 0.0, 18575 / 48384, 13525 / 55296, 277 / 14336, 0.25],
          [0.0, 0.2, 0.3, 0.6, 1.0, 7 / 8], 5)
_register(RKType.RKDP,
          [[0.0], [0.2], [3 / 40, 9 / 40], [44 / 45, -56 / 15, 32 / 9],
           [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
           [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
           [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]],
          [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
          [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
          [0.0, 0.2, 0.3, 0.8, 8 / 9, 1.0, 1.0], 5)
_register(RKType.VER56,
          [[0.0], [1 / 6], [4 / 75, 16 / 75], [5 / 6, -8 / 3, 5 / 2],
           [-165 / 64, 55 / 6, -425 / 64, 85 / 96],
           [12 / 5, -8.0, 4015 / 612, -11 / 36, 88 / 255],
           [-8263 / 15000, 124 / 75, -643 / 680, -81 / 250, 2484 / 10625],
           [3501 / 1720, -300 / 43, 297275 / 52632, -319 / 2322, 24068 / 84065, 0.0, 3850 / 26703]],
          [3 / 40, 0.0, 875 / 2244, 23 / 72, 264 / 1955, 0.0, 125 / 11592, 43 / 616],
          [13 / 160, 0.0, 2375 / 5984, 5 / 16, 12 / 85, 3 / 44, 0.0, 0.0],
          [0.0, 1 / 6, 4 / 15, 2 / 3, 5 / 6, 1.0, 1 / 15, 1.0], 6)


@annotate("ode.tableau")
def tableau(kind: RKType) -> ButcherTableau:
    return _TABLEAUS[kind]


class ODESolverStatus(enum.Enum):
    SUCCESS = 0
    MAX_STEPS = 1
    MIN_STEP = 2


class RKResult(NamedTuple):
    y: torch.Tensor
    status: torch.Tensor      # int32 ODESolverStatus value ((B,) batched)
    num_steps: torch.Tensor   # int32 ((B,) batched)


def _as_state(y0, device) -> torch.Tensor:
    """y0 as a floating tensor: a tensor keeps its device, anything else
    goes to default_device(device).  A tensor or an ndarray keeps its dtype;
    a Python number or list takes numpy's, f64 (complex128 for a complex
    number), as ``jnp.asarray`` gives it with x64 on."""
    if isinstance(y0, torch.Tensor) and device is None:
        y = y0
    elif isinstance(y0, (torch.Tensor, np.ndarray, np.generic)):
        y = torch.as_tensor(y0, device=default_device(device))
    else:
        y = torch.as_tensor(np.asarray(y0), device=default_device(device))
    return y if y.dtype.is_floating_point or y.dtype.is_complex else y.to(torch.float64)


def arg_dims(args) -> tuple:
    """``torch.func.vmap``'s in_dims for (t, y, *args): t, y and the tensor
    args batched on axis 0, anything else shared."""
    return (0, 0) + tuple(0 if isinstance(a, torch.Tensor) else None for a in args)


def batched_fun(f: Callable, args, dtype):
    """f(t, y, *args) of one system as a function of (t (B,), y (B, n)):
    ``torch.func.vmap`` over the systems, tensor args batched on axis 0."""
    dims = arg_dims(args)
    vf = torch.func.vmap(lambda t, y, *a: torch.as_tensor(f(t, y, *a)).to(dtype), in_dims=dims)
    return lambda t, y: vf(t, y, *args)


def single_fun(f: Callable, args, dtype):
    """f(t, y, *args) of one system as the batched form at B = 1."""
    return lambda t, y: torch.as_tensor(f(t[0], y[0], *args)).to(dtype)[None]


def _rk_step(fun, tb: ButcherTableau, t, h, y):
    """One step of every system: (y_hi, y_hi − y_lo), t and h (B,), y (B, n)."""
    hc = h[:, None]
    ks = []
    for i in range(tb.stages):
        yi = y
        for j, aij in enumerate(tb.a[i][:i]):
            if aij != 0.0:
                yi = yi + hc * aij * ks[j]
        ks.append(fun(t + tb.c[i] * h, yi))
    y_hi = y
    for i, bi in enumerate(tb.b):
        if bi != 0.0:
            y_hi = y_hi + hc * bi * ks[i]
    if tb.bhat is None:
        return y_hi, torch.zeros_like(y)
    y_lo = y
    for i, bi in enumerate(tb.bhat):
        if bi != 0.0:
            y_lo = y_lo + hc * bi * ks[i]
    return y_hi, y_hi - y_lo


def _rk(fun, y0, t0, t1, kind, num_steps, rel_tol, abs_tol, max_steps):
    """The batched integration of y0 (B, ...): each system's state is
    flattened for the steps (the error norm is the max over every entry, as
    in ``tpukk``) and given back to ``fun`` and the caller in its shape.  t
    and h are real, in the real type of y0's dtype."""
    tb = tableau(kind)
    nb, shape, dt, dev = y0.shape[0], y0.shape[1:], y0.dtype, y0.device
    rdt = dt.to_real() if dt.is_complex else dt
    y0 = y0.reshape(nb, -1)

    def flat(t, y):
        return fun(t, y.reshape(nb, *shape)).reshape(nb, -1)

    def result(y, status, steps):
        return RKResult(y.reshape(nb, *shape), status, steps)

    if num_steps == 0 and tb.bhat is None:
        num_steps = 100  # non-embedded tableaus have no error estimate
    if num_steps:
        h = torch.full((nb,), (t1 - t0) / num_steps, dtype=rdt, device=dev)
        y = y0
        for i in range(num_steps):
            t = torch.full((nb,), t0 + i * ((t1 - t0) / num_steps), dtype=rdt, device=dev)
            y, _ = _rk_step(flat, tb, t, h, y)
        return result(y, torch.full((nb,), ODESolverStatus.SUCCESS.value, dtype=torch.int32,
                                    device=dev),
                      torch.full((nb,), num_steps, dtype=torch.int32, device=dev))
    min_h = (t1 - t0) / (10.0 * max_steps)
    t = torch.full((nb,), t0, dtype=rdt, device=dev)
    h = torch.full((nb,), (t1 - t0) / 100.0, dtype=rdt, device=dev)
    y = y0
    steps = torch.zeros(nb, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    while True:
        run = ~done & (steps < max_steps)
        if not bool(run.any()):
            break
        hs = torch.minimum(h, t1 - t)
        ynew, err = _rk_step(flat, tb, t, hs, y)
        tol = abs_tol + rel_tol * torch.maximum(y.abs().amax(-1), ynew.abs().amax(-1))
        enorm = err.abs().amax(-1) / tol
        accept = run & (enorm <= 1.0)
        t = torch.where(accept, t + hs, t)
        y = torch.where(accept[:, None], ynew, y)
        fac = torch.clamp(0.9 * (1.0 / torch.clamp(enorm, min=1e-12)) ** (1.0 / tb.order),
                          0.2, 5.0)
        h = torch.where(run, torch.clamp(hs * fac, min=min_h), h)
        reached = t >= t1 * (1 - 1e-12) if t1 > 0 else t >= t1
        done = torch.where(run, reached, done)
        steps = steps + run.to(torch.int32)
    status = torch.where(done, ODESolverStatus.SUCCESS.value,
                         ODESolverStatus.MAX_STEPS.value).to(torch.int32)
    return result(y, status, steps)


@annotate("ode.rk_solve")
def rk_solve(f: Callable, y0, t0: float, t1: float, *, kind: RKType = RKType.RKDP,
             num_steps: int = 0, rel_tol: float = 1e-6, abs_tol: float = 1e-9,
             max_steps: int = 10_000, args=(), device=None):
    """Integrate y' = f(t, y, *args) from t0 to t1 (cf.
    RungeKutta<RK_type>::Solve).  num_steps > 0: fixed steps; else adaptive
    (embedded error control, the reference's safety-factor step update)."""
    y0 = _as_state(y0, device)
    r = _rk(single_fun(f, args, y0.dtype), y0[None], t0, t1, kind, num_steps, rel_tol, abs_tol,
            max_steps)
    return RKResult(r.y[0], r.status[0], r.num_steps[0])


@annotate("ode.rk_solve_batched")
def rk_solve_batched(f: Callable, y0, t0: float, t1: float, *, kind: RKType = RKType.RKDP,
                     num_steps: int = 0, rel_tol: float = 1e-6, abs_tol: float = 1e-9,
                     max_steps: int = 10_000, args=(), device=None):
    """``rk_solve`` of B systems y0 (B, n) at once, ``f`` of one system and
    its tensor ``args`` batched on axis 0: what ``jax.vmap`` of ``tpukk``'s
    ``rk_solve`` gives, with y (B, n), status and num_steps (B,)."""
    y0 = _as_state(y0, device)
    return _rk(batched_fun(f, args, y0.dtype), y0, t0, t1, kind, num_steps, rel_tol, abs_tol,
               max_steps)
