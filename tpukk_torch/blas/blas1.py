"""BLAS1 — vector and multivector ops, counterpart of ``tpukk/blas/blas1.py``
(blas/src/KokkosBlas1_*.hpp: abs, axpby/axpy, dot, fill, iamax, mult, nrm1,
nrm2, nrm2_squared, nrm2w, nrminf, reciprocal, rot, rotg, rotm, rotmg, scal,
set, sum, swap, update).

``tpukk`` hands these to XLA, so they are torch ops here, on the tensors'
device.  Every function returns new tensors and modifies none of its
arguments (``fill``, ``set``, ``scal``, ``swap`` and ``rot`` included), as
``tpukk``'s do on immutable arrays.  Multivector (2-D, "MV") forms take
per-column coefficient vectors like the reference's axpby MV overloads
(blas/impl/KokkosBlas1_axpby_mv_impl.hpp): scalars broadcast, rank-1
coefficient tensors apply per column, and MV reductions give one value a
column.  A Python scalar coefficient keeps the vector's dtype (JAX's weak
types do the same in ``tpukk``).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..common import arith_traits
from ..common.types import default_device
from ..common.tracing import annotate

__all__ = [
    "abs", "axpy", "axpby", "dot", "fill", "iamax", "mult", "nrm1", "nrm2",
    "nrm2_squared", "nrm2w", "nrminf", "reciprocal", "rot", "rotg", "rotm",
    "rotmg", "scal", "set", "update", "sum", "swap",
]


def _scalar(a, x: torch.Tensor):
    """A Python number as is; anything else as a tensor on x's device."""
    return a if isinstance(a, numbers.Number) else torch.as_tensor(a, device=x.device)


def _coef(a, x: torch.Tensor):
    """Broadcast a scalar or per-column coefficient against vector/multivector x."""
    a = _scalar(a, x)
    if isinstance(a, torch.Tensor) and a.ndim == 1 and x.ndim == 2:
        return a[None, :]
    return a


def _over(x: torch.Tensor) -> dict:
    """A reduction's dims: per column for a multivector, else all of x."""
    return {"dim": 0} if x.ndim == 2 else {}


@annotate("blas1.abs")
def abs(x):  # noqa: A001 - matches KokkosBlas1_abs
    return torch.abs(x)


@annotate("blas1.axpy")
def axpy(alpha, x, y):
    """y + alpha*x (returns the new y)."""
    return _coef(alpha, x) * x + y


@annotate("blas1.axpby")
def axpby(alpha, x, beta, y):
    """alpha*x + beta*y, cf. blas/src/KokkosBlas1_axpby.hpp."""
    return _coef(alpha, x) * x + _coef(beta, y) * y


@annotate("blas1.dot")
def dot(x, y):
    """<x,y> with x conjugated for complex types
    (cf. Kokkos_InnerProductSpaceTraits.hpp).  MV form: per-column dots."""
    return torch.sum(arith_traits(x.dtype).conj(x) * y, **_over(x))


@annotate("blas1.fill")
def fill(x, val):
    """A new tensor of x's shape and dtype, every entry val."""
    return torch.full_like(x, val if isinstance(val, numbers.Number)
                           else torch.as_tensor(val).item())


def set(y, x):  # noqa: A001 - matches KokkosBlas1_set (Y = X)
    """Y = X as a new tensor: x broadcast to y's shape, in y's dtype
    (cf. blas/src/KokkosBlas1_set.hpp)."""
    return torch.empty_like(y).copy_(torch.as_tensor(x, device=y.device))


@annotate("blas1.iamax")
def iamax(x):
    """Index of the largest |x_i| (0-based, the first of ties; per column for MV)."""
    return torch.argmax(torch.abs(x), dim=0)


@annotate("blas1.mult")
def mult(gamma, y, alpha, a, x):
    """gamma*y + alpha*a*x elementwise (cf. KokkosBlas1_mult.hpp)."""
    a = _scalar(a, x)
    if isinstance(a, torch.Tensor) and a.ndim == 1 and x.ndim == 2:
        a = a[:, None]
    return _scalar(gamma, y) * y + _scalar(alpha, x) * a * x


@annotate("blas1.nrm1")
def nrm1(x):
    return torch.sum(torch.abs(x), **_over(x)).to(arith_traits(x.dtype).mag_dtype)


@annotate("blas1.nrm2_squared")
def nrm2_squared(x):
    m = torch.abs(x) if arith_traits(x.dtype).is_complex else x
    return torch.sum(m * m, **_over(x))


@annotate("blas1.nrm2")
def nrm2(x):
    return torch.sqrt(nrm2_squared(x))


@annotate("blas1.nrm2w")
def nrm2w(x, w):
    """sqrt(sum((x_i/w_i)^2)) — cf. KokkosBlas1_nrm2w.hpp."""
    w = _scalar(w, x)
    if isinstance(w, torch.Tensor) and w.ndim == 1 and x.ndim == 2:
        w = w[:, None]
    return torch.sqrt(torch.sum(torch.abs(x / w) ** 2, **_over(x)))


@annotate("blas1.nrminf")
def nrminf(x):
    return torch.amax(torch.abs(x), **_over(x))


@annotate("blas1.reciprocal")
def reciprocal(x):
    return 1.0 / x


@annotate("blas1.scal")
def scal(alpha, x):
    return _coef(alpha, x) * x


@annotate("blas1.update")
def update(alpha, x, beta, y, gamma, z):
    """alpha*x + beta*y + gamma*z (cf. KokkosBlas1_update.hpp)."""
    return _coef(alpha, x) * x + _coef(beta, y) * y + _coef(gamma, z) * z


@annotate("blas1.sum")
def sum(x):  # noqa: A001
    return torch.sum(x, **_over(x))


@annotate("blas1.swap")
def swap(x, y):
    """(y, x) as new tensors; cf. KokkosBlas1_swap.hpp."""
    return y.clone(), x.clone()


@annotate("blas1.rot")
def rot(x, y, c, s):
    """Apply a Givens rotation: (c*x + s*y, c*y - s*x)."""
    c, s = _scalar(c, x), _scalar(s, x)
    return c * x + s * y, c * y - s * x


def _reals(values, device) -> list:
    """Scalar arguments as float tensors on one device: a tensor keeps its
    device, and the others go to the first tensor's, or to
    ``default_device(device)`` where none is a tensor.  A tensor or numpy
    value keeps its float dtype; a Python number or an integer is f64
    (``tpukk`` runs with JAX's x64 on, where ``jnp.result_type(v, 1.0)`` is
    f64 for them)."""
    home = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    home = home if home is not None else default_device(device)
    out = []
    for v in values:
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out.append((t if t.is_floating_point() else t.to(torch.float64)).to(home))
    return out


@annotate("blas1.rotg")
def rotg(a, b, device=None):
    """Construct the Givens rotation that zeroes b: (r, z, c, s) per BLAS,
    r carrying the sign of the larger of |a| and |b|.  Tensors keep their
    device; numbers go to ``device`` (None: the CUDA device)."""
    a, b = _reals((a, b), device)
    big_a = torch.abs(a) > torch.abs(b)
    sigma = torch.where(big_a, torch.sign(a), torch.sign(b))
    r = sigma * torch.sqrt(a * a + b * b)
    safe = torch.where(r == 0, 1.0, r)
    c = torch.where(r == 0, 1.0, a / safe)
    s = torch.where(r == 0, 0.0, b / safe)
    z = torch.where(big_a, s, torch.where(c != 0, 1.0 / c, 1.0))
    return r, z, c, s


@annotate("blas1.rotm")
def rotm(x, y, param):
    """Apply the modified Givens rotation H (param = [flag, h11, h21, h12, h22])."""
    param = torch.as_tensor(param, device=x.device)
    flag = param[0]
    h11, h21, h12, h22 = param[1], param[2], param[3], param[4]
    one = torch.ones_like(h11)
    zero = torch.zeros_like(h11)
    h11 = torch.where(flag == -2.0, one, torch.where(flag == 0.0, one, h11))
    h22 = torch.where(flag == -2.0, one, torch.where(flag == 0.0, one, h22))
    h12 = torch.where(flag == -2.0, zero, torch.where(flag == 1.0, one, h12))
    h21 = torch.where(flag == -2.0, zero, torch.where(flag == 1.0, -one, h21))
    return h11 * x + h12 * y, h21 * x + h22 * y


@annotate("blas1.rotmg")
def rotmg(d1, d2, x1, y1, device=None):
    """Construct the modified Givens rotation — the reference LAPACK drotmg
    with its gamma-threshold rescaling loops (GAM = 4096): while a scale
    factor lies outside [1/GAM², GAM²], d, x1 and H are rescaled by GAM²
    steps and the flag drops to -1 (the full-matrix form).  Scalars in;
    (d1, d2, x1, param) out, param = [flag, h11, h21, h12, h22].  A negative
    d1, or a negative q2 = d2·y1² where |q2| ≥ |q1|, gives LAPACK's flag -1
    and zeros, where ``tpukk`` does not return.  Tensors keep their device;
    numbers go to ``device`` (None: the CUDA device)."""
    d1, d2, x1, y1 = _reals((d1, d2, x1, y1), device)
    d2, x1, y1 = (v.to(d1.dtype) for v in (d2, x1, y1))
    p2 = d2 * y1
    p1 = d1 * x1
    q2 = p2 * y1
    q1 = p1 * x1
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)

    # |q1| > |q2|: H = [[1, h12], [h21, 1]]
    h21 = -y1 / x1
    h12 = p2 / p1
    u = 1.0 - h12 * h21
    f0 = (zero, d1 / u, d2 / u, x1 * u, one, h21, h12, one)
    # |q2| >= |q1|: H = [[h11, 1], [-1, h22]]
    h11 = p1 / p2
    h22 = x1 / y1
    u = 1.0 + h11 * h22
    f1 = (one, d2 / u, d1 / u, y1 * u, h11, -one, one, h22)
    use0 = torch.abs(q1) > torch.abs(q2)
    flag, nd1, nd2, nx1, h11, h21, h12, h22 = (torch.where(use0, a, b) for a, b in zip(f0, f1))
    # the second case with u <= 0 (a negative weight would result): LAPACK
    # zeroes everything and returns the full-matrix form with H = 0
    bad = (~use0) & (1.0 + (p1 / p2) * (x1 / y1) <= 0.0) & (q2 != 0)
    flag = torch.where(bad, -1.0, flag)
    nd1, nd2, nx1, h11, h21, h12, h22 = (torch.where(bad, zero, h)
                                         for h in (nd1, nd2, nx1, h11, h21, h12, h22))
    # degenerate: zero inputs → the identity, flag -2
    degen = (q2 == 0) & (q1 == 0)
    flag = torch.where(degen, -2.0, flag)
    nd1 = torch.where(degen, d1, nd1)
    nd2 = torch.where(degen, d2, nd2)
    nx1 = torch.where(degen, x1, nx1)
    # LAPACK's error branches, d1 < 0 or q2 < 0 in the second case: flag -1
    # and everything 0 (tpukk's loop below never ends on these inputs, since
    # a negative d1 never enters the window)
    neg = (d1 < 0) | (~use0 & (q2 < 0))
    flag = torch.where(neg, -1.0, flag)
    nd1, nd2, nx1, h11, h21, h12, h22 = (torch.where(neg, zero, h)
                                         for h in (nd1, nd2, nx1, h11, h21, h12, h22))

    # gamma rescaling (LAPACK drotmg's GAM/GAMSQ/RGAMSQ loops)
    gam = torch.tensor(4096.0, dtype=d1.dtype, device=d1.device)
    gamsq, rgamsq = gam * gam, 1.0 / (gam * gam)

    def need(a1, a2, fl) -> bool:
        d1bad = (a1 != 0) & ((a1 <= rgamsq) | (a1 >= gamsq))
        d2bad = (a2 != 0) & ((torch.abs(a2) <= rgamsq) | (torch.abs(a2) >= gamsq))
        return bool((fl != -2.0) & (d1bad | d2bad))

    while need(nd1, nd2, flag):
        # entering the full-matrix form: write out the implicit 1 / -1 entries
        h11 = torch.where(flag == 0.0, one, h11)
        h22 = torch.where(flag == 0.0, one, h22)
        h21 = torch.where(flag == 1.0, -one, h21)
        h12 = torch.where(flag == 1.0, one, h12)
        flag = torch.where(flag != -2.0, -one, flag)
        lo1 = (nd1 != 0) & (nd1 <= rgamsq)
        hi1 = nd1 >= gamsq
        nd1 = torch.where(lo1, nd1 * gamsq, torch.where(hi1, nd1 / gamsq, nd1))
        nx1 = torch.where(lo1, nx1 / gam, torch.where(hi1, nx1 * gam, nx1))
        h11 = torch.where(lo1, h11 / gam, torch.where(hi1, h11 * gam, h11))
        h12 = torch.where(lo1, h12 / gam, torch.where(hi1, h12 * gam, h12))
        lo2 = (nd2 != 0) & (torch.abs(nd2) <= rgamsq)
        hi2 = torch.abs(nd2) >= gamsq
        nd2 = torch.where(lo2, nd2 * gamsq, torch.where(hi2, nd2 / gamsq, nd2))
        h21 = torch.where(lo2, h21 / gam, torch.where(hi2, h21 * gam, h21))
        h22 = torch.where(lo2, h22 / gam, torch.where(hi2, h22 * gam, h22))
    return nd1, nd2, nx1, torch.stack([flag, h11, h21, h12, h22])
