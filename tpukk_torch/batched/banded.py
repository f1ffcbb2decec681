"""Band-storage batched factorizations and solves — counterpart of
``tpukk/batched/banded.py`` (the reference's KokkosBatched_{Pbtrf, Pbtrs,
Gbtrf, Gbtrs, Tbsv}.hpp) on LAPACK's compact band layout.

``tpukk`` writes each as one ``lax.scan`` over the columns that carries a
small update window, vmapped over the batch.  Here each is a Python loop
over the n columns that carries the same window for all B systems at once:
every step is a handful of batched ops on (B, kd+1) or (B, kl+1, ku+1)
tensors, on the inputs' device.

Storage (LAPACK):
* symmetric lower band, bandwidth kd:  Ab[i, j] = A[j+i, j], shape
  (..., kd+1, n); entries with j+i >= n are ignored;
* general band, kl sub / ku super:  Ab[i, j] = A[j+i-ku, j], shape
  (..., kl+ku+1, n).

``gbtrf_banded`` does not pivot: the diagonally dominant (static pivoting)
regime of the reference's batched banded use, as in ``tpukk``.
"""
from __future__ import annotations

import torch

from ..common.tracing import annotate

__all__ = ["pbtrf_banded", "pbtrs_banded", "gbtrf_banded", "gbtrs_banded",
           "tbsv_banded"]


def _flat(a, band_ndim=2):
    """(a with one batch axis, the batch shape)."""
    bshape = a.shape[:-band_ndim]
    return a.reshape((-1,) + a.shape[len(bshape):]), bshape


def _safe_div(num, den):
    """num / den, 0 where den is 0."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


# ---------------------------------------------------------------------------
# banded Cholesky
# ---------------------------------------------------------------------------

def _pbtrf(Ab):
    """(B, kd+1, n) lower band -> L in the same layout."""
    nb, kd1, n = Ab.shape
    kd = kd1 - 1
    if kd == 0:
        return torch.sqrt(Ab)
    i = torch.arange(kd1, device=Ab.device)[:, None]
    j = torch.arange(n, device=Ab.device)[None, :]
    Ab = torch.where(i + j < n, Ab, torch.zeros_like(Ab))
    idx = torch.arange(kd1, device=Ab.device)[:, None] + torch.arange(kd, device=Ab.device)[None]
    U = torch.zeros((nb, kd1, kd), dtype=Ab.dtype, device=Ab.device)
    cols = []
    for c in range(n):
        # U[:, r, t]: the update accumulated for band entry (r, c+t)
        w = Ab[:, :, c] + U[:, :, 0]
        ljj = torch.sqrt(w[:, 0])
        l = torch.where(ljj[:, None] > 0, w[:, 1:] / torch.where(ljj == 0, 1.0, ljj)[:, None],
                        torch.zeros_like(w[:, 1:]))
        lpad = torch.cat([l, torch.zeros((nb, kd + 1), dtype=l.dtype, device=l.device)], 1)
        upd = -lpad[:, idx] * l[:, None, :]
        U = torch.cat([U[:, :, 1:], torch.zeros((nb, kd1, 1), dtype=U.dtype, device=U.device)],
                      2) + upd
        cols.append(torch.cat([ljj[:, None], l], 1))
    return torch.stack(cols, -1)


@annotate("batched.pbtrf_banded")
def pbtrf_banded(Ab):
    """Cholesky of an SPD band matrix in lower band storage (..., kd+1, n);
    L in the same layout (cf. KokkosBatched_Pbtrf.hpp)."""
    a, bshape = _flat(Ab)
    return _pbtrf(a).reshape(Ab.shape)


def _band_shift_rows(Lb):
    """S[:, i, j] = Lb[:, i, j-i] (0 where j < i): the anti-diagonal gather
    that turns column-stored band rows into each row's solve coefficients."""
    nb, kd1, n = Lb.shape
    rows = [Lb[:, 0]]
    for i in range(1, kd1):
        rows.append(torch.cat([torch.zeros((nb, i), dtype=Lb.dtype, device=Lb.device),
                               Lb[:, i, :n - i]], 1))
    return torch.stack(rows, 1)


def _lower_band_fwd(Lb, b):
    """Solve L·y = b, L (B, kd+1, n) in lower band storage, b (B, n): x_j
    from the kd values before it."""
    nb, kd1, n = Lb.shape
    kd = kd1 - 1
    S = _band_shift_rows(Lb)
    w = torch.zeros((nb, max(kd, 1)), dtype=b.dtype, device=b.device)
    ys = []
    for j in range(n):
        s = S[:, :, j]
        contrib = torch.sum(s[:, 1:].flip(1) * w, 1) if kd else 0.0
        x = (b[:, j] - contrib) / s[:, 0]
        if kd:
            w = torch.cat([w[:, 1:], x[:, None]], 1)
        ys.append(x)
    return torch.stack(ys, 1)


def _lower_band_bwd_T(Lb, y):
    """Solve Lᵀ·x = y, L in lower band storage: column j of Lb holds row j's
    coefficients of Lᵀ."""
    nb, kd1, n = Lb.shape
    kd = kd1 - 1
    w = torch.zeros((nb, max(kd, 1)), dtype=y.dtype, device=y.device)
    xs = []
    for j in range(n - 1, -1, -1):
        c = Lb[:, :, j]
        contrib = torch.sum(c[:, 1:] * w, 1) if kd else 0.0
        x = (y[:, j] - contrib) / c[:, 0]
        if kd:
            w = torch.cat([x[:, None], w[:, :-1]], 1)
        xs.append(x)
    return torch.stack(xs[::-1], 1)


@annotate("batched.pbtrs_banded")
def pbtrs_banded(Lb, b):
    """Solve A·x = b from ``pbtrf_banded``'s factor (cf.
    KokkosBatched_Pbtrs.hpp)."""
    L = Lb.reshape((-1,) + Lb.shape[-2:])
    bf = b.reshape(-1, b.shape[-1])
    return _lower_band_bwd_T(L, _lower_band_fwd(L, bf)).reshape(b.shape)


# ---------------------------------------------------------------------------
# banded LU (no pivoting)
# ---------------------------------------------------------------------------

def _gbtrf(Ab, kl, ku):
    """(B, kl+ku+1, n) general band -> (Lb (B, kl, n) column-stored unit
    lower multipliers, Ub (B, ku+1, n) row-stored U: Ub[t, j] = U[j, j+t])."""
    nb, _, n = Ab.shape
    dev, dt = Ab.device, Ab.dtype
    i = torch.arange(kl + ku + 1, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    r = i + j - ku
    Ab = torch.where((r >= 0) & (r < n), Ab, torch.zeros_like(Ab))
    rows = [Ab[:, ku]]
    for t in range(1, ku + 1):
        rows.append(torch.cat([Ab[:, ku - t, t:], torch.zeros((nb, t), dtype=dt, device=dev)], 1))
    Rrow = torch.stack(rows, 1)                     # (B, ku+1, n)
    Csub = Ab[:, ku + 1:]                           # (B, kl, n)
    M = torch.zeros((nb, kl + 1, ku + 1), dtype=dt, device=dev)
    Ls, Us = [], []
    for c in range(n):
        # M[:, s, t]: the update accumulated for A[c+s, c+t]
        urow = Rrow[:, :, c] + M[:, 0]
        ujj = urow[:, 0]
        cupd = Csub[:, :, c] + M[:, 1:, 0] if kl else Csub[:, :, c]
        l = _safe_div(cupd, ujj[:, None])
        Mn = torch.zeros_like(M)
        if kl and ku:
            Mn[:, :kl, :ku] = M[:, 1:, 1:] - l[:, :, None] * urow[:, None, 1:]
        M = Mn
        Ls.append(l)
        Us.append(urow)
    return torch.stack(Ls, -1), torch.stack(Us, -1)


@annotate("batched.gbtrf_banded")
def gbtrf_banded(Ab, kl: int, ku: int):
    """LU (no pivoting) of a general band matrix in LAPACK band storage
    (..., kl+ku+1, n): (Lb, Ub), the unit lower multipliers column-stored
    (..., kl, n) and U row-stored (..., ku+1, n) (cf.
    KokkosBatched_Gbtrf.hpp; static-pivoting regime)."""
    a, bshape = _flat(Ab)
    Lb, Ub = _gbtrf(a, kl, ku)
    return Lb.reshape(bshape + Lb.shape[1:]), Ub.reshape(bshape + Ub.shape[1:])


def _gbtrs(Lb, Ub, b):
    nb, kl, n = Lb.shape
    ku = Ub.shape[1] - 1
    if kl:
        S = _band_shift_rows(torch.cat([torch.ones((nb, 1, n), dtype=Lb.dtype,
                                                   device=Lb.device), Lb], 1))
        w = torch.zeros((nb, kl), dtype=b.dtype, device=b.device)
        ys = []
        for j in range(n):
            yj = b[:, j] - torch.sum(S[:, 1:, j].flip(1) * w, 1)
            w = torch.cat([w[:, 1:], yj[:, None]], 1)
            ys.append(yj)
        y = torch.stack(ys, 1)
    else:
        y = b
    w = torch.zeros((nb, max(ku, 1)), dtype=b.dtype, device=b.device)
    xs = []
    for j in range(n - 1, -1, -1):
        u = Ub[:, :, j]
        contrib = torch.sum(u[:, 1:] * w, 1) if ku else 0.0
        x = (y[:, j] - contrib) / u[:, 0]
        if ku:
            w = torch.cat([x[:, None], w[:, :-1]], 1)
        xs.append(x)
    return torch.stack(xs[::-1], 1)


@annotate("batched.gbtrs_banded")
def gbtrs_banded(Lb, Ub, b):
    """Solve A·x = b from ``gbtrf_banded``'s factors (cf.
    KokkosBatched_Gbtrs.hpp)."""
    L = Lb.reshape((-1,) + Lb.shape[-2:])
    U = Ub.reshape((-1,) + Ub.shape[-2:])
    return _gbtrs(L, U, b.reshape(-1, b.shape[-1])).reshape(b.shape)


@annotate("batched.tbsv_banded")
def tbsv_banded(Ab, b, lower: bool = True, unit_diag: bool = False):
    """Triangular banded solve in band storage (cf. KokkosBatched_Tbsv.hpp).
    lower: Ab (..., k+1, n) lower band (Ab[i, j] = A[j+i, j]); upper: Ab
    (..., k+1, n) upper band row-stored (Ab[t, j] = A[j, j+t])."""
    a = Ab.reshape((-1,) + Ab.shape[-2:])
    if unit_diag:
        a = torch.cat([torch.ones_like(a[:, :1]), a[:, 1:]], 1)
    bf = b.reshape(-1, b.shape[-1])
    if lower:
        x = _lower_band_fwd(a, bf)
    else:
        x = _gbtrs(a[:, :0], a, bf)
    return x.reshape(b.shape)
