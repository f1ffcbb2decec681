"""Batched general (nonsymmetric) eigendecomposition — counterpart of
``tpukk/batched/eig.py`` (the reference's KokkosBatched_Eigendecomposition:
Hessenberg condensation, QR iteration to Schur form, eigenvalues with
conjugate pairs adjacent, left and right eigenvectors).

The same algorithm as ``tpukk``'s, so the eigenvalues come out in its order:
masked Householder reflectors reduce each matrix to upper Hessenberg form,
then a single-Wilkinson-shift implicit QR with Givens bulge chasing, in
complex arithmetic, drives it to complex Schur form, deflating the trailing
subdiagonal when it is negligible; the eigenvectors come from triangular
solves against the Schur factor.  ``tpukk`` runs each matrix's QR in a
``lax.while_loop`` under ``vmap``, so every matrix keeps its own active
window and sweep count and the loop runs until all are done.  Here the loop
is over iterations of the whole batch, with the window end k, the sweep
count and whether each matrix deflates or sweeps as (B,) tensors: a matrix
that is done, or that deflates this iteration, gets identity rotations,
which leave it exactly as it was.  Every op is batched over B on the
input's device; ``torch.linalg.eig`` is not used (it is chip_smoke.py's
yardstick only).
"""
from __future__ import annotations

import torch

from ..common.tracing import annotate

__all__ = ["hessenberg", "schur", "eig", "eigenvalues", "eigendecomposition"]


def _complex_dtype(dtype):
    return torch.complex64 if dtype in (torch.float32, torch.float16, torch.bfloat16) \
        else torch.complex128


def _eps(dtype):
    return torch.finfo(dtype).eps


def _hessenberg(A):
    """(H, Q) with Qᴴ·A·Q = H upper Hessenberg, A (B, n, n)."""
    nb, n, _ = A.shape
    dt, dev = A.dtype, A.device
    Q = torch.eye(n, dtype=dt, device=dev).repeat(nb, 1, 1)
    H = A.clone()
    if n <= 2:
        return H, Q
    rows = torch.arange(n, device=dev)
    for j in range(n - 2):
        x = H[:, :, j]
        xm = torch.where(rows > j, x, torch.zeros_like(x))
        normx = torch.sqrt(torch.sum(xm.abs() ** 2, -1))
        p = x[:, j + 1]
        pa = p.abs()
        phase = torch.where(pa > 0, p / torch.clamp(pa, min=1e-300), torch.ones_like(p))
        u = xm.clone()
        u[:, j + 1] = u[:, j + 1] + phase * normx
        unorm = torch.sqrt(torch.sum(u.abs() ** 2, -1))
        u = torch.where(unorm[:, None] > 0,
                        u / torch.where(unorm > 0, unorm, torch.ones_like(unorm))[:, None],
                        torch.zeros_like(u))
        uh = u.conj()
        # H ← (I − 2uuᴴ)·H·(I − 2uuᴴ);  Q ← Q·(I − 2uuᴴ)
        H = H - 2.0 * u[:, :, None] * torch.einsum("bi,bij->bj", uh, H)[:, None, :]
        H = H - 2.0 * torch.einsum("bij,bj->bi", H, u)[:, :, None] * uh[:, None, :]
        Q = Q - 2.0 * torch.einsum("bij,bj->bi", Q, u)[:, :, None] * uh[:, None, :]
    return H, Q


def _givens(x, z):
    """(B, 2, 2) unitary G = [[x̄, z̄], [−z, x]]/r zeroing z in (x, z)ᵀ; the
    identity where r is 0."""
    r = torch.sqrt(x.abs() ** 2 + z.abs() ** 2)
    ok = r > 0
    rs = torch.where(ok, r, torch.ones_like(r))
    g00 = torch.where(ok, x.conj() / rs, torch.ones_like(x))
    g01 = torch.where(ok, z.conj() / rs, torch.zeros_like(z))
    return torch.stack([torch.stack([g00, g01], -1),
                        torch.stack([-g01.conj(), g00.conj()], -1)], -2)


def _schur(H, Q, max_sweeps):
    """Complex Schur form of upper Hessenberg H (B, n, n), Q accumulated."""
    nb, n, _ = H.shape
    dt, dev = H.dtype, H.device
    if n == 1:
        return H, Q
    eps = _eps(dt)
    bi = torch.arange(nb, device=dev)
    idx = torch.arange(n - 1, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    k = torch.full((nb,), n - 1, dtype=torch.long, device=dev)
    it = torch.zeros(nb, dtype=torch.long, device=dev)
    while True:
        running = (k > 0) & (it < max_sweeps)
        if not bool(running.any()):
            break
        km1 = torch.clamp(k - 1, min=0)
        sub_k = H[bi, k, km1].abs()
        tol_k = eps * (H[bi, km1, km1].abs() + H[bi, k, k].abs() + eps)
        deflating = running & (sub_k <= tol_k)
        sweeping = running & ~deflating
        # deflate: zero the negligible H[k, k-1] and shrink the window
        zero = torch.zeros_like(H[bi, k, km1])
        H[bi, k, km1] = torch.where(deflating, zero, H[bi, k, km1])
        # sweep: the active window [l, k] and its Wilkinson shift
        d_ = torch.diagonal(H, dim1=-2, dim2=-1).abs()
        small = H.diagonal(-1, dim1=-2, dim2=-1).abs() <= eps * (d_[:, :-1] + d_[:, 1:] + eps)
        lcand = torch.where((idx[None] < k[:, None]) & small, idx[None] + 1,
                            torch.zeros_like(idx[None]))
        l = lcand.max(-1).values
        a = H[bi, km1, km1]
        b = H[bi, km1, k]
        c = H[bi, k, km1]
        d = H[bi, k, k]
        tr2 = (a + d) / 2
        disc = torch.sqrt(tr2 * tr2 - (a * d - b * c))
        mu1, mu2 = tr2 + disc, tr2 - disc
        mu = torch.where((mu1 - d).abs() < (mu2 - d).abs(), mu1, mu2)
        for j in range(n - 1):
            active = sweeping & (j >= l) & (j < k)
            start = j == l
            jm1 = max(j - 1, 0)
            xs = torch.where(start, H[:, j, j] - mu, H[:, j, jm1])
            zs = torch.where(start, H[:, j + 1, j], H[:, j + 1, jm1])
            G = torch.where(active[:, None, None], _givens(xs, zs), eye2)
            H[:, j:j + 2, :] = torch.matmul(G, H[:, j:j + 2, :])
            Gh = G.mH
            H[:, :, j:j + 2] = torch.matmul(H[:, :, j:j + 2], Gh)
            Q[:, :, j:j + 2] = torch.matmul(Q[:, :, j:j + 2], Gh)
        k = torch.where(deflating, k - 1, k)
        it = it + running.long()
    return torch.triu(H), Q


def _bump(dg, tnorm, eps):
    """A diagonal entry below eps·|T| raised to that size (its phase kept,
    1 for a zero entry): LAPACK's guard for repeated eigenvalues."""
    mag = dg.abs()
    unit = torch.where(mag > 0, dg / torch.where(mag > 0, mag, torch.ones_like(mag)),
                       torch.ones_like(dg))
    return torch.where(mag < eps * tnorm, unit * (eps * tnorm), dg)


def _eigvec_right(T):
    """Right eigenvectors (columns) of upper triangular T (B, n, n): for
    column i, rows ≥ i of (T − λ_i·I) become identity rows and the system is
    solved upward (RightEigenvectorFromSchur)."""
    nb, n, _ = T.shape
    dt, dev = T.dtype, T.device
    eps = _eps(dt)
    tnorm = torch.clamp(T.abs().amax((-2, -1)), min=eps)
    rows = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    lam = torch.diagonal(T, dim1=-2, dim2=-1)                      # (B, n): λ_i
    U = T[:, None] - lam[:, :, None, None] * eye                   # (B, i, n, n)
    dg = _bump(torch.diagonal(U, dim1=-2, dim2=-1), tnorm[:, None, None], eps)
    U = U - torch.diag_embed(torch.diagonal(U, dim1=-2, dim2=-1)) + torch.diag_embed(dg)
    below = (rows[None, :] >= rows[:, None])[:, :, None]           # (i, r, 1)
    M = torch.where(below, eye, U)
    rhs = (rows[None, :] == rows[:, None]).to(dt)[..., None].expand(nb, n, n, 1)
    y = torch.linalg.solve_triangular(M, rhs, upper=True)[..., 0]  # (B, i, n)
    nrm = torch.clamp(torch.sqrt(torch.sum(y.abs() ** 2, -1)), min=eps)
    return (y / nrm[..., None]).mT


def _eigvec_left(T):
    """Left eigenvectors: zᴴ·T = λ·zᴴ ⇔ (Tᴴ − λ̄·I)·z = 0, solved downward
    (LeftEigenvectorFromSchur)."""
    nb, n, _ = T.shape
    dt, dev = T.dtype, T.device
    eps = _eps(dt)
    Th = T.mH
    tnorm = torch.clamp(T.abs().amax((-2, -1)), min=eps)
    rows = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    lam = torch.diagonal(T, dim1=-2, dim2=-1).conj()
    L = Th[:, None] - lam[:, :, None, None] * eye
    dg = _bump(torch.diagonal(L, dim1=-2, dim2=-1), tnorm[:, None, None], eps)
    L = L - torch.diag_embed(torch.diagonal(L, dim1=-2, dim2=-1)) + torch.diag_embed(dg)
    above = (rows[None, :] <= rows[:, None])[:, :, None]
    M = torch.where(above, eye, L)
    rhs = (rows[None, :] == rows[:, None]).to(dt)[..., None].expand(nb, n, n, 1)
    z = torch.linalg.solve_triangular(M, rhs, upper=False)[..., 0]
    nrm = torch.clamp(torch.sqrt(torch.sum(z.abs() ** 2, -1)), min=eps)
    return (z / nrm[..., None]).mT


def _as_batch(A):
    if A.ndim == 2:
        return A[None], True
    return A, False


@annotate("batched.hessenberg")
def hessenberg(A):
    """Batched (H, Q) with Qᴴ·A·Q = H upper Hessenberg."""
    Ab, single = _as_batch(A)
    H, Q = _hessenberg(Ab)
    return (H[0], Q[0]) if single else (H, Q)


@annotate("batched.schur")
def schur(A, max_sweeps: int | None = None):
    """Batched complex Schur decomposition A = Z·T·Zᴴ (T upper triangular):
    real or complex input, complex (T, Z)."""
    Ab, single = _as_batch(A)
    cdt = Ab.dtype if Ab.dtype.is_complex else _complex_dtype(Ab.dtype)
    Ab = Ab.to(cdt)
    n = Ab.shape[-1]
    ms = max_sweeps if max_sweeps is not None else max(40 * n, 80)
    H, Q = _hessenberg(Ab)
    T, Z = _schur(H, Q, ms)
    return (T[0], Z[0]) if single else (T, Z)


@annotate("batched.eigenvalues")
def eigenvalues(A, max_sweeps: int | None = None):
    """Batched eigenvalues only (the reference's Eigenvalue interface)."""
    T, _ = schur(A, max_sweeps)
    return torch.diagonal(T, dim1=-2, dim2=-1)


@annotate("batched.eig")
def eig(A, left: bool = True, right: bool = True, max_sweeps: int | None = None):
    """Batched general eigendecomposition (w, VL, VR), complex, VR's and
    VL's columns of unit norm; None for a side not requested."""
    T, Z = schur(A, max_sweeps)
    Tb, single = _as_batch(T)
    Zb, _ = _as_batch(Z)
    w = torch.diagonal(Tb, dim1=-2, dim2=-1)
    VL = VR = None
    if right:
        VR = torch.matmul(Zb, _eigvec_right(Tb))
        VR = VR / torch.linalg.vector_norm(VR, dim=-2, keepdim=True)
    if left:
        VL = torch.matmul(Zb, _eigvec_left(Tb))
        VL = VL / torch.linalg.vector_norm(VL, dim=-2, keepdim=True)
    if single:
        w = w[0]
        VL = VL[0] if VL is not None else None
        VR = VR[0] if VR is not None else None
    return w, VL, VR


def _lexsort(keys):
    """Indices that sort the last axis by keys[-1], then keys[-2], ...
    (``jnp.lexsort``), with stable sorts from the last key to the first."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for key in keys[1:]:
        order = order.gather(-1, torch.argsort(key.gather(-1, order), dim=-1, stable=True))
    return order


@annotate("batched.eigendecomposition")
def eigendecomposition(A, max_sweeps: int | None = None):
    """The reference's outputs (er, ei, UL, UR) for real batched A: er + ei·i
    with a conjugate pair stored a+bi, a−bi consecutively, UL/UR complex
    eigenvector columns in the same order."""
    w, VL, VR = eig(A, max_sweeps=max_sweeps)
    wb = w if w.ndim == 2 else w[None]
    re, im = wb.real, wb.imag
    order = _lexsort(((im < 0).to(re.dtype), -im.abs(), re))
    ws0 = wb.gather(-1, order)
    # a computed pair's real parts may differ in the last bits and put the
    # a−bi member first: swap such adjacent pairs back
    re_s, im_s = ws0.real, ws0.imag
    tol = 1e-7 * (ws0.abs().amax(-1, keepdim=True) + 1e-30)
    nxt_im = torch.cat([im_s[..., 1:], torch.zeros_like(im_s[..., :1])], -1)
    nxt_re = torch.cat([re_s[..., 1:], re_s[..., :1]], -1)
    flip = ((im_s < 0) & (nxt_im > 0) & ((im_s + nxt_im).abs() <= tol)
            & ((re_s - nxt_re).abs() <= tol))
    prev = torch.cat([torch.zeros_like(flip[..., :1]), flip[..., :-1]], -1)
    flip = flip & ~prev
    prev = torch.cat([torch.zeros_like(flip[..., :1]), flip[..., :-1]], -1)
    shift = flip.long() - prev.long()
    order = order.gather(-1, torch.arange(ws0.shape[-1], device=w.device) + shift)
    ws = wb.gather(-1, order)

    def take(X):
        X = X if X.ndim == 3 else X[None]
        return X.gather(-1, order[..., None, :].expand(X.shape))

    ULs, URs = take(VL), take(VR)
    if w.ndim == 1:
        ws, ULs, URs = ws[0], ULs[0], URs[0]
    return ws.real, ws.imag, ULs, URs
