"""Batched small-dense functions — counterpart of ``tpukk/batched/dense.py``
(the reference's batched/dense/src/: Gemm, Gemv, Ger, Syr, Dot, Axpy, Xpay,
HadamardProduct, Copy/Set/Scale/SetIdentity, AddRadial, LU, SolveLU,
InverseLU, Trsm, Trsv, Trmm, Trtri, QR, ApplyQ, SVD, Eigendecomposition,
Gesv, Getrf/Getrs, Pttrf/Pttrs, Tbsv, Laswp, Iamax, QR with column
pivoting, UTV).

``tpukk`` runs these as XLA ops vmapped over the leading batch axis, with no
Pallas kernel; here they are batched torch ops on tensors of shape (B, ...)
(``torch.linalg`` is the TPL, as it is for ``tpukk_torch.lapack``), on the
tensors' device.  ``tpukk``'s ``lax.scan`` recurrences (``pttrf``/``pttrs``)
and ``fori_loop``s (the unpivoted ``lu``, the pivot conversion, the
pivoted QR) are loops over the rows or columns with B in every op.  Pivots
follow ``tpukk``: ``getrf`` returns 0-based pivots (the row swapped with row
i at step i) and the permutation.  Functions are functional: no input is
modified.
"""
from __future__ import annotations

import torch

from .. import lapack
from ..common import check
from ..common.tracing import annotate

__all__ = [
    "gemm", "gemv", "ger", "syr", "dot", "axpy", "xpay", "hadamard",
    "copy", "set_value", "scale", "set_identity", "add_radial",
    "lu", "solve_lu", "inverse_lu", "trsm", "trsv", "trmm", "trtri",
    "qr", "apply_q", "svd", "eigh", "gesv", "getrf", "getrs",
    "pttrf", "pttrs", "pbtrf", "pbtrs", "gbtrf", "gbtrs",
    "tbsv", "laswp", "iamax",
    "qr_with_column_pivoting", "utv", "solve_utv",
]


def _op(A, trans):
    t = trans.upper()
    check(t in ("N", "T", "C"), f"invalid trans '{trans}'")
    if t == "N":
        return A
    return A.mT if t == "T" else A.mH


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


# ---- BLAS-like ------------------------------------------------------------

@annotate("batched.gemm")
def gemm(transA, transB, alpha, A, B, beta, C):
    """(B,m,k)·(B,k,n) in A's dtype (at least f32), the result in C's
    (cf. KokkosBatched_Gemm_Decl.hpp)."""
    pet = torch.promote_types(A.dtype, torch.float32)
    prod = torch.matmul(_op(A, transA).to(pet), _op(B, transB).to(pet))
    return (beta * C + alpha * prod).to(C.dtype)


@annotate("batched.gemv")
def gemv(trans, alpha, A, x, beta, y):
    return beta * y + alpha * torch.einsum("bij,bj->bi", _op(A, trans), x)


@annotate("batched.ger")
def ger(alpha, x, y, A):
    return A + alpha * torch.einsum("bi,bj->bij", x, y.conj())


@annotate("batched.syr")
def syr(uplo, alpha, x, A):
    full = alpha * torch.einsum("bi,bj->bij", x, x)
    n = A.shape[-1]
    ones = torch.ones((n, n), dtype=torch.bool, device=A.device)
    mask = torch.tril(ones) if uplo.upper() == "L" else torch.triu(ones)
    return A + torch.where(mask, full, torch.zeros_like(full))


@annotate("batched.dot")
def dot(x, y):
    return torch.sum(x.conj() * y, dim=-1)


def _bcast(a, x):
    """A batch of scalars (B,) as a column against x, else a itself."""
    if isinstance(a, torch.Tensor) and a.ndim == 1 and x.ndim > 1:
        return a.reshape((-1,) + (1,) * (x.ndim - 1))
    return a


@annotate("batched.axpy")
def axpy(alpha, x, y):
    return y + _bcast(alpha, x) * x


@annotate("batched.xpay")
def xpay(beta, x, y):
    """x + beta*y (cf. KokkosBatched_Xpay.hpp)."""
    return x + _bcast(beta, y) * y


@annotate("batched.hadamard")
def hadamard(alpha, x, y):
    return alpha * x * y


@annotate("batched.copy")
def copy(x):
    return x.clone()


@annotate("batched.set_value")
def set_value(x, val):
    return torch.full_like(x, val)


@annotate("batched.scale")
def scale(alpha, x):
    return _bcast(alpha, x) * x


@annotate("batched.set_identity")
def set_identity(A):
    return _eye_like(A).clone()


@annotate("batched.add_radial")
def add_radial(eps, A):
    """A + eps·sign(diag)·I, sign(0) = +1 — the diagonal stabilizer
    (cf. KokkosBatched_AddRadial_Decl.hpp)."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    # jnp orders complex values on (real, imag): d ≥ 0 where real > 0, or
    # real = 0 and imag ≥ 0
    nonneg = (d.real > 0) | ((d.real == 0) & (d.imag >= 0)) if d.is_complex() else d >= 0
    shift = eps * torch.where(nonneg, 1.0, -1.0).to(A.dtype)
    return A + shift[..., None] * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


# ---- factorizations -------------------------------------------------------

@annotate("batched.lu")
def lu(A):
    """Unpivoted LU stored packed (L unit lower, U upper in one matrix) —
    KokkosBatched::LU (no pivoting), right-looking, a column a step."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    M = A.clone()
    for j in range(n - 1):
        piv = M[..., j, j]
        l = M[..., :, j] / piv[..., None]
        l = torch.where(idx > j, l, torch.zeros_like(l))
        u = torch.where(idx >= j, M[..., j, :], torch.zeros_like(M[..., j, :]))
        M = M - l[..., :, None] * u[..., None, :]
        M[..., :, j] = torch.where(idx > j, l, M[..., :, j])
    return M


def _column(b, ref):
    """(b as (..., n, k), whether it was a vector)."""
    vec = b.ndim == ref.ndim - 1
    return (b[..., None] if vec else b), vec


@annotate("batched.solve_lu")
def solve_lu(LU, b, trans: str = "N"):
    """Solve with a packed unpivoted LU (cf. KokkosBatched_SolveLU_Decl.hpp)."""
    rhs, vec = _column(b, LU)
    if trans.upper() == "N":
        y = torch.linalg.solve_triangular(LU, rhs, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(LU, y, upper=True)
    else:
        y = torch.linalg.solve_triangular(LU.mT, rhs, upper=False)
        x = torch.linalg.solve_triangular(LU.mT, y, upper=True, unitriangular=True)
    return x[..., 0] if vec else x


@annotate("batched.inverse_lu")
def inverse_lu(LU):
    return solve_lu(LU, _eye_like(LU))


@annotate("batched.trsm")
def trsm(side, uplo, trans, diag, alpha, A, B):
    """op(A)·X = alpha·B (side L) or X·op(A) = alpha·B (side R), A
    triangular; trans "T" transposes A and "C" conjugates it without
    transposing, as ``tpukk``'s (``lax.linalg.triangular_solve``'s
    conjugate_a) does."""
    lower = uplo.upper() == "L"
    t = trans.upper()
    T = A.mT if t == "T" else (A.conj() if t == "C" else A)
    upper = lower if t == "T" else not lower
    return torch.linalg.solve_triangular(T, alpha * B, upper=upper, left=side.upper() == "L",
                                         unitriangular=diag.upper() == "U")


@annotate("batched.trsv")
def trsv(uplo, trans, diag, A, b):
    return trsm("L", uplo, trans, diag, 1.0, A, b[..., None])[..., 0]


@annotate("batched.trmm")
def trmm(side, uplo, trans, diag, alpha, A, B):
    T = torch.tril(A) if uplo.upper() == "L" else torch.triu(A)
    if diag.upper() == "U":
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        T = T - torch.diagonal(T, dim1=-2, dim2=-1)[..., None] * eye + eye
    T = _op(T, trans)
    return alpha * (torch.matmul(T, B) if side.upper() == "L" else torch.matmul(B, T))


@annotate("batched.trtri")
def trtri(uplo, diag, A):
    return torch.linalg.solve_triangular(A, _eye_like(A), upper=uplo.upper() != "L",
                                         unitriangular=diag.upper() == "U")


@annotate("batched.qr")
def qr(A):
    return torch.linalg.qr(A, mode="reduced")


@annotate("batched.apply_q")
def apply_q(Q, B, trans: str = "N"):
    """Apply Q (from qr) to B (cf. KokkosBatched_ApplyQ_Decl.hpp)."""
    return torch.matmul(_op(Q, trans), B)


@annotate("batched.svd")
def svd(A, full_matrices: bool = False):
    """(U, s, Vh)."""
    return torch.linalg.svd(A, full_matrices=full_matrices)


@annotate("batched.eigh")
def eigh(A):
    """Symmetric (Hermitian) eigendecomposition (w, V) of (A + Aᴴ)/2, as
    ``jnp.linalg.eigh`` symmetrizes its input."""
    return torch.linalg.eigh((A + A.mH) / 2)


@annotate("batched.gesv")
def gesv(A, b):
    """Batched solve with partial pivoting (cf. KokkosBatched_Gesv.hpp)."""
    rhs, vec = _column(b, A)
    x = torch.linalg.solve(A, rhs)
    return x[..., 0] if vec else x


@annotate("batched.getrf")
def getrf(A):
    """(lu, pivots, permutation): 0-based int32 pivots and A[perm] = L·U,
    as ``jax.lax.linalg.lu`` gives them."""
    return lapack.getrf(A)


_piv_to_perm = lapack._piv_to_perm


@annotate("batched.getrs")
def getrs(lu_, piv, b, trans: str = "N"):
    """Solve A·x = b (trans "N") or Aᵀ·x = b from ``getrf``'s factors."""
    rhs, vec = _column(b, lu_)
    perm = _piv_to_perm(piv, lu_.shape[-1])
    idx = perm[..., None].expand(rhs.shape)
    if trans.upper() == "N":
        y = torch.linalg.solve_triangular(lu_, rhs.gather(-2, idx), upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(lu_, y, upper=True)
    else:
        y = torch.linalg.solve_triangular(lu_.mT, rhs, upper=False)
        x = torch.linalg.solve_triangular(lu_.mT, y, upper=True, unitriangular=True)
        x = x.gather(-2, torch.argsort(perm, dim=-1)[..., None].expand(x.shape))
    return x[..., 0] if vec else x


# ---- banded / tridiagonal -------------------------------------------------

@annotate("batched.pttrf")
def pttrf(d, e):
    """LDLᵀ of a symmetric tridiagonal (d (B,n) the diagonal, e (B,n-1) the
    off-diagonal) — cf. KokkosBatched_Pttrf.hpp: (d', l), a row a step."""
    n = d.shape[-1]
    dd = [d[..., 0]]
    ls = []
    for i in range(1, n):
        l = e[..., i - 1] / dd[-1]
        dd.append(d[..., i] - l * e[..., i - 1])
        ls.append(l)
    lt = torch.stack(ls, -1) if ls else e[..., :0]
    return torch.stack(dd, -1), lt


@annotate("batched.pttrs")
def pttrs(d, l, b):
    """Solve from ``pttrf``'s factors: forward, scale, backward, a row a
    step."""
    n = b.shape[-1]
    y = [b[..., 0]]
    for i in range(1, n):
        y.append(b[..., i] - l[..., i - 1] * y[-1])
    z = torch.stack(y, -1) / d
    x = [z[..., n - 1]]
    for i in range(n - 2, -1, -1):
        x.append(z[..., i] - l[..., i] * x[-1])
    return torch.stack(x[::-1], -1)


@annotate("batched.pbtrf")
def pbtrf(A):
    """Banded Cholesky in dense storage (cf. KokkosBatched_Pbtrf.hpp; the
    band-storage form is ``banded.pbtrf_banded``)."""
    return torch.linalg.cholesky(A)


@annotate("batched.pbtrs")
def pbtrs(L, b):
    rhs, vec = _column(b, L)
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


@annotate("batched.gbtrf")
def gbtrf(A):
    """Banded LU in dense storage (cf. KokkosBatched_Gbtrf.hpp)."""
    return lapack.getrf(A)


@annotate("batched.gbtrs")
def gbtrs(lu_, piv, b):
    return getrs(lu_, piv, b)


@annotate("batched.tbsv")
def tbsv(uplo, trans, diag, A, b):
    """Triangular banded solve in dense storage (cf. KokkosBatched_Tbsv.hpp)."""
    return trsv(uplo, trans, diag, A, b)


@annotate("batched.laswp")
def laswp(piv, B):
    """Apply LAPACK-style row interchanges (cf. KokkosBatched_Laswp.hpp)."""
    perm = _piv_to_perm(piv, B.shape[-2])
    return B.gather(-2, perm[..., None].expand(B.shape))


@annotate("batched.iamax")
def iamax(x):
    return torch.argmax(x.abs(), dim=-1)


# ---- rank-revealing factorizations ---------------------------------------

def _flat(A):
    return A.reshape((-1,) + A.shape[-2:])


@annotate("batched.qr_with_column_pivoting")
def qr_with_column_pivoting(A):
    """Householder QR with greedy column pivoting: A[..., :, perm] = Q·R
    (cf. KokkosBatched_QR_WithColumnPivoting_Decl.hpp).  Returns (Q (m,k),
    R (k,n), perm (n,)) with k = min(m, n); |diag R| is non-increasing.
    Real dtypes.  Each step j pivots every matrix's column of largest
    remaining norm into place, then reflects rows j.. of all of them."""
    shape = A.shape
    r = _flat(A).clone()
    nb, m, n = r.shape
    k = min(m, n)
    dev, dt = A.device, A.dtype
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    bi = torch.arange(nb, device=dev)
    q = torch.eye(m, dtype=dt, device=dev).repeat(nb, 1, 1)
    perm = cols.repeat(nb, 1)
    for j in range(k):
        live = (rows >= j)[None, :, None]
        norms = torch.sum(torch.where(live, r, torch.zeros_like(r)) ** 2, dim=1)
        norms = torch.where(cols >= j, norms, torch.full_like(norms, -float("inf")))
        p = torch.argmax(norms, dim=-1)
        cj, cp = r[bi, :, j].clone(), r[bi, :, p].clone()
        r[bi, :, j], r[bi, :, p] = cp, cj
        pj, pp = perm[bi, j].clone(), perm[bi, p].clone()
        perm[bi, j], perm[bi, p] = pp, pj
        x = torch.where(rows >= j, r[:, :, j], torch.zeros_like(r[:, :, j]))
        alpha = torch.sqrt(torch.sum(x * x, dim=-1))
        sgn = torch.where(r[:, j, j] >= 0, 1.0, -1.0).to(dt)
        v = x.clone()
        v[:, j] = v[:, j] + sgn * alpha
        vn2 = torch.sum(v * v, dim=-1, keepdim=True)
        v = torch.where(vn2 > 0, v * torch.rsqrt(torch.clamp(vn2, min=1e-37)),
                        torch.zeros_like(v))
        r = r - 2.0 * v[:, :, None] * torch.einsum("bm,bmn->bn", v, r)[:, None, :]
        q = q - 2.0 * torch.einsum("bmn,bn->bm", q, v)[:, :, None] * v[:, None, :]
    r = torch.where(rows[:, None] <= cols[None, :], r, torch.zeros_like(r))
    lead = shape[:-2]
    return (q[:, :, :k].reshape(lead + (m, k)), r[:, :k].reshape(lead + (k, n)),
            perm.reshape(lead + (n,)))


@annotate("batched.utv")
def utv(A, rel_tol: float = 1e-6):
    """Rank-revealing UTV (cf. KokkosBatched_UTV_Decl.hpp): A[..., :, perm] =
    U·T·Vᵀ with U (m,k), T (k,k) lower triangular whose trailing (k - rank)
    block is zero, V (n,k) with orthonormal columns.  Returns (U, T, V,
    perm, rank); the rank counts |R_jj| > rel_tol·|R_00| of the pivoted QR."""
    q, r, perm = qr_with_column_pivoting(A)
    k = r.shape[-2]
    d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    rank = torch.sum(d > rel_tol * torch.clamp(d[..., :1], min=1e-37), dim=-1).to(torch.int32)
    live = torch.arange(k, device=A.device) < rank[..., None]
    rmask = torch.where(live[..., :, None], r, torch.zeros_like(r))
    v, r2 = torch.linalg.qr(rmask.mT, mode="reduced")
    return q, r2.mT, v, perm, rank


@annotate("batched.solve_utv")
def solve_utv(U, T, V, perm, rank, b):
    """Minimum-norm least-squares solve from ``utv``'s factors (cf.
    KokkosBatched_SolveUTV_Decl.hpp): the rank-padded lower system with a
    unit-padded diagonal, the tail masked."""
    vec = b.ndim == U.ndim - 1
    rhs = b[..., None] if vec else b
    k = T.shape[-1]
    c = U.mT @ rhs
    live = torch.arange(k, device=T.device) < rank[..., None]
    tpad = T + torch.diag_embed(torch.where(live, 0.0, 1.0).to(T.dtype))
    z = torch.linalg.solve_triangular(tpad, c, upper=False)
    z = torch.where(live[..., None], z, torch.zeros_like(z))
    x = V @ z
    xp = torch.zeros_like(x).scatter(-2, perm.long()[..., None].expand(x.shape), x)
    return xp[..., 0] if vec else xp
