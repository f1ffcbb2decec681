"""Batched sparse functions — counterpart of ``tpukk/batched/sparse.py`` (the
reference's batched/sparse/src/: a CrsMatrix with batched values on one
graph, Spmv, CG, GMRES, JacobiPrec, Identity).

Many small systems on one sparsity pattern, solved together.  ``tpukk``
vmaps the single-system SpMV over the values' batch axis; here the product
runs on the port's SEGSUM plan (``spmv_impl.build_segsum_plan``: each
entry's row and column) with B in every op: one gather of X's columns, one
product and one ``index_add_`` along the rows for all B systems.  CG and
GMRES run a fixed number of iterations with masked updates, as in
``tpukk``: each system keeps its own convergence, and a converged system's
iterate no longer moves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common.tracing import annotate
from ..containers import CsrMatrix
from ..sparse.spmv_impl import SegsumPlan, build_segsum_plan

__all__ = ["BatchedCrsMatrix", "batched_spmv", "JacobiPrec", "IdentityPrec",
           "batched_cg", "batched_gmres"]


@dataclasses.dataclass
class BatchedCrsMatrix:
    """One graph, per-system values (B, nnz) — cf.
    KokkosBatched_CrsMatrix.hpp."""

    row_map: torch.Tensor
    entries: torch.Tensor
    values: torch.Tensor     # (B, nnz)
    nrows: int
    ncols: int
    _plan: SegsumPlan = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_csr(cls, A: CsrMatrix, batched_values):
        """The pattern of A with ``batched_values`` (B, nnz) on A's device."""
        vals = torch.as_tensor(batched_values, device=A.device)
        return cls(A.row_map, A.entries, vals, A.nrows, A.ncols)

    @property
    def n_batch(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def plan(self) -> SegsumPlan:
        """The SEGSUM plan of the pattern (rows and columns of every entry),
        built once; its values are the first system's."""
        if self._plan is None:
            pat = CsrMatrix(self.row_map, self.entries, self.values[0], self.nrows, self.ncols)
            self._plan = build_segsum_plan(pat, self.values.dtype)
        return self._plan


@annotate("batched.batched_spmv")
def batched_spmv(A: BatchedCrsMatrix, X, rows=None):
    """Y[b] = A[b]·X[b] for X (B, ncols) — cf. KokkosBatched_Spmv.  ``rows``
    (nnz,) gives each entry's row, as ``tpukk`` takes it; None: the plan's."""
    p = A.plan()
    rows = p.rows if rows is None else torch.as_tensor(rows, device=X.device).long()
    prod = A.values * X[:, p.cols]
    Y = torch.zeros((X.shape[0], A.nrows), dtype=prod.dtype, device=X.device)
    return Y.index_add_(1, rows, prod)


class IdentityPrec:
    """cf. KokkosBatched_Identity.hpp."""

    def apply(self, X):
        return X


class JacobiPrec:
    """Diagonal preconditioner — cf. KokkosBatched_JacobiPrec.hpp; a row
    without a diagonal entry takes 1."""

    def __init__(self, A: BatchedCrsMatrix):
        rm = A.row_map.cpu().numpy().astype(np.int64)
        ent = A.entries.cpu().numpy()
        rows = np.repeat(np.arange(A.nrows), np.diff(rm))
        hits = np.nonzero(ent == rows)[0]
        pos = np.full(A.nrows, -1, np.int64)
        # the first diagonal entry of each row, as tpukk takes it
        pos[rows[hits[::-1]]] = hits[::-1]
        p = torch.from_numpy(pos).to(A.device)
        self.diag = torch.where(p >= 0, A.values[:, torch.clamp(p, min=0)],
                                torch.ones((), dtype=A.values.dtype, device=A.device))

    def apply(self, X):
        return X / self.diag


def _norm(R):
    """sqrt(Σ R·R), unconjugated as in ``tpukk`` (complex for complex R)."""
    return torch.sqrt(torch.sum(R * R, dim=-1))


def _greater(a, b):
    """a > b, complex values ordered on (real, imag) as ``jnp`` orders them."""
    if not (torch.is_complex(a) or torch.is_complex(b)):
        return a > b
    a, b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b, device=a.device))
    return (a.real > b.real) | ((a.real == b.real) & (a.imag > b.imag))


def _maximum(a, b):
    """``jnp.maximum``: the larger on (real, imag) for complex values."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.where(_greater(b, a), b, a)


@annotate("batched.batched_cg")
def batched_cg(A: BatchedCrsMatrix, B, max_iters: int = 100, tol: float = 1e-8,
               prec=None, X0=None):
    """Batched CG — cf. KokkosBatched_CG.  Returns (X, iterations, final
    residual norms): ``max_iters`` iterations, each system updated while its
    residual exceeds tol·max(|b|, 1).  The sums are unconjugated, as in
    ``tpukk``: on a complex symmetric system this is COCG, and the norms
    sqrt(Σ r·r) are complex, compared on (real, imag) as ``jnp`` does."""
    prec = prec or IdentityPrec()
    X = torch.zeros_like(B) if X0 is None else X0.clone()
    R = B - batched_spmv(A, X)
    Z = prec.apply(R)
    P = Z
    rz = torch.sum(R * Z, dim=-1)
    tol_abs = tol * _maximum(_norm(B), 1.0)
    zero = torch.zeros_like(rz)
    for _ in range(max_iters):
        AP = batched_spmv(A, P)
        pAp = torch.sum(P * AP, dim=-1)
        active = _greater(_norm(R), tol_abs)
        alpha = torch.where(active & (pAp != 0), rz / torch.where(pAp == 0, 1.0, pAp), zero)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        Z = prec.apply(R)
        rz_new = torch.sum(R * Z, dim=-1)
        beta = torch.where(active & (rz != 0), rz_new / torch.where(rz == 0, 1.0, rz), zero)
        P = Z + beta[:, None] * P
        rz = rz_new
    return X, max_iters, _norm(R)


@annotate("batched.batched_gmres")
def batched_gmres(A: BatchedCrsMatrix, B, restart: int = 30, max_restarts: int = 5,
                  tol: float = 1e-8, prec=None, X0=None):
    """Batched restarted GMRES(m) with modified Gram-Schmidt — cf.
    KokkosBatched_GMRES.  ``max_restarts`` cycles of m = min(restart, n)
    Arnoldi steps, each system's least-squares problem solved by a batched
    QR.  Returns (X, final residual norms)."""
    prec = prec or IdentityPrec()
    nb, n = B.shape
    m = min(restart, n)
    X = torch.zeros_like(B) if X0 is None else X0.clone()
    for _ in range(max_restarts):
        R = prec.apply(B - batched_spmv(A, X))
        beta = _norm(R)
        V = torch.zeros((nb, m + 1, n), dtype=B.dtype, device=B.device)
        V[:, 0] = R / torch.where(beta == 0, 1.0, beta)[:, None]
        H = torch.zeros((nb, m + 1, m), dtype=B.dtype, device=B.device)
        for j in range(m):
            W = prec.apply(batched_spmv(A, V[:, j]))
            for i in range(j + 1):
                h = torch.sum(W * V[:, i], dim=-1)
                W = W - h[:, None] * V[:, i]
                H[:, i, j] = h
            hn = _norm(W)
            H[:, j + 1, j] = hn
            V[:, j + 1] = W / torch.where(hn == 0, 1.0, hn)[:, None]
        e1 = torch.zeros((nb, m + 1), dtype=B.dtype, device=B.device)
        e1[:, 0] = beta
        Q, Rm = torch.linalg.qr(H, mode="reduced")
        rhs = torch.einsum("bij,bi->bj", Q, e1)[..., None]
        y = torch.linalg.solve_triangular(Rm, rhs, upper=True)
        X = X + torch.einsum("bmn,bm->bn", V[:, :m], y[..., 0])
    return X, _norm(B - batched_spmv(A, X))
