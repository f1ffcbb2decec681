"""GMRES — restarted, CGS2/MGS orthogonalization, preconditionable.
Counterpart of ``tpukk/sparse/gmres.py`` (the reference's
sparse/src/KokkosSparse_gmres.hpp:59, gmres_handle.hpp:76-78 and the
Arnoldi loop of sparse/impl/KokkosSparse_gmres_impl.hpp:64-244).

The Arnoldi cycle keeps the basis V (m+1, n) and the Hessenberg H (m+1, m)
on the device; CGS2 orthogonalizes against the first j+1 rows of V only (the
static-j slices of ``tpukk``'s unrolled cycle), MGS one row at a time.  Every
inner product conjugates its first operand and the norm is
sqrt(real(Σ conj(x)·x)), as in ``tpukk`` (gmres.py:66-109), so complex
systems solve.  The small (m+1)×m least-squares problem is solved on the host
in f64 (complex128 for a complex b) by LAPACK's gelsd
(``numpy.linalg.lstsq``), which returns the minimum-norm solution when
H is singular (β = 0, happy breakdown), as ``jnp.linalg.lstsq`` does: one
copy of H per cycle.  The restart loop reads the true residual norm once per
cycle, as ``tpukk`` does, and counts iterations in multiples of m.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..common.tracing import annotate, profile_region
from .pcg import _nonzero
from .preconditioner import IdentityPrec, Preconditioner
from .spmv import SpmvHandle

__all__ = ["Ortho", "GmresHandle", "GmresStats", "gmres"]

# a restart cycle, and inside it its two host reads, each a check: H to the
# host (with the least-squares solve and the update), then the residual
# norm; no region inside an Arnoldi step
BLOCK_REGION = "tpukk::gmres.block"
CHECK_REGION = "tpukk::gmres.check"


class Ortho(enum.Enum):
    MGS = "mgs"
    CGS2 = "cgs2"


class GmresHandle:
    """cf. gmres_handle.hpp: m (subspace), tol, max_restarts, ortho.

    ``reorder``: "auto" | "rcm" | "none".  "rcm" runs the whole Krylov loop
    in RCM-permuted space (the iterates are the same, since GMRES is
    orthogonally invariant: (PAPᵀ)(Px) = Pb); "auto" does so only without a
    user preconditioner, for an f32 CsrMatrix of at least 4096 rows whose
    bandwidth RCM cuts at least 4x."""

    def __init__(self, m: int = 50, tol: float = 1e-8, max_restarts: int = 50,
                 ortho: Ortho = Ortho.CGS2, reorder: str = "auto"):
        self.m = int(m)
        self.tol = float(tol)
        self.max_restarts = int(max_restarts)
        self.ortho = ortho
        self.reorder = reorder
        # stats (filled by gmres)
        self.num_iters = 0
        self.end_rel_res = float("nan")
        self.converged = False


@dataclasses.dataclass
class GmresStats:
    num_iters: int
    end_rel_res: float
    converged: bool


def _norm(x: torch.Tensor, reduce=None) -> torch.Tensor:
    """‖x‖₂ as a real 0-d tensor on x's device, conjugation-correct for
    complex x; ``reduce`` sums the local sum over the ranks of a row
    partition (``dist.dist_gmres``)."""
    s = torch.sum(torch.conj(x) * x)
    return torch.sqrt(torch.real(s if reduce is None else reduce(s)))


def _arnoldi_cycle(Ah, prec, b, x0, m: int, ortho: Ortho, reduce=None):
    """One restart cycle from x0; returns the new iterate.  ``reduce``, when
    given, sums each inner product's local value over the ranks that hold
    the other rows of the vectors (the distributed GMRES); H and the
    least-squares solve are then the same on every rank."""
    red = (lambda t: t) if reduce is None else reduce
    r = b - Ah(x0)
    z = prec.apply(r)
    beta = _norm(z, reduce).to(b.dtype)
    V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    V[0] = z / _nonzero(beta)
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    for j in range(m):
        w = prec.apply(Ah(V[j]))
        if ortho == Ortho.CGS2:
            # classical Gram-Schmidt twice, against rows [0, j] only
            Vj = V[:j + 1]
            Vc = Vj.conj()
            h1 = red(torch.mv(Vc, w))
            w = w - torch.mv(Vj.T, h1)
            h2 = red(torch.mv(Vc, w))
            w = w - torch.mv(Vj.T, h2)
            H[:j + 1, j] = h1 + h2
        else:
            for i in range(j + 1):
                hi = red(torch.vdot(V[i], w))
                w = w - hi * V[i]
                H[i, j] = hi
        hn = _norm(w, reduce).to(b.dtype)
        H[j + 1, j] = hn
        V[j + 1] = w / _nonzero(hn)
    # rank-safe least squares on the host (minimum norm when H is singular),
    # in complex128 for a complex b
    with profile_region(CHECK_REGION):
        hdt = torch.complex128 if b.dtype.is_complex else torch.float64
        Hb = torch.cat([H.reshape(-1), beta.reshape(1)]).to(hdt).cpu().numpy()
        e1 = np.zeros(m + 1, Hb.dtype)
        e1[0] = Hb[-1]
        y = np.linalg.lstsq(Hb[:-1].reshape(m + 1, m), e1, rcond=None)[0]
        return x0 + torch.mv(V[:m].T, torch.from_numpy(y).to(b.dtype).to(b.device))


@annotate("gmres")
def gmres(handle: GmresHandle, A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          prec: Optional[Preconditioner] = None):
    """Solve A·x = b; returns (x, GmresStats).  ``A`` is a CsrMatrix or an
    SpmvHandle; ``b`` lies on the matrix's device."""
    Ah = A if isinstance(A, SpmvHandle) else SpmvHandle(A)
    to_p = from_p = None
    if handle.reorder in ("auto", "rcm") and prec is None and not isinstance(A, SpmvHandle):
        sel = _rcm_reorder(Ah, force=handle.reorder == "rcm")
        if sel is not None:
            Ah, to_p, from_p = sel
    prec = prec or IdentityPrec()
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    if to_p is not None:
        b = to_p(b)
        x = to_p(x)
    m = min(handle.m, b.shape[0])
    bnorm = float(_norm(b)) or 1.0
    iters = 0
    rel = float("inf")
    for _ in range(handle.max_restarts):
        with profile_region(BLOCK_REGION):
            x = _arnoldi_cycle(Ah, prec, b, x, m, handle.ortho)
            with profile_region(CHECK_REGION):
                # the true residual at the restart boundary
                rel = float(_norm(b - Ah(x))) / bnorm
        iters += m
        if rel <= handle.tol:
            break
    handle.num_iters = iters
    handle.end_rel_res = rel
    handle.converged = rel <= handle.tol
    if from_p is not None:
        x = from_p(x)
    return x, GmresStats(iters, rel, handle.converged)


def _bandwidth(A) -> int:
    rows = np.repeat(np.arange(A.nrows), A.row_lengths())
    return int(np.abs(rows - A.host_entries()).max(initial=0))


def _rcm_reorder(Ah: SpmvHandle, force: bool = False):
    """(permuted handle, to_perm, from_perm) when RCM re-bands the matrix
    enough to pay for itself inside the Krylov loop (or when forced), else
    None."""
    A = Ah.A
    if A.dtype != torch.float32 or A.nrows < 4096:
        return Ah.rcm_permuted() if force else None
    ph, to_p, from_p = Ah.rcm_permuted()
    if not force and _bandwidth(ph.A) * 4 > _bandwidth(A):
        return None
    return ph, to_p, from_p
