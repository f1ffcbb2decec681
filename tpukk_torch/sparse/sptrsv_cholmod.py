"""CHOLMOD-format supernodal factor import — counterpart of
``tpukk/sparse/sptrsv_cholmod.py`` (the role of the reference's
read_cholmod_factor, sparse/src/KokkosSparse_sptrsv_cholmod.hpp): a Cholesky
factorization made by CHOLMOD, A = Pᵀ·L·Lᵀ·P, solved by this package's
kernels as x = Pᵀ·L⁻ᵀ·L⁻¹·P·b.

Two entry forms: the raw supernodal arrays of a ``cholmod_factor`` (the
fields the reference reads: ``super``, ``pi``, ``px``, ``s``, ``x``,
``Perm``; panels column-major with the full leading block, entries above the
diagonal of the diagonal block ignored), or any object with ``L()`` and
``P()`` methods, as scikit-sparse's ``cholmod.Factor`` has.  The raw form's
supernode partition goes to the SUPERNODAL solve of L, and its mirror to the
solve of Lᵀ, so the imported partition, not a detected one, shapes the
blocks.  P is composed into the L solve's ``src`` and Pᵀ into the Lᵀ
solve's ``dst`` when the solver is built, so an apply is two K4 launches.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..common.tracing import annotate
from ..containers import CsrMatrix
from .sptrsv import SptrsvAlgorithm, SptrsvHandle, _permuted_solve, sptrsv_symbolic

__all__ = ["CholmodSolve", "cholmod_import", "cholmod_raw_to_csr"]


def cholmod_raw_to_csr(n, super_, pi, px, s, x):
    """Lower-triangular CSR L from CHOLMOD's supernodal raw arrays.

    Supernode k covers columns [super_[k], super_[k+1]); its row pattern is
    s[pi[k]:pi[k+1]] (the diagonal block's rows first) and its values are
    column-major: L[s[pi[k]+i], super_[k]+j] = x[px[k] + j*nrows + i].
    Returns (scipy CSR, supernode id per column)."""
    super_ = np.asarray(super_, np.int64)
    pi = np.asarray(pi, np.int64)
    px = np.asarray(px, np.int64)
    s = np.asarray(s, np.int64)
    x = np.asarray(x)
    nsn = len(super_) - 1
    rows_all, cols_all, vals_all = [], [], []
    sn_of_col = np.zeros(n, np.int64)
    for k in range(nsn):
        c0, c1 = super_[k], super_[k + 1]
        ncols = c1 - c0
        ridx = s[pi[k]:pi[k + 1]]
        nrows = len(ridx)
        sn_of_col[c0:c1] = k
        panel = x[px[k]:px[k] + nrows * ncols].reshape(ncols, nrows).T
        rr = np.broadcast_to(ridx[:, None], (nrows, ncols)).ravel()
        cc = np.broadcast_to(np.arange(c0, c1)[None, :], (nrows, ncols)).ravel()
        vv = panel.ravel()
        keep = rr >= cc
        rows_all.append(rr[keep])
        cols_all.append(cc[keep])
        vals_all.append(vv[keep])
    if nsn:
        rows, cols, vals = (np.concatenate(a) for a in (rows_all, cols_all, vals_all))
    else:
        rows = cols = np.empty(0, np.int64)
        vals = np.empty(0)
    L = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    L.sort_indices()
    return L, sn_of_col


class CholmodSolve:
    """x = Pᵀ·L⁻ᵀ·L⁻¹·P·b for an imported Cholesky factor, on the factor's
    device.  Callable; ``apply`` is the preconditioner contract."""

    def __init__(self, Lh, Lth, L: CsrMatrix, Lt: CsrMatrix, perm):
        self.Lh, self.Lth = Lh, Lth
        self.L, self.Lt = L, Lt
        # CHOLMOD's Perm: (P·b)[i] = b[perm[i]]; x = Pᵀ·w  ⇔  x[perm[i]] = w[i]
        self.perm = torch.from_numpy(np.asarray(perm, np.int32)).to(L.device)
        self.inv_perm = torch.from_numpy(np.argsort(perm).astype(np.int32)).to(L.device)
        self._solve_l = _permuted_solve(Lh, before=self.perm)
        self._solve_lt = _permuted_solve(Lth, after=self.inv_perm)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve_lt(self._solve_l(b))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self(r)


@annotate("sptrsv_cholmod_import")
def cholmod_import(factor=None, *, n=None, super_=None, pi=None, px=None, s=None, x=None,
                   perm=None, algorithm: SptrsvAlgorithm = SptrsvAlgorithm.SEQLVLSCHD,
                   value_dtype=None, device=None) -> CholmodSolve:
    """Import a CHOLMOD Cholesky factor (cf. read_cholmod_factor) into solve
    handles on ``device``: a ``factor`` with ``L()`` and ``P()``, or the raw
    supernodal arrays (``perm`` defaults to the identity).  SUPERNODAL solves
    with the raw form's partition."""
    sn_of_col = None
    if factor is not None:
        Lsp = sps.csr_matrix(factor.L())
        perm = np.asarray(factor.P(), np.int64)
    else:
        if any(a is None for a in (n, super_, pi, px, s, x)):
            raise ValueError("cholmod_import: factor or raw arrays required")
        Lsp, sn_of_col = cholmod_raw_to_csr(n, super_, pi, px, s, x)
        if perm is None:
            perm = np.arange(Lsp.shape[0], dtype=np.int64)
    Lsp.sort_indices()
    Ltsp = Lsp.T.tocsr()
    Ltsp.sort_indices()
    L = CsrMatrix.from_scipy(Lsp, value_dtype=value_dtype, device=device)
    Lt = CsrMatrix.from_scipy(Ltsp, value_dtype=value_dtype, device=device)
    Lh = SptrsvHandle(lower=True, algorithm=algorithm)
    Lth = SptrsvHandle(lower=False, algorithm=algorithm)
    if algorithm is SptrsvAlgorithm.SUPERNODAL and sn_of_col is not None:
        Lh.sn_partition = sn_of_col
        # the upper solve runs index-reversed: the mirrored partition
        Lth.sn_partition = sn_of_col[::-1]
    sptrsv_symbolic(Lh, L)
    sptrsv_symbolic(Lth, Lt)
    return CholmodSolve(Lh, Lth, L, Lt, perm)
