"""Public SpMV API — counterpart of ``tpukk/sparse/spmv.py`` (the reference's
sparse/src/KokkosSparse_spmv.hpp:77 and KokkosSparse_spmv_handle.hpp).

    y = spmv(A, x)                      # A·x
    y = spmv(A, x, alpha, beta, y)      # beta*y + alpha*op(A)·x
    h = SpmvHandle(A, algorithm=...)    # reusable plan (symbolic phase)
    y = h(x)                            # numeric phase

Modes: 'N' no transpose, 'T' transpose, 'C' conjugate without transpose, 'H'
conjugate transpose (KokkosSparse_spmv.hpp:126).  Transpose modes
materialise Aᵀ at plan time.  Values are real (complex SpMV is ROADMAP queue
A), so C is N and H is T.

Routes (``SpmvHandle.algorithm``), the same on every device:

=================  ====================================  =====================
route              on CUDA                               on the CPU
=================  ====================================  =====================
DIA, PALLAS        K1 ``dia_spmv`` / K2 ``dia_spmm``     their plain version
ONEHOT             K3 ``csr_spmv``; a 2-D x with         their plain versions
                   1 < k ≤ 16: K7 ``csr_spmm``; wider:
                   ELL, as in ``tpukk``
RCM                K5 ``permute_gather``, the AUTO       their plain versions
                   route of P·A·Pᵀ, K5 back
ELL/SEGSUM/DENSE   torch ops                             torch ops
DS                 the AUTO route, in native f64         the same
=================  ====================================  =====================
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from .. import native
from ..common import check
from ..common.permute import build_permute_plan, static_permute
from ..common.tracing import profile_region, region_name
from ..containers import CsrMatrix
from ..containers.sort_crs import transpose as _transpose
from . import spmv_cuda, spmv_impl
from .spmv_impl import SpmvAlgorithm

__all__ = ["SpmvAlgorithm", "SpmvHandle", "spmv", "spmm"]

_NOT_PORTED = {
    SpmvAlgorithm.BSR: "the BSR route is not ported yet (ROADMAP queue A, item A2)",
}


def _choose_algorithm(A: CsrMatrix) -> SpmvAlgorithm:
    """AUTO gate (KokkosSparse_spmv.hpp:222; ``tpukk`` spmv.py:35-53): tiny →
    DENSE; banded/stencil → DIA; unstructured f32/f64 → ONEHOT (the CSR
    kernel, which has no tile padding to estimate); else ELL.  It does not
    depend on the device, so the CPU takes the same routes."""
    if A.nrows * A.ncols <= 256 * 256:
        return SpmvAlgorithm.DENSE
    offs = spmv_impl.detect_dia_offsets(A, max_diags=32)
    if offs is not None and len(offs) * A.nrows <= 4 * max(A.nnz, 1):
        # dense-diagonal storage is within 4x of CSR nnz → streaming wins
        return SpmvAlgorithm.DIA
    if A.dtype in (torch.float32, torch.float64):
        return SpmvAlgorithm.ONEHOT
    return SpmvAlgorithm.ELL


def _compute_dtype(A: CsrMatrix, x: torch.Tensor) -> torch.dtype:
    """The dtype a product is computed in: the promotion of A's and x's,
    at least f32 (bf16 widens, as at tpukk's plan time)."""
    return torch.promote_types(torch.promote_types(A.dtype, x.dtype), torch.float32)


class SpmvHandle:
    """Reusable SpMV plan — analog of SPMVHandle
    (KokkosSparse_spmv_handle.hpp:91-135, setup caching across calls)."""

    def __init__(self, A: CsrMatrix, algorithm: SpmvAlgorithm = SpmvAlgorithm.AUTO):
        check(isinstance(A, CsrMatrix), "SpmvHandle: CSR matrices only (BSR: ROADMAP queue A)")
        if A.dtype.is_complex:
            raise NotImplementedError(
                "complex SpMV is not ported yet (ROADMAP queue A, item A3)")
        if algorithm in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[algorithm])
        self.A = A
        self._user_algorithm = algorithm
        # DS: native f64 on this hardware, so it is AUTO's route computed in f64
        self.algorithm = (_choose_algorithm(A)
                          if algorithm in (SpmvAlgorithm.AUTO, SpmvAlgorithm.DS)
                          else algorithm)
        self._plans = {}
        self._transposed: Optional["SpmvHandle"] = None

    # -- plan construction (symbolic phase, host-side, cached) ----------
    def _plan(self, key: str, dtype: torch.dtype):
        p = self._plans.get((key, dtype))
        if p is None:
            p = self._plans[(key, dtype)] = self._build_plan(key, dtype)
        return p

    def _build_plan(self, key: str, dtype: torch.dtype):
        A = self.A
        if key == "ell":
            return spmv_impl.build_ell_plan(A, dtype)
        if key == "dia":
            return spmv_impl.build_dia_plan(A, dtype=dtype)
        if key == "csr":
            return spmv_cuda.build_csr_plan(A, dtype)
        if key == "segsum":
            return spmv_impl.build_segsum_plan(A, dtype)
        if key == "dense":
            return A.to_dense().to(dtype)
        raise KeyError(key)  # pragma: no cover

    def _rcm_plan(self):
        """(handle on P·A·Pᵀ, to-permuted plan, back plan), built once: the
        native RCM of A's pattern as given (not symmetrized), as ``tpukk``'s
        RCM route does (spmv.py:122-141).  With pm = perm (pm[new] = old),
        the permuted vector is x[pm] and the natural one y_p[inv]."""
        p = self._plans.get(("rcm", None))
        if p is None:
            A = self.A
            sp = A.to_scipy().tocsr()
            pm = native.rcm(sp.indptr, sp.indices, A.nrows).astype(np.int64)
            spp = sp[pm][:, pm].tocsr()
            spp.sort_indices()
            perm_h = SpmvHandle(CsrMatrix.from_scipy(spp, value_dtype=A.host_values().dtype,
                                                     device=A.device))
            inv = np.empty(A.nrows, np.int64)
            inv[pm] = np.arange(A.nrows)
            p = self._plans[("rcm", None)] = (perm_h, build_permute_plan(pm, A.device),
                                              build_permute_plan(inv, A.device))
        return p

    def rcm_permuted(self):
        """(handle on P·A·Pᵀ, to_permuted, from_permuted): the RCM route's
        handle and the two converters (each one K5 launch), for solvers that
        iterate in permuted space and convert once per solve."""
        perm_h, to_p, from_p = self._rcm_plan()
        return (perm_h, lambda v: static_permute(to_p, v.contiguous()),
                lambda v: static_permute(from_p, v.contiguous()))

    def transposed(self) -> "SpmvHandle":
        if self._transposed is None:
            self._transposed = SpmvHandle(_transpose(self.A), self.algorithm)
        return self._transposed

    # -- numeric phase --------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """op-free A·x (or A·X for a multivector), in the compute dtype."""
        dt = _compute_dtype(self.A, x)
        x = x.to(dt).contiguous()
        alg = self.algorithm
        if alg in (SpmvAlgorithm.DIA, SpmvAlgorithm.PALLAS):
            plan = self._plan("dia", dt)
            return spmv_cuda.dia_spmv(plan, x) if x.ndim == 1 else spmv_cuda.dia_spmm(plan, x)
        if alg == SpmvAlgorithm.ONEHOT:
            if x.ndim == 1:
                return spmv_cuda.csr_spmv(self._plan("csr", dt), x)
            if 1 < x.shape[1] <= spmv_cuda.SPMM_MAX_K:
                return spmv_cuda.csr_spmm(self._plan("csr", dt), x)
            # wider than K7's panel (or k = 1): ELL, as tpukk does (spmv.py:249-251)
            return spmv_impl.apply_ell(self._plan("ell", dt), x)
        if alg == SpmvAlgorithm.ELL:
            return spmv_impl.apply_ell(self._plan("ell", dt), x)
        if alg == SpmvAlgorithm.SEGSUM:
            return spmv_impl.apply_segsum(self._plan("segsum", dt), x)
        if alg == SpmvAlgorithm.DENSE:
            return spmv_impl.apply_dense(self._plan("dense", dt), x)
        if alg == SpmvAlgorithm.RCM:
            perm_h, to_p, from_p = self._rcm_plan()
            return static_permute(from_p, perm_h.matvec(static_permute(to_p, x)))
        raise NotImplementedError(alg)  # pragma: no cover

    def matvec_f64(self, x) -> np.ndarray:
        """y = A·x in f64 for a host array x, host numpy in and out: the
        handle's own product with f64 operands (the card computes f64
        natively, so ``tpukk``'s double-single kernels have no counterpart)."""
        xt = torch.from_numpy(np.asarray(x, np.float64)).to(self.A.device)
        return self.matvec(xt).cpu().numpy()

    def __call__(self, x: torch.Tensor, alpha=1.0, beta=0.0, y=None, mode: str = "N"):
        m = mode.upper()
        check(m in ("N", "T", "C", "H"), f"spmv: invalid mode '{mode}'")
        # real values: conj(A) == A, so C runs as N and H as T
        h = self.transposed() if m in ("T", "H") else self
        _check_dims(h.A, x, y)
        # algorithm-labelled region, the pushRegion analog
        # (sparse/src/KokkosSparse_spmv.hpp:261-266)
        ds = self._user_algorithm == SpmvAlgorithm.DS
        with profile_region(region_name("spmv", m, h.algorithm.name)):
            ax = h.matvec(x.double() if ds else x)
            if y is None or _is_zero(beta):
                out = ax if _is_one(alpha) else alpha * ax
            else:
                out = beta * y + alpha * ax
            # DS returns f64 whatever x is, as tpukk's f64 route does
            return out if ds else out.to(x.dtype)


def _is_zero(c):
    return isinstance(c, (int, float)) and c == 0


def _is_one(c):
    return isinstance(c, (int, float)) and c == 1


def _check_dims(A: CsrMatrix, x: torch.Tensor, y):
    check(isinstance(x, torch.Tensor), "spmv: x must be a torch tensor")
    check(x.device == A.device, f"spmv: x on {x.device}, matrix on {A.device}")
    check(x.ndim in (1, 2), f"spmv: x must be rank 1 or 2, got rank {x.ndim}")
    check(x.shape[0] == A.ncols, f"spmv: x has {x.shape[0]} rows, expected {A.ncols}")
    if y is not None:
        check(y.shape[0] == A.nrows, f"spmv: y has {y.shape[0]} rows, expected {A.nrows}")
        check(x.ndim == y.ndim, "spmv: x/y rank mismatch")


_handle_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached_handle(A: CsrMatrix) -> SpmvHandle:
    h = _handle_cache.get(A)
    if h is None:
        h = _handle_cache[A] = SpmvHandle(A)
    return h


def spmv(A, x, alpha=1.0, beta=0.0, y=None, mode: str = "N",
         algorithm: SpmvAlgorithm = SpmvAlgorithm.AUTO):
    """Handle-less overload (KokkosSparse_spmv.hpp:77): builds, and for AUTO
    caches per matrix, a handle."""
    h = _cached_handle(A) if algorithm == SpmvAlgorithm.AUTO else SpmvHandle(A, algorithm)
    return h(x, alpha=alpha, beta=beta, y=y, mode=mode)


def spmm(A, X, alpha=1.0, beta=0.0, Y=None, mode: str = "N",
         algorithm: SpmvAlgorithm = SpmvAlgorithm.AUTO):
    """Multivector SpMM (rank-2 X of shape (ncols, k))."""
    check(X.ndim == 2, "spmm: X must be rank-2")
    return spmv(A, X, alpha=alpha, beta=beta, y=Y, mode=mode, algorithm=algorithm)
