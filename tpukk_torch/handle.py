"""Aggregate kernel handle — counterpart of ``tpukk/handle.py``
(sparse/src/KokkosKernels_Handle.hpp:33-37, ``KokkosKernelsHandle``): one
object that creates, hands out and destroys the per-kernel sub-handles
(spgemm, spadd, Gauss-Seidel, sptrsv, spiluk, par_ilut, gmres;
KokkosKernels_Handle.hpp:469-504,581-627), so that a solver composition
shares one configuration surface.  Every sub-handle is the port's own, so
what a composition runs on the card is what the direct handles run.

The reference's multi-stream variants (``spiluk_numeric_streams``, n-stream
GS handles, KokkosKernels_Handle.hpp:581-627) are the ``*_streams`` helpers:
the calls run one after the other on the current CUDA stream.
"""
from __future__ import annotations

from typing import List, Optional

from .common import check
from .graph.coloring import ColoringAlgorithm
from .sparse.gauss_seidel import ClusteringAlgorithm, GsAlgorithm, GsHandle
from .sparse.gmres import GmresHandle, Ortho
from .sparse.par_ilut import ParIlutHandle
from .sparse.spadd import SpaddHandle
from .sparse.spgemm import SpgemmAlgorithm, SpgemmHandle
from .sparse.spiluk import SpilukHandle
from .sparse.spmv import SpmvAlgorithm, SpmvHandle
from .sparse.sptrsv import SptrsvHandle

__all__ = ["TpukkHandle", "spiluk_numeric_streams", "sptrsv_solve_streams"]


class TpukkHandle:
    """create_*_handle / destroy_*_handle / get_*_handle triads, mirroring
    the reference's aggregator contract."""

    def __init__(self):
        self._spgemm: Optional[SpgemmHandle] = None
        self._spadd: Optional[SpaddHandle] = None
        self._gs: Optional[GsHandle] = None
        self._sptrsv_lower: Optional[SptrsvHandle] = None
        self._sptrsv_upper: Optional[SptrsvHandle] = None
        self._spiluk: Optional[SpilukHandle] = None
        self._par_ilut: Optional[ParIlutHandle] = None
        self._gmres: Optional[GmresHandle] = None

    # -- spgemm ---------------------------------------------------------
    def create_spgemm_handle(self, algorithm: SpgemmAlgorithm = SpgemmAlgorithm.KK):
        self._spgemm = SpgemmHandle(algorithm)
        return self._spgemm

    def get_spgemm_handle(self) -> SpgemmHandle:
        check(self._spgemm is not None, "spgemm handle not created")
        return self._spgemm

    def destroy_spgemm_handle(self):
        self._spgemm = None

    # -- spadd ----------------------------------------------------------
    def create_spadd_handle(self, sorted_input: bool = True):
        self._spadd = SpaddHandle(sorted_input)
        return self._spadd

    def get_spadd_handle(self) -> SpaddHandle:
        check(self._spadd is not None, "spadd handle not created")
        return self._spadd

    def destroy_spadd_handle(self):
        self._spadd = None

    # -- gauss-seidel ----------------------------------------------------
    def create_gs_handle(self, algorithm: GsAlgorithm = GsAlgorithm.POINT,
                         coloring: ColoringAlgorithm = ColoringAlgorithm.VB,
                         clustering: ClusteringAlgorithm = None):
        self._gs = GsHandle(algorithm, coloring, clustering=clustering)
        return self._gs

    def get_gs_handle(self) -> GsHandle:
        check(self._gs is not None, "gs handle not created")
        return self._gs

    def destroy_gs_handle(self):
        self._gs = None

    # -- sptrsv ----------------------------------------------------------
    def create_sptrsv_handle(self, lower: bool = True):
        h = SptrsvHandle(lower)
        if lower:
            self._sptrsv_lower = h
        else:
            self._sptrsv_upper = h
        return h

    def get_sptrsv_handle(self, lower: bool = True) -> SptrsvHandle:
        h = self._sptrsv_lower if lower else self._sptrsv_upper
        check(h is not None, "sptrsv handle not created")
        return h

    def destroy_sptrsv_handle(self, lower: bool = True):
        if lower:
            self._sptrsv_lower = None
        else:
            self._sptrsv_upper = None

    # -- spiluk ----------------------------------------------------------
    def create_spiluk_handle(self, fill_level: int = 0):
        self._spiluk = SpilukHandle(fill_level)
        return self._spiluk

    def get_spiluk_handle(self) -> SpilukHandle:
        check(self._spiluk is not None, "spiluk handle not created")
        return self._spiluk

    def destroy_spiluk_handle(self):
        self._spiluk = None

    # -- par_ilut ---------------------------------------------------------
    def create_par_ilut_handle(self, **kw):
        self._par_ilut = ParIlutHandle(**kw)
        return self._par_ilut

    def get_par_ilut_handle(self) -> ParIlutHandle:
        check(self._par_ilut is not None, "par_ilut handle not created")
        return self._par_ilut

    def destroy_par_ilut_handle(self):
        self._par_ilut = None

    # -- gmres ------------------------------------------------------------
    def create_gmres_handle(self, m: int = 50, tol: float = 1e-8,
                            max_restarts: int = 50, ortho: Ortho = Ortho.CGS2):
        self._gmres = GmresHandle(m, tol, max_restarts, ortho)
        return self._gmres

    def get_gmres_handle(self) -> GmresHandle:
        check(self._gmres is not None, "gmres handle not created")
        return self._gmres

    def destroy_gmres_handle(self):
        self._gmres = None


def spiluk_numeric_streams(handles: List[SpilukHandle], matrices):
    """n-stream ILU numeric (cf. spiluk_numeric_streams,
    KokkosSparse_spiluk.hpp:440): independent factorizations, one after the
    other."""
    from .sparse.spiluk import spiluk_numeric

    return [spiluk_numeric(h, A) for h, A in zip(handles, matrices)]


def sptrsv_solve_streams(handles: List[SptrsvHandle], matrices, rhss):
    """n-stream triangular solves (cf. sptrsv streams overloads,
    KokkosSparse_sptrsv.hpp)."""
    from .sparse.sptrsv import sptrsv_solve

    return [sptrsv_solve(h, A, b) for h, A, b in zip(handles, matrices, rhss)]
