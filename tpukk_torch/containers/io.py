"""Matrix IO — counterpart of ``tpukk/containers/io.py`` (MatrixMarket read,
sparse/src/KokkosSparse_IOUtils.hpp:632-876).  scipy reads ``.mtx`` and
``.mtx.gz`` alike."""
from __future__ import annotations

from .csr import CsrMatrix

__all__ = ["read_mtx"]


def read_mtx(path, value_dtype=None, device=None) -> CsrMatrix:
    import scipy.io as sio

    sp = sio.mmread(str(path)).tocsr()
    sp.sort_indices()
    return CsrMatrix.from_scipy(sp, value_dtype=value_dtype, device=device)
