"""Matrix IO — counterpart of ``tpukk/containers/io.py``: MatrixMarket read
and write (sparse/src/KokkosSparse_IOUtils.hpp:632-876; scipy reads ``.mtx``
and ``.mtx.gz`` alike) and the ``.npz`` dump and restore of a CSR matrix
(common/src/KokkosKernels_IOUtils.hpp:135-248), in ``tpukk``'s file layout
(``row_map``, ``entries``, ``values``, ``shape``), so either package reads
the other's files."""
from __future__ import annotations

import numpy as np

from .csr import CsrMatrix

__all__ = ["read_mtx", "write_mtx", "save_csr_npz", "load_csr_npz"]


def read_mtx(path, value_dtype=None, device=None) -> CsrMatrix:
    import scipy.io as sio

    sp = sio.mmread(str(path)).tocsr()
    sp.sort_indices()
    return CsrMatrix.from_scipy(sp, value_dtype=value_dtype, device=device)


def write_mtx(path, csr: CsrMatrix):
    import scipy.io as sio

    sio.mmwrite(str(path), csr.to_scipy())


def save_csr_npz(path, csr: CsrMatrix):
    np.savez_compressed(
        str(path),
        row_map=csr.host_row_map(),
        entries=csr.host_entries(),
        values=csr.host_values(),
        shape=np.asarray(csr.shape),
    )


def load_csr_npz(path, device=None) -> CsrMatrix:
    with np.load(str(path)) as z:
        return CsrMatrix.from_arrays(
            z["row_map"], z["entries"], z["values"],
            nrows=int(z["shape"][0]), ncols=int(z["shape"][1]), device=device,
        )
