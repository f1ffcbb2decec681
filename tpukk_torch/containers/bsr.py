"""BSR (block CSR) container — counterpart of ``tpukk/containers/bsr.py``
(sparse/src/KokkosSparse_BsrMatrix.hpp): int32 ``row_map`` and block-column
ids, and the values as a dense (nnz_blocks, b, b) tensor, on one device.

Its SpMV routes are in ``sparse/spmv.py`` (``SpmvHandle`` on a BsrMatrix),
its SpGEMM and SpADD in ``sparse/spgemm.py`` and ``sparse/spadd.py``
(``bspgemm``, ``bspadd``), block Gauss-Seidel in ``sparse/gauss_seidel.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import check, default_device, default_offset, default_ordinal
from .csr import _check_index_dtype, _host_index, _HostMirrors

__all__ = ["BsrMatrix"]


@dataclasses.dataclass(eq=False)
class BsrMatrix(_HostMirrors):
    row_map: torch.Tensor  # (n_block_rows+1,)
    entries: torch.Tensor  # (nnz_blocks,) block-column ids
    values: torch.Tensor   # (nnz_blocks, b, b)
    nrows: int             # scalar rows = n_block_rows * b
    ncols: int
    block_size: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def n_block_rows(self) -> int:
        return self.nrows // self.block_size

    @property
    def n_block_cols(self) -> int:
        return self.ncols // self.block_size

    @property
    def nnz_blocks(self) -> int:
        return int(self.entries.shape[0])

    @property
    def nnz(self) -> int:
        return self.nnz_blocks * self.block_size * self.block_size

    @classmethod
    def from_scipy_bsr(cls, sp, ordinal_dtype=default_ordinal, offset_dtype=default_offset,
                       device=None) -> "BsrMatrix":
        _check_index_dtype(ordinal_dtype, "ordinal_dtype")
        _check_index_dtype(offset_dtype, "offset_dtype")
        check(sp.blocksize[0] == sp.blocksize[1], "BsrMatrix: square blocks only")
        dev = default_device(device)
        rm, en = _host_index(sp.indptr, "row_map"), _host_index(sp.indices, "entries")
        vals = np.array(sp.data)
        obj = cls(torch.from_numpy(rm).to(dev), torch.from_numpy(en).to(dev),
                  torch.from_numpy(vals).to(dev), int(sp.shape[0]), int(sp.shape[1]),
                  int(sp.blocksize[0]))
        obj._prefill(row_map=rm, entries=en, values=vals)
        return obj

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.bsr_matrix((self.host_values().copy(), self.host_entries().copy(),
                               self.host_row_map().copy()), shape=self.shape)

    def with_values(self, values) -> "BsrMatrix":
        """Same block pattern, new (nnz_blocks, b, b) values."""
        vals_h = None
        if not isinstance(values, torch.Tensor):
            vals_h = np.array(values)
            values = torch.from_numpy(vals_h)
        obj = BsrMatrix(self.row_map, self.entries, values.to(self.device), self.nrows,
                        self.ncols, self.block_size)
        cache = self.__dict__.get("_hcache", {})
        obj._prefill(row_map=cache.get("row_map"), entries=cache.get("entries"), values=vals_h)
        return obj

    def host_values(self) -> np.ndarray:
        return self._mirror("values")
