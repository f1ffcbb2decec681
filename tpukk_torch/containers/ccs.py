"""CCS (compressed column) container — counterpart of
``tpukk/containers/ccs.py`` (sparse/src/KokkosSparse_CcsMatrix.hpp): int32
``col_map`` and row ids and the values, as torch tensors on one device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import default_device, default_offset, default_ordinal
from .csr import _check_index_dtype, _host_index

__all__ = ["CcsMatrix"]


@dataclasses.dataclass(eq=False)
class CcsMatrix:
    col_map: torch.Tensor  # (ncols+1,)
    entries: torch.Tensor  # row ids (nnz,)
    values: torch.Tensor
    nrows: int
    ncols: int

    @classmethod
    def from_scipy(cls, sp, ordinal_dtype=default_ordinal, offset_dtype=default_offset,
                   device=None) -> "CcsMatrix":
        _check_index_dtype(ordinal_dtype, "ordinal_dtype")
        _check_index_dtype(offset_dtype, "offset_dtype")
        dev = default_device(device)
        csc = sp.tocsc()
        return cls(torch.from_numpy(_host_index(csc.indptr, "col_map")).to(dev),
                   torch.from_numpy(_host_index(csc.indices, "entries")).to(dev),
                   torch.from_numpy(np.array(csc.data)).to(dev),
                   int(csc.shape[0]), int(csc.shape[1]))

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
    def nnz(self) -> int:
        return int(self.entries.shape[0])

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csc_matrix((self.values.cpu().numpy(), self.entries.cpu().numpy(),
                               self.col_map.cpu().numpy()), shape=self.shape)
