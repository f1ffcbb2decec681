"""COO container — counterpart of ``tpukk/containers/coo.py``
(sparse/src/KokkosSparse_CooMatrix.hpp): int32 row and column ids and the
values, as torch tensors on one device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import default_device, default_ordinal
from .csr import _check_index_dtype, _host_index

__all__ = ["CooMatrix"]


@dataclasses.dataclass(eq=False)
class CooMatrix:
    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
    nrows: int
    ncols: int

    @classmethod
    def from_scipy(cls, sp, ordinal_dtype=default_ordinal, device=None) -> "CooMatrix":
        _check_index_dtype(ordinal_dtype, "ordinal_dtype")
        dev = default_device(device)
        coo = sp.tocoo()
        return cls(torch.from_numpy(_host_index(coo.row, "row")).to(dev),
                   torch.from_numpy(_host_index(coo.col, "col")).to(dev),
                   torch.from_numpy(np.array(coo.data)).to(dev),
                   int(coo.shape[0]), int(coo.shape[1]))

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.coo_matrix((self.data.cpu().numpy(), (self.row.cpu().numpy(),
                                                         self.col.cpu().numpy())),
                              shape=self.shape)
