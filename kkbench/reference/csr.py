"""CSR matrices for the reference: SciPy on the host, ``torch.sparse`` CSR
products on the device."""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sps
import torch


def from_arrays(arrays: dict) -> sps.csr_matrix:
    """The benchmark's matrix arrays (host copies) as a SciPy matrix."""
    return sps.csr_matrix((arrays["values"], arrays["entries"], arrays["row_map"]),
                          shape=(arrays["nrows"], arrays["ncols"]))


def to_torch(A: sps.csr_matrix, device, dtype) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)).to(device),
            torch.from_numpy(A.indices.astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(A.data)).to(device, dtype),
            size=A.shape)


def rel_residual(At: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ in A's precision."""
    return float(torch.linalg.vector_norm(b - torch.mv(At, x.to(b.dtype)))
                 / torch.linalg.vector_norm(b))


def row_blocks(A: sps.csr_matrix, groups, device, dtype):
    """(rows, A[rows] on the device) for each group of row indices."""
    out = []
    for rows in groups:
        sub = A[rows].tocsr()
        out.append((torch.from_numpy(rows.astype(np.int64)).to(device),
                    to_torch(sub, device, dtype)))
    return out
