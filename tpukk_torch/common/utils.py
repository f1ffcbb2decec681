"""Shared primitives — counterpart of ``tpukk/common/utils.py`` (the subset
this package uses).  Scans run as torch ops on the tensor's device; plan-time
helpers stay on the host in numpy."""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "exclusive_scan",
    "inclusive_scan",
    "permute",
    "permute_via_sort",
    "inverse_permutation",
    "round_up",
    "cdiv",
]


def exclusive_scan(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """[x0,x1,..] -> [0, x0, x0+x1, ...] with the total appended (length n+1)."""
    x = x if dtype is None else x.to(dtype)
    out = torch.zeros(x.shape[0] + 1, dtype=x.dtype, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def inclusive_scan(x: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=dtype)


def permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """y[i] = x[perm[i]] along the first axis (gather form)."""
    return x.index_select(0, perm.long())


def permute_via_sort(x: torch.Tensor, inv_perm_keys: torch.Tensor) -> torch.Tensor:
    """``tpukk``'s key convention: element i carries key inv_perm_keys[i], so
    after sorting by key, position j holds x[perm[j]] with perm =
    argsort(inv_perm_keys).  The TPU ran this as a key-sort because its
    gathers were slow; here it is the argsort and one gather."""
    return permute(x, torch.argsort(inv_perm_keys, stable=True))


def inverse_permutation(perm) -> np.ndarray:
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
