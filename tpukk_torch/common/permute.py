"""Static permutation — counterpart of ``tpukk/common/permute.py``.

A plan is the source index vector ``src`` with ``out[i] = x[src[i]]``, as a
device int32 tensor; applying it is one launch of K5 ``permute_gather``
(``csrc/permute.cu``).  ``tpukk`` routes the permutation on the host through a
three-phase Beneš network (``StaticPermutePlan``'s routing tables) because
Mosaic has no fast dynamic gather; the H100 gathers from device memory
directly, so no routing tables are carried.

``permute_gather`` is K5's wrapper: it checks its operands and raises on
anything else; on a CPU tensor it runs the plain version ``permute_plain``,
on a CUDA tensor it launches the kernel on the current stream or raises.  It
adds one to its ``launches`` count each time it launches the kernel, and
nowhere else.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import check

__all__ = ["PermutePlan", "build_permute_plan", "static_permute", "permute_gather",
           "permute_plain"]


@dataclasses.dataclass
class PermutePlan:
    """out[i] = x[src[i]]: ``src`` is (n,) int32 on the plan's device."""

    src: torch.Tensor
    n: int


def build_permute_plan(src, device) -> PermutePlan:
    """Plan for the static gather out[i] = x[src[i]] (src a permutation of
    range(n), checked here on the host)."""
    src = np.asarray(src, np.int64)
    n = src.shape[0]
    check(src.ndim == 1 and np.array_equal(np.sort(src), np.arange(n)),
          "build_permute_plan: src must be a permutation of range(n)")
    return PermutePlan(torch.from_numpy(src.astype(np.int32)).to(device), n)


def static_permute(plan: PermutePlan, x: torch.Tensor) -> torch.Tensor:
    """x[plan.src] along the first axis, in x's dtype (f32/f64 on CUDA)."""
    return permute_gather(plan.src, x)


def permute_plain(src: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``index_select`` along the first axis."""
    return x.index_select(0, src.long())


def permute_gather(src: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5: out[i] = x[src[i]] for a vector x, or out[i, :] = x[src[i], :] for
    a row-major (n, k) x; src is int32 with values in [0, x.shape[0])."""
    from .. import _kernels

    check(x.ndim in (1, 2), f"permute_gather: x must be rank 1 or 2, got rank {x.ndim}")
    check(src.ndim == 1 and src.dtype == torch.int32,
          "permute_gather: src must be a rank-1 int32 tensor")
    check(src.device == x.device, f"permute_gather: src on {src.device}, x on {x.device}")
    if not _kernels.on_cuda(x, "permute_gather"):
        return permute_plain(src, x)
    check(x.dtype in _kernels.DTYPE_CODE, f"permute_gather: dtype {x.dtype} not f32/f64")
    check(x.is_contiguous() and src.is_contiguous(),
          "permute_gather: x and src must be contiguous")
    n = src.shape[0]
    k = 1 if x.ndim == 1 else x.shape[1]
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _kernels.library("permute").tpukk_permute_gather(
        _kernels.DTYPE_CODE[x.dtype], src.data_ptr(), x.data_ptr(), out.data_ptr(), n, k,
        _kernels.stream_of(x))
    _kernels.check_launch(err, "permute_gather")
    permute_gather.launches += 1
    return out


permute_gather.launches = 0
