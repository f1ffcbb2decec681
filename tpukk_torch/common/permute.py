"""Static permutation — counterpart of ``tpukk/common/permute.py``.

A plan is the source index vector ``src`` with ``out[i] = x[src[i]]``, as a
device int32 tensor; applying it is one launch of K5 ``permute_gather``
(``csrc/permute.cu``).  ``tpukk`` routes the permutation on the host through a
three-phase Beneš network (``StaticPermutePlan``'s routing tables) because
Mosaic has no fast dynamic gather; the H100 gathers from device memory
directly, so no routing tables are carried.

``permute_gather`` is K5's wrapper: it checks its operands and raises on
anything else; it takes f32, f64, complex64 and complex128.  K5 has no
complex instance and needs none: a permutation moves values and does no
arithmetic, so a complex64 value moves as the 8 bytes of one f64
(``view(torch.float64)``) and a complex128 value as the 16-byte row of two
f64 (``view_as_real``, K5's k > 1 path), and the bits that arrive are the
complex values that ``tpukk``'s routed permutation (``_rowperm3_call``,
``_rowperm_call``) moves.  On a CPU tensor it runs the plain version
``permute_plain``, on a CUDA tensor it launches the kernel on the current
stream or raises.  It adds one to its ``launches`` count each time it
launches the kernel, and nowhere else.  ``permute_geometry`` picks the
kernel's vector width and lanes a row from n, k, the dtype and the
operands' alignment.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tracing
from .errors import check
from .utils import permute_via_sort

__all__ = ["PermutePlan", "build_permute_plan", "static_permute", "permute_gather",
           "permute_plain", "permute_geometry", "FILL_THREADS"]

# Half the threads the H100 holds resident (132 SMs × 2,048): K5 gathers
# several values a thread only where the threads still fill this many
FILL_THREADS = 132 * 2048 // 2


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


def static_permute(plan: PermutePlan | None, x: torch.Tensor, keys=None) -> torch.Tensor:
    """x[plan.src] along the first axis, in x's dtype (f32, f64, complex64
    or complex128 on CUDA); with plan None, ``permute_via_sort(x, keys)``
    as in ``tpukk``."""
    if plan is None:
        return permute_via_sort(x, keys)
    return permute_gather(plan.src, x)


def permute_plain(src: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``index_select`` along the first axis."""
    return x.index_select(0, src.long())


def permute_geometry(n: int, k: int, itemsize: int, src_offset: int = 0, x_offset: int = 0,
                     out_offset: int = 0) -> tuple[int, int]:
    """K5's (vec, lanes) for n rows of k values of ``itemsize`` bytes, each
    operand's address ``*_offset`` bytes past a 16-byte boundary.

    k = 1: a thread gathers ``vec`` consecutive outputs, loading their src
    entries with one access and storing them with one: the widest of 16
    bytes of out (4 f32, 2 f64), then halves, whose src and out accesses lie
    on their own size (a view off that boundary takes a narrower width, down
    to one value), halved again while the n / vec threads would not fill
    ``FILL_THREADS`` (one value a thread took 14-51 % less time than 16
    bytes on the paths' 30,000- and 173,001-value permutations, 16 bytes
    14-16 % less on lap1000's RCM permutation of 1M; PERF.md, K5); lanes
    is 1.  k > 1: ``lanes`` lanes a row copy it in chunks of
    ``vec`` values, the widest of 16 bytes, 8, or one value that divides k
    and keeps x's and out's rows on a chunk boundary; lanes is the power of
    two at least the row's chunks, at most 32 (a lane then takes several)."""
    check(k >= 1 and itemsize in (4, 8), f"permute_geometry: k {k}, itemsize {itemsize}")
    vec = 16 // itemsize
    if k == 1:
        while vec > 1 and (src_offset % (4 * vec) or out_offset % (vec * itemsize)
                           or n < vec * FILL_THREADS):
            vec //= 2
        return vec, 1
    while vec > 1 and (k % vec or (x_offset | out_offset) % (vec * itemsize)):
        vec //= 2
    lanes = 1
    while lanes < min(k // vec, 32):
        lanes *= 2
    return vec, lanes


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
    check(x.is_contiguous() and src.is_contiguous(),
          "permute_gather: x and src must be contiguous")
    if x.dtype == torch.complex64:
        return permute_gather(src, x.view(torch.float64)).view(torch.complex64)
    if x.dtype == torch.complex128:
        rows = torch.view_as_real(x).reshape(x.shape[0], -1)  # (n, 2) or (n, 2k) f64
        return torch.view_as_complex(permute_gather(src, rows).reshape(
            (src.shape[0],) + tuple(x.shape[1:]) + (2,)))
    code = _kernels.dtype_code(x.dtype, _kernels.DTYPE_CODE, "permute_gather")
    n = src.shape[0]
    k = 1 if x.ndim == 1 else x.shape[1]
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec, lanes = permute_geometry(n, k, x.element_size(), src.data_ptr() % 16,
                                  x.data_ptr() % 16, out.data_ptr() % 16)
    err = _kernels.library("permute").tpukk_permute_gather(
        code, vec, lanes, src.data_ptr(), x.data_ptr(), out.data_ptr(),
        n, k, _kernels.stream_of(x))
    _kernels.check_launch(err, "permute_gather")
    tracing.count("launches.permute_gather")
    return out


