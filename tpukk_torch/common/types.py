"""Default types and the default device — counterpart of
``tpukk/common/types.py``.

Scalars default to f32 and ordinals/offsets to i32, as in ``tpukk``.  f64 is
native on the GPU and the CPU, so it is always supported: ``tpukk``'s
``enable_x64`` (JAX's switch, ``tpukk/common/types.py:34``) has no
counterpart.

Device rule: every constructor takes ``device=None`` and ``None`` means
``cuda``.  Nothing silently drops to the CPU: without a CUDA device the caller
must ask for ``device="cpu"``.
"""
from __future__ import annotations

import torch

from .errors import TpuKKError

__all__ = [
    "default_scalar",
    "default_ordinal",
    "default_offset",
    "supported_scalars",
    "default_device",
    "result_dtype",
]

default_scalar = torch.float32
default_ordinal = torch.int32   # lno_t: column indices / row ids
default_offset = torch.int32    # size_type: row_map offsets


def supported_scalars():
    """Scalar dtypes the kernels specialise for (the ETI axis analog); bf16
    values are widened to f32 at plan time."""
    return [torch.float32, torch.float64, torch.bfloat16]


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise TpuKKError(
            "no CUDA device is available: pass device='cpu' to run on the "
            "CPU through the kernels' plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def result_dtype(given: torch.dtype, computed: torch.dtype) -> torch.dtype:
    """An output's dtype: the caller's ``given`` dtype, unless the work ran in
    a complex ``computed`` dtype on a real one, whose imaginary part ``given``
    would drop."""
    return computed if computed.is_complex and not given.is_complex else given
