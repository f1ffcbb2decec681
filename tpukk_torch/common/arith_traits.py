"""Scalar arithmetic traits — counterpart of ``tpukk/common/arith_traits.py``
(Kokkos::ArithTraits, common/src/Kokkos_ArithTraits.hpp: zero/one/eps/abs/
conj/isNan for float/double/half/bhalf/complex/int).

A trait is a small frozen dataclass keyed by torch dtype; a numpy dtype (or
its name) is taken too and mapped to torch's.  The element functions act on
torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["ArithTraits", "arith_traits", "is_complex", "mag_dtype"]

_MAG = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


@dataclasses.dataclass(frozen=True)
class ArithTraits:
    """Scalar traits for one dtype (cf. Kokkos_ArithTraits.hpp:1-1654)."""

    dtype: torch.dtype
    zero: Any
    one: Any
    eps: float
    is_integer: bool
    is_complex: bool
    # magnitude (abs-value) dtype: the real part's dtype for complex, self otherwise
    mag_dtype: torch.dtype

    def abs(self, x):
        return torch.abs(x)

    def conj(self, x):
        return torch.conj_physical(x) if self.is_complex else x

    def real(self, x):
        return torch.real(x) if self.is_complex else x

    def imag(self, x):
        return torch.imag(x) if self.is_complex else torch.zeros_like(x)

    def isnan(self, x):
        if self.is_integer:
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        return torch.isnan(x)

    def sqrt(self, x):
        return torch.sqrt(x)

    @property
    def min(self):
        return (torch.iinfo if self.is_integer else torch.finfo)(self.dtype).min

    @property
    def max(self):
        return (torch.iinfo if self.is_integer else torch.finfo)(self.dtype).max


def _make(dtype: torch.dtype) -> ArithTraits:
    is_int = not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool
    is_cplx = dtype.is_complex
    return ArithTraits(
        dtype=dtype,
        zero=torch.zeros((), dtype=dtype),
        one=torch.ones((), dtype=dtype),
        eps=0.0 if is_int else float(torch.finfo(dtype).eps),
        is_integer=is_int,
        is_complex=is_cplx,
        mag_dtype=_MAG.get(dtype, dtype),
    )


_CACHE: dict = {}


def arith_traits(dtype) -> ArithTraits:
    """Return the ArithTraits for ``dtype`` (torch or numpy; cached)."""
    key = _torch_dtype(dtype)
    if key not in _CACHE:
        _CACHE[key] = _make(key)
    return _CACHE[key]


def is_complex(dtype) -> bool:
    return _torch_dtype(dtype).is_complex


def mag_dtype(dtype) -> torch.dtype:
    return arith_traits(dtype).mag_dtype
