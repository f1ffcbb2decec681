"""Error handling — counterpart of ``tpukk/common/errors.py``.

API-layer argument validation raises :class:`TpuKKError` before any device
work is enqueued, as the reference's runtime dimension checks do at its L1
entry points (sparse/src/KokkosSparse_spmv.hpp:80-141).
"""
from __future__ import annotations

__all__ = ["TpuKKError", "check", "check_rank", "check_same_dtype"]


class TpuKKError(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise TpuKKError(msg)


def check_rank(x, rank: int, name: str):
    if x.ndim != rank:
        raise TpuKKError(f"{name}: expected rank-{rank} array, got rank {x.ndim}")


def check_same_dtype(name: str, *arrays):
    dts = {a.dtype for a in arrays}
    if len(dts) > 1:
        raise TpuKKError(f"{name}: mismatched dtypes {sorted(map(str, dts))}")
