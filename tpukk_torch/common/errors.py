"""Error handling — counterpart of ``tpukk/common/errors.py``.

API-layer argument validation raises :class:`TpuKKError` before any device
work is enqueued, as the reference's runtime dimension checks do at its L1
entry points (sparse/src/KokkosSparse_spmv.hpp:80-141).
"""
from __future__ import annotations

__all__ = ["TpuKKError", "check"]


class TpuKKError(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise TpuKKError(msg)

