"""Row partition planner — counterpart of ``tpukk/dist/partition.py``: the
piece the reference delegates to its callers (Trilinos/Tpetra Import/Export),
built on the host with numpy from the CSR partition.

The partition produces uniform-shape per-part padded-row (ELL) blocks,
stacked on a leading parts axis, equal to ``tpukk``'s.  ``shard_partition``
(``spmv.py``) takes one rank's slice onto a device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..common import round_up
from ..containers import CsrMatrix

__all__ = ["RowPartition", "partition_rows"]


@dataclasses.dataclass
class RowPartition:
    """Stacked per-part padded-row (ELL) blocks of a globally row-partitioned
    CSR matrix.

    cols/vals: (n_parts, rows_per_part, width); pads → col 0, val 0.
    row_valid: (n_parts, rows_per_part) bool mask (False for pad rows).
    A rank's shard (``rank`` set) holds its slice as tensors on its device,
    without the parts axis.
    """

    cols: Any
    vals: Any
    row_valid: Any
    nrows: int
    ncols: int
    n_parts: int
    rows_per_part: int
    rank: Any = None

    @property
    def padded_rows(self) -> int:
        return self.n_parts * self.rows_per_part


def partition_rows(A: CsrMatrix, n_parts: int, row_block: int = 8) -> RowPartition:
    """Block row partition: part p owns rows [p*rpp, (p+1)*rpp) (padded)."""
    rm = A.host_row_map()
    ent = A.host_entries()
    vals = A.host_values()
    lengths = rm[1:] - rm[:-1]
    width = max(1, int(lengths.max(initial=1)))
    rpp = round_up(-(-A.nrows // n_parts), row_block)

    total = n_parts * rpp
    rows = np.arange(total)
    in_range = rows < A.nrows
    rsafe = np.minimum(rows, A.nrows - 1)
    lens = np.where(in_range, (rm[rsafe + 1] - rm[rsafe]).astype(np.int64), 0)
    pos = rm[rsafe][:, None] + np.arange(width)[None, :]
    mask = np.arange(width)[None, :] < lens[:, None]
    pos = np.minimum(pos, max(len(ent) - 1, 0))
    cols = np.where(mask, ent[pos], 0).astype(np.int32).reshape(n_parts, rpp, width)
    v = np.where(mask, vals[pos], 0).reshape(n_parts, rpp, width)
    valid = in_range.reshape(n_parts, rpp)
    return RowPartition(cols, v, valid, A.nrows, A.ncols, n_parts, rpp)
