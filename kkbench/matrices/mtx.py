"""A MatrixMarket file under ``kkbench/`` (``cfg["file"]``, relative to the
checkout's root), read with SciPy, rows sorted, moved to the device."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io as sio
import torch

ROOT = Path(__file__).resolve().parents[2]
_DTYPES = {"float32": np.float32, "float64": np.float64}


def build(cfg: dict, device) -> dict:
    sp = sio.mmread(str(ROOT / cfg["file"])).tocsr()
    sp.sort_indices()
    return {"row_map": torch.from_numpy(sp.indptr.astype(np.int32)).to(device),
            "entries": torch.from_numpy(sp.indices.astype(np.int32)).to(device),
            "values": torch.from_numpy(sp.data.astype(_DTYPES[cfg["dtype"]])).to(device),
            "nrows": sp.shape[0], "ncols": sp.shape[1]}
