"""HPCG's 27-point operator (hpcg-benchmark.org, reference
``src/GenerateProblem_ref.cpp``): one row per point of an nx × ny × nz grid,
numbered x fastest, ``diagonal`` on the diagonal and ``offdiagonal`` for each
of the up to 26 neighbours inside the grid, columns ascending.  Built on the
device in a few tensor operations."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build(cfg: dict, device) -> dict:
    """CSR arrays (int32 row_map and entries, values) on ``device``."""
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dtype = _DTYPES[cfg["dtype"]]
    n = nx * ny * nz
    idx = torch.arange(n, device=device, dtype=torch.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    # (dz, dy, dx) in lexicographic order gives ascending columns in a row
    d = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
                     device=device, dtype=torch.int64)
    jx = ix[:, None] + d[None, :, 2]
    jy = iy[:, None] + d[None, :, 1]
    jz = iz[:, None] + d[None, :, 0]
    inside = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
    cols = (jx + nx * (jy + ny * jz))[inside]
    diag = (d == 0).all(dim=1)[None, :].expand(n, -1)[inside]
    del jx, jy, jz
    row_map = torch.zeros(n + 1, device=device, dtype=torch.int64)
    torch.cumsum(inside.sum(dim=1), 0, out=row_map[1:])
    values = torch.full(cols.shape, float(cfg["offdiagonal"]), device=device, dtype=dtype)
    values[diag] = float(cfg["diagonal"])
    return {"row_map": row_map.to(torch.int32), "entries": cols.to(torch.int32),
            "values": values, "nrows": n, "ncols": n}
