"""HPCG's 27-point operator (hpcg-benchmark.org, reference
``src/GenerateProblem_ref.cpp``): one row per point of an nx × ny × nz grid,
numbered x fastest, ``diagonal`` on the diagonal and ``offdiagonal`` for each
of the up to 26 neighbours inside the grid, columns ascending.  Built on the
device in a few tensor operations.

Over several ranks (``build_part``) the configuration's grid is each rank's
local grid, as HPCG's is, and the ranks form HPCG's process grid."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _offsets(device) -> torch.Tensor:
    # (dz, dy, dx) in lexicographic order gives ascending columns in a row
    return torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
                        device=device, dtype=torch.int64)


def build(cfg: dict, device) -> dict:
    """CSR arrays (int32 row_map and entries, values) on ``device``."""
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dtype = _DTYPES[cfg["dtype"]]
    n = nx * ny * nz
    idx = torch.arange(n, device=device, dtype=torch.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    d = _offsets(device)
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


def process_grid(cfg: dict, size: int) -> tuple:
    """(px, py, pz): the configuration's ``process_grid``, HPCG's grid of
    ranks; one rank needs none."""
    grid = tuple(int(p) for p in cfg.get("process_grid", (1, 1, 1)))
    if len(grid) != 3 or grid[0] * grid[1] * grid[2] != size:
        raise ValueError(f"stencil27: process_grid {grid} does not hold {size} ranks")
    return grid


def build_part(cfg: dict, device, rank: int, size: int) -> dict:
    """Rank ``rank``'s rows of the operator over ``size`` ranks, as CSR
    arrays on ``device`` whose column ids are global rows, plus ``row0``,
    the global row of the part's first row.

    Ranks lie in the process grid px × py × pz as HPCG numbers them (rank =
    ipx + px·(ipy + py·ipz)), each holding an nx × ny × nz box of the global
    grid (px·nx) × (py·ny) × (pz·nz).  A point's global row is its rank's
    first row, rank · nx·ny·nz, plus its row in the box (x fastest), so the
    global matrix is the parts concatenated in rank order: HPCG's operator
    with its rows and columns renumbered rank by rank.  Columns ascend in
    each row."""
    px, py, pz = process_grid(cfg, size)
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dtype = _DTYPES[cfg["dtype"]]
    n = nx * ny * nz
    row0 = rank * n
    idx = torch.arange(n, device=device, dtype=torch.int64)
    gx = idx % nx + (rank % px) * nx
    gy = (idx // nx) % ny + (rank // px) % py * ny
    gz = idx // (nx * ny) + rank // (px * py) * nz
    d = _offsets(device)
    jx = gx[:, None] + d[None, :, 2]
    jy = gy[:, None] + d[None, :, 1]
    jz = gz[:, None] + d[None, :, 0]
    inside = ((jx >= 0) & (jx < px * nx) & (jy >= 0) & (jy < py * ny)
              & (jz >= 0) & (jz < pz * nz))
    jx, jy, jz = jx.clamp(0, px * nx - 1), jy.clamp(0, py * ny - 1), jz.clamp(0, pz * nz - 1)
    rx, ry, rz = jx // nx, jy // ny, jz // nz
    cols = ((rx + px * (ry + py * rz)) * n
            + (jx - rx * nx) + nx * ((jy - ry * ny) + ny * (jz - rz * nz)))
    del jx, jy, jz, rx, ry, rz
    # outside points sort past every column; each row's columns ascend
    cols, _ = torch.sort(torch.where(inside, cols, px * py * pz * n), dim=1)
    diag = cols == (idx + row0)[:, None]
    keep = cols < px * py * pz * n
    row_map = torch.zeros(n + 1, device=device, dtype=torch.int64)
    torch.cumsum(keep.sum(dim=1), 0, out=row_map[1:])
    values = torch.full((int(row_map[-1]),), float(cfg["offdiagonal"]), device=device,
                        dtype=dtype)
    values[diag[keep]] = float(cfg["diagonal"])
    return {"row_map": row_map.to(torch.int32), "entries": cols[keep].to(torch.int32),
            "values": values, "nrows": n, "ncols": px * py * pz * n, "row0": row0}
