"""One symmetric multicolor Gauss-Seidel sweep from zero, ω = 1: the
forward half over the colors in order, then the backward half.  Rows of one
color share no entry, so each color is one vectorised update
x[c] += D[c]⁻¹ (r[c] − A[c,:]·x).

The sweep follows the coloring of the side under test (the program's, or
the control's own), which ``judge`` first holds to be a coloring: every row
colored, no stored entry between two rows of one color.  A greedy coloring
in the port's order would take a sequential pass over 29.8M entries here.
"""
from __future__ import annotations

import numpy as np
import torch

from kkbench.reference import csr


def conflicts(A, colors: np.ndarray) -> int:
    """Rows left uncolored plus stored off-diagonal entries whose two rows
    share a color."""
    coo = A.tocoo()
    off = coo.row != coo.col
    same = colors[coo.row[off]] == colors[coo.col[off]]
    return int(np.count_nonzero(colors < 1)) + int(np.count_nonzero(same))


class Reference:
    def __init__(self, A, tables: dict, device, dtype):
        colors = np.asarray(tables["colors"])
        self.colors = colors
        order = np.argsort(colors, kind="stable")
        bounds = np.searchsorted(colors[order], np.arange(1, colors.max() + 2))
        groups = [order[bounds[c]:bounds[c + 1]] for c in range(len(bounds) - 1)]
        self.blocks = csr.row_blocks(A, [g for g in groups if g.size], device, dtype)
        d = A.diagonal()
        self.inv_diag = torch.from_numpy(1.0 / d).to(device, dtype)
        self.A, self.n, self.device, self.dtype = A, A.shape[0], device, dtype

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        x = torch.zeros(self.n, device=self.device, dtype=self.dtype)
        for rows, Ab in [*self.blocks, *reversed(self.blocks)]:
            x[rows] += self.inv_diag[rows] * (r[rows] - torch.mv(Ab, x))
        return x

    def judge(self, tables: dict) -> dict:
        return {"color_conflicts": conflicts(self.A, self.colors)}


def luby_colors(A, seed: int) -> np.ndarray:
    """A coloring of the reference's own (for the control): in each round the
    uncolored rows whose random priority beats every uncolored neighbour's
    take the round's color."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    coo = A.tocoo()
    off = coo.row != coo.col
    r, c = coo.row[off], coo.col[off]
    prio = rng.permutation(n)
    colors = np.zeros(n, np.int32)
    color = 0
    while (colors == 0).any():
        color += 1
        open_ = colors == 0
        beaten = open_[r] & open_[c] & (prio[c] > prio[r])
        beat = np.bincount(r, weights=beaten, minlength=n) > 0
        colors[open_ & ~beat] = color
    return colors


def control_tables(A, dtype, seed: int) -> dict:
    return {"colors": luby_colors(A, seed)}
