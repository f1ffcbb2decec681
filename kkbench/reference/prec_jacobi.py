"""Jacobi: z = D⁻¹r."""
from __future__ import annotations

import numpy as np
import torch


class Reference:
    def __init__(self, A, tables: dict, device, dtype):
        d = A.diagonal()
        inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
        self.inv_diag = torch.from_numpy(inv).to(device, dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * r

    def judge(self, tables: dict) -> dict:
        return {}


def control_tables(A, dtype, seed: int) -> dict:
    return {}
