"""Supernodal sparse triangular solve — counterpart of
``examples/sptrsv_supernodal.py`` (the SUPERNODAL_* SpTRSV capability, as
sptrsv_supernode.hpp is used with SuperLU factors).  The supernode partition
is found in the factor's pattern, and the solve runs on the supernodal DAG,
one K4 launch on the card."""
import numpy as np
import scipy.sparse as sps
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import CsrMatrix
from tpukk_torch.sparse import SptrsvAlgorithm, SptrsvHandle, sptrsv_solve, sptrsv_symbolic


def blocked_lower_factor(n, bs, seed=0):
    """A supernodal-looking lower factor: dense diagonal blocks and shared
    below-diagonal row panels (the shape SuperLU/CHOLMOD factors have)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for k in range(n // bs):
        s = k * bs
        for i in range(bs):
            for j in range(i + 1):
                rows.append(s + i)
                cols.append(s + j)
                vals.append(rng.standard_normal() + (5.0 if i == j else 0.0))
        below = np.arange(s + bs, n)
        if len(below):
            for r in rng.choice(below, size=min(4, len(below)), replace=False):
                for j in range(bs):
                    rows.append(int(r))
                    cols.append(s + j)
                    vals.append(0.3 * rng.standard_normal())
    T = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    T.sum_duplicates()
    T.sort_indices()
    return T


def main(device=None):
    dev = default_device(device)
    T = blocked_lower_factor(256, 16)
    L = CsrMatrix.from_scipy(T.astype(np.float32), device=dev)

    h = SptrsvHandle(lower=True, algorithm=SptrsvAlgorithm.SUPERNODAL)
    sptrsv_symbolic(h, L)
    print(f"supernodes: {h.sn_plan.num_supernodes} "
          f"(max block {h.sn_plan.max_block}), levels: {h.num_levels}")

    bh = np.random.default_rng(1).standard_normal(L.nrows).astype(np.float32)
    x = sptrsv_solve(h, L, torch.from_numpy(bh).to(dev)).cpu().numpy()
    resid = np.abs(T @ x - bh).max() / np.abs(bh).max()
    print(f"relative residual: {resid:.2e}")
    assert resid < 1e-4
    return dict(x=x, num_supernodes=h.sn_plan.num_supernodes, max_block=h.sn_plan.max_block)


if __name__ == "__main__":
    main()
