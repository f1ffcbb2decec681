"""Distributed SpMV and PCG on K3 — counterpart of
``examples/dist_gt_pcg.py``: each rank's local block runs the CSR kernel
after one halo exchange (``dist.build_dist_gt_plan``: the neighbour
schedule with the interior/boundary split where it applies), and Jacobi-free
PCG runs through the same plan, on ``n_ranks`` ranks::

    python -m tpukk_torch.examples.dist_gt_pcg
    python -c "from tpukk_torch.examples import dist_gt_pcg as m; m.main(device='cpu')"
"""
import numpy as np
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_structured_laplacian
from tpukk_torch.dist import build_dist_gt_plan, dist_pcg, dist_spmv_gt, shard_dist_gt_plan
from tpukk_torch.dist.ranks import world
from tpukk_torch.examples.dist_halo_spmv import backend_for, start


def _rank(plan, x, b, device):
    """On each rank: its shard of A·x, and of the PCG solution of A·x = b."""
    dev = torch.device(device)
    rank, _ = world()
    sp = shard_dist_gt_plan(plan, device=dev)
    rows = slice(rank * plan.rows_per_part, (rank + 1) * plan.rows_per_part)
    y = dist_spmv_gt(sp, torch.from_numpy(x[rows]).to(dev))
    xs, iters, rel = dist_pcg(sp, torch.from_numpy(b[rows]).to(dev), tol=1e-5, max_iters=500)
    return y.cpu().numpy(), xs.cpu().numpy(), iters, rel


def main(device=None, n_ranks: int = 4):
    dev = default_device(device)
    A = generate_structured_laplacian(48, 48, dtype=np.float32, device="cpu")
    n = A.nrows
    plan = build_dist_gt_plan(A, n_ranks)
    if hasattr(plan, "offsets"):  # the neighbour plan
        print(f"plan: neighbour offsets={list(plan.offsets)} parts={n_ranks} "
              f"halo_total={plan.halo_total} pad={plan.pad_ratio:.2f}")
    else:
        print(f"plan: layout={plan.layout} parts={n_ranks} halo={plan.halo} "
              f"pad={plan.pad_ratio:.2f}")
    rng = np.random.default_rng(0)
    x = np.zeros(plan.padded_rows, np.float32)
    x[:n] = rng.standard_normal(n).astype(np.float32)
    b = np.zeros(plan.padded_rows, np.float32)
    b[:n] = 1.0
    with start(dev, n_ranks) as pool:
        out = pool.run(_rank, plan, x, b, str(dev))
    y = np.concatenate([o[0] for o in out])[:n]
    ref = A.to_scipy() @ x[:n]
    err = np.abs(y - ref).max() / np.abs(ref).max()
    print(f"dist SpMV rel err: {err:.2e} ({backend_for(dev, n_ranks)} on {dev.type})")
    iters, rel = out[0][2], out[0][3]
    print(f"PCG through the plan: {iters} iters, rel {rel:.2e}")
    return dict(y=y, x=np.concatenate([o[1] for o in out])[:n], iters=iters, rel=rel,
                spmv_rel_err=err)


if __name__ == "__main__":
    main()
