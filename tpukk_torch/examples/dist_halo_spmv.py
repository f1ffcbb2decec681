"""Distributed example — counterpart of ``examples/dist_halo_spmv.py``:
row-partitioned SpMV with halo exchange, then ten distributed CG steps, on
``n_ranks`` ranks of a new process group (``dist.ranks.RankPool``; gloo, or
NCCL with one card a rank where there are enough)::

    python -m tpukk_torch.examples.dist_halo_spmv
    python -c "from tpukk_torch.examples import dist_halo_spmv as m; m.main(device='cpu')"
"""
import numpy as np
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_structured_laplacian
from tpukk_torch.dist import (
    build_halo_plan,
    dist_cg_step,
    dist_spmv_halo,
    partition_rows,
    shard_halo_plan,
    shard_partition,
)
from tpukk_torch.dist.ranks import RankPool, world


def backend_for(dev: torch.device, n_ranks: int) -> str:
    """NCCL with a card a rank, else gloo (which also takes CUDA tensors)."""
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def start(dev: torch.device, n_ranks: int) -> RankPool:
    """The ranks, the kernels built first on a card."""
    if dev.type == "cuda":
        from tpukk_torch import _kernels

        _kernels.build_all()
    return RankPool(n_ranks, backend_for(dev, n_ranks))


def _rank(plan, cplan, device):
    """On each rank: its shard of y = A·1 and of the state after ten CG steps."""
    dev = torch.device(device)
    rank, _ = world()
    hp = shard_halo_plan(plan, device=dev)
    rpp = plan.rows_per_part
    x = torch.ones(plan.padded_rows, dtype=torch.float32)
    x[plan.ncols:] = 0
    y = dist_spmv_halo(hp, x[rank * rpp:(rank + 1) * rpp].to(dev))
    cp = shard_partition(cplan, device=dev)
    crpp = cplan.rows_per_part
    b = torch.zeros(cplan.padded_rows, dtype=torch.float32)
    b[:cplan.nrows] = 1.0
    bl = b[rank * crpp:(rank + 1) * crpp].to(dev)
    state = (torch.zeros_like(bl), bl.clone(), bl.clone(), float(b @ b))
    for _ in range(10):
        state = dist_cg_step(cp, state)
    return y.cpu().numpy(), state[0].cpu().numpy(), float(state[3])


def main(device=None, n_ranks: int = 4):
    dev = default_device(device)
    A = generate_structured_laplacian(64, 64, dtype=np.float32, device="cpu")
    plan = build_halo_plan(A, n_ranks)
    cplan = partition_rows(A, n_ranks)
    with start(dev, n_ranks) as pool:
        print(f"ranks: {n_ranks} on {dev.type} ({backend_for(dev, n_ranks)})")
        out = pool.run(_rank, plan, cplan, str(dev))
    y = np.concatenate([o[0] for o in out])[:A.nrows]
    print(f"halo spmv: ||y|| = {np.linalg.norm(y):.4f}, halo width = {plan.halo}")
    rr = out[0][2]
    print(f"CG 10 iters: |r|^2 = {rr:.3e}")
    return dict(y=y, x=np.concatenate([o[1] for o in out])[:A.nrows], rr=rr)


if __name__ == "__main__":
    main()
