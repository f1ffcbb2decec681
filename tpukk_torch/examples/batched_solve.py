"""Batched solves — counterpart of ``examples/batched_solve.py``
(example/batched_solve/: serial getrs, pttrs and pbtrs on many small
systems, and team GMRES on systems of one sparsity pattern)."""
import numpy as np
import torch

from tpukk_torch.batched import BatchedCrsMatrix, batched_gmres
from tpukk_torch.batched import dense as bd
from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_diag_dominant_csr


def main(device=None):
    dev = default_device(device)
    rng = np.random.default_rng(0)
    B, n = 64, 16
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)

    lu, piv, _ = bd.getrf(At)
    x = bd.getrs(lu, piv, bt)
    r = np.linalg.norm(np.einsum("bij,bj->bi", A, x.cpu().numpy()) - b)
    print(f"getrf/getrs: residual = {r:.2e}")

    d = rng.random((B, n)) + 2
    e = rng.random((B, n - 1)) * 0.5
    dd, l = bd.pttrf(torch.from_numpy(d).to(dev), torch.from_numpy(e).to(dev))
    xt = bd.pttrs(dd, l, bt)
    print("pttrf/pttrs: solved tridiagonal batch, x[0,0] =", float(xt[0, 0]))

    S = A @ np.swapaxes(A, 1, 2) / n + n * np.eye(n)
    Lc = bd.pbtrf(torch.from_numpy(S).to(dev))
    xs = bd.pbtrs(Lc, bt)
    rs = np.linalg.norm(np.einsum("bij,bj->bi", S, xs.cpu().numpy()) - b)
    print(f"pbtrf/pbtrs: residual = {rs:.2e}")

    # batched Krylov on systems of one sparsity pattern
    A0 = generate_diag_dominant_csr(40, 4, dtype=np.float64, seed=2, device=dev)
    vals = torch.stack([A0.values * (1 + 0.05 * k) for k in range(8)])
    Ab = BatchedCrsMatrix.from_csr(A0, vals)
    rhs = torch.from_numpy(rng.standard_normal((8, 40))).to(dev)
    xg, res = batched_gmres(Ab, rhs, restart=20, max_restarts=3)
    print(f"team GMRES: max residual = {float(res.max()):.2e}")
    return dict(A=A, b=b, x=x, d=d, e=e, xt=xt, S=S, xs=xs, A0=A0, rhs=rhs, xg=xg, res=res,
                residual_getrs=r, residual_pbtrs=rs)


if __name__ == "__main__":
    main()
