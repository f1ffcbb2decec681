"""ODE integration — counterpart of ``examples/ode_integrate.py``: adaptive
RKDP, BDF2 on a stiff problem, a batch of systems (``rk_solve_batched``,
the port's counterpart of ``jax.vmap`` over ``rk_solve``) and adaptive BDF
on Robertson's kinetics."""
import numpy as np
import torch

from tpukk_torch.common import default_device
from tpukk_torch.ode import RKType, bdf_solve, bdf_solve_adaptive, rk_solve, rk_solve_batched


def main(device=None):
    dev = default_device(device)
    one = torch.tensor([1.0], dtype=torch.float64, device=dev)
    res = rk_solve(lambda t, y: -y, one, 0.0, 1.0, kind=RKType.RKDP)
    print(f"RKDP adaptive: y(1) = {float(res.y[0]):.8f} (exact {np.exp(-1):.8f}), "
          f"steps = {int(res.num_steps)}")

    r2 = bdf_solve(lambda t, y: -50.0 * (y - torch.cos(t)), torch.zeros_like(one), 0.0, 2.0,
                   num_steps=80, order=2)
    print(f"BDF2 stiff: y(2) = {float(r2.y[0]):.5f} (~cos(2) = {np.cos(2):.5f})")

    y0s = torch.linspace(0.5, 2.0, 16, dtype=torch.float64, device=dev)[:, None]
    ys = rk_solve_batched(lambda t, y: -y, y0s, 0.0, 1.0, kind=RKType.RK4, num_steps=50).y
    print("batched RK4:", ys[:3, 0].cpu().numpy())

    def rob(t, y):
        return torch.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                            0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                            3e7 * y[1] ** 2])

    ra = bdf_solve_adaptive(rob, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=dev),
                            0.0, 100.0, rtol=1e-6, atol=1e-9)
    print(f"adaptive BDF Robertson: y(100) = {ra.y.cpu().numpy()}, "
          f"accepted steps = {int(ra.num_steps)}")
    return dict(rk=res, bdf2=r2, batch=ys, robertson=ra)


if __name__ == "__main__":
    main()
