"""GMRES example — counterpart of ``examples/gmres_ex_real_A.py``
(example/gmres/ex_real_A.cpp:26-113: build a matrix, solve with restarted
GMRES, then with an ILU(0) preconditioner; example/gmres/test_prec.cpp)."""
import numpy as np
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_diag_dominant_csr
from tpukk_torch.sparse import (GmresHandle, LUPrec, SpilukHandle, gmres, spiluk_numeric,
                                spiluk_symbolic)


def main(device=None):
    dev = default_device(device)
    A = generate_diag_dominant_csr(400, 8, dtype=np.float64, seed=1, device=dev)
    b = torch.ones(A.nrows, dtype=torch.float64, device=dev)

    h = GmresHandle(m=25, tol=1e-8, max_restarts=40)
    x, stats = gmres(h, A, b)
    print(f"plain GMRES: converged={stats.converged} iters={stats.num_iters} "
          f"rel_res={stats.end_rel_res:.2e}")

    kh = SpilukHandle(fill_level=0)
    spiluk_symbolic(kh, A)
    L, U = spiluk_numeric(kh, A)
    h2 = GmresHandle(m=25, tol=1e-8, max_restarts=40)
    x2, stats2 = gmres(h2, A, b, prec=LUPrec(L, U))
    print(f"ILU(0)-GMRES: converged={stats2.converged} iters={stats2.num_iters} "
          f"rel_res={stats2.end_rel_res:.2e}")
    assert stats.converged and stats2.converged
    assert stats2.num_iters <= stats.num_iters
    return dict(x=x, stats=stats, x_ilu=x2, stats_ilu=stats2)


if __name__ == "__main__":
    main()
