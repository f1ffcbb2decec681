"""RCM-reorder solving — counterpart of ``examples/rcm_reorder_solve.py``.

On mesh-like unstructured matrices RCM collapses the bandwidth, so the
permutes pay for themselves in iterative use, not in a one-shot SpMV:

* ``SpmvHandle(A, SpmvAlgorithm.RCM)``: the matvec with the permutes (K5)
  folded in;
* ``handle.rcm_permuted()``: the permuted-space interface (convert once,
  iterate in permuted space);
* ``gmres(GmresHandle(reorder="auto"), A, b)``: the solver does this by
  itself when RCM cuts the bandwidth at least 4×.

Reference analog: the structure-exploiting algorithm selection of
sparse/impl/KokkosSparse_spmv_impl.hpp:221-377."""
import numpy as np
import scipy.sparse as sps
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import CsrMatrix, generate_fem2d_csr
from tpukk_torch.sparse import GmresHandle, SpmvAlgorithm, SpmvHandle, gmres


def _bandwidth(s):
    rows = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
    return int(np.abs(rows - s.indices).max(initial=0))


def main(device=None):
    dev = default_device(device)
    sp = generate_fem2d_csr(1200, seed=11, device="cpu").to_scipy().tocsr()
    sp = (sp + 4.0 * sps.eye(sp.shape[0], format="csr")).tocsr()
    A = CsrMatrix.from_scipy(sp.astype(np.float32), device=dev)

    # the explicit RCM route: the same answer, the permutes folded in
    h = SpmvHandle(A, SpmvAlgorithm.RCM)
    xh = np.random.default_rng(0).standard_normal(A.ncols).astype(np.float32)
    x = torch.from_numpy(xh).to(dev)
    y = h.matvec(x).cpu().numpy()
    ref = sp @ xh
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5

    # the permuted-space interface: the bandwidth really collapsed
    ph, to_p, from_p = h.rcm_permuted()
    b_before, b_after = _bandwidth(sp), _bandwidth(ph.A.to_scipy().tocsr())
    assert b_after < b_before
    yp = from_p(ph.matvec(to_p(x))).cpu().numpy()
    assert np.abs(yp - ref).max() / np.abs(ref).max() < 1e-5

    # GMRES runs its whole Krylov loop in RCM space by itself
    b = torch.ones(A.nrows, dtype=torch.float32, device=dev)
    xs, stats = gmres(GmresHandle(m=40, tol=1e-6, reorder="auto"), A, b)
    r = sp @ xs.cpu().numpy().astype(np.float64) - 1.0
    rel = np.linalg.norm(r) / np.sqrt(A.nrows)
    assert stats.converged and rel < 1e-5
    print(f"bandwidth {b_before} -> {b_after}; gmres iters={stats.num_iters} rel={rel:.2e}")
    return dict(y=y, bandwidth=(b_before, b_after), x=xs, stats=stats)


if __name__ == "__main__":
    main()
