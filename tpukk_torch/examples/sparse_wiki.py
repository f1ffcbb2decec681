"""Sparse wiki samples — counterpart of ``examples/sparse_wiki.py``
(example/wiki/sparse/: spmv, spadd, spgemm, gauss_seidel, bsrmatrix).  The
BSR SpMV takes AUTO's route for a banded block graph: DIA on its scalar
expansion (K1 on the card)."""
import numpy as np
import torch

from tpukk_torch.common import default_device
from tpukk_torch.containers import CsrMatrix, crs2bsr, generate_structured_laplacian
from tpukk_torch.sparse import (GsAlgorithm, GsHandle, gauss_seidel_apply, gauss_seidel_numeric,
                                gauss_seidel_symbolic, spadd, spgemm, spmv)


def main(device=None):
    dev = default_device(device)
    A = generate_structured_laplacian(32, 32, dtype=np.float32, device=dev)
    x = torch.ones(A.ncols, dtype=torch.float32, device=dev)

    y = spmv(A, x, alpha=1.0, beta=0.0)
    print("spmv:   ||A·1|| =", float(torch.linalg.norm(y)))

    C = spadd(1.0, A, 1.0, A)
    print("spadd:  nnz(A+A) =", C.nnz)

    C2 = spgemm(A, A)
    print("spgemm: nnz(A·A) =", C2.nnz)

    B = crs2bsr(generate_structured_laplacian(64, dtype=np.float32, device=dev), 4)
    yb = spmv(B, torch.ones(B.ncols, dtype=torch.float32, device=dev))
    print("bsr spmv: ||B·1|| =", float(torch.linalg.norm(yb)))

    sp = A.to_scipy()
    sp.setdiag(sp.diagonal() + 1.0)
    Add = CsrMatrix.from_scipy(sp.tocsr(), device=dev)
    h = GsHandle(GsAlgorithm.POINT)
    gauss_seidel_symbolic(h, Add)
    gauss_seidel_numeric(h, Add)
    b = torch.ones(Add.nrows, dtype=torch.float32, device=dev)
    xs = gauss_seidel_apply(h, Add, None, b, num_sweeps=5)
    bh = b.cpu().numpy()
    r = np.linalg.norm(sp @ xs.cpu().numpy() - bh) / np.linalg.norm(bh)
    print(f"gauss_seidel: rel residual after 5 sweeps = {r:.3e}")
    return dict(y=y, C=C, C2=C2, yb=yb, xs=xs, rel_res=r)


if __name__ == "__main__":
    main()
