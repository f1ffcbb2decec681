"""Banded SpGEMM — counterpart of ``examples/banded_spgemm.py``: C = A·B as an
offset convolution of diagonals (``sparse/spgemm_dia.py``).  For banded
operands with full diagonals KK routes there with the exact structural
pattern; otherwise SpgemmAlgorithm.DIA opts in to the clipped-band pattern (a
superset that may carry explicit zeros)."""
import numpy as np

from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_banded_csr, generate_structured_laplacian
from tpukk_torch.sparse import SpgemmAlgorithm, SpgemmHandle, spgemm_numeric, spgemm_symbolic


def main(device=None):
    dev = default_device(device)
    # the exact case: a full-diagonal band goes to the DIA path
    A = generate_banded_csr(2000, 3, dtype=np.float64, seed=0, device=dev)
    h = SpgemmHandle()
    spgemm_symbolic(h, A, A)
    assert h.dia_plan is not None, "KK should route full bands to DIA"
    C = spgemm_numeric(h, A, A)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    err = abs(C.to_scipy() - ref).max()
    print(f"banded A·A: nnz={C.nnz} (scipy {ref.nnz}), max err {err:.2e}")
    assert err <= 1e-12 * abs(ref).max()

    # the opt-in band pattern for a stencil matrix with diagonal holes
    L = generate_structured_laplacian(40, 40, dtype=np.float64, device=dev)
    h2 = SpgemmHandle(SpgemmAlgorithm.DIA)
    spgemm_symbolic(h2, L, L)
    C2 = spgemm_numeric(h2, L, L)
    ref2 = (L.to_scipy() @ L.to_scipy()).toarray()
    err2 = np.abs(C2.to_scipy().toarray() - ref2).max()
    print(f"laplacian A·A (clipped band): nnz={C2.nnz}, dense err {err2:.2e}")
    assert err2 <= 1e-12 * np.abs(ref2).max()
    return dict(C=C, C2=C2)


if __name__ == "__main__":
    main()
