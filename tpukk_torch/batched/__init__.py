"""Batched small-dense, band and sparse functions — counterpart of
``tpukk/batched`` (the reference's batched/): tensors of shape (B, ...) on
their own device, every op batched over B (``tpukk`` vmaps XLA ops; it has
no Pallas kernel here)."""
from . import banded, dense, eig as eig_mod, sparse
from .banded import (gbtrf_banded, gbtrs_banded, pbtrf_banded, pbtrs_banded,
                     tbsv_banded)
from .eig import eig, eigendecomposition, eigenvalues, hessenberg, schur
from .sparse import BatchedCrsMatrix, JacobiPrec, batched_cg, batched_gmres, batched_spmv
