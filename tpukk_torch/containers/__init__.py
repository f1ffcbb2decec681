from .csr import CsrMatrix, StaticCrsGraph, expand_row_ids, torch_dtype
from .generators import (
    generate_banded_csr,
    generate_diag_dominant_csr,
    generate_fem2d_csr,
    generate_random_csr,
    generate_structured_laplacian,
)
from .io import read_mtx
from .sort_crs import is_sorted, transpose
