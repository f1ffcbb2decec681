from .bsr import BsrMatrix
from .ccs import CcsMatrix
from .convert import (bsr2crs, ccs2crs, coo2crs, crs2bsr, crs2ccs, crs2coo, detect_block_size,
                      expand_row_indices)
from .coo import CooMatrix
from .csr import CsrMatrix, StaticCrsGraph, expand_row_ids, torch_dtype
from .generators import (
    generate_banded_csr,
    generate_diag_dominant_csr,
    generate_fem2d_csr,
    generate_random_bsr,
    generate_random_csr,
    generate_structured_laplacian,
)
from .io import load_csr_npz, read_mtx, save_csr_npz, write_mtx
from .sort_crs import (extract_diagonal_blocks, is_sorted, remove_zeros, sort_and_merge_crs,
                       sort_by_row_size, sort_crs, symmetrize_pattern, transpose)
