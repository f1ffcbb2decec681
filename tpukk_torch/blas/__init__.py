"""BLAS 1/2/3 — counterpart of ``tpukk/blas`` (the names it exports)."""
from . import blas1, blas2, blas3
from .blas1 import (
    abs,  # noqa: A004
    axpby,
    axpy,
    dot,
    fill,
    iamax,
    mult,
    nrm1,
    nrm2,
    nrm2_squared,
    nrm2w,
    nrminf,
    reciprocal,
    rot,
    rotg,
    rotm,
    rotmg,
    scal,
    set,  # noqa: A004
    sum,  # noqa: A004
    swap,
    update,
)
from .blas2 import gemv, ger, syr, syr2
from .blas3 import gemm, trmm, trsm
