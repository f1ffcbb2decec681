from .pcg import PcgStats, pcg
from .preconditioner import IdentityPrec, JacobiPrec, MatrixPrec, Preconditioner
from .spmv import SpmvAlgorithm, SpmvHandle, spmm, spmv
