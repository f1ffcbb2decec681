from .gauss_seidel import (ClusteringAlgorithm, GsAlgorithm, GsHandle, backward_sweep,
                           forward_sweep, gauss_seidel_apply, gauss_seidel_numeric,
                           gauss_seidel_symbolic, symmetric_sweep)
from .gmres import GmresHandle, GmresStats, Ortho, gmres
from .pcg import PcgStats, pcg
from .preconditioner import GsPrec, IdentityPrec, JacobiPrec, LUPrec, MatrixPrec, Preconditioner
from .spiluk import SpilukHandle, spiluk_numeric, spiluk_symbolic
from .spmv import SpmvAlgorithm, SpmvHandle, spmm, spmv
from .sptrsv import SptrsvAlgorithm, SptrsvHandle, sptrsv_solve, sptrsv_symbolic
from .trsv import trsv
