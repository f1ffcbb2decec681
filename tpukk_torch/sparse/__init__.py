from .gauss_seidel import (ClusteringAlgorithm, GsAlgorithm, GsHandle, backward_sweep,
                           forward_sweep, gauss_seidel_apply, gauss_seidel_numeric,
                           gauss_seidel_symbolic, symmetric_sweep)
from .gmres import GmresHandle, GmresStats, Ortho, gmres
from .mdf import MdfHandle, mdf_numeric, mdf_ordering, mdf_symbolic
from .par_ilut import ParIlutHandle, par_ilut, par_ilut_numeric, par_ilut_symbolic
from .pcg import PcgStats, pcg
from .preconditioner import GsPrec, IdentityPrec, JacobiPrec, LUPrec, MatrixPrec, Preconditioner
from .spadd import SpaddHandle, bspadd, spadd, spadd_numeric, spadd_symbolic
from .spgemm import (SpgemmAlgorithm, SpgemmHandle, bspgemm, bspgemm_numeric,
                     bspgemm_symbolic, spgemm, spgemm_jacobi, spgemm_numeric, spgemm_symbolic)
from .spiluk import (IlukRefreshPlan, SpilukHandle, build_iluk_refresh, refresh_to_csr,
                     spiluk_numeric, spiluk_refresh, spiluk_symbolic)
from .spmv import SpmvAlgorithm, SpmvHandle, spmm, spmv
from .sptrsv import SptrsvAlgorithm, SptrsvHandle, sptrsv_solve, sptrsv_symbolic
from .sptrsv_cholmod import CholmodSolve, cholmod_import, cholmod_raw_to_csr
from .sptrsv_superlu import SuperLUSolve, superlu_import
from .trsv import trsv
