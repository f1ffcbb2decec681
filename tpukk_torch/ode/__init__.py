"""ODE integrators — counterpart of ``tpukk/ode`` (the reference's ode/):
explicit Runge-Kutta, fixed and adaptive BDF, Newton; each with a batched
form (``*_batched``) for many systems at once, the port's counterpart of
``jax.vmap`` over ``tpukk``'s solvers."""
from .bdf import (BDFAdaptiveResult, BDFResult, bdf_solve, bdf_solve_adaptive,
                  bdf_solve_adaptive_batched)
from .newton import NewtonResult, newton_solve
from .runge_kutta import (ButcherTableau, ODESolverStatus, RKResult, RKType, rk_solve,
                          rk_solve_batched, tableau)
