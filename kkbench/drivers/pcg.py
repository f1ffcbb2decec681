"""PCG through ``tpukk_torch.sparse.pcg``: one caller solving one system
after another with the mix's preconditioner, from x0 = 0, to the
configuration's relative residual, checked every ``check_every``
iterations."""
from __future__ import annotations

from types import SimpleNamespace

from tpukk_torch.sparse import pcg

from kkbench.drivers import _port

load = _port.load
# single operations on a copy of the matrix (the per-layer rooflines' ring)
make_spmv = _port.spmv_handle
make_prec = _port.prec_only


def prepare(A, cfg: dict, mix: dict):
    """The port's set-up of the solver on A: the SpMV handle and its plan,
    the preconditioner."""
    Ah = _port.spmv_handle(A)
    prec, tables = _port.make_prec(A, mix)
    return SimpleNamespace(A=A, Ah=Ah, prec=prec, tables=tables, tol=float(cfg["rtol"]),
                           max_iters=int(mix["max_iters"]),
                           check_every=int(mix.get("check_every", 10)))


def solve(state, b):
    """(x, iterations, converged)."""
    x, st = pcg(state.Ah, b, tol=state.tol, max_iters=state.max_iters, prec=state.prec,
                check_every=state.check_every)
    return x, st.num_iters, st.converged
