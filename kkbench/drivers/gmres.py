"""Restarted GMRES through ``tpukk_torch.sparse.gmres``: one caller solving
one system after another with the mix's preconditioner (left-applied),
from x0 = 0, to the configuration's relative residual, checked at each
restart."""
from __future__ import annotations

from types import SimpleNamespace

from tpukk_torch.sparse import GmresHandle, Ortho, gmres

from kkbench.drivers import _port

load = _port.load
# single operations on a copy of the matrix (the per-layer rooflines' ring)
make_spmv = _port.spmv_handle
make_prec = _port.prec_only


def prepare(A, cfg: dict, mix: dict):
    Ah = _port.spmv_handle(A)
    prec, tables = _port.make_prec(A, mix)
    return SimpleNamespace(A=A, Ah=Ah, prec=prec, tables=tables, tol=float(cfg["rtol"]),
                           m=int(mix["m"]), max_restarts=int(mix["max_restarts"]),
                           ortho=Ortho[mix.get("ortho", "CGS2")])


def solve(state, b):
    h = GmresHandle(m=state.m, tol=state.tol, max_restarts=state.max_restarts,
                    ortho=state.ortho, reorder="none")
    x, st = gmres(h, state.Ah, b, prec=state.prec)
    return x, st.num_iters, st.converged
