"""Halo exchanges per ``dist_pcg`` iteration: the port's counter
``dist.halo_exchanges`` (one a call of ``tpukk_torch.dist.ranks.exchange``)
over a recorded stretch of whole solves, over their iterations.  With the
distributed symmetric Gauss-Seidel, 2 × colors an apply and one a SpMV: 2 ×
colors + 1 an iteration, and the apply before the loop, 2 × colors a solve.
The dot products' all_reduces are not exchanges.  None where the port has
no such counter."""
from kkbench import dist_spans


def read(ctx):
    return dist_spans.read(ctx).get("exchanges_per_iter")
