"""Share of rank 0's device idle time whose innermost program span is a
halo exchange (``tpukk::dist.halo_exchange``, as the innermost span over a
gap's midpoint), read as ``solver.idle_own_pct`` is: from a stretch of whole
solves with the profiler (device intervals) and the recorder (spans) both
on.  None off the card and where the port records no such span."""
from kkbench import dist_spans


def read(ctx):
    return dist_spans.read(ctx).get("halo_idle_pct")
