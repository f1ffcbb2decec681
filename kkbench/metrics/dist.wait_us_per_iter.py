"""Host µs a ``dist_pcg`` iteration waits, from the port's own spans: the
``tpukk::dist_pcg.check`` spans (each block's residual read, its one sync)
over the iterations of a recorded stretch of whole solves (no profiler), on
rank 0.  None where the port records no such spans."""
from kkbench import dist_spans


def read(ctx):
    return dist_spans.read(ctx).get("wait_us")
