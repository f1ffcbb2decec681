"""Host µs a solver iteration waits for the device, from the port's own
spans: the ``tpukk::pcg.check`` / ``tpukk::gmres.check`` spans (each
block's residual read, its one sync) over the iterations of a recorded
stretch of whole solves (no profiler).  None off the card and where the
port records no spans."""
from kkbench import spans


def read(ctx):
    return spans.read(ctx).get("wait_us")
