"""Host µs to issue a ``dist_pcg`` iteration, from the port's own spans:
the ``tpukk::dist_pcg.block`` spans less their ``tpukk::dist_pcg.check``
spans, over the iterations of a recorded stretch of whole solves (no
profiler), on rank 0.  None where the port records no such spans."""
from kkbench import dist_spans


def read(ctx):
    return dist_spans.read(ctx).get("issue_us")
