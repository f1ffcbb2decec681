"""Host µs to issue a solver iteration, from the port's own spans: the
``tpukk::pcg.block`` / ``tpukk::gmres.block`` spans less their ``.check``
spans, over the iterations of a recorded stretch of whole solves (no
profiler).  None off the card and where the port records no spans."""
from kkbench import spans


def read(ctx):
    return spans.read(ctx).get("issue_us")
