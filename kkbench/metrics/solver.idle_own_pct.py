"""Share of the device's idle time that lies under the solver's own spans
(``tpukk::pcg``/``gmres``, their ``.block`` and ``.check``, as the innermost
span over a gap's midpoint): the solver's own host work and waits, not a
layer below it.  Read from a stretch of whole solves with the profiler
(device intervals) and the recorder (spans) both on.  None off the card
and where the port records no spans."""
from kkbench import spans


def read(ctx):
    return spans.read(ctx).get("idle_own_pct")
