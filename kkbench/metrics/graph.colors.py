"""Distinct colors of the cell's matrix coloring, the steps of K6's fused
sweep: the port's gauge ``graph.colors`` (set by ``graph_color``) after the
run's set-ups.  None for a mix whose preconditioner does not color, and
where the port has no counter registry."""
from kkbench import spans


def read(ctx):
    return spans.gauge(ctx, "graph.colors")
