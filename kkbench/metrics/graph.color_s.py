"""Host seconds of the last coloring of the cell's matrix, a part of
``prep_s``: the port's gauge ``graph.color_s`` (set by ``graph_color``).
None for a mix whose preconditioner does not color, and where the port has
no counter registry."""
from kkbench import spans


def read(ctx):
    return spans.gauge(ctx, "graph.color_s")
