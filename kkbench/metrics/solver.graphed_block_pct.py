"""Share of PCG's ``check_every`` blocks run as one CUDA graph's replay: 100
× the port's counters ``pcg.graph_replays`` over ``pcg.blocks``, over the
process's solves (the warm solve's first block runs as it is, and the
capture follows it).  None where the port has no such counters."""
from kkbench import spans


def read(ctx):
    blocks = spans.gauge(ctx, "pcg.blocks")
    if not blocks:
        return None
    return 100.0 * (spans.gauge(ctx, "pcg.graph_replays") or 0) / blocks
