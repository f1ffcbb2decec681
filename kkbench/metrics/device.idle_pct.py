"""Share of a traced stretch of whole solves in which no kernel or copy ran
on the card.  The profiler's own host cost lengthens the stretch, so this
reads above an untraced run's idle share."""


def read(ctx):
    t = ctx.trace
    if not t or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["trace_window_s"])
