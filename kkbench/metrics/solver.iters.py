"""Mean iterations per solve over the window (PcgStats / GmresStats; PCG
counts in blocks of its check_every)."""


def read(ctx):
    its = [r["iters"] for r in ctx.window]
    return sum(its) / len(its) if its else None
