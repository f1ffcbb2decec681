"""The cell's preconditioner apply through its public entry on the cell's
matrix: its compulsory bytes over the card's published bandwidth, over its
time (slope over CUDA graphs, L2 cold)."""


def read(ctx):
    return ctx.roofline_pct("prec")
