"""The port's own set-up of the cell's solver on its matrix, what a user
pays each time the matrix changes: the second of two complete set-ups from
the same CsrMatrix, synchronised (the first loads the kernels).  Host work
(coloring, plans) on the host's clock."""


def read(ctx):
    return ctx.prep_s
