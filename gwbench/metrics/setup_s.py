"""Set-up: from the process's start to the first timed call (imports,
inputs and weights from the seed, the kernels built or loaded, the cell's
own shapes warmed)."""


def read(ctx):
    return ctx.setup_s
