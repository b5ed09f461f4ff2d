"""Windows scored over the whole timed window's wall time, calls issued
back to back by one caller."""


def read(ctx):
    return ctx.window.work / ctx.window.elapsed_s
