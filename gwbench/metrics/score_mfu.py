"""The whole scoring step's share of the card's fp32 peak (67 TFLOP/s,
the unit the step computes on): the autoencoder's forward operations over
the windows the timed window scored, over its wall time, in %."""

from gwbench import costs


def read(ctx):
    flops = costs.forward_flops_per_window(ctx.config) * ctx.window.work
    return 100.0 * flops / (ctx.window.elapsed_s * costs.PEAK_FP32_FLOPS)
