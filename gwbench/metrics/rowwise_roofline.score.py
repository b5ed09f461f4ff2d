"""The row-wise kernel's share of its roofline in a batch score: the least
time for a call's four products (the two layer-0 input projections, the
dense head, the error sums), at the model's widths, over their device
time in the trace, in %."""

from gwbench import costs

KERNEL = "rowwise_kernel"
PER_CALL = 4


def read(ctx):
    if ctx.trace is None:
        return None
    times = [d for name, _, d in ctx.trace.ops if KERNEL in name]
    if not times or len(times) != PER_CALL * ctx.trace.calls:
        return None
    least = sum(costs.bound_s(c)
                for c in costs.score_products(ctx.config, ctx.traffic["batch"]))
    return 100.0 * least * ctx.trace.calls / sum(times)
