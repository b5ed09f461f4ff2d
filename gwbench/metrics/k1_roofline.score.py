"""K1's share of its roofline in a batch score: the least time the card
needs for a call's two wavefront launches (encoder and decoder, at the
model's widths) over their device time in the trace, in %."""

from gwbench import costs

KERNEL = "lstm_stack_kernel"
PER_CALL = 2


def read(ctx):
    if ctx.trace is None:
        return None
    times = [d for name, _, d in ctx.trace.ops if KERNEL in name]
    if not times or len(times) != PER_CALL * ctx.trace.calls:
        return None
    batch, t_len = ctx.traffic["batch"], ctx.config["timesteps"]
    least = sum(costs.bound_s(costs.stack_costs(seg, batch, t_len))
                for seg in costs.segments(ctx.config))
    return 100.0 * least * ctx.trace.calls / sum(times)
