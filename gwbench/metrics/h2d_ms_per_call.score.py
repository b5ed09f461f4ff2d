"""Device time of the host-to-device copies of one batch score (the
engine staging the windows), in ms per call."""


def read(ctx):
    if ctx.trace is None:
        return None
    times = [d for name, _, d in ctx.trace.ops if name.startswith("Memcpy HtoD")]
    if not times:
        return None
    return 1e3 * sum(times) / ctx.trace.calls
