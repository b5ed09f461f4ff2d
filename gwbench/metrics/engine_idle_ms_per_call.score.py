"""Time the card sits idle inside the program's ``score`` spans, in ms per
call: the gaps between device operations, intersected with each call's
host interval.  Read under a CPU and CUDA profile, which slows the host,
so it reads high."""

from gwbench import spans


def read(ctx):
    st = spans.of(ctx)
    if st is None or not st.ops:
        return None
    return 1e3 * st.idle_s / st.calls
