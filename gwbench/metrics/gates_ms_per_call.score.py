"""Device time of layer 0's gate stream in a batch score, both segments,
in ms per call: the device operations launched inside the program's
``stack.gates`` spans (the time-major copy, the row-wise projection, the
casts, the bias add)."""

from gwbench import spans


def read(ctx):
    st = spans.of(ctx)
    if st is None or not st.ops:
        return None
    return 1e3 * st.device_s("stack.gates") / st.calls
