"""Device time of the score's tail in a batch score, in ms per call: the
device operations launched inside the program's ``head`` and ``error``
spans (the dense head's copy, product and bias; the squared error, its
row-wise sums and the divide)."""

from gwbench import spans


def read(ctx):
    st = spans.of(ctx)
    if st is None or not st.ops:
        return None
    return 1e3 * st.device_s("head", "error") / st.calls
