"""Device operations (kernels, copies, fills) a batch score launches, per
call: those launched inside the program's ``score`` spans."""

from gwbench import spans


def read(ctx):
    st = spans.of(ctx)
    if st is None or not st.ops:
        return None
    return len(st.in_span()) / st.calls
