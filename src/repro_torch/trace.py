"""Spans of the port's program stages, on the clock of ``torch.profiler``.

``span(name)`` marks a stage of the program.  Tracing is off by default,
and then ``span`` returns one shared no-op context: it allocates nothing,
never synchronises and never touches the device.  With tracing on
(``enable(True)`` or ``with tracing():``), a span opens
``torch.profiler.record_function(name)``.  A profiler that records CPU
activity then holds it as a user annotation on the same clock as the
device operations, nested in the span that encloses it, and links each
device operation to the runtime call that launched it, so a profile can
charge every operation to the stage that caused it.  Outside a profiler a
span records nothing.  Whoever runs the profiler reads the spans.

The batch score (``AnomalyStreamEngine.score``) opens, in its order:

    score               the whole call, labelled with the engine's call
                        number and the batch's window count
                        (``score call=3 windows=73728``)
      score.plan        plan lookup and bind of both segments
      score.stage_in    the batch copied to the device
      encode, decode    one segment each; ``decode`` holds the
                        RepeatVector expand and the dense head
        stack.pad       zero or packed initial state, input padded to the
                        pack width (the decoder's repeat: one (B, 1, W) slice)
        stack.gates     layer 0's gate stream: the time-major copy, the
                        row-wise projection, casts, int8 scales, the bias
                        (the decoder's: over its B rows once, a view of
                        time stride 0 over the window)
        stack.k1        the wavefront kernel, its operand casts and outputs
        head            the dense head: reshape, row-wise product, bias
      error             squared error and each window's row-wise sum
      score.fetch       the device-to-host copy of the scores and its wait

The ``stack.*`` spans are in shared code, so the other paths that run the
wavefront kernel (``fused_step``, ``mixed``, sharded, streaming) open them
too.  Opened while a CUDA graph is captured, a span is on the host alone.

Beside the spans, the kernel wrappers count their launches on the card:
``lstm_stack.launches`` (the wavefront kernel, 2 a batch score), the same
by path in ``lstm_stack.launches_by_path`` (keyed by ``kernel_path``'s
kind: at a large batch gw_nominal's 2 are ``"blocked"``, gw_small's 2
``"row_thread"``), of them ``lstm_stack.repeated_input_launches`` (layer
0's stream of time stride 0: the decoder's, 1 a batch score) and
``lstm_stack.trimmed_launches`` (row-blocked at the layers' own widths:
gw_nominal's 2 a batch score, gw_small's none), ``lstm_stack_step.launches`` and
``rowwise_matmul.launches`` (4 a batch score).
"""

from __future__ import annotations

import contextlib

from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Turn tracing on or off for the whole process."""
    global _on
    _on = bool(on)


def span(name: str, args: dict | None = None):
    """A context marking one program stage: with tracing on, a profiler
    annotation labelled ``name``, followed by ``args`` as ``key=value``
    words where given (the label's first word is the span's name); the
    shared no-op context with tracing off."""
    if not _on:
        return _OFF
    if args:
        name = " ".join([name] + [f"{k}={v}" for k, v in args.items()])
    return record_function(name)


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing on (or off) inside the block, as it was after it."""
    before = _on
    enable(on)
    try:
        yield
    finally:
        enable(before)
