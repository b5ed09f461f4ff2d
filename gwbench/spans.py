"""The program's own spans (``repro_torch.trace``) over a few calls, with
every device operation charged to the program stage that launched it.

``program_trace`` turns the program's tracing on, profiles CPU and CUDA
activity over a few calls and turns tracing off again.  Each device
operation (kernel, memcpy, memset) is charged to the innermost program
span that holds the runtime call that launched it: the profiler gives a
device operation and its launching runtime call one correlation id, so
the charge follows the launch, never the device's timeline, which runs
behind the host.  A device operation whose runtime call the profile lacks
is charged outside every span and counted (``unlinked``).  The idle
stretches of the card, the gaps between its operations, are intersected
with the host intervals of the ``score`` spans, and each is charged to the
span the host was in at its middle.

The per-layer readers take ``of(ctx)``: the reading's ``spans`` where the
harness made them, else a pass of its own over a fresh cell of the same
configuration and traffic (one pool batch, seed ``SEED``), made once per
reading.  A program without ``repro_torch.trace`` gives None, and so does a
CPU run on a machine with a card (the reading's cell ran on the CPU, and
the pass would not).  The per-span table goes to standard error.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from dataclasses import dataclass, field
from typing import Callable

import torch

from gwbench import tracing

#: runtime and driver API calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
#: ``cudaMemcpyAsync``, ...): the host side of a device operation
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
#: the seed of the readers' own pass (its inputs and weights; the work of a
#: call does not depend on their values)
SEED = 1
TOP_SPAN = "score"


@dataclass
class SpanTrace:
    """``ops``: [(path, name, start s, duration s)] of every device
    operation, ``path`` the program spans around its launch, outermost
    first (empty: outside every span).  ``spans``: [(path, start s,
    duration s)] of every program span on the host, ``path`` ending in its
    own name.  ``busy_s``: the card's busy time inside the ``score`` spans;
    ``idle``: {path: s} its idle time there, each stretch charged to the
    innermost span the host was in at the stretch's middle.  ``unlinked``:
    operations whose launching runtime call the profile lacks.
    ``launches``: the kernel wrappers' launch counts over the calls."""

    calls: int
    ops: list
    spans: list
    busy_s: float = 0.0
    idle: dict = field(default_factory=dict)
    unlinked: int = 0
    launches: dict = field(default_factory=dict)

    @property
    def idle_s(self) -> float:
        return sum(self.idle.values())

    def device_s(self, *names: str) -> float:
        """Device seconds charged to the spans called ``names`` themselves."""
        return sum(d for path, _, _, d in self.ops if path and path[-1] in names)

    def in_span(self, name: str = TOP_SPAN) -> list:
        """The operations launched inside a span called ``name``."""
        return [op for op in self.ops if name in op[0]]

    def table(self) -> list:
        """[[span path, device ms, device operations, host ms]] a call."""
        rows: dict = {}
        for path, _, dur in self.spans:
            rows.setdefault(path, [0.0, 0, 0.0])[2] += dur
        for path, _, _, dur in self.ops:
            row = rows.setdefault(path, [0.0, 0, 0.0])
            row[0] += dur
            row[1] += 1
        n = self.calls
        return [["/".join(path) or "(outside spans)", 1e3 * dev / n, ops / n, 1e3 * host / n]
                for path, (dev, ops, host) in sorted(rows.items())]


def _innermost(spans: list, thread, t: float) -> tuple:
    inner = [(b - a, path) for path, th, a, b in spans if th == thread and a <= t <= b]
    return min(inner)[1] if inner else ()


def _span_paths(marks: list) -> list:
    """[(path, thread, start, end)] of the program spans, each path the
    names of the spans that contain it, outermost first, on its thread."""
    out = []
    by_thread: dict = {}
    for e in marks:
        by_thread.setdefault(e.thread, []).append(e)
    for thread, group in by_thread.items():
        stack: list = []
        for e in sorted(group, key=lambda e: (e.time_range.start, -e.time_range.end)):
            a, b = e.time_range.start, e.time_range.end
            while stack and not (stack[-1][2] <= a and b <= stack[-1][3]):
                stack.pop()
            path = (stack[-1][0] if stack else ()) + (e.name.split(" ")[0],)
            stack.append((path, thread, a, b))
            out.append(stack[-1])
    return out


def charge(events, n_calls: int) -> SpanTrace:
    """Reduce a profile's events (``prof.events()``) to a ``SpanTrace``."""
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    marks = [e for e in host if getattr(e, "is_user_annotation", False)
             and e.name != tracing.WINDOW]
    names = {e.name for e in marks} | {tracing.WINDOW}
    spans = _span_paths(marks)
    runtime = {e.id: e for e in host if RUNTIME.match(e.name)}
    # device events, less the window markers and the profiler's device-side
    # copies of the host annotations (no operations)
    device = sorted((e for e in events if e.device_type != cpu
                     and tracing.SPIN not in e.name and e.name not in names),
                    key=lambda e: e.time_range.start)
    us = 1e-6
    ops, unlinked = [], 0
    for e in device:
        r = runtime.get(e.id)
        unlinked += r is None
        path = () if r is None else _innermost(spans, r.thread, r.time_range.start)
        ops.append((path, e.name, e.time_range.start * us,
                    (e.time_range.end - e.time_range.start) * us))
    busy, idle = 0.0, {}
    intervals = sorted((a, a + d) for _, _, a, d in ops)
    for path, thread, a, b in spans:
        if path != (TOP_SPAN,):
            continue
        a, b = a * us, b * us
        inside = [(max(x, a), min(y, b)) for x, y in intervals if y > a and x < b]
        busy += tracing.union_s(inside)
        at = a
        for x, y in inside + [(b, b)]:
            if x > at:   # an idle stretch: charged to the span the host is in at its middle
                where = _innermost(spans, thread, (at + x) / 2 / us)
                idle[where] = idle.get(where, 0.0) + x - at
            at = max(at, y)
    return SpanTrace(calls=n_calls, ops=ops,
                     spans=[(path, a * us, (b - a) * us) for path, _, a, b in spans],
                     busy_s=busy, idle=idle, unlinked=unlinked)


def _launch_counts() -> dict:
    from repro_torch.kernels.lstm_stack import lstm_stack
    from repro_torch.kernels.rowwise import rowwise_matmul

    return {"lstm_stack": lstm_stack.launches, "rowwise_matmul": rowwise_matmul.launches}


def program_trace(call: Callable[[int], object], first: int, n_calls: int) -> SpanTrace | None:
    """Profile ``call(first) ... call(first + n_calls - 1)`` with the
    program's tracing on; None where the program has no spans."""
    if importlib.util.find_spec("repro_torch.trace") is None:
        return None
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = _launch_counts()
    with trace.tracing(), profile(activities=activities) as prof:
        if cuda:
            tracing._lead_in()
        for i in range(first, first + n_calls):
            call(i)
        if cuda:
            torch.cuda.synchronize()
    out = charge(prof.events(), n_calls)
    out.launches = {k: v - before[k] for k, v in _launch_counts().items()}
    return out


def report(st: SpanTrace, err=sys.stderr) -> None:
    """The per-span table, and the two checks: the charged device time
    against the busy time inside ``score``, and the kernels' launches
    charged a call against their wrappers' counts."""
    print(f"spans: {st.calls} calls; per call: span | device ms | device ops | host ms",
          file=err)
    for path, dev, ops, host in st.table():
        print(f"spans: {path} | {dev:.4f} | {ops:g} | {host:.4f}", file=err)
    inside = sum(d for _, _, _, d in st.in_span())
    print(f"spans: device ms charged inside score {1e3 * inside / st.calls:.4f}, busy "
          f"{1e3 * st.busy_s / st.calls:.4f}, idle {1e3 * st.idle_s / st.calls:.4f}; "
          f"unlinked operations {st.unlinked}", file=err)
    by_span = {"/".join(k): round(1e3 * v / st.calls, 4) for k, v in sorted(st.idle.items())}
    print(f"spans: idle ms a call by the host's span {by_span}", file=err)
    for kernel, wrapper in (("lstm_stack_kernel", "lstm_stack"), ("rowwise_kernel", "rowwise_matmul")):
        where: dict = {}
        for path, name, _, dur in st.ops:
            if kernel in name:
                row = where.setdefault("/".join(path), [0, 0.0])
                row[0] += 1
                row[1] += dur
        per_call = {k: [n / st.calls, 1e3 * d / st.calls] for k, (n, d) in where.items()}
        print(f"spans: {kernel} a call by span [launches, ms] {per_call}, total ms "
              f"{sum(d for _, d in per_call.values()):.4f}; {wrapper}.launches a call "
              f"{st.launches.get(wrapper, 0) / st.calls:g}", file=err)


def of(ctx) -> SpanTrace | None:
    """The span trace of a reading: the harness's (``ctx.spans``), else
    this module's own pass, kept on the reading for the other readers."""
    if "spans" not in vars(ctx):
        ctx.spans = _own_pass(ctx)
    return ctx.spans


def _own_pass(ctx) -> SpanTrace | None:
    if importlib.util.find_spec("repro_torch.trace") is None:
        return None
    cuda = ctx.trace is not None
    if not cuda and torch.cuda.is_available():
        return None
    from gwbench import harness

    traffic = dict(ctx.traffic)
    if "pool_calls" in traffic:
        traffic["pool_calls"] = 1
    cell = harness.load_module("drivers", traffic["driver"]).Cell(
        ctx.config, traffic, SEED, "cuda" if cuda else "cpu")
    cell.setup()
    cell.keep_answers = False
    try:
        st = program_trace(cell.call, 0, traffic["gap_calls"])
    finally:
        cell.release()
    if st is not None:
        report(st)
    return st
