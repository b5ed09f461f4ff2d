"""The device trace of a few timed calls, reduced to what the per-layer
readers take: the device operations inside the traced window, the
window's length and the time some operation ran.

The window is bracketed on the device itself by two short spin kernels,
launched just before the first call and just after the last one has
returned (every call ends by reading its result back, so the card is
idle when the end marker is queued): the window is what the card saw,
and the trace records the device alone, which keeps tens of thousands of
operations cheap to record.  Eight longer spins come first because the
first device events of a trace can go unrecorded.

``host_gaps`` traces the host too, over fewer calls, and names what the
host was doing in each stretch the card sat idle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

SPIN = "spin_kernel"
#: the host-side annotation of ``host_gaps``'s window (the profiler mirrors
#: it on the device's timeline, where it is no operation)
WINDOW = "gwbench.window"
#: spin kernels that absorb the events a trace can drop at its start
LEAD_SPINS = 8
#: entries of a breakdown list
TOP = 10


@dataclass
class Trace:
    """Device operations [(name, start s, duration s)] inside the window,
    the window's length, and the time covered by at least one of them."""

    ops: list
    window_s: float
    busy_s: float
    calls: int

    def top_ops(self) -> list:
        by_name: dict = {}
        for name, _, dur in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:120], secs] for name, secs in ranked]


def _device_events(prof) -> list:
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
    return sorted(out, key=lambda e: e[1])


def _lead_in() -> None:
    for _ in range(LEAD_SPINS):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()
    time.sleep(0.02)


def union_s(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def device_trace(call: Callable[[int], object], first: int, n_calls: int) -> Trace | None:
    """Trace ``call(first) ... call(first + n_calls - 1)``; None where the
    trace lost a window marker."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in()
        torch.cuda._sleep(1000)
        for i in range(first, first + n_calls):
            call(i)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = _device_events(prof)
    spins = [e for e in events if SPIN in e[0]]
    if len(spins) < 2:
        return None
    w0, w1 = spins[-2][2], spins[-1][1]
    ops = [(n, a, b - a) for n, a, b in events if SPIN not in n and a >= w0 and b <= w1]
    busy = union_s([(a, a + d) for _, a, d in ops])
    return Trace(ops=ops, window_s=w1 - w0, busy_s=busy, calls=n_calls)


def host_gaps(call: Callable[[int], object], first: int, n_calls: int) -> list:
    """[[host operation, idle seconds]]: the stretches of the traced window
    with nothing on the card, each charged to the innermost host operation
    running at its middle, summed by name, longest first."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _lead_in()
        with record_function(WINDOW):
            for i in range(first, first + n_calls):
                call(i)
            torch.cuda.synchronize()
    host, window = [], None
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.name == WINDOW:
            window = span
        else:
            host.append((e.name, *span))
    if window is None:
        return []
    busy = [(a, b) for n, a, b in _device_events(prof)
            if SPIN not in n and n != WINDOW and b > window[0] and a < window[1]]
    gaps, at = [], window[0]
    for a, b in sorted(busy):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if window[1] > at:
        gaps.append((at, window[1]))
    by_name: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [(s, n) for n, s, e in host if s <= mid <= e]
        name = max(inner)[1] if inner else "(host Python between operations)"
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:120], secs] for name, secs in ranked]
