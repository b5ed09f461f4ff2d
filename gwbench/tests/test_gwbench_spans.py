"""The span readers (``gwbench/spans.py`` and the four ``program_span``
metrics): each reader on a hand-built ``SpanTrace``, nothing without
spans, the charge of a device operation by its launching runtime call
(never by time overlap; outside every span where the link is missing),
and a CPU run with ``--trace 1`` that runs the program's spans and leaves
the result line as it was."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from gwbench import harness, spans, tracing

MANIFEST = harness.load_manifest()
CELLS = ["gw_nominal.score_b73728", "gw_small.score_b294912"]
NEW = {"gates_ms_per_call.score": ("ms", "whole step"),
       "tail_ms_per_call.score": ("ms", "whole step"),
       "engine_idle_ms_per_call.score": ("ms", "engines"),
       "device_ops_per_call.score": ("ops", "whole step")}
SMALL_SCORE = {"batch": 4, "pool_calls": 2, "keep_stride": 1, "warmup_calls": 1,
               "gap_calls": 2}
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def hand_built() -> spans.SpanTrace:
    """Two calls: gates 3 + 5 ms, head 1 ms, error 2 ms, a copy outside
    every span, idle 0.5 ms a call."""
    enc, dec = ("score", "encode"), ("score", "decode")
    ops = [(enc + ("stack.gates",), "proj", 0.000, 0.003),
           (enc + ("stack.k1",), "k1", 0.003, 0.010),
           (dec + ("stack.gates",), "proj", 0.013, 0.005),
           (dec + ("head",), "head", 0.018, 0.001),
           (("score", "error"), "err", 0.019, 0.002),
           ((), "copy", 0.030, 0.001)]
    return spans.SpanTrace(calls=2, ops=ops, spans=[(("score",), 0.0, 0.022)],
                           busy_s=0.021, idle={("score",): 0.0004,
                                               ("score", "score.stage_in"): 0.0006})


def reading(**extra) -> harness.Reading:
    ctx = harness.Reading(CELLS[0], {}, {}, 1.0, harness.Window(1.0, 1, 1, 0))
    for k, v in extra.items():
        setattr(ctx, k, v)
    return ctx


@pytest.mark.parametrize("name,want", [("gates_ms_per_call.score", 4.0),
                                       ("tail_ms_per_call.score", 1.5),
                                       ("engine_idle_ms_per_call.score", 0.5),
                                       ("device_ops_per_call.score", 2.5)])
def test_each_reader_on_a_hand_built_trace(name, want):
    got = harness.load_module("metrics", name).read(reading(spans=hand_built()))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(NEW))
def test_no_spans_or_no_device_ops_read_nothing(name):
    reader = harness.load_module("metrics", name)
    assert reader.read(reading(spans=None)) is None
    assert reader.read(reading(spans=spans.SpanTrace(calls=2, ops=[], spans=[]))) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    """Laid over a parent without ``repro_torch.trace``, the readers make
    no pass and return None."""
    real = spans.importlib.util.find_spec
    monkeypatch.setattr(spans.importlib.util, "find_spec",
                        lambda n, *a: None if n == "repro_torch.trace" else real(n, *a))
    ctx = reading()
    assert harness.load_module("metrics", name).read(ctx) is None
    assert ctx.spans is None


def test_the_new_entries_are_program_spans_of_both_cells():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    names = [m["name"] for m in MANIFEST["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for name, (unit, layer) in NEW.items():
        m = entries[name]
        assert (m["unit"], m["layer"], m["source"]) == (unit, layer, "program_span")
        assert m["better"] == "lower" and m["moves"] == "score_windows_per_s"
        assert m["workloads"] == CELLS


def event(name, device, start, end, id=0, thread=1, mark=False):
    return SimpleNamespace(name=name, device_type=device, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=mark)


def test_device_ops_are_charged_by_their_launch_not_by_overlap():
    """The card runs behind the host: the kernel launched in ``stack.gates``
    runs while the host is in ``stack.k1``, and is charged to the gates."""
    events = [
        event(f"{spans.TOP_SPAN} call=1 windows=4", CPU, 0, 100, mark=True),
        event("encode", CPU, 10, 80, mark=True),
        event("stack.gates", CPU, 10, 20, mark=True),
        event("stack.k1", CPU, 20, 80, mark=True),
        event("cudaLaunchKernel", CPU, 12, 13, id=7),
        event("cudaLaunchKernel", CPU, 22, 23, id=8),
        event("cudaMemcpyAsync", CPU, 85, 86, id=9),
        event("proj_kernel", CUDA, 25, 40, id=7),
        event("k1_kernel", CUDA, 40, 90, id=8),
        event("Memcpy DtoH", CUDA, 92, 94, id=9),
        event("stack.gates", CUDA, 25, 40, mark=True),   # the profiler's device copy
        event(tracing.SPIN, CUDA, 0, 1, id=3),
    ]
    st = spans.charge(events, 1)
    assert [(path, name) for path, name, _, _ in st.ops] == [
        (("score", "encode", "stack.gates"), "proj_kernel"),
        (("score", "encode", "stack.k1"), "k1_kernel"),
        (("score",), "Memcpy DtoH")]
    assert st.device_s("stack.gates") == pytest.approx(15e-6)
    assert st.unlinked == 0
    assert st.busy_s == pytest.approx(67e-6) and st.idle_s == pytest.approx(33e-6)
    # idle 0-25 (middle 12.5: the host in stack.gates), 90-92 and 94-100 (in score)
    assert st.idle == pytest.approx({("score", "encode", "stack.gates"): 25e-6,
                                     ("score",): 8e-6})
    assert [p for p, _, _ in st.spans] == [("score",), ("score", "encode"),
                                           ("score", "encode", "stack.gates"),
                                           ("score", "encode", "stack.k1")]


def test_an_op_without_its_runtime_call_is_charged_outside_and_counted():
    """Never to the span it happens to overlap on the device's timeline."""
    events = [
        event("score", CPU, 0, 100, mark=True),
        event("head", CPU, 10, 60, mark=True),
        event("cudaLaunchKernel", CPU, 12, 13, id=2),
        event("head_kernel", CUDA, 20, 30, id=2),
        event("lost_kernel", CUDA, 40, 50, id=5),
    ]
    st = spans.charge(events, 1)
    assert [(path, name) for path, name, _, _ in st.ops] == [
        (("score", "head"), "head_kernel"), ((), "lost_kernel")]
    assert st.unlinked == 1
    assert len(st.in_span()) == 1


def test_the_table_is_per_call():
    rows = {r[0]: r[1:] for r in hand_built().table()}
    assert rows["score/encode/stack.gates"] == pytest.approx([1.5, 0.5, 0.0])
    assert rows["(outside spans)"] == pytest.approx([0.5, 0.5, 0.0])
    assert rows["score"] == pytest.approx([0.0, 0.0, 11.0])


@pytest.mark.parametrize("workload", CELLS)
def test_a_cpu_traced_run_runs_the_spans_and_keeps_its_line(workload, monkeypatch):
    """``--trace 1`` on the CPU: the program's spans are profiled (host
    spans, no device operations; on a machine with a card the pass is not
    made), the new metrics read nothing, and the result's keys and metric
    names are those of a run without them."""
    seen = []
    real = spans.program_trace

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(spans, "program_trace", spy)
    result = harness.run_cell(workload, 2 ** 31 + 29, 0.2, True, t_start=time.perf_counter(),
                              device="cpu", overrides=SMALL_SCORE)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert sorted(result["metrics"]) == ["score_mfu"]
    assert result["correct"] is True
    if torch.cuda.is_available():
        assert seen == []   # a CPU cell on a machine with a card: no pass
        return
    [st] = seen
    assert st.ops == [] and st.calls == SMALL_SCORE["gap_calls"]
    paths = {p for p, _, _ in st.spans}
    assert ("score", "encode", "stack.gates") in paths and ("score", "error") in paths
    assert sum(p == ("score",) for p, _, _ in st.spans) == st.calls

