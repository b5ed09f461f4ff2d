"""The port's spans (``repro_torch.trace``): off by default, where ``span``
is one shared no-op that allocates nothing and records nothing; on, a batch
score opens the documented tree of spans, every operation it runs lies
under one leaf span (views aside, which run nothing), and the scores keep
their bits.  On the card (``gpu``): every device operation of a call is
charged, by its launching runtime call, to a leaf span, and K1's and the
row-wise kernel's launches charged a call equal their wrappers' counts."""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.kernels.lstm_stack import lstm_stack
from repro_torch.kernels.rowwise import rowwise_matmul
from repro_torch.serve.engine import AnomalyStreamEngine

STACK = ("stack.pad", "stack.gates", "stack.k1")
#: every span of one batch score, as paths from ``score`` down
TREE = {("score",), ("score", "score.plan"), ("score", "score.stage_in"),
        ("score", "encode"), ("score", "decode"), ("score", "decode", "head"),
        ("score", "error"), ("score", "score.fetch")} | {
        ("score", seg, s) for seg in ("encode", "decode") for s in STACK}
#: the spans that hold no other span; between them they hold every
#: operation of a call
LEAVES = {"score.plan", "score.stage_in", "head", "error", "score.fetch", *STACK}
MODELS = ("gw_nominal", "gw_small")


def engine(model: str, device: str = "cpu") -> AnomalyStreamEngine:
    cfg = GW_MODELS[model]
    return AnomalyStreamEngine(init_autoencoder(cfg, seed=3, device=device), cfg, device=device)


def windows(eng: AnomalyStreamEngine, batch: int = 3) -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.standard_normal((batch, eng.cfg.timesteps, eng.cfg.input_dim)).astype(np.float32)


def profiled(eng, x, on: bool = True, cuda: bool = False):
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with trace.tracing(on), profile(activities=activities) as prof:
        scores = eng.score(x)
        if cuda:
            torch.cuda.synchronize()
    return scores, prof.events()


def span_paths(events) -> list:
    """[(path, start, end)] of the user annotations, each path the span
    names (a label's first word) that contain it, outermost first."""
    marks = sorted((e for e in events if e.is_user_annotation
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    out, stack = [], []
    for e in marks:
        a, b = e.time_range.start, e.time_range.end
        while stack and not (stack[-1][1] <= a and b <= stack[-1][2]):
            stack.pop()
        path = (stack[-1][0] if stack else ()) + (e.name.split(" ")[0],)
        stack.append((path, a, b))
        out.append(stack[-1])
    return out


def enclosing(spans, a, b) -> list:
    return [path for path, s, e in spans if s <= a and b <= e]


def returns_alias(op_name: str) -> bool:
    """Every tensor overload of the ATen op (``out=`` forms aside) returns
    a view of an input that it does not write: it runs nothing (``aten::to`` that does cast calls
    ``aten::_to_copy``, which is no view)."""
    packet = getattr(torch.ops.aten, op_name.split("::", 1)[1], None)
    if packet is None:
        return False
    schemas = [getattr(packet, o)._schema for o in packet.overloads() if not o.startswith("out")]
    returns = [r for s in schemas if s.returns and all(str(r.type) == "Tensor" for r in s.returns)
               for r in s.returns]
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


@pytest.fixture(scope="module", params=MODELS)
def scored(request):
    """One engine's score of one batch with tracing on, then off, each
    under the profiler, then with no profiler."""
    eng = engine(request.param)
    x = windows(eng, 5)
    on, on_events = profiled(eng, x, on=True)
    calls = eng.calls
    off, off_events = profiled(eng, x, on=False)
    return {"on": on, "off": off, "bare": eng.score(x), "on_events": on_events,
            "off_events": off_events, "calls": calls}


def test_a_batch_score_opens_the_documented_tree(scored):
    events = scored["on_events"]
    paths = [p for p, _, _ in span_paths(events)]
    assert set(paths) == TREE
    counts = {p: paths.count(p) for p in TREE}
    assert all(n == 1 for n in counts.values()), counts
    top = [e.name for e in events if e.is_user_annotation and e.name.startswith("score ")]
    assert top == [f"score call={scored['calls']} windows=5"]


def test_every_op_of_a_score_lies_under_one_leaf(scored):
    events = scored["on_events"]
    spans = span_paths(events)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for e in ops:
        around = enclosing(spans, e.time_range.start, e.time_range.end)
        assert ("score",) in around, e.name
        leaves = [p for p in around if p[-1] in LEAVES]
        if not returns_alias(e.name):
            assert len(leaves) == 1, (e.name, around)
        assert len(leaves) <= 1, (e.name, around)


def test_views_are_told_apart_from_ops_that_run():
    assert all(returns_alias(n) for n in ("aten::slice", "aten::select", "aten::expand",
                                          "aten::to", "aten::as_strided", "aten::unsqueeze"))
    assert not any(returns_alias(n) for n in ("aten::add", "aten::copy_", "aten::clone",
                                              "aten::_to_copy", "aten::zeros", "aten::zero_",
                                              "aten::fill_", "aten::add_"))


def off() -> bool:
    return trace.span("head") is trace.span("error")


def test_off_records_no_span(scored):
    assert off()
    assert [e for e in scored["off_events"] if e.name.startswith("aten::")]
    assert not [e.name for e in scored["off_events"] if e.is_user_annotation]


def test_off_span_is_one_shared_object_and_allocates_nothing():
    assert off()
    first = trace.span("score.plan")
    assert all(trace.span(n) is first for n in ("stack.k1", "head", "error"))
    tracemalloc.start()
    try:
        for _ in range(1000):
            with trace.span("stack.gates"):
                pass
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(s.size for s in snap.statistics("filename")) == 0


def test_enable_and_tracing_switch_and_restore():
    assert off()
    with trace.tracing():
        assert not off()
        with trace.tracing(False):
            assert off()
        assert not off()
    assert off()
    trace.enable(True)
    try:
        assert not off()
    finally:
        trace.enable(False)
    assert off()
    with pytest.raises(RuntimeError):
        with trace.tracing():
            raise RuntimeError("inside")
    assert off()


def test_scores_are_bit_equal_with_tracing_on_and_off(scored):
    assert scored["on"].tobytes() == scored["off"].tobytes() == scored["bare"].tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODELS)
def test_on_the_card_every_device_op_is_charged_to_a_leaf(model):
    """Device operations are charged by their runtime call's correlation
    id (the card runs behind the host, so time overlap would misplace
    them): every one to a leaf span; K1 twice a call, in ``stack.k1``; the
    row-wise kernel four times, one in each ``stack.gates``, ``head``
    and ``error``; both as their wrappers count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = engine(model, "cuda")
    x = windows(eng, 256)
    eng.score(x)
    k1, rw = lstm_stack.launches, rowwise_matmul.launches
    _, events = profiled(eng, x, cuda=True)
    k1, rw = lstm_stack.launches - k1, rowwise_matmul.launches - rw
    spans = span_paths(events)
    cpu = torch.autograd.DeviceType.CPU
    runtime = {e.id: e for e in events if e.device_type == cpu and e.name.startswith("cu")}
    labels = {e.name for e in events if e.is_user_annotation}
    device = [e for e in events if e.device_type != cpu and e.name not in labels]
    assert device
    charged = []
    for e in device:
        r = runtime[e.id]
        around = enclosing(spans, r.time_range.start, r.time_range.start)
        leaves = [p for p in around if p[-1] in LEAVES]
        assert len(leaves) == 1, (e.name, around)
        charged.append((leaves[0], e.name))
    k1_at = sorted(p for p, n in charged if "lstm_stack_kernel" in n)
    rw_at = sorted(p for p, n in charged if "rowwise_kernel" in n)
    assert k1_at == [("score", "decode", "stack.k1"), ("score", "encode", "stack.k1")]
    assert rw_at == sorted([("score", "decode", "head"), ("score", "decode", "stack.gates"),
                            ("score", "encode", "stack.gates"), ("score", "error")])
    assert (k1, rw) == (2, 4)
