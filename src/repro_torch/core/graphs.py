"""CUDA graphs for the serving and training paths: the port's counterpart
of ``jax.jit``.

The reference compiles each serving call (the bound encoder step, the
coalesced pool step, the window finish, the LM prefill and decode step) and
its train step as one program each.  Run eagerly, each of those calls is
dozens to tens of thousands of small launches whose host cost dwarfs the
device work.  A ``CapturedCall``
runs a function once eagerly on a side stream (the warm-up PyTorch's
CUDA-graph notes ask for: libraries built and loaded, cuBLAS handles and
the kernels' per-stream scratch made before capture), then captures it as
one ``torch.cuda.CUDAGraph``; each later ``replay`` relaunches the whole
sequence over the same static tensors.  The function must read its inputs
from, and leave its results in, tensors that outlive the graph: whatever
it allocates comes from the graph's private pool and is overwritten by
the next replay.

Launch counts: every kernel wrapper counts its own launches (``.launches``,
and K3's ``launches_by_path``).  The warm-up's launches are real and stay
counted; the capture's are taken back out and recorded, and each replay
adds what the capture recorded, so a count reads the same whether a path
ran eagerly or replayed.

Python's cyclic garbage collector is off while a capture runs: a graph
kept alive only by a reference cycle (an executor and its step graph) that
the collector frees mid-capture would destroy its CUDA graph on the
capturing thread, which invalidates the capture (PyTorch's ``graph``
context no longer collects on entry).

A train step updates its state (parameters, optimizer state) in place:
``CapturedStep`` counts ``CapturedCall``'s eager warm-up as the first step,
so N calls are N steps whether they replayed or not.

Nothing here is used on the CPU: the engines and the trainer run eagerly
there.
"""

from __future__ import annotations

import gc
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


def _counted_wrappers() -> list:
    """Every kernel wrapper that keeps a launch count."""
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.lstm_scan import lstm_scan
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step
    from repro_torch.kernels.rowwise import rowwise_matmul
    from repro_torch.kernels.ssd_scan import ssd_scan

    return [lstm_stack, lstm_stack_step, lstm_scan, decode_attn, ssd_scan, rowwise_matmul]


def _snapshot() -> list:
    return [(fn.launches, dict(getattr(fn, "launches_by_path", {})))
            for fn in _counted_wrappers()]


def _delta(before: list, after: list) -> list:
    return [(n1 - n0, {k: v - p0.get(k, 0) for k, v in p1.items() if v != p0.get(k, 0)})
            for (n0, p0), (n1, p1) in zip(before, after)]


def _add(delta: list, sign: int = 1) -> None:
    for fn, (n, by_path) in zip(_counted_wrappers(), delta):
        fn.launches += sign * n
        paths = getattr(fn, "launches_by_path", None)
        for k, v in by_path.items():
            paths[k] = paths.get(k, 0) + sign * v


_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream every capture on ``device`` runs on (kernel
    scratch keyed by stream, as K5's counters are, is made once for it)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


class CapturedCall:
    """``fn`` (no arguments) captured as one CUDA graph.

    Construction runs ``fn`` once eagerly on the capture stream and returns
    that run's result as ``first``, then captures ``fn``; ``replay()`` runs
    the captured sequence on the current stream and returns the tensors
    the capture produced (the same objects every time).  Capture failures
    raise.
    """

    def __init__(self, fn: Callable, device: torch.device):
        main = torch.cuda.current_stream(device)
        side = capture_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn()
        main.wait_stream(side)
        before = _snapshot()
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a server's other threads may use the card meanwhile
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
            self.launches = _delta(before, _snapshot())
            _add(self.launches, -1)  # the capture launched nothing

    def replay(self):
        self.graph.replay()
        _add(self.launches)
        return self.out


class CapturedStep:
    """``step_fn(state, batch) -> (out, new_state)`` over resident state,
    captured as one CUDA graph.

    ``state`` is a tree of tensors on ``device`` that every call updates in
    place with ``new_state``'s values; ``batch`` a tree of tensors or
    arrays copied into static buffers of the first call's shapes.  The
    first call runs the step eagerly (``CapturedCall``'s warm-up: it is a
    real step) and captures it; each later call replays the capture.
    Returns ``out``, which a replay overwrites.

    A replay writes the state on the device alone, so each call bumps the
    version counter of every state leaf, as an eager in-place update
    would: a cache keyed on them (``pack_stack_cached``) then misses
    instead of serving what it cached before the replay.
    """

    def __init__(self, step_fn: Callable, state: Any, device: torch.device):
        self.step_fn, self.state, self.device = step_fn, state, device
        self._batch: Any = None
        self._call: CapturedCall | None = None

    def _run(self):
        out, new = self.step_fn(self.state, self._batch)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.state), tree_leaves(new), strict=True):
                dst.copy_(src)
        return out

    def __call__(self, batch: Any):
        if self._call is None:
            self._batch = tree_map(
                lambda x: torch.empty(tuple(x.shape), dtype=torch.as_tensor(x).dtype,
                                      device=self.device), batch)
        for dst, src in zip(tree_leaves(self._batch), tree_leaves(batch), strict=True):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"captured step: batch leaf {tuple(src.shape)}, the "
                                 f"capture's is {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(src))
        if self._call is None:
            self._call = CapturedCall(self._run, self.device)
            return self._call.first
        out = self._call.replay()
        for leaf in tree_leaves(self.state):
            torch.autograd.graph.increment_version(leaf)
        return out
