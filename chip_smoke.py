#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the kernels of ``src/repro_torch`` (the fused LSTM-stack kernels K1
and K2, the per-layer scan kernel K3, decode attention K5, the SSD scan K4
and the row-wise product, one ``nvcc`` per source, started together),
holds each kernel against
its plain PyTorch version at the shapes of its path in fp32 and bf16, and
drives three serving paths: two at the full ``gw_nominal`` width with
weights from the golden fixtures (``tests/data/torch_port_gw_nominal.npz``
and ``torch_port_gw_server.npz``, produced by the JAX reference):

* the engines on their defaults (batch scoring, streaming pushes,
  push_many), through K1 and K2;
* the engines on ``impl="kernel"`` (K3 per layer) and the ``StreamServer``
  over a ``fused_step`` and a ``kernel`` engine: the reference's server
  script, a fake-clock run of 32 streams against sequential replays,
  checkpoint and restore, the health screen, and a threaded run;

and LM serving through ``LmEngine`` at full width in bf16 with random
weights from a seed: ``smollm-360m`` (K5 on every decode step),
``mamba2-130m`` (K4 on every prefill), ``qwen2-moe-a2.7b`` (K5 on every
decode step; routed experts with the reference's dense capacity dispatch)
and ``hymba-1.5b`` (K4 on every prefill, K5 over its window ring on every
decode step), B=8, prompts of 512 (and 500 for mamba2, 1536 for hymba:
above the flash threshold, the ring wrapped), 64 new tokens, with the
kernel path's logits held against the plain path's under teacher forcing
(for qwen2-moe, with the count of routing decisions the two paths differ
on, both held against a control: the path with K5's plain version in the
kernel's place).  The frontend-fed LMs take their embeddings from a seed:
``llava-next-34b`` (68.8 GB of bf16 weights drawn on the card; 576 patches
spliced in front of 512 tokens, K5 at 56/8 heads on every decode step)
and ``seamless-m4t-large-v2`` (512 frames + 512 tokens and 1536 frames +
16 tokens through one engine; no kernel on its path, so its served
decode is also held against ``forward`` over the same frames and
tokens).  Each run logs its peak
device memory.  The reduced LM golden fixtures
(``tests/data/torch_port_lm_*.npz``: smollm, mamba2, qwen2moe, hymba,
seamless, llava) are served on the card first and must match the
reference's logits and tokens.

On the card the serving calls replay CUDA graphs; phases 15-18 hold the
GW graphs against eager runs bit for bit (the step at every pool width up
to 32, the batched window decode), ``push_many`` over 32 streams that
complete windows together against sequential pushes, the row-wise
product of the score tail and ``fuse_gates`` against their plain
versions, and time a T=1 push and the threaded server eager and
replayed; phase 13 holds the LM replay against the eager kernel path.

Phases 23-25 train the GW autoencoder on the card (``repro_torch.train``,
each step replayed as one CUDA graph) against
``tests/data/torch_port_gw_train.npz``: ``mse_loss`` and its gradients at
full ``gw_nominal`` width, 5 AdamW steps, replay bit-equal to eager; the
paper's Fig. 9 recipe (gw_small, 200 steps) with its AUCs on ``split``,
16-bit weights, PAPER_HW and ``fused_stack`` fp32/bf16/int8 (K1) against
the reference's; the row-wise kernel and K1 bit-equal to their plain
versions at the shapes training and that evaluation give them; step
times eager and replayed with the device's idle share; and a
kill-and-resume through ``Trainer`` bit-equal to an uninterrupted run.

Phases 29-31 train LMs on the card (``launch/train.py``, ``loss_fn``
of each family, each step after the first replayed as one CUDA graph):
every family's reduced golden training fixture
(``tests/data/torch_port_lm_train.npz``: loss, gradients, 3 AdamW
steps) in fp32, then ``smollm-360m`` and ``mamba2-130m`` at full width
(S=4096, B=8, 8 steps, bf16 weights and fp32 moments; smollm with
PyTorch's math attention backend disabled, so a training attention that
is not fused raises), with the flash gradients at the training shape
against the plain ``sdpa``'s fp32 ones, replayed steps bit-equal to
eager ones, step times, tokens/s, the idle share, peak memory and the
model-FLOP share (the ``lm_train`` JSON line); K4 and K5 launch on no
training path.

Phases 32-34 run the mesh and the dry run (``launch/dryrun.py``): an
NCCL process group of one rank and ``make_host_mesh()`` on the card;
smollm-360m's ``train_4k`` cell (cut to B=8) through ``build_cell``'s
DTensor step for 3 steps against the plain step (deterministic mode,
within ``LM_TRAIN_DEFAULT_TOL``), the dry run's prediction for it
(argument bytes exactly, the traced peak against
``max_memory_allocated``, dot FLOPs against ``FlopCounterMode``), its
``decode_32k`` cell (B=8, 16 steps) against ``LmEngine``'s plain path
(``LM_TF_TOL``), and three production cells traced on ``pod_32x8`` on
the card's host beside them (the ``dryrun`` JSON line).

Phases 26-28 place ``gw_nominal`` on a stage mesh (``fused_stack_sharded``:
each stage a contiguous sub-stack on its own CUDA stream, one K1 launch per
chunk; the stages share the card, or take one card each where there are
several): bit-equal to the local ``fused_stack`` over stages 1, 2 and 4,
B 1 and 64, ``n_chunks`` 1, 2, 4 and 5 in fp32 and int8 (bf16 compute
within K1's bf16 tolerance), each stage's K1 bit-equal to its plain version on
its sub-pack; the library and both engines within 1e-5 of the golden
scores, ``push_many`` against sequential pushes, snapshots across
placements; the window's time at 1, 2 and 4 stages beside the local K1,
the eager push and the batch score (the ``sharded`` JSON line); and
``launch/serve.py --placement sharded --server``.

Phases 20-22 serve ``gw_nominal`` on the ``mixed`` backend (per-layer
storage int8, fp32, fp32, int8: each segment a chain of ``fused_step``
segments on K1 and K2) with the weights of
``tests/data/torch_port_gw_mixed.npz``: scores within 1e-5 of the
reference's, ``mixed`` bit-equal to hand-chained segments, its step and
decode graphs to eager runs, ``push_many`` to sequential pushes, a
snapshot round trip; its push, server and batch-score times beside
``fused_step``'s; ``tune="balanced"`` with its predicted and measured
per-segment times; and a smoke sweep of both segments through
``python -m repro_torch.launch.tune`` whose cache ``plan_stack(tune=
"cached")`` then reads.

It checks the scores against the reference's and times the kernels beside
their plain versions, their bound and a library call (cuDNN's LSTM,
``scaled_dot_product_attention``, ``torch.addmm``).  Every phase raises on
failure; the last line is ``{"ok": true, "device": {...}}``.  Needs one
CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port_gw_nominal.npz"
SERVER_FIXTURE = ROOT / "tests" / "data" / "torch_port_gw_server.npz"
MIXED_FIXTURE = ROOT / "tests" / "data" / "torch_port_gw_mixed.npz"
TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_port_gw_train.npz"
#: training against the reference (tests/test_torch_golden_train.py says
#: why): loss relative, gradient per leaf over its largest |g|, and each
#: entry after 5 AdamW steps (``OPT5``) whose first gradient is decided
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_STEP_ATOL = 1e-6, 1e-5, 1e-5
OPT5 = dict(lr=3e-3, warmup_steps=2, total_steps=200)
#: the fig9 recipe (tests/test_gw_e2e.py): gw_small, 200 steps of B=32,
#: evaluations on 192 background and 192 signal windows each
RECIPE = dict(steps=200, batch=32, n_eval=192)
RECIPE_OPT = dict(lr=3e-3, warmup_steps=20, total_steps=200, weight_decay=0.0)
RECIPE_EVALS = ("fp32", "q16", "hw", "fused_fp32", "fused_bf16", "fused_int8")
#: train steps one device-only trace covers for a step's busy time (phase 25)
STEP_TRACE_CALLS = 2
#: the mixed path's per-layer storage (the fixture's first plan)
MIXED_WDS = ("int8", "fp32", "fp32", "int8")
TOL = dict(rtol=1e-5, atol=1e-5)            # engine scores vs the reference's
STREAM_TOL = dict(rtol=1e-6, atol=1e-7)     # chunked streaming vs one-shot

LM_FIXTURES = {"smollm-360m": ROOT / "tests" / "data" / "torch_port_lm_smollm.npz",
               "qwen2-moe-a2.7b": ROOT / "tests" / "data" / "torch_port_lm_qwen2moe.npz",
               "hymba-1.5b": ROOT / "tests" / "data" / "torch_port_lm_hymba.npz",
               "mamba2-130m": ROOT / "tests" / "data" / "torch_port_lm_mamba2.npz",
               "seamless-m4t-large-v2": ROOT / "tests" / "data" / "torch_port_lm_seamless.npz",
               "llava-next-34b": ROOT / "tests" / "data" / "torch_port_lm_llava.npz"}
LM_GOLDEN_TOL = dict(rtol=1e-4, atol=1e-4)  # reduced fp32 logits vs the reference's
#: kernel vs plain version, the reference's own tolerances for K5 and K4 in
#: fp32 (other summation orders).  In bf16 both read the same bf16 inputs,
#: compute in fp32 and round once, so they differ by at most one bf16 ulp
#: (2^-7 of the value) where the fp32 results straddle a rounding point
K5_TOL, K4_TOL = 2e-5, 2e-4
BF16_TOL = dict(rtol=8e-3, atol=1e-3)
#: K1's bf16 tolerance (the reference's; tests/test_torch_kernels.py): a
#: sharded stack at bf16 compute rounds a stage boundary's input product to
#: bf16 where the local K1 does not, and the recurrence carries that
#: rounding on through the window
K1_BF16_TOL = dict(rtol=2e-2, atol=1e-2)
#: of K4's bf16 y elements that differ from the plain version's (by one
#: ulp), the largest share that may lie toward zero: two fp32 summation
#: orders round apart either way alike, a sum that loses its low bits
#: toward zero (the tensor cores' accumulation) leans one way, and every
#: later layer of a bf16 model carries that lean on; it is counted over
#: at least K4_LEAN_MIN differing elements
K4_LEAN_MAX, K4_LEAN_MIN = 0.55, 500
#: head geometries (Hq, Hkv, D): smollm-360m, granite-3-2b, qwen1.5-4b, yi-9b,
#: qwen2-moe-a2.7b (G=1), hymba-1.5b (G=5), llava-next-34b (G=7: the odd
#: tail of K5's tiles of kQTile=4 heads)
K5_GEOMETRIES = ((15, 5, 64), (32, 8, 64), (20, 20, 128), (32, 4, 128), (16, 16, 128),
                 (25, 5, 64), (56, 8, 128))
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
#: the full-width serving runs (arch, prompt length, frontend rows), B=LM_BATCH,
#: LM_NEW new tokens: hymba's 1536 is above the 1024-token flash threshold
#: and wider than its window, so its ring wraps in prefill; llava's 576
#: patches in front of 512 tokens put its prefill on the flash path; seamless
#: serves 512 frames + 512 tokens (every attention on sdpa) and 1536 frames +
#: 16 tokens (the encoder on flash; a short decoder prompt, as speech
#: translation gives) through one engine
LM_RUNS = (("smollm-360m", LM_PROMPT, 0), ("mamba2-130m", LM_PROMPT, 0),
           ("mamba2-130m", 500, 0), ("qwen2-moe-a2.7b", LM_PROMPT, 0),
           ("hymba-1.5b", LM_PROMPT, 0), ("hymba-1.5b", 1536, 0),
           ("llava-next-34b", LM_PROMPT, 576), ("seamless-m4t-large-v2", LM_PROMPT, 512),
           ("seamless-m4t-large-v2", 16, 1536))
#: copies of smollm's serving cache the cold K5 timings rotate (12 x 5.9 MB > 50 MB of L2)
K5_COPIES = 12
#: full-width bf16 logits, kernel path vs plain path under teacher forcing:
#: max |difference| over max |logit|.  The two paths differ by bf16
#: roundings (sdpa rounds the softmax weights to bf16, K5 does not; a
#: one-ulp change, 0.4-0.8%, of one layer's attention or scan output is
#: carried on by the 24-32 bf16 layers after it); a wrong head, group or
#: length moves logits by their own size
LM_TF_TOL = 0.05
#: qwen2-moe under teacher forcing: a near-tie of the k-th and (k+1)-th
#: expert flips on a one-ulp difference of the residual, and the flip is
#: carried on through the layers and the cache.  The served path is held
#: against a control, the same path with K5's plain version in the
#: kernel's place: its routing decisions apart from the plain path's, and
#: its logit gap to it, at most this many times the control's (the gap
#: at least LM_TF_TOL)
TF_CONTROL_FACTOR = 2.0

#: H100 SXM peaks (NVIDIA data sheet, dense).  A bound counts each
#: kernel's work at the peak of the unit that type of work can run on,
#: whatever a kernel uses: fp32 arithmetic (the LSTM kernels, K5, K4's fp32
#: instantiation) at the fp32 CUDA-core peak, bf16 products with fp32
#: sums (K4's bf16 instantiation) at the bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: LM training (phases 29-31): the reduced golden fixture and its limits
#: (tests/test_torch_lm_train_golden.py says why ``a_log`` is held to 3e-5),
#: the optimizer the fixture's 3 steps ran with
LM_TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_port_lm_train.npz"
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_REL = 1e-6, 1e-5
LM_TRAIN_GRAD_REL_LEAF = {"layers/ssm/a_log": 3e-5}
LM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=50)
#: the full-width training runs through launch/train.py: (arch, sequence
#: length, batch, steps).  4096 is train_4k's length (above the 1,024-token
#: flash threshold: SDPA's fused backward at 4k; mamba2's scan in 64
#: chunks); train_4k's global batch of 256 is cut to one card's 8
LM_TRAIN_RUNS = (("smollm-360m", 4096, 8, 8), ("mamba2-130m", 4096, 8, 8))
#: flash attention at the training shape (bf16, fused SDPA) against the
#: plain ``sdpa`` in fp32 on the same bf16 inputs, each tensor scaled by its
#: largest |value|: the output within the forward's bf16 tolerance, the
#: gradients within twice its rtol and four times its atol, since the
#: backward rounds to bf16 twice on the way (the probabilities and dS
#: before their products) besides the result, and a rehearsal of this check
#: on the CPU's bf16 flash kernel put 2 of 65,920 dq entries 1.6e-3 off
FLASH_OUT_TOL = BF16_TOL
FLASH_GRAD_TOL = dict(rtol=1.6e-2, atol=4e-3)
#: smollm-360m's replayed steps in PyTorch's default mode (the mode the
#: times are taken in), where cuDNN's fused attention backward is not
#: bit-reproducible, against eager steps from the same state: each step's
#: loss gap over the eager loss, and each state leaf's max |difference| over
#: its largest |value|, the bf16 parameters and the fp32 AdamW moments apart.
#: Read on an NVIDIA H100 80GB HBM3 at 700 W: replay 1.4e-6 / 1.06e-3 /
#: 1.11e-3; a second eager run from the same state (the control) 2.4e-6 /
#: 1.06e-3 / 1.81e-3; the state one step apart 7.7e-3 / 1.06e-3 / 0.205;
#: another run's loss gap 1.46e-5.  So the loss is held 3x above the largest
#: reading and the moments 5x above the control's, each over 20x below one
#: step; the parameters' largest difference is one AdamW update either way
#: (about lr, the sign of a near-zero gradient's update flips), so their
#: limit catches only a corrupted state, and the loss and moments catch a
#: lost or repeated step
LM_TRAIN_DEFAULT_TOL = dict(loss=5e-5, params=4e-3, moments=1e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel: str | None = None, host: bool = True) -> float | None:
    """Device time per call of ``fn`` from ``torch.profiler``: the device
    kernels whose name contains ``kernel`` (all of them if None), summed and
    divided by ``reps``.  One profiled call first counts the kernels a call
    launches; a run of ``reps`` calls whose trace holds another multiple of
    that count (the profiler dropped or split events) is run once more, and
    then None is returned, as it is when no device time was recorded.
    ``host=False`` traces the device alone (``kernel_trace``).

    The first device events of a trace can go unrecorded (seen on the H100
    with torch 2.11, from one event to most of a 50-call trace), so each
    trace starts with spin kernels, a synchronise and a pause, and the
    spins are not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call, _ = kernel_trace(fn, 1, kernel, host)
    for _ in range(2):
        count, total_us = kernel_trace(fn, reps, kernel, host)
        if per_call > 0 and count == per_call * reps and total_us > 0:
            return total_us / reps / 1e3
    log(f"device_ms: {count} kernel events in {reps} calls, want {per_call} per call; "
        f"no device time")
    return None


def graph_ms(fn, n_calls: int = 12, reps: int = 5) -> float:
    """Device time per call of ``fn``, without the profiler: ``n_calls``
    calls captured once as one CUDA graph (after as many warm-up calls on
    the capture stream), the graph replayed ``reps`` times between CUDA
    events, the median over ``n_calls``.  It counts each call's whole
    device work, plus the gap between two kernels of a graph, about a
    microsecond.  The kernel rows of the ``kernels`` line are timed so."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(n_calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_calls)
    return statistics.median(times)


def top_kernels(fn, reps: int = 3, n: int = 6) -> list:
    """The ``n`` device kernels that take most of one call of ``fn``:
    [(name, ms per call, launches per call)] from a device-only trace of
    ``reps`` calls (after the spin kernels ``device_ms`` describes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name[:90], ms / reps, count / reps) for name, (ms, count) in ranked]


def kernel_trace(fn, n_calls: int, kernel: str | None = None,
                 host: bool = True) -> tuple[int, float]:
    """(device events, their summed µs) of ``n_calls`` calls of ``fn``
    under ``torch.profiler``, after the spin kernels ``device_ms``
    describes (not counted); ``host=False`` records device activity alone,
    which keeps a trace of tens of thousands of operations cheap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    ranges = [e.time_range for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name and (kernel is None or kernel in e.name)]
    return len(ranges), sum(r.elapsed_us() for r in ranges)


def bound(step: bool, L: int, W: int, T: int, B: int) -> tuple[float, str]:
    """Least time the card needs for one K1 (``step=False``) or K2 call
    over an fp32 pack: the larger of bytes over the memory rate and
    operations over the fp32 peak; returns (ms, "bytes"|"operations").
    The counts are
    ``autotune.model.stack_kernel_costs``'s and the rates ``H100_SXM``'s,
    the same the mixed-split balancer's floors read."""
    from repro_torch.autotune.model import roofline_terms_from_counts, stack_kernel_costs

    costs = stack_kernel_costs(L, W, B, T, step=step)
    terms = roofline_terms_from_counts(costs["flops"], costs["bytes"])
    return terms["t_bound_us"] / 1e3, ("bytes" if terms["bound"] == "hbm" else "operations")


def check_push_many(make_engine, windows: np.ndarray, T: int) -> int:
    """``push_many`` over 8 streams at ragged fill levels must be bit-equal
    to pushing each stream's chunks alone; returns the stream count."""
    n_streams = 8
    rng = np.random.RandomState(0)
    x = np.concatenate([windows[:n_streams], windows[n_streams : 2 * n_streams]], axis=1)
    x = x + rng.randn(*x.shape).astype(np.float32) * 0.01
    ids = [f"det{i}" for i in range(n_streams)]
    lead = 3  # three streams start 7 samples ahead: ragged fill levels
    pool = make_engine()
    pool.push_many(ids[:lead], x[:lead, :7])
    got = {sid: [] for sid in ids}
    starts = [7 if i < lead else 0 for i in range(n_streams)]
    for a, b in ((0, 1), (1, 26), (26, 50), (50, 2 * T - 7)):
        res = pool.push_many(ids, np.stack([x[i, s + a : s + b] for i, s in enumerate(starts)]))
        for sid in ids:
            got[sid] += res[sid]
    seq = make_engine()
    for i, sid in enumerate(ids):
        seq.reset()  # the same chunks, pushed by one stream alone
        cuts = ([0] if starts[i] else []) + [starts[i] + a for a in (0, 1, 26, 50, 2 * T - 7)]
        want = [sc for a, b in zip(cuts, cuts[1:]) for sc in seq.push(x[i : i + 1, a:b])]
        assert len(got[sid]) == len(want) >= 1, (sid, len(got[sid]), len(want))
        for g, w in zip(got[sid], want):
            np.testing.assert_array_equal(g, w, err_msg="push_many vs sequential pushes")
    return n_streams

def rowwise_bound(m: int, k: int, n: int, bias: bool) -> tuple[float, str]:
    """Least time the card needs for one row-wise product: bytes (x, w, b
    read once, out written once, fp32) over the memory rate vs 2 operations
    per multiply-add (and 1 per bias add) over the fp32 peak."""
    n_bytes = (m * k + k * n + (n if bias else 0) + m * n) * 4
    ops = 2 * m * n * k + (m * n if bias else 0)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def push_times(engine, windows: np.ndarray, n: int = 200) -> list:
    """Host ms of ``n`` T=1 pushes at B=1, each synchronised (a window
    completion every ``window`` pushes runs the decoder)."""
    import torch

    out = []
    for i in range(n):
        pos = i % windows.shape[1]
        t1 = time.perf_counter()
        engine.push(windows[:1, pos : pos + 1])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return out


def gw_graph_phases(params, cfg, windows, T, dev, smi, all_packs, state, compare) -> dict:
    """Phases 15-18: the GW side's CUDA graphs against eager runs, the
    pool's batched window decode, the row-wise product kernel and
    ``fuse_gates`` against their plain versions, and eager vs replay
    timings.  Returns the row-wise kernel's ``kernels`` entry (its
    ``launches`` filled in by the caller) and the report."""
    import torch
    from repro_torch.core.executor import plan_stack
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step, lstm_stack_step_plain
    from repro_torch.kernels.rowwise import rowwise_matmul, rowwise_matmul_plain
    from repro_torch.serve.engine import StreamingAnomalyEngine, _pad_width

    report: dict = {}
    # -- phase 15: graph replay vs eager, GW ---------------------------------
    t0 = time.perf_counter()
    ex = StreamingAnomalyEngine(params, cfg, batch=1)._exec_enc
    gen = torch.Generator().manual_seed(15)
    widths = sorted({_pad_width(n) for n in range(1, 33)})
    for width in widths:
        for t_len in (1, 25):
            x = torch.randn(width, t_len, 1, generator=gen).to(dev)
            st0 = state(ex.packed, width)
            want = ex.step(x, st0)
            graph = ex.step_graph(width)
            first = tuple(t.clone() for t in graph(x, st0))  # runs eagerly, then captures
            before = lstm_stack_step.launches
            got = graph(x, st0)  # a replay
            torch.cuda.synchronize()
            if lstm_stack_step.launches - before != 1:
                raise AssertionError(f"step graph width {width}: a replay counted "
                                     f"{lstm_stack_step.launches - before} K2 launches")
            compare(first, want, f"step graph width {width} T={t_len}, first call")
            compare(got, want, f"step graph width {width} T={t_len}, replay")
    rng = np.random.RandomState(15)
    finish = {}
    for k in (1, 3, 8, 32):
        x = rng.randn(k, 2 * T, 1).astype(np.float32)
        ids = [f"f{i}" for i in range(k)]
        runs = []
        for graphs in (False, True):
            eng = StreamingAnomalyEngine(params, cfg, batch=1, graphs=graphs)
            got = []
            for w in range(2):  # the second window replays the finish graph
                res = eng.push_many(ids, x[:, w * T : (w + 1) * T])
                got.append(np.concatenate([res[sid][0] for sid in ids]))
            runs.append(got)
        for w in range(2):
            np.testing.assert_array_equal(runs[1][w], runs[0][w],
                                          err_msg=f"batched finish k={k} window {w}: "
                                                  "replay vs eager")
        finish[k] = _pad_width(k)
    log(f"phase 15 graph replay == eager: GW step at widths {widths} (T=1 and 25; first "
        f"call and replay), batched finish at group sizes {sorted(finish)} (widths "
        f"{sorted(set(finish.values()))}) ({time.perf_counter() - t0:.1f} s)")

    # -- phase 16: the pool over 32 streams completing together ---------------
    t0 = time.perf_counter()
    n = 32
    x = rng.randn(n, 2 * T, 1).astype(np.float32)
    ids = [f"p{i}" for i in range(n)]
    pool = StreamingAnomalyEngine(params, cfg, batch=1)
    got = {sid: [] for sid in ids}
    decodes = []
    pieces = [(a, a + 25) for a in range(0, 2 * T, 25)]  # step-kernel pieces
    for a, b in pieces:
        before = lstm_stack.launches
        res = pool.push_many(ids, x[:, a:b])
        decodes.append(lstm_stack.launches - before)
        for sid in ids:
            got[sid] += res[sid]
    if decodes != [int(b % T == 0) for _, b in pieces]:
        raise AssertionError(f"push_many over {n} streams: K1 decodes per piece {decodes}, "
                             "want one per window completion")
    seq = StreamingAnomalyEngine(params, cfg, batch=1)
    want = {}
    for i, sid in enumerate(ids):
        seq.reset()
        want[sid] = [sc for pos in range(0, 2 * T, 25) for sc in
                     seq.push(x[i : i + 1, pos : pos + 25])]
    assert_bit_equal(got, want, f"push_many over {n} streams")
    log(f"phase 16 pool ok: {n} streams completing windows together, one decode per "
        f"completion ({decodes}), bit-equal to sequential pushes "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 17: the row-wise product and fuse_gates against their plain versions
    t0 = time.perf_counter()
    dec = all_packs[("fp32", "fp32")]["dec"]
    w0 = dec.stacked["w_x"][0].float()
    head_w, head_b = params["dense"]["w"].float(), params["dense"]["b"]
    rw_cases = []
    for batch in (1, 32):
        rows = batch * T
        rw_cases += [
            ("decoder projection", torch.randn(rows, w0.shape[0], generator=gen), w0, None),
            ("decoder projection bf16", torch.randn(rows, w0.shape[0], generator=gen)
             .to(torch.bfloat16), w0, None),
            ("dense head", torch.randn(rows, head_w.shape[0], generator=gen), head_w, head_b),
            ("error sum", torch.rand(batch, T, generator=gen), torch.ones(T, 1), None),
        ]
    rw_err, rw_rows = 0.0, []
    for name, xr, wr, br in rw_cases:
        xr, wr = xr.to(dev), wr.to(dev)
        got = rowwise_matmul(xr, wr, br)
        want = rowwise_matmul_plain(xr, wr, br)
        torch.cuda.synchronize()
        rw_err = max(rw_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"rowwise_matmul {name} {tuple(xr.shape)}: kernel differs "
                                 f"from its plain version")
        if xr.dtype == torch.float32 and name != "error sum":
            kernel = lambda: rowwise_matmul(xr, wr, br)  # noqa: E731
            lib = (lambda: torch.addmm(br, xr, wr)) if br is not None else \
                (lambda: xr @ wr)  # noqa: E731
            b_ms, b_by = rowwise_bound(xr.shape[0], xr.shape[1], wr.shape[1], br is not None)
            rw_rows.append({
                "what": name, "M": xr.shape[0], "K": xr.shape[1], "N": wr.shape[1],
                "ms": graph_ms(kernel), "call_ms": median_ms(kernel, reps=50),
                "plain_ms": median_ms(lambda: rowwise_matmul_plain(xr, wr, br), reps=5),
                "library_ms": graph_ms(lib),
                "bound_ms": b_ms, "bound_by": b_by})
    n_fused = 0
    for key in (("fp32", "fp32"), ("bf16", "fp32"), ("bf16", "bf16")):
        for seg, pk in all_packs[key].items():
            st = pk.stacked
            for t_len in (1, 25):
                for batch in (1, 8):
                    xs = pk.pad_input(torch.randn(batch, t_len, pk.in_dims[0],
                                                  generator=gen).to(dev))
                    h0, c0 = state(pk, batch)
                    got = lstm_stack_step(xs, st["w_x"], st["w_h"], st["b"], h0, c0,
                                          fuse_gates=True)
                    want = lstm_stack_step_plain(xs, st["w_x"], st["w_h"], st["b"], h0, c0,
                                                 fuse_gates=True)
                    torch.cuda.synchronize()
                    compare(got, want, f"K2 fuse_gates {key} {seg} T={t_len} B={batch}")
                    n_fused += 1
    int8 = all_packs[("int8", "fp32")]["enc"]
    h0, c0 = state(int8, 1)
    xs = int8.pad_input(torch.randn(1, 1, 1, generator=gen).to(dev))
    for refuse in (
        lambda: lstm_stack_step(xs, int8.stacked["w_x"], int8.stacked["w_h"], int8.stacked["b"],
                                h0, c0, scales=int8.stacked["scales"], fuse_gates=True),
        lambda: plan_stack(dataclasses.replace(cfg, weight_dtype="int8").layer_cfgs()[:2],
                           impl="fused_step", fuse_gates=True),
    ):
        try:
            refuse()
        except ValueError:
            continue
        raise AssertionError("fuse_gates with an int8 pack was not refused")
    log(f"phase 17 rowwise_matmul ok: {len(rw_cases)} cases (the decoder's projection in "
        f"fp32 and bf16, the dense head, the error sums; B=1 and 32), bit-equal to the "
        f"plain version; K2 fuse_gates ok: {n_fused} cases (fp32/bf16 packs), bit-equal, "
        f"int8 refused ({time.perf_counter() - t0:.1f} s)")

    # -- phase 18: eager vs replay timing, GW ---------------------------------
    t0 = time.perf_counter()
    engines = {"eager": StreamingAnomalyEngine(params, cfg, batch=1, graphs=False),
               "replay": StreamingAnomalyEngine(params, cfg, batch=1)}
    push = {mode: [] for mode in engines}
    for mode in ("eager", "replay", "replay", "eager"):  # in turns
        push[mode] += push_times(engines[mode], windows)
    report["push_T1_B1"] = {
        mode: {"median_ms": statistics.median(v), "p99_ms": float(np.percentile(v, 99)),
               "n": len(v)} for mode, v in push.items()}
    threaded, errors = threaded_run(
        lambda: StreamingAnomalyEngine(params, cfg, batch=1, graphs=False),
        StreamingAnomalyEngine(params, cfg, batch=1, graphs=False),
        np.random.RandomState(18), T, "eager fused_step")
    if errors:
        raise AssertionError(f"eager fused_step server: {errors} engine-step errors")
    report["server_eager_threaded"] = threaded
    log(smi)
    log(f"phase 18 GW timing: T=1 push B=1 " + ", ".join(
        f"{m} median {r['median_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms"
        for m, r in report["push_T1_B1"].items())
        + f"; eager server p50 {threaded['p50_us']:.0f} us p99 {threaded['p99_us']:.0f} us "
        f"({time.perf_counter() - t0:.1f} s)")
    head = rw_rows[0]  # the decoder's projection of one window (B=1)
    entry = {"name": "rowwise_matmul", "route": "cuda",
             "source": "src/repro_torch/kernels/rowwise/csrc/rowwise.cu",
             "replaces": "src/repro/kernels/lstm_stack/ops.py:198 and "
                         "src/repro/core/autoencoder.py:222",
             "launches": None, "max_abs_err": rw_err,
             "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "shapes": rw_rows}
    return entry, report


def mixed_split_scores(params, cfg, windows: np.ndarray, split: int, dev) -> tuple:
    """``split=k`` on each segment of ``cfg``, through the bound mixed
    executors: (one-shot scores, scores streamed in chunks of 25, each
    segment plan's layer assignment), as ``tests/test_torch_golden_mixed.py``
    makes them with the reference."""
    import torch
    from repro_torch.core.autoencoder import (
        decoder_layers,
        encoder_layers,
        reconstruction_error,
        reconstruction_error_from_latent,
    )
    from repro_torch.core.executor import plan_stack

    execs = {}
    for name, (plist, cfgs) in (("enc", encoder_layers(params, cfg)),
                                ("dec", decoder_layers(params, cfg))):
        execs[name] = plan_stack(cfgs, impl="mixed", split=split).bind(plist)
    x = torch.as_tensor(windows, device=dev)
    with torch.no_grad():
        one = reconstruction_error(params, x, cfg, exec_enc=execs["enc"], exec_dec=execs["dec"])
        state = execs["enc"].zero_state(len(windows))
        for pos in range(0, windows.shape[1], 25):
            state = execs["enc"].step(x[:, pos : pos + 25], state)
        streamed = reconstruction_error_from_latent(
            params, execs["enc"].last_hidden(state), x, cfg, exec_dec=execs["dec"])
    layers = {k: ex.plan.layer_assignment() for k, ex in execs.items()}
    return one.cpu().numpy(), streamed.cpu().numpy(), layers


def gw_mixed_phases(dev, smi: str, compare, block_plain) -> tuple[dict, dict, dict]:
    """Phases 20-22, this slice's path: ``gw_nominal`` at full width on the
    mixed backend (``MIXED_WDS``), weights from the reference's mixed
    fixture; the balanced split; a smoke sweep through ``launch/tune.py``.
    Returns (the mixed path's launches by kernel, its launches per window
    by mode, the report)."""
    import torch
    from repro_torch.autotune.cache import TunedPlanCache, set_cache
    from repro_torch.configs.gw import GW_MODELS
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.autoencoder import decoder_layers, encoder_layers
    from repro_torch.core.executor import plan_stack, state_leaves
    from repro_torch.core.stage_balance import choose_mixed_split, segment_runs
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step
    from repro_torch.kernels.rowwise import rowwise_matmul
    from repro_torch.launch import tune as tune_cli
    from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

    with np.load(MIXED_FIXTURE) as data:
        golden = {k: data[k] for k in data.files}
    tree: dict = {}
    for key, value in golden.items():
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = value
    params = params_from_numpy(tree, dev)
    base = GW_MODELS["gw_nominal"]
    cfg = dataclasses.replace(base, weight_dtypes=MIXED_WDS, impl="mixed")
    T = cfg.timesteps
    windows = golden["windows"]
    gen = torch.Generator().manual_seed(20)

    def mixed_engine(**kw):
        return StreamingAnomalyEngine(params, cfg, impl="mixed", **{"batch": 1, **kw})

    def counts():
        return {"lstm_stack_wavefront": lstm_stack.launches,
                "lstm_stack_step": lstm_stack_step.launches,
                "rowwise_matmul": rowwise_matmul.launches}

    report: dict = {}
    # -- phase 20: the mixed path, counts set to 0 before it, read after it --
    t0 = time.perf_counter()
    lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
    with block_plain():
        batch_eng = AnomalyStreamEngine(params, cfg, impl="mixed")
        assert batch_eng.effective_impl == "mixed", batch_eng.effective_impl
        np.testing.assert_allclose(batch_eng.score(windows), golden["scores/wdtypes"], **TOL,
                                   err_msg="mixed batch scores vs reference")
        lock = mixed_engine(batch=len(windows))
        streamed = [s for pos in range(0, T, 25) for s in lock.push(windows[:, pos : pos + 25])]
        np.testing.assert_allclose(streamed[0], golden["streamed/wdtypes"], **TOL,
                                   err_msg="mixed streamed scores vs reference")
        layers = {"enc": lock._exec_enc.plan.layer_assignment(),
                  "dec": lock._exec_dec.plan.layer_assignment()}
        if layers != json.loads(str(golden["layers/wdtypes"])):
            raise AssertionError(f"mixed layer assignment {layers} differs from the reference's")
        for split in (1, 2):
            one, stream, lay = mixed_split_scores(params, base, windows, split, dev)
            np.testing.assert_allclose(one, golden[f"scores/split{split}"], **TOL,
                                       err_msg=f"split={split} scores vs reference")
            np.testing.assert_allclose(stream, golden[f"streamed/split{split}"], **TOL,
                                       err_msg=f"split={split} streamed vs reference")
            if lay != json.loads(str(golden[f"layers/split{split}"])):
                raise AssertionError(f"split={split} layer assignment differs: {lay}")
        eng = mixed_engine()
        one_shot = eng.score(windows[:1])
        for chunk in (1, 25):
            got = [s for pos in range(0, T, chunk) for s in eng.push(windows[:1, pos : pos + chunk])]
            assert len(got) == 1
            np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                                       err_msg=f"mixed, chunks of {chunk} vs one-shot")
        n = 32
        x = np.random.RandomState(20).randn(n, 2 * T, 1).astype(np.float32)
        ids = [f"m{i}" for i in range(n)]
        pool = mixed_engine()
        got = {sid: [] for sid in ids}
        decodes = []
        for a in range(0, 2 * T, 25):
            before = lstm_stack.launches
            res = pool.push_many(ids, x[:, a : a + 25])
            decodes.append(lstm_stack.launches - before)
            for sid in ids:
                got[sid] += res[sid]
        n_dec = len(pool._exec_dec.plan.segments)
        if decodes != [n_dec * int((a + 25) % T == 0) for a in range(0, 2 * T, 25)]:
            raise AssertionError(f"mixed push_many: K1 launches per piece {decodes}, want "
                                 f"{n_dec} (one per decoder segment) per window completion")
        seq = mixed_engine()
        want = {}
        for i, sid in enumerate(ids):
            seq.reset()
            want[sid] = [sc for pos in range(0, 2 * T, 25) for sc in
                         seq.push(x[i : i + 1, pos : pos + 25])]
        assert_bit_equal(got, want, f"mixed push_many over {n} streams")
        src = mixed_engine()
        src.push(windows[:1, :37])
        src.push_many(["p", "q"], windows[:2, :41])
        dst = mixed_engine()
        dst.restore(src.snapshot())
        np.testing.assert_array_equal(dst.push(windows[:1, 37:T])[0], src.push(windows[:1, 37:T])[0],
                                      err_msg="mixed snapshot round trip, lock-step")
        r_dst, r_src = dst.push_many(["p", "q"], windows[:2, 41:T]), src.push_many(["p", "q"],
                                                                                    windows[:2, 41:T])
        assert_bit_equal(r_dst, r_src, "mixed snapshot round trip, pool")
        torch.cuda.synchronize()
    launches = counts()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the mixed path never launched {name}")
    per_window = {}
    for mode, chunk in (("mixed_push_T1", 1), ("mixed_push_T25", 25)):
        lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
        for pos in range(0, T, chunk):
            eng.push(windows[:1, pos : pos + chunk])
        per_window[mode] = counts()
    lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
    batch_eng.score(windows)
    per_window[f"mixed_score_call_B{len(windows)}"] = counts()
    log(f"phase 20 mixed path ok: {MIXED_WDS} scores within 1e-5 of the reference (engines "
        f"and split=1/2 on each segment), chunked == one-shot, push_many over {n} streams "
        f"bit-equal ({decodes}), snapshot round trip bit-equal, launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")

    # mixed == hand-chained fused_step segments, bit for bit, at full width
    t0 = time.perf_counter()
    n_eq = 0
    for seg, (plist, cfgs) in (("enc", encoder_layers(params, cfg)),
                               ("dec", decoder_layers(params, cfg))):
        mex = plan_stack(cfgs, impl="mixed").bind(plist)
        wds = mex.plan.weight_dtype
        subs = [plan_stack(cfgs[a:b], impl="fused_step", weight_dtype=wds[a]).bind(plist[a:b])
                for a, b in segment_runs(wds)]
        in_dim = cfgs[0].in_dim
        for t_len in (T, 1, 25, 40):  # the batch forward, then steps (40 > chunk_len: K1)
            if seg == "enc":
                xin = torch.randn(20, t_len, in_dim, generator=gen)
            else:
                xin = torch.rand(20, 1, in_dim, generator=gen).expand(20, t_len, in_dim) * 2 - 1
            xin = xin.to(dev)
            with torch.no_grad():
                if t_len == T:
                    h_got, f_got = mex(xin)
                    h, f_want = xin, []
                    for sub in subs:
                        h, f = sub(h)
                        f_want.extend(f)
                else:
                    h_got, f_got = mex.step_with_output(xin, mex.zero_state(20))
                    h, f_want = xin, []
                    for sub in subs:
                        h, st = sub.step_with_output(h, sub.zero_state(20))
                        f_want.append(st)
            torch.cuda.synchronize()
            compare([h_got, *state_leaves(f_got)], [h, *state_leaves(f_want)],
                    f"mixed {seg} T={t_len} vs hand-chained segments")
            n_eq += 1
    # the step graph (the whole chain, one replay) and the batched decode graph
    ex = mixed_engine()._exec_enc
    n_seg = len(ex.plan.segments)
    for width in (1, 8, 32):
        for t_len in (1, 25):
            xs = torch.randn(width, t_len, 1, generator=gen).to(dev)
            st0 = tuple(((torch.randn(h.shape, generator=gen) * 0.3).to(dev),
                         (torch.randn(c.shape, generator=gen) * 0.3).to(dev))
                        for h, c in ex.zero_state(width))
            want = ex.step(xs, st0)
            graph = ex.step_graph(width)
            first = [t.clone() for t in state_leaves(graph(xs, st0))]
            before = lstm_stack_step.launches
            got = graph(xs, st0)
            torch.cuda.synchronize()
            if lstm_stack_step.launches - before != n_seg:
                raise AssertionError(f"mixed step graph width {width}: a replay counted "
                                     f"{lstm_stack_step.launches - before} K2 launches, want "
                                     f"{n_seg}")
            compare(first, state_leaves(want), f"mixed step graph width {width} T={t_len}, first")
            compare(state_leaves(got), state_leaves(want),
                    f"mixed step graph width {width} T={t_len}, replay")
    for k in (1, 3, 8, 32):
        xk = np.random.RandomState(k).randn(k, 2 * T, 1).astype(np.float32)
        ids = [f"f{i}" for i in range(k)]
        runs = []
        for graphs in (False, True):
            e = mixed_engine(graphs=graphs)
            runs.append([np.concatenate([e.push_many(ids, xk[:, w * T : (w + 1) * T])[sid][0]
                                         for sid in ids]) for w in range(2)])
        for w in range(2):
            np.testing.assert_array_equal(runs[1][w], runs[0][w],
                                          err_msg=f"mixed batched decode k={k} window {w}: "
                                                  "replay vs eager")
    log(f"phase 20 mixed == hand-chained segments: {n_eq} cases (batch forward T={T}, steps "
        f"T=1/25, a T=40 piece on K1), step graph replay == eager at widths 1/8/32 (one "
        f"replay, {n_seg} K2 launches), batched decode replay == eager at 1/3/8/32 streams "
        f"({time.perf_counter() - t0:.1f} s)")

    # mixed vs fused_step: push, server and batch score, in turns
    t0 = time.perf_counter()
    engines = {"fused_step": StreamingAnomalyEngine(params, base, batch=1), "mixed": mixed_engine()}
    push = {name: [] for name in engines}
    for name in ("fused_step", "mixed", "mixed", "fused_step"):
        push[name] += push_times(engines[name], windows)
    report["push_T1_B1"] = {
        name: {"median_ms": statistics.median(v), "p99_ms": float(np.percentile(v, 99)),
               "n": len(v)} for name, v in push.items()}
    scorers = {"fused_stack": AnomalyStreamEngine(params, base, impl="fused_stack"),
               "mixed": AnomalyStreamEngine(params, cfg, impl="mixed")}
    w20 = np.concatenate([windows] * 3)[:20]
    score_ms = {name: [] for name in scorers}
    for name in ("fused_stack", "mixed", "mixed", "fused_stack"):
        for _ in range(12):
            t1 = time.perf_counter()
            scorers[name].score(w20)
            score_ms[name].append((time.perf_counter() - t1) * 1e3)
    report["score_B20_ms_median"] = {k: statistics.median(v[2:]) for k, v in score_ms.items()}
    report["server_replay_threaded"] = {}
    for name, make in (("fused_step", lambda: StreamingAnomalyEngine(params, base, batch=1)),
                       ("mixed", mixed_engine)):
        threaded, errors = threaded_run(make, make(), np.random.RandomState(20), T, name)
        if errors:
            raise AssertionError(f"{name} server: {errors} engine-step errors")
        report["server_replay_threaded"][name] = threaded
    log(smi)
    log(f"phase 20 timing: T=1 push B=1 replay " + ", ".join(
        f"{k} median {r['median_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms"
        for k, r in report["push_T1_B1"].items())
        + "; score B=20 " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in report["score_B20_ms_median"].items())
        + "; threaded server " + ", ".join(
            f"{k} p50 {r['p50_us']:.0f} us p99 {r['p99_us']:.0f} us"
            for k, r in report["server_replay_threaded"].items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    # -- phase 21: tune="balanced" -------------------------------------------
    t0 = time.perf_counter()
    report["balanced"] = {}
    for seg, (plist, cfgs) in (("enc", encoder_layers(params, base)),
                               ("dec", decoder_layers(params, base))):
        choice = choose_mixed_split(cfgs)  # the H100's floors at B=8, T=8
        plan = plan_stack(cfgs, impl="mixed", tune="balanced")
        if plan.weight_dtype != choice.dtypes or plan.knob_provenance()["split"][1] != "balanced":
            raise AssertionError(f"balanced {seg}: plan {plan.describe()} vs choice {choice}")
        ex = plan.bind(plist)
        measured = []
        for sub in ex._segment_executors():
            xs = torch.randn(8, 8, sub.plan.cfgs[0].in_dim, generator=gen).to(dev)
            graph = sub.step_graph(8)
            run = lambda graph=graph, xs=xs: graph(xs, graph.state)  # noqa: E731
            measured.append({"replay_ms": median_ms(run, reps=50),
                             "device_ms": device_ms(run, reps=50, kernel="lstm_stack_kernel")})
        xs = torch.randn(8, 8, cfgs[0].in_dim, generator=gen).to(dev)
        chain = ex.step_graph(8)
        report["balanced"][seg] = {
            "split": plan.split, "weight_dtype": list(plan.weight_dtype),
            "predicted_us": list(choice.segment_us), "segments": measured,
            "chain_replay_ms": median_ms(lambda: chain(xs, chain.state), reps=50),
            "scored": [["+".join(c), m, t] for c, m, t in choice.scored]}
        log(f"phase 21 balanced {seg}: split={plan.split} {'+'.join(plan.weight_dtype)}; "
            f"predicted (floors) " + ", ".join(f"{u:.4f} us" for u in choice.segment_us)
            + "; measured per segment (B=8, T=8) " + ", ".join(
                f"replay {m['replay_ms']:.4f} ms device "
                + (f"{m['device_ms']:.4f} ms" if m["device_ms"] is not None else "not measured")
                for m in measured))
    bal_cfg = dataclasses.replace(base, impl="mixed")
    bal = StreamingAnomalyEngine(params, bal_cfg, batch=1, impl="mixed", tune="balanced")
    one_shot = bal.score(windows[:1])
    got = [s for pos in range(0, T, 25) for s in bal.push(windows[:1, pos : pos + 25])]
    if not np.all(np.isfinite(one_shot)):
        raise AssertionError(f"balanced engine scores are not finite: {one_shot}")
    np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                               err_msg="balanced engine, chunked vs one-shot")
    log(f"phase 21 balanced engine ok: {bal.fingerprint()['weight_dtype']} encoder, chunked == "
        f"one-shot ({time.perf_counter() - t0:.1f} s)")

    # -- phase 22: a smoke sweep through launch/tune.py ---------------------
    t0 = time.perf_counter()
    report["sweep"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache_path = f"{tmp}/tuned.json"
        for seg, dims in (("enc", "1x32,32x8"), ("dec", "8x8,8x32")):
            for impl in ("mixed", "fused_step"):
                out = tune_cli.main(
                    ["--dims", dims, "--impl", impl, "--batch", "8", "--t-len", "8",
                     "--k", "3", "--reps", "20", "--max-points", "24", "--device", "cuda",
                     "--jsonl", f"{tmp}/{seg}_{impl}.jsonl", "--cache", cache_path]
                    + (["--balanced"] if impl == "mixed" else []))
                ((_, best, default, ratio),) = out["winners"]
                fit = out["fit"]
                report["sweep"][f"{seg}_{impl}"] = {
                    "best": best["point"], "best_us": best["us"], "default_us": default["us"],
                    "best_vs_default": ratio, "fit": fit.describe(),
                    "fit_median_rel_err": fit.median_rel_err, "fit_max_rel_err": fit.max_rel_err,
                    "per_record": [[p, pred, meas, err] for _, p, pred, meas, err in fit.per_record],
                    "balanced_split": {k: c.split for k, c in out["choices"].items()}}
        old = set_cache(TunedPlanCache.load(cache_path))
        try:
            tuned_plans = []
            for seg, (plist, cfgs) in (("enc", encoder_layers(params, base)),
                                       ("dec", decoder_layers(params, base))):
                for impl in ("mixed", "fused_step"):
                    plan = plan_stack(cfgs, impl=impl, tune="cached")
                    tuned = sorted(k for k, (_, src) in plan.knob_provenance().items()
                                   if src == "tuned")
                    if not tuned:
                        continue
                    tuned_plans.append(f"{seg} {impl}: {plan.describe()} (tuned {tuned})")
                    ex = plan.bind(plist)
                    t_len = min(8, plan.chunk_len)
                    xs = torch.randn(8, t_len, cfgs[0].in_dim, generator=gen).to(dev)
                    st0 = ex.zero_state(8)
                    want = ex.step(xs, st0)
                    graph = ex.step_graph(8)
                    graph(xs, st0)
                    got = graph(xs, st0)
                    torch.cuda.synchronize()
                    compare(state_leaves(got), state_leaves(want),
                            f"tuned {seg} {impl} plan: replay vs eager")
        finally:
            set_cache(old)
    if not tuned_plans:
        raise AssertionError("no plan resolved a knob from the swept cache as 'tuned'")
    report["sweep"]["tuned_plans"] = tuned_plans
    log(smi)
    log(f"phase 22 sweep ok: " + "; ".join(
        f"{k} best {v['best']} {v['best_vs_default']:.3f}x vs default, fit median "
        f"{v['fit_median_rel_err']:.3f} max {v['fit_max_rel_err']:.3f}"
        for k, v in report["sweep"].items() if k != "tuned_plans")
        + f"; tune='cached' plans: {tuned_plans}, replay == eager "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, per_window, report


def recipe_evals(params, cfg, ds, dev) -> dict:
    """The fig9 recipe's evaluations (``RECIPE_EVALS`` in order, each on
    ``RECIPE["n_eval"]`` background then signal windows drawn from ``ds``),
    then the fused fp32 engine calibrated to 5% FPR: the order of draws of
    ``tests/test_torch_golden_train.py``, whose fixture holds the
    reference's values.  Returns {name: (scores (2, n), auc), "fpr", "tpr"}."""
    import torch
    from repro_torch.core.autoencoder import auc_score, reconstruction_error
    from repro_torch.core.quant import PAPER_HW, quantize_tree
    from repro_torch.serve.engine import AnomalyStreamEngine

    out, n = {}, RECIPE["n_eval"]
    for name in RECIPE_EVALS:
        p, c = params, cfg
        if name in ("q16", "hw"):
            p = quantize_tree(params)
        if name == "hw":
            c = dataclasses.replace(cfg, acts=PAPER_HW)
        if name.startswith("fused_"):
            c = dataclasses.replace(cfg, impl="fused_stack", weight_dtype=name[6:])
        with torch.no_grad():
            neg, pos = (reconstruction_error(p, torch.from_numpy(x).to(dev), c).cpu().numpy()
                        for x in (ds.background(n), ds.events(n)))
        out[name] = (np.stack([neg, pos]), auc_score(neg, pos))
    eng = AnomalyStreamEngine(params, cfg, device=dev)
    eng.calibrate(ds.background(512), fpr=0.05)
    out["fpr"] = float(eng.flag(ds.background(256)).mean())
    out["tpr"] = float(eng.flag(ds.events(256)).mean())
    return out


def gw_train_phases(dev, smi: str, block_plain) -> tuple[dict, dict]:
    """Phases 23-25, this slice's path: GW training on the card.

    23. ``mse_loss`` and its gradients at full width (gw_nominal, B=64,
        T=100) and on gw_small, against the reference's in
        ``tests/data/torch_port_gw_train.npz``; 5 AdamW steps against the
        fixture's; 5 replayed steps bit-equal to 5 eager ones.  Before it,
        the row-wise kernel against its plain version, bit for bit, at the
        shapes training and the evaluation give it.
    24. The fig9 recipe: ``Trainer`` (replayed steps) over ``mse_loss`` on
        gw_small, 200 steps of B=32 from the fixture's init on the port's
        ``GwDataset``, then the AUCs on ``split``, after ``quantize_tree``,
        with PAPER_HW and on ``fused_stack`` fp32/bf16/int8 (K1), and the
        calibrated engine's FPR and TPR, against the reference's; the same
        evaluations of the reference's trained params, score for score;
        fused scores of the trained params equal to split scores (no stale
        pack); K1 on the trained params' fp32, bf16 and int8 packs at the
        evaluation's B bit-equal to its plain version.
    25. Step times eager and replayed (gw_nominal B=64, gw_small B=32) with
        the device's busy time, idle share and device operations per step
        (``STEP_TRACE_CALLS``);
        a kill-and-resume through ``Trainer`` bit-equal to an uninterrupted
        run.

    Counts are set to 0 just before the training run and the evaluation
    and read just after each.  Returns (launches by path and kernel, the
    report)."""
    import torch
    from repro_torch.configs.gw import GW_MODELS
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy, unflatten
    from repro_torch.core.autoencoder import (
        decoder_layers,
        encoder_layers,
        mse_loss,
        reconstruction_error,
    )
    from repro_torch.core.graphs import CapturedStep
    from repro_torch.core.quant import kernel_safe
    from repro_torch.data.gw import GwDataConfig, GwDataset
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0
    from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref
    from repro_torch.kernels.rowwise import rowwise_matmul, rowwise_matmul_plain
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten, tree_leaves

    with np.load(TRAIN_FIXTURE) as data:
        golden = {k: data[k] for k in data.files}

    def tree_of(prefix):
        return params_from_numpy(unflatten(golden, prefix=prefix + "/"), dev)

    def counts():
        return {"lstm_stack_wavefront": lstm_stack.launches,
                "rowwise_matmul": rowwise_matmul.launches}

    def zero_counts():
        lstm_stack.launches = rowwise_matmul.launches = 0

    def loss_of(cfg):
        return lambda p, b: mse_loss(p, b, cfg)

    def as_state(step):
        def step_fn(st, batch):
            loss, p, o = step(st["params"], st["opt"], batch)
            return loss, {"params": p, "opt": o}
        return step_fn

    def bit_equal(a, b, what):
        leaves = lambda t: t if isinstance(t, list) else tree_leaves(t)  # noqa: E731
        for x, y in zip(leaves(a), leaves(b), strict=True):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: not bit-equal (max |difference| "
                                     f"{(x.float() - y.float()).abs().max().item():.3g})")

    nominal, small = GW_MODELS["gw_nominal"], GW_MODELS["gw_small"]
    T = nominal.timesteps
    report: dict = {}
    launches: dict = {}

    # -- phase 23: gradients at full width, 5 steps, replay == eager ---------
    t0 = time.perf_counter()
    # the row-wise kernel at the shapes this path gives it: the dense head
    # (no bias: it is added after) and the error sum of every training
    # forward (gw_small B=32, gw_nominal B=64), and of the evaluation's
    # batches (gw_small B=192), with layer 0's projection on the fused path
    gen = torch.Generator().manual_seed(23)
    rw_cases = []
    for name, batch in (("small", RECIPE["batch"]), ("nominal", 64), ("small", RECIPE["n_eval"])):
        head_w = tree_of(f"{name}/params")["dense"]["w"].float()
        rw_cases += [
            (f"gw_{name} dense head", torch.rand(batch * T, head_w.shape[0], generator=gen) * 2 - 1,
             head_w),
            (f"gw_{name} error sum", torch.rand(batch, T, generator=gen), torch.ones(T, 1))]
    w0 = pack_stack(*encoder_layers(tree_of("small/params"), small)).stacked["w_x"][0]
    rw_cases.append(("gw_small layer-0 projection",
                     torch.randn(RECIPE["n_eval"] * T, w0.shape[0], generator=gen), w0))
    rw_shapes = []
    for what, xr, wr in rw_cases:
        xr, wr = xr.to(dev), wr.to(dev)
        got, want = rowwise_matmul(xr, wr), rowwise_matmul_plain(xr, wr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"rowwise_matmul {what} {tuple(xr.shape)}: kernel differs "
                                 f"from its plain version")
        rw_shapes.append([what, *xr.shape, wr.shape[1]])
    report["rowwise_bit_equal"] = rw_shapes
    zero_counts()
    with block_plain():
        for name in ("small", "nominal"):
            loss, grads = value_and_grad(loss_of(GW_MODELS[f"gw_{name}"]),
                                         tree_of(f"{name}/params"),
                                         torch.from_numpy(golden["batch"]).to(dev))
            want = float(golden[f"{name}/loss"])
            loss_rel = abs(float(loss) - want) / abs(want)
            grad_rel = 0.0
            want_g = flatten(unflatten(golden, prefix=f"{name}/grads/"))
            got_g = flatten(grads)
            if list(got_g) != list(want_g):
                raise AssertionError(f"gw_{name} gradient leaves {list(got_g)}")
            for key, w in want_g.items():
                err = np.abs(got_g[key].cpu().numpy() - w).max() / np.abs(w).max()
                grad_rel = max(grad_rel, float(err))
            if loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_REL:
                raise AssertionError(f"gw_{name}: loss {loss_rel:.3g} relative (limit "
                                     f"{TRAIN_LOSS_RTOL}), gradients {grad_rel:.3g} of their "
                                     f"largest (limit {TRAIN_GRAD_REL})")
            report[f"gw_{name}_grads"] = {"B": len(golden["batch"]), "T": T,
                                          "loss_rel_err": loss_rel, "grad_rel_err": grad_rel}
        step = make_train_step(loss_of(nominal), AdamWConfig(**OPT5))
        batches = [torch.from_numpy(b).to(dev) for b in golden["steps/batches"]]
        params = tree_of("nominal/params")
        opt = init_opt_state(params, AdamWConfig(**OPT5))
        eager_losses = []
        for batch in batches:
            loss, params, opt = step(params, opt, batch)
            eager_losses.append(loss)
        np.testing.assert_allclose([float(v) for v in eager_losses], golden["steps/losses"],
                                   rtol=1e-5, err_msg="5 AdamW steps: losses")
        want_opt = opt_state_from_numpy(unflatten(golden, prefix="steps/opt/"), dev)
        g0 = flatten(unflatten(golden, prefix="steps/grads0/"))
        got = flatten({"params": params, "m": opt["m"], "v": opt["v"]})
        want = flatten({"params": tree_of("steps/params"), "m": want_opt["m"],
                        "v": want_opt["v"]})
        step_err = 0.0
        for key, w in want.items():
            g = g0[key.split("/", 1)[1]]
            undecided = np.abs(g) <= TRAIN_GRAD_REL * np.abs(g).max()
            diff = np.abs(got[key].cpu().numpy() - w.cpu().numpy())
            limit = TRAIN_STEP_ATOL if not key.startswith("params/") else np.where(
                undecided, 2 * OPT5["lr"] * len(batches), TRAIN_STEP_ATOL)
            if not (diff <= limit).all():
                raise AssertionError(f"5 AdamW steps: {key} off by {diff.max():.3g}")
            step_err = max(step_err, float(np.where(undecided, 0, diff).max()
                                           if key.startswith("params/") else diff.max()))
        state = {"params": tree_of("nominal/params"),
                 "opt": init_opt_state(tree_of("nominal/params"), AdamWConfig(**OPT5))}
        captured = CapturedStep(as_state(step), state, dev)
        replay_losses = [captured(batch).clone() for batch in batches]
        torch.cuda.synchronize()
        bit_equal(replay_losses, eager_losses, "replayed step losses vs eager")
        bit_equal(state, {"params": params, "opt": opt}, "5 replayed steps vs 5 eager steps")
    report["gw_nominal_5_steps"] = {"max_abs_err_decided": step_err,
                                    "replay_bit_equal": True}
    launches["grads_and_steps"] = counts()
    log(f"phase 23 training parity ok: gw_nominal loss {report['gw_nominal_grads']['loss_rel_err']:.2g} "
        f"relative, gradients {report['gw_nominal_grads']['grad_rel_err']:.2g} of their largest "
        f"(limits {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_REL}); gw_small "
        f"{report['gw_small_grads']['loss_rel_err']:.2g}, "
        f"{report['gw_small_grads']['grad_rel_err']:.2g}; 5 AdamW steps within {step_err:.2g}; "
        f"5 replayed steps bit-equal to eager; rowwise_matmul bit-equal to its plain version "
        f"at {len(rw_cases)} shapes of training and evaluation "
        f"({', '.join('x'.join(map(str, r[1:])) for r in rw_shapes)}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 24: the fig9 recipe on the card --------------------------------
    t0 = time.perf_counter()
    ds = GwDataset(GwDataConfig(timesteps=T, seed=0))
    init = tree_of("small/params")
    init_copy = [t.clone() for t in tree_leaves(init)]
    with tempfile.TemporaryDirectory() as ckpt, block_plain():
        trainer = Trainer(loss_of(small), lambda gen: init,
                          (ds.background(RECIPE["batch"]) for _ in range(RECIPE["steps"])),
                          TrainerConfig(total_steps=RECIPE["steps"], checkpoint_every=10**9,
                                        opt=AdamWConfig(**RECIPE_OPT)), ckpt, device=dev)
        zero_counts()
        t1 = time.perf_counter()
        result = trainer.run(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t1
        launches["train"] = counts()
        zero_counts()
        evals = recipe_evals(trainer.params, small, ds, dev)
        torch.cuda.synchronize()
        launches["train_eval"] = counts()
    for name, count in {**launches["train_eval"],
                        "rowwise_matmul": launches["train"]["rowwise_matmul"]}.items():
        if count == 0:
            raise AssertionError(f"the training path never launched {name}")
    losses = result.losses
    want_losses = golden["recipe/losses"]
    aucs = {name: evals[name][1] for name in RECIPE_EVALS}
    for name, auc in aucs.items():
        if abs(auc - float(golden[f"recipe/auc/{name}"])) >= 0.03:
            raise AssertionError(f"recipe AUC {name}: {auc:.4f}, the reference's "
                                 f"{float(golden[f'recipe/auc/{name}']):.4f} (limit 0.03)")
    if abs(losses[-1] - want_losses[-1]) >= 0.05 * want_losses[-1]:
        raise AssertionError(f"recipe final loss {losses[-1]:.5f}, the reference's "
                             f"{want_losses[-1]:.5f} (limit 5%)")
    if not (aucs["fp32"] > 0.8 and abs(aucs["q16"] - aucs["fp32"]) < 0.05
            and abs(aucs["hw"] - aucs["fp32"]) < 0.08 and evals["fpr"] < 0.15
            and evals["tpr"] > 3 * max(evals["fpr"], 0.02)):
        raise AssertionError(f"recipe thresholds of tests/test_gw_e2e.py: AUCs {aucs}, "
                             f"FPR {evals['fpr']}, TPR {evals['tpr']}")
    # the reference's trained params on the same windows, score for score
    ds_ref = GwDataset(GwDataConfig(timesteps=T, seed=0))
    for _ in range(RECIPE["steps"]):
        ds_ref.background(RECIPE["batch"])
    with block_plain():
        ref_evals = recipe_evals(tree_of("recipe/params"), small, ds_ref, dev)
    score_err = 0.0
    for name in RECIPE_EVALS:
        want_s = golden[f"recipe/scores/{name}"]
        np.testing.assert_allclose(ref_evals[name][0], want_s, **TOL,
                                   err_msg=f"reference-trained params, {name} scores")
        score_err = max(score_err, float(np.abs(ref_evals[name][0] - want_s).max()))
    # no stale pack: fused scores of the trained params are split scores,
    # not the init's (whose pack the first evaluation may have cached)
    x = torch.from_numpy(GwDataset(GwDataConfig(timesteps=T, seed=3)).background(64)).to(dev)
    fused = dataclasses.replace(small, impl="fused_stack")
    with torch.no_grad(), block_plain():
        before = reconstruction_error(init, x, fused)
        after = reconstruction_error(trainer.params, x, fused)
        split_after = reconstruction_error(trainer.params, x, small)
    torch.testing.assert_close(after, split_after, **TOL)
    if torch.allclose(after, before, **TOL):
        raise AssertionError("fused scores after training equal the untrained ones")
    bit_equal(tree_leaves(init), init_copy, "the caller's init params after training")
    # K1 against its plain version on the trained params' packs, at the
    # evaluation's batch: encoder on windows, decoder on the repeated latent
    windows = torch.from_numpy(GwDataset(GwDataConfig(timesteps=T, seed=6)).background(
        RECIPE["n_eval"])).to(dev)
    k1_cases = []
    with torch.no_grad():
        for wd in ("fp32", "bf16", "int8"):
            c = dataclasses.replace(small, weight_dtype=wd)
            x = windows
            for seg, layers in (("enc", encoder_layers), ("dec", decoder_layers)):
                pk = pack_stack(*layers(trainer.params, c))
                st = pk.stacked
                xw0 = project_layer0(pk.pad_input(x), st, wd)
                h0, c0 = pk.zero_state(x.shape[0])
                scales = st["scales"] if wd == "int8" else None
                acts = kernel_safe(pk.acts)
                got = lstm_stack(xw0, st["w_x"], st["w_h"], st["b"], h0, c0, scales=scales,
                                 acts=acts)
                want = lstm_stack_ref(xw0, st["w_x"], st["w_h"], st["b"], h0, c0,
                                      scales=scales, sigma=acts.sigma, tanh=acts.tanh)
                torch.cuda.synchronize()
                bit_equal(list(got), list(want), f"K1 {wd} {seg} B={x.shape[0]} W={pk.width_p}")
                k1_cases.append(f"{wd} {seg}")
                latent = got[0][-1, :, :pk.hidden[-1]]
                x = latent[:, None, :].expand(latent.shape[0], T, latent.shape[1])
    report["recipe"] = {
        "model": "gw_small", "steps": RECIPE["steps"], "batch": RECIPE["batch"],
        "train_wall_s": train_wall, "ms_per_step_wall": train_wall / RECIPE["steps"] * 1e3,
        "loss_first": losses[0], "loss_final": losses[-1],
        "ref_loss_final": float(want_losses[-1]),
        "auc": aucs, "ref_auc": {n: float(golden[f"recipe/auc/{n}"]) for n in RECIPE_EVALS},
        "fpr": evals["fpr"], "tpr": evals["tpr"],
        "ref_fpr": float(golden["recipe/fpr"]), "ref_tpr": float(golden["recipe/tpr"]),
        "ref_params_max_score_err": score_err, "ref_params_auc": {
            n: ref_evals[n][1] for n in RECIPE_EVALS},
        "launches_train": launches["train"], "launches_eval": launches["train_eval"],
        "k1_bit_equal": k1_cases}
    log(f"phase 24 fig9 recipe ok: 200 steps B=32 in {train_wall:.2f} s "
        f"({train_wall / RECIPE['steps'] * 1e3:.2f} ms/step), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (reference {want_losses[-1]:.4f}); AUC " + ", ".join(
            f"{n} {aucs[n]:.4f} ({float(golden[f'recipe/auc/{n}']):.4f})" for n in RECIPE_EVALS)
        + f"; FPR {evals['fpr']:.4f} TPR {evals['tpr']:.4f}; K1 bit-equal to its plain "
        f"version at B={RECIPE['n_eval']} on {len(k1_cases)} packs ({', '.join(k1_cases)}); "
        f"reference-trained scores within "
        f"{score_err:.2g}; launches {launches['train']} training, {launches['train_eval']} "
        f"evaluating ({time.perf_counter() - t0:.1f} s)")

    # -- phase 25: step timing, eager vs replay; kill and resume ---------------
    t0 = time.perf_counter()
    timing = {}
    for name, cfg, batch_size in (("gw_nominal", nominal, 64), ("gw_small", small, 32)):
        step = make_train_step(loss_of(cfg), AdamWConfig(**RECIPE_OPT))
        batch = torch.from_numpy(
            GwDataset(GwDataConfig(timesteps=T, seed=4)).background(batch_size)).to(dev)
        p0 = tree_of(f"{name.split('_')[1]}/params")
        eager_state = [p0, init_opt_state(p0, AdamWConfig(**RECIPE_OPT))]

        def eager():
            loss, p, o = step(eager_state[0], eager_state[1], batch)
            eager_state[:] = [p, o]
            return float(loss)

        p1 = tree_of(f"{name.split('_')[1]}/params")
        captured = CapturedStep(as_state(step), {
            "params": p1, "opt": init_opt_state(p1, AdamWConfig(**RECIPE_OPT))}, dev)
        t1 = time.perf_counter()
        captured(batch)  # the eager first step and the capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t1

        def replay():
            return float(captured(batch))

        zero_counts()
        eager()
        rowwise_per_step = rowwise_matmul.launches
        # a step's span: from a CUDA event before it to one after the loss
        # was read (the trainer's step), no profiler on
        ms = {"eager": [], "replay": []}
        reps = 4 if name == "gw_nominal" else 8
        for mode in ("eager", "replay", "replay", "eager"):  # in turns
            fn = eager if mode == "eager" else replay
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms[mode].append(start.elapsed_time(end))
        row = {"B": batch_size, "T": T, "capture_s": capture_s,
               "rowwise_launches_per_step": rowwise_per_step}
        t1 = time.perf_counter()
        for mode, fn in (("eager", eager), ("replay", replay)):
            # a step's busy time: the summed device time of its operations
            # over STEP_TRACE_CALLS steps traced apart (device activity
            # alone, ~28 k events a gw_nominal step); idle share = 1 -
            # busy / the untraced steps' median span
            n_ops, busy_us = kernel_trace(fn, STEP_TRACE_CALLS, host=False)
            span = statistics.median(ms[mode])
            busy = busy_us / 1e3 / STEP_TRACE_CALLS if n_ops else None
            row[mode] = {"step_ms_median": span, "step_ms_min": min(ms[mode]),
                         "step_ms_max": max(ms[mode]), "device_busy_ms": busy,
                         "idle_share": 1 - busy / span if n_ops else None,
                         "device_ops_per_step": n_ops / STEP_TRACE_CALLS}
        row["trace_s"] = time.perf_counter() - t1
        timing[name] = row
        log(f"phase 25 {name} B={batch_size} train step: " + ", ".join(
            f"{m} {row[m]['step_ms_median']:.2f} ms ({row[m]['step_ms_min']:.2f}-"
            f"{row[m]['step_ms_max']:.2f}; busy {row[m]['device_busy_ms']} ms traced, idle "
            f"share {row[m]['idle_share']}, {row[m]['device_ops_per_step']} device ops)"
            for m in ("eager", "replay"))
            + f"; capture {capture_s:.2f} s, {rowwise_per_step} row-wise launches/step, "
            f"traces {row['trace_s']:.1f} s")
    report["step_timing"] = timing

    data = GwDataset(GwDataConfig(timesteps=T, seed=5))
    stream = [data.background(RECIPE["batch"]) for _ in range(20)]

    def train(ckpt, total, start=0):
        t = Trainer(loss_of(small), lambda gen: tree_of("small/params"), iter(stream[start:]),
                    TrainerConfig(total_steps=total, checkpoint_every=10,
                                  opt=AdamWConfig(**RECIPE_OPT)), ckpt, device=dev)
        return t, t.run(torch.Generator().manual_seed(0))

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as whole, tempfile.TemporaryDirectory() as cut, \
            block_plain():
        t_whole, r_whole = train(whole, 20)
        train(cut, 10)
        t1 = time.perf_counter()
        t_cut, r_cut = train(cut, 20, start=10)
        resume_s = time.perf_counter() - t1
    if r_cut.resumed_from != 10 or r_cut.losses != r_whole.losses[10:]:
        raise AssertionError(f"resume: from {r_cut.resumed_from}, losses {r_cut.losses} vs "
                             f"{r_whole.losses[10:]}")
    bit_equal({"p": t_cut.params, "o": t_cut.opt_state},
              {"p": t_whole.params, "o": t_whole.opt_state}, "resumed run vs uninterrupted run")
    report["resume"] = {"kill_at": 10, "total": 20, "bit_equal": True,
                        "resume_and_10_steps_s": resume_s}
    log(f"phase 25 kill at step 10 and resume: 20 steps bit-equal to the uninterrupted run "
        f"({time.perf_counter() - t1:.1f} s; phase {time.perf_counter() - t0:.1f} s)")
    return launches, report


def stage_inputs_k1(packed, staged, x, ct: int, acts, compare) -> int:
    """Each stage's K1 launch on its sub-pack against ``lstm_stack_ref`` on
    the same operands, bit for bit: the first chunk (``ct`` timesteps)
    through stage after stage, each stage's input the hidden chunk the
    kernel gave the stage before it, at a random non-zero state.  Returns
    the count of launches held."""
    import torch
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.ops import project_layer0
    from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref

    gen = torch.Generator().manual_seed(26)
    feed = x[:, :ct]
    for s, sub in enumerate(staged.stages):
        dev = staged.mesh[s]
        shape = (sub["w_h"].shape[0], x.shape[0], packed.width_p)
        h0 = (torch.randn(shape, generator=gen) * 0.3).to(packed.dtype).to(dev)
        c0 = (torch.randn(shape, generator=gen) * 0.3).to(dev)
        feed = feed.to(dev)
        xw0 = project_layer0(feed, sub, packed.weight_dtype)
        scales = sub.get("scales") if packed.weight_dtype == "int8" else None
        got = lstm_stack(xw0, sub["w_x"], sub["w_h"], sub["b"], h0, c0, scales=scales,
                         acts=acts)
        want = lstm_stack_ref(xw0, sub["w_x"], sub["w_h"], sub["b"], h0, c0, scales=scales,
                              sigma=acts.sigma, tanh=acts.tanh)
        torch.cuda.synchronize()
        compare(got, want, f"K1 on stage {s}'s sub-pack ({packed.weight_dtype}, "
                           f"{packed.dtype}, B={x.shape[0]}, T={ct})")
        feed = got[0].transpose(0, 1)
    return len(staged.stages)


def gw_sharded_phases(params, cfg, golden: dict, dev, smi: str, compare,
                      block_plain) -> tuple[dict, dict]:
    """Phases 26-28, this slice's path: sharded placement of ``gw_nominal``
    at full width with the golden fixture's weights, its stages sharing the
    card (one stage per card where there are several): ``fused_stack_sharded``
    against the local ``fused_stack`` over a sweep of stages, batches,
    chunkings and storage, each stage's K1 against its plain version on its
    sub-pack; the library and both engines against the golden scores; the
    CLI's server.  Returns (the sharded path's launches by kernel, the
    report)."""
    import torch
    from repro_torch.core.autoencoder import (
        decoder_layers,
        encoder_layers,
        reconstruction_error,
        segment_executors,
    )
    from repro_torch.core.executor import plan_stack
    from repro_torch.core.quant import EXACT, PAPER_HW_KERNEL
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step
    from repro_torch.kernels.rowwise import rowwise_matmul
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

    T = cfg.timesteps
    windows = golden["windows"]
    n_cards = torch.cuda.device_count()
    report: dict = {"cards": n_cards}
    if n_cards > 1:
        log(f"phase 26: {n_cards} cards: the sweep also runs one stage per card")
    else:
        log("phase 26: one card: every stage of a mesh shares it, each on its own stream")

    def counts():
        return {"lstm_stack_wavefront": lstm_stack.launches,
                "lstm_stack_step": lstm_stack_step.launches,
                "rowwise_matmul": rowwise_matmul.launches}

    def zero_counts():
        lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0

    # -- phase 26: fused_stack_sharded against the local fused_stack ---------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(26)
    segments = {"enc": encoder_layers(params, cfg), "dec": decoder_layers(params, cfg)}
    layers = [params[f"lstm_{i}"] for i in range(len(cfg.hidden))]
    segments["stack"] = (layers, cfg.layer_cfgs())
    meshes = {"enc": (1, 2), "dec": (1, 2), "stack": (2, 4)}
    storage = (("fp32", torch.float32), ("bf16", torch.float32), ("int8", torch.float32),
               ("bf16", torch.bfloat16), ("int8", torch.bfloat16))
    n_runs = n_k1 = 0
    bf16_err = 0.0
    for name, (plist, cfgs) in segments.items():
        stage_sets = [(dev,) * s for s in meshes[name]]
        if n_cards > 1 and len(cfgs) % 2 == 0:
            stage_sets.append(tuple(torch.device("cuda", i) for i in range(2)))
        for wd, compute in storage:
            c = [dataclasses.replace(x, dtype=compute) for x in cfgs]
            local = plan_stack(c, impl="fused_stack", weight_dtype=wd).bind(plist)
            for batch in (1, 64):
                if name == "dec":
                    x = (torch.rand(batch, 1, c[0].in_dim, generator=gen) * 2 - 1).expand(
                        batch, T, c[0].in_dim).to(dev)
                else:
                    x = torch.randn(batch, T, c[0].in_dim, generator=gen).to(dev)
                want = local(x)
                for mesh in stage_sets:
                    for n_chunks in (1, 2, 4, 5):
                        ex = plan_stack(c, impl="fused_stack", weight_dtype=wd,
                                        placement="sharded", mesh=mesh,
                                        n_chunks=n_chunks).bind(plist)
                        got = ex(x)
                        torch.cuda.synchronize()
                        pairs = [(got[0], want[0])] + [
                            (a, b) for fg, fw in zip(got[1], want[1]) for a, b in zip(fg, fw)]
                        what = (f"sharded {name} {wd}/{compute} B={batch} stages={len(mesh)} "
                                f"n_chunks={n_chunks}")
                        if compute == torch.float32:
                            if not all(torch.equal(a, b) for a, b in pairs):
                                raise AssertionError(f"{what}: differs from the local fused_stack")
                        else:
                            for a, b in pairs:
                                np.testing.assert_allclose(a.float().cpu().numpy(),
                                                           b.float().cpu().numpy(),
                                                           **K1_BF16_TOL, err_msg=what)
                                bf16_err = max(bf16_err, (a.float() - b.float()).abs().max().item())
                        n_runs += 1
                    if len(mesh) > 1:
                        for acts in (EXACT, PAPER_HW_KERNEL):
                            n_k1 += stage_inputs_k1(ex.packed, ex.staged, ex.packed.pad_input(x),
                                                    T // 4, acts, compare)
    report["sweep"] = {"runs": n_runs, "stage_k1_checks": n_k1, "bf16_max_abs_err": bf16_err}
    log(f"phase 26 fused_stack_sharded ok: {n_runs} runs (segments at 1 and 2 stages, the "
        f"4-layer stack at 2 and 4, B 1/64, n_chunks 1/2/4/5, fp32/bf16/int8 storage at fp32 "
        f"compute bit-equal to the local fused_stack; bf16 compute within K1's bf16 "
        f"tolerance, max |difference| {bf16_err:.3g}); {n_k1} stage K1 launches bit-equal to lstm_stack_ref "
        f"on their sub-packs ({time.perf_counter() - t0:.1f} s)")

    # -- phase 27: the library and both engines (counts 0 before, read after)
    t0 = time.perf_counter()
    mesh2 = (dev, dev)
    x = torch.as_tensor(windows, device=dev)
    zero_counts()
    with block_plain():
        for wd in ("fp32", "bf16", "int8"):
            c = dataclasses.replace(cfg, weight_dtype=wd)
            enc, dec = segment_executors(params, c, impl="fused_stack", placement="sharded",
                                         mesh=mesh2)
            assert enc.plan.impl == dec.plan.impl == "fused_stack_sharded"
            with torch.no_grad():
                lib = reconstruction_error(params, x, c, exec_enc=enc, exec_dec=dec)
            np.testing.assert_allclose(lib.cpu().numpy(), golden[f"scores/{wd}"], **TOL,
                                       err_msg=f"sharded library scores vs reference, {wd}")
            batch_eng = AnomalyStreamEngine(params, c, placement="sharded", mesh=mesh2)
            np.testing.assert_allclose(batch_eng.score(windows), golden[f"scores/{wd}"], **TOL,
                                       err_msg=f"sharded batch engine vs reference, {wd}")
            lock = StreamingAnomalyEngine(params, c, batch=len(windows), placement="sharded",
                                          mesh=mesh2)
            streamed = [s for pos in range(0, T, 25) for s in lock.push(windows[:, pos : pos + 25])]
            np.testing.assert_allclose(streamed[0], golden[f"streamed/{wd}"], **TOL,
                                       err_msg=f"sharded streamed scores vs reference, {wd}")
        eng = StreamingAnomalyEngine(params, cfg, batch=1, placement="sharded", mesh=mesh2)
        if eng._graph_steps or eng._graph_finish:
            raise AssertionError("a sharded engine took the graph capture")
        one_shot = eng.score(windows[:1])
        for chunk in (1, 25):
            got = [s for pos in range(0, T, chunk) for s in eng.push(windows[:1, pos : pos + chunk])]
            np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                                       err_msg=f"sharded, chunks of {chunk} vs one-shot")
        n_streams = check_push_many(
            lambda: StreamingAnomalyEngine(params, cfg, batch=1, placement="sharded",
                                           mesh=mesh2), windows, T)
        torch.cuda.synchronize()
    launches = counts()
    if not launches["lstm_stack_wavefront"] or not launches["rowwise_matmul"]:
        raise AssertionError(f"the sharded path's launches are wrong: {launches}")
    # after the read: these runs have a local engine on one side
    with block_plain():
        for src_kw, dst_kw in ((dict(placement="sharded", mesh=mesh2), {}),
                               ({}, dict(placement="sharded", mesh=mesh2))):
            src = StreamingAnomalyEngine(params, cfg, batch=1, **src_kw)
            dst = StreamingAnomalyEngine(params, cfg, batch=1, **dst_kw)
            src.push(windows[:1, :37])
            src.push_many(["p", "q"], windows[:2, :41])
            dst.restore(src.snapshot())
            np.testing.assert_array_equal(dst.push(windows[:1, 37:T])[0],
                                          src.push(windows[:1, 37:T])[0],
                                          err_msg="snapshot across placements, lock-step")
            assert_bit_equal(dst.push_many(["p", "q"], windows[:2, 41:T]),
                             src.push_many(["p", "q"], windows[:2, 41:T]),
                             "snapshot across placements, pool")
        torch.cuda.synchronize()
    per_window = {}
    for stages in (1, 2):
        e = StreamingAnomalyEngine(params, cfg, batch=1, placement="sharded",
                                   mesh=(dev,) * stages)
        zero_counts()
        for pos in range(T):
            e.push(windows[:1, pos : pos + 1])
        per_window[f"sharded_S{stages}_push_T1"] = counts()
    log(f"phase 27 sharded path ok: library and engines within 1e-5 of the reference "
        f"(fp32/bf16/int8), chunked == one-shot, push_many bit-equal over {n_streams} "
        f"streams, snapshots cross placements, launches {launches}, per window of T=1 "
        f"pushes {per_window} ({time.perf_counter() - t0:.1f} s)")

    # timing: the window at 1, 2 and 4 stages against the local K1 (device
    # time from the profiler, every kernel of a call; host time to issue a
    # call, per tick), the eager push, the batch score
    t0 = time.perf_counter()
    timing = {}
    for name, (plist, cfgs) in (("enc", segments["enc"]), ("stack", segments["stack"])):
        xw = torch.randn(1, T, 1, generator=gen).to(dev)
        rows = {}
        for stages in (0, 1, 2, 4):
            if stages and len(cfgs) % stages:
                continue
            if stages:
                ex = plan_stack(cfgs, impl="fused_stack_sharded", mesh=(dev,) * stages).bind(plist)
                ticks = 2 * stages - 1  # auto n_chunks = stages at T=100
            else:
                ex = plan_stack(cfgs, impl="fused_stack").bind(plist)
                ticks = 1
            st = ex.zero_state(1)
            with torch.no_grad():
                call = lambda: ex.step(xw, st)  # noqa: E731
                ms = median_ms(call, reps=50)
                dev_ms = device_ms(call, reps=20)
                host = []
                for _ in range(50):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    call()
                    host.append((time.perf_counter() - t1) * 1e3)
                torch.cuda.synchronize()
            rows["local" if not stages else f"S{stages}"] = {
                "ms": ms, "device_ms": dev_ms, "host_issue_ms": statistics.median(host),
                "host_ms_per_tick": statistics.median(host) / ticks, "ticks": ticks}
        timing[f"window_T{T}_B1_{name}"] = rows
    push = {}
    for label, kw in (("replay", {}), ("sharded_S1", dict(placement="sharded")),
                      ("sharded_S2", dict(placement="sharded", mesh=mesh2))):
        e = StreamingAnomalyEngine(params, cfg, batch=1, **kw)
        v = push_times(e, windows) + push_times(e, windows)
        push[label] = {"median_ms": statistics.median(v), "p99_ms": float(np.percentile(v, 99)),
                       "n": len(v)}
    timing["push_T1_B1"] = push
    score = {}
    for label, kw in (("local", {}), ("sharded_S2", dict(placement="sharded", mesh=mesh2))):
        e = AnomalyStreamEngine(params, cfg, **kw)
        e.score(windows)
        v = []
        for _ in range(20):
            t1 = time.perf_counter()
            e.score(windows)
            v.append((time.perf_counter() - t1) * 1e3)
        score[label] = statistics.median(v)
    timing[f"score_B{len(windows)}_ms_median"] = score
    report["timing"] = timing
    report["launches_per_window"] = per_window
    log(smi)
    log(f"phase 27 sharded timing: " + "; ".join(
        f"{k}: " + ", ".join(f"{s} {r['ms']:.4f} ms (device {r['device_ms']}, host "
                             f"{r['host_ms_per_tick']:.4f} ms/tick)" for s, r in v.items())
        for k, v in timing.items() if k.startswith("window"))
        + "; push " + ", ".join(f"{k} {r['median_ms']:.4f}/{r['p99_ms']:.4f} ms"
                                for k, r in push.items())
        + f"; score {score} ({time.perf_counter() - t0:.1f} s)")

    # -- phase 28: the CLI's server on the sharded placement ------------------
    t0 = time.perf_counter()
    out = serve_cli.main(["--mode", "anomaly", "--gw-model", "gw_nominal", "--placement",
                          "sharded", "--server", "--streams", "8", "--chunk", "25",
                          "--windows", "8", "--arrival-hz", "2000"])
    stats = out["stats"]
    if stats["windows_scored"] != 64 or stats["engine_errors"]:
        raise AssertionError(f"sharded CLI server: {stats}")
    report["cli_server"] = {k: stats[k] for k in ("processed", "windows_scored",
                                                   "latency.p50_us", "latency.p99_us",
                                                   "latency.max_us")}
    log(f"phase 28 --placement sharded --server ok: {stats['windows_scored']} windows, "
        f"p50 {stats['latency.p50_us']:.0f} us p99 {stats['latency.p99_us']:.0f} us "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, report


def scan_bound(H: int, T: int, B: int, IN: int = 0) -> tuple[float, str]:
    """Least time the card needs for one K3 call: bytes (xw, or x, W_x and
    b when IN > 0; W_h, h0, c0 read once; hs, h_f, c_f written once) over
    the memory rate vs fp32 operations (2 per multiply-add of x @ W_x and
    h @ W_h, 1 per add of b and of the input term, 10 per cell element)
    over the fp32 peak; returns (ms, "bytes"|"operations")."""
    h4 = 4 * H
    inputs = (T * B * IN + IN * h4 + h4) if IN else T * B * h4
    n_bytes = (inputs + H * h4 + 2 * B * H + T * B * H + 2 * B * H) * 4
    ops = T * B * (2 * (IN + H) * h4 + (2 if IN else 1) * h4 + 10 * H)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


#: op kinds of the golden server script (tests/test_torch_golden_server.py)
SUBMIT, ADVANCE, TICK, DRAIN, CLOSE = range(5)


class FakeClock:
    """Injectable server clock (seconds), advanced by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def replay_script(server, clock, ops, data) -> np.ndarray:
    """Play the golden script's op table; returns the tick/drain/close
    results in order (the replay of tests/test_torch_golden_server.py)."""
    results = []
    for kind, s, a, b in ops.tolist():
        if kind == SUBMIT:
            server.submit("s2" if s == data.shape[0] - 1 else f"s{s}", data[s, a:b])
        elif kind == ADVANCE:
            clock.t += a * 1e-6
        elif kind == TICK:
            results.append(server.tick(force=bool(a)))
        elif kind == DRAIN:
            results.append(server.drain())
        else:
            results.append(server.close_stream(f"s{s}"))
    return np.asarray(results, dtype=np.int64)


def sequential_scores(engine, chunk_lists: dict) -> dict:
    """Ground truth: each stream's chunks pushed alone through ``engine``."""
    out = {}
    for sid, chunks in chunk_lists.items():
        engine.reset()
        out[sid] = [sc for c in chunks for sc in engine.push(c[None])]
    return out


def assert_bit_equal(got: dict, want: dict, what: str) -> int:
    """Per-stream scores equal bit for bit; returns the window count."""
    want = {k: v for k, v in want.items() if v}
    if set(got) != set(want):
        raise AssertionError(f"{what}: streams {sorted(got)} != {sorted(want)}")
    for sid in want:
        if len(got[sid]) != len(want[sid]):
            raise AssertionError(f"{what}: {sid} has {len(got[sid])} scores, want "
                                 f"{len(want[sid])}")
        for g, w in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {sid}")
    return sum(len(v) for v in want.values())


def ragged_chunks(rng, x: np.ndarray, sizes=(1, 25)) -> list:
    """Cut one stream's samples into chunks of randomly chosen sizes."""
    out, pos = [], 0
    while pos < len(x):
        t = min(int(rng.choice(sizes)), len(x) - pos)
        out.append(x[pos : pos + t])
        pos += t
    return out


def server_phases(impl: str, make_engine, sgold: dict, T: int) -> dict:
    """The StreamServer over one engine (``impl``) on the card: the golden
    script against the reference, a fake-clock run of 32 streams against
    sequential replays, checkpoint and restore, the health screen, and a
    threaded run.  Raises on any failure; returns what it measured."""
    from repro_torch.serve.health import ChunkRejectedError, HealthConfig
    from repro_torch.serve.server import AdaptiveConfig, ServerConfig, StreamServer

    seq = make_engine()
    errors = 0

    # (a) the reference's fake-clock script: same decisions, same counters
    clock = FakeClock()
    srv = StreamServer(make_engine(), ServerConfig(
        max_coalesce=8, adaptive=AdaptiveConfig(max_deadline_us=600.0)), clock=clock)
    results = replay_script(srv, clock, sgold["server/ops"], sgold["server/data"])
    np.testing.assert_array_equal(results, sgold["server/results"],
                                  err_msg=f"{impl} server: tick results vs reference")
    summary = json.loads(json.dumps(srv.stats.summary()))
    if summary != json.loads(bytes(sgold["server/summary"])):
        raise AssertionError(f"{impl} server: stats {summary} differ from the reference's")
    for sid, scores in srv.pop_scores().items():
        np.testing.assert_allclose(np.concatenate(scores), sgold[f"server/scores/{sid}"],
                                   **TOL, err_msg=f"{impl} server: {sid} vs reference")
    errors += srv.stats.engine_errors

    # (b) 32 streams, ragged T=1 and T=25 chunks, late joins, a close and
    # a rejoin, the adaptive policy: bit-equal to sequential replays
    rng = np.random.RandomState(1)
    n = 32
    data = rng.randn(n + 1, 2 * T, 1).astype(np.float32)
    chunk_lists = {f"s{i}": ragged_chunks(rng, data[i]) for i in range(n)}
    pending = {sid: list(c) for sid, c in chunk_lists.items()}
    late = {f"s{i}" for i in range(24, n)}
    total, submitted = sum(map(len, pending.values())), 0
    clock = FakeClock()
    srv = StreamServer(make_engine(), ServerConfig(adaptive=True), clock=clock)
    want_extra = None
    while any(pending.values()):
        ready = [sid for sid, q in pending.items()
                 if q and (sid not in late or submitted > total // 3)]
        sid = ready[int(rng.randint(len(ready)))]
        srv.submit(sid, pending[sid].pop(0))
        submitted += 1
        clock.t += int(rng.randint(0, 300)) * 1e-6
        if rng.rand() < 0.5:
            srv.tick(force=bool(rng.rand() < 0.1))
        done = len(chunk_lists["s5"]) - len(pending["s5"])
        if sid == "s5" and want_extra is None and done == 6:
            srv.drain()
            srv.close_stream("s5")  # leaves mid-window, rejoins with fresh data
            kept, fresh = chunk_lists["s5"][:6], ragged_chunks(rng, data[n])
            chunk_lists["s5"], want_extra = kept, fresh
            pending["s5"] = list(fresh)
    srv.drain()
    want = sequential_scores(seq, chunk_lists)
    want["s5"] += sequential_scores(seq, {"s5": want_extra})["s5"]
    windows_b = assert_bit_equal(srv.pop_scores(), want, f"{impl} server, 32 streams")
    stats_b = srv.stats.summary()
    errors += srv.stats.engine_errors

    # (c) checkpoint mid-run, restart_from on a fresh engine: bit-equal to
    # the run that never stopped, and to sequential replays
    sizes = [25, 25, 13, 1, 24, 12, 25, 25, 25, 25]
    cuts = np.cumsum([0] + sizes)
    ck_data = {f"c{i}": rng.randn(2 * T, 1).astype(np.float32) for i in range(8)}
    srv = StreamServer(make_engine(), ServerConfig(deadline_us=1e9))
    for j in range(4):
        for sid, x in ck_data.items():
            srv.submit(sid, x[cuts[j] : cuts[j + 1]])
        srv.drain()
    mid = srv.pop_scores()
    with tempfile.TemporaryDirectory() as tmp:
        path = srv.checkpoint(str(Path(tmp) / "server.npz"))
        restarted = StreamServer.restart_from(path, make_engine(),
                                              ServerConfig(deadline_us=1e9))
    for j in range(4, len(sizes)):
        for sid, x in ck_data.items():
            srv.submit(sid, x[cuts[j] : cuts[j + 1]])
            restarted.submit(sid, x[cuts[j] : cuts[j + 1]])
        srv.drain()
        restarted.drain()
    tail = srv.pop_scores()
    assert_bit_equal(restarted.pop_scores(), tail, f"{impl} server, restart_from")
    whole = {sid: mid.get(sid, []) + tail.get(sid, []) for sid in ck_data}
    assert_bit_equal(whole, sequential_scores(seq, {
        sid: [x[cuts[j] : cuts[j + 1]] for j in range(len(sizes))]
        for sid, x in ck_data.items()}), f"{impl} server, checkpointed lineage")
    errors += srv.stats.engine_errors + restarted.stats.engine_errors

    # (d) health: NaN chunks of one stream are rejected at submit; every
    # stream, that one included, scores its accepted chunks unchanged
    srv = StreamServer(make_engine(), ServerConfig(
        deadline_us=1e9, health=HealthConfig(sanitize="reject")))
    h_data = {f"h{i}": [rng.randn(25, 1).astype(np.float32) for _ in range(8)]
              for i in range(4)}
    rejected = 0
    for j in range(8):
        for sid, chunks in h_data.items():
            srv.submit(sid, chunks[j])
        try:
            srv.submit("h0", np.full((25, 1), np.nan, np.float32))
        except ChunkRejectedError:
            rejected += 1
        srv.drain()
    if rejected != 8 or srv.stats.rejected != 8:
        raise AssertionError(f"{impl} server: {rejected} NaN chunks rejected, want 8")
    assert_bit_equal(srv.pop_scores(), sequential_scores(seq, h_data),
                     f"{impl} server, health screen")
    errors += srv.stats.engine_errors

    # (e) threaded, real clock
    threaded, n_errors = threaded_run(make_engine, seq, rng, T, impl)
    errors += n_errors
    if errors:
        raise AssertionError(f"{impl} server: {errors} engine-step errors")
    return {"threaded": threaded,
            "fake_clock_32_streams": {"windows": windows_b, "summary": stats_b},
            "rejected": rejected}


def threaded_run(make_engine, seq, rng, T: int, what: str) -> tuple[dict, int]:
    """The StreamServer threaded, real clock, on an engine warmed at every
    pool width: four producers submit T=1 chunks for 32 streams at a fixed
    rate; stop(drain=True) must finish in time, every completed window must
    be scored, and the first streams' scores must equal sequential pushes.
    Returns (enqueue-to-score latency and rate, engine-step errors)."""
    from repro_torch.serve.engine import _pad_width
    from repro_torch.serve.server import ServerConfig, StreamServer

    n, rate = 32, 1000.0  # chunks per second per producer
    r_data = rng.randn(n, 2 * T, 1).astype(np.float32)
    engine = make_engine()
    # warm-up: every pool width a tick can have, a T=1 step and a window's
    # decode each (on the card the first call of each captures its graph)
    for width in sorted({_pad_width(k) for k in range(1, n + 1)}):
        ids = [f"warm{i}" for i in range(width)]
        engine.push_many(ids, np.zeros((width, T - 1, 1), np.float32))
        engine.push_many(ids, np.zeros((width, 1, 1), np.float32))
    engine.reset()
    srv = StreamServer(engine, ServerConfig(deadline_us=200.0))

    def produce(first: int) -> None:
        ids = range(first, first + n // 4)
        t_next = time.perf_counter()
        for t in range(2 * T):
            for i in ids:
                srv.submit(f"r{i}", r_data[i, t : t + 1])
            t_next += len(ids) / rate
            time.sleep(max(0.0, t_next - time.perf_counter()))

    srv.start()
    producers = [threading.Thread(target=produce, args=(k * n // 4,)) for k in range(4)]
    t0 = time.perf_counter()
    for p in producers:
        p.start()
    for p in producers:
        p.join(300.0)
        if p.is_alive():
            raise AssertionError(f"{what} server: a producer thread did not finish")
    if not srv.stop(drain=True, deadline_s=120.0):
        raise AssertionError(f"{what} server: stop(drain=True) missed its deadline")
    wall = time.perf_counter() - t0
    scores = srv.pop_scores()
    n_windows = sum(len(v) for v in scores.values())
    st = srv.stats
    if n_windows != 2 * n or not st.processed == st.submitted == 2 * T * n:
        raise AssertionError(f"{what} server: {n_windows} windows scored of {2 * n}, "
                             f"{st.processed} of {st.submitted} chunks")
    assert_bit_equal({k: scores[f"r{k}"] for k in range(4)}, sequential_scores(
        seq, {k: [r_data[k, t : t + 1] for t in range(2 * T)] for k in range(4)}),
        f"{what} server, threaded")
    lat = st.latency
    return ({"summary": st.summary(), "p50_us": lat.percentile(50),
             "p99_us": lat.percentile(99), "max_us": lat.max_us,
             "wall_s": wall, "chunks_per_s": st.processed / wall}, st.engine_errors)


# -- the LM side: K5 (decode attention) and K4 (SSD scan) -----------------

def decode_attn_bound(batch: int, hq: int, hkv: int, d: int, rows: int,
                      itemsize: int) -> tuple[float, str]:
    """Least time the card needs for one K5 call: bytes (q read and the
    output written once, the ``rows`` valid cache rows of K and V read once,
    ``rows`` summed over the batch, and the lengths) over the memory rate vs
    fp32 operations (2 per multiply-add of q.k and of p.v, 6 per score for
    the online softmax) over the fp32 peak; returns (ms, "bytes"|"operations")."""
    n_bytes = 2 * batch * hq * d * itemsize + 2 * rows * hkv * d * itemsize + 4 * batch
    ops = rows * hq * (4 * d + 6)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ssd_bound(batch: int, t_len: int, heads: int, groups: int, p: int, n: int, chunk: int,
              itemsize: int, with_s0: bool) -> tuple[float, str]:
    """Least time the card needs for one K4 call: bytes (x, B, C at the
    model dtype, dt and a fp32, s0 if given, read once; y and the fp32 final
    state written once) over the memory rate vs the operations of the
    chunked algorithm (2 per multiply-add of C.B over the lower triangle, of
    M @ X, of (C exp(cum)) @ S^T and of xw^T @ B, 2 per state element for
    the decay and the add) over the peak for the model dtype: bf16 inputs
    at the bf16 tensor-core peak, fp32 inputs at the fp32 peak; returns
    (ms, "bytes"|"operations")."""
    n_bytes = (2 * batch * t_len * heads * p + 2 * batch * t_len * groups * n) * itemsize \
        + batch * t_len * heads * 4 + heads * 4 + (2 if with_s0 else 1) * batch * heads * p * n * 4
    ops = 0
    for t0 in range(0, t_len, chunk):
        lc = min(chunk, t_len - t0)
        tri = lc * (lc + 1) // 2
        ops += 2 * tri * n + 2 * tri * p + 4 * lc * p * n + 2 * p * n
    ops *= batch * heads
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k5_phase(dev) -> float:
    """K5 against its plain version: the head geometries of K5_GEOMETRIES, S in
    {1, 511, 576, 2048}, B in {1, 8} with ragged lengths down to 1, and the
    edges of its splits (lengths SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1,
    5, 1 and S = 2 * SPLIT_ROWS + 7, NaN past every length), bf16 and fp32
    caches.  Returns the max |kernel - plain|."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain
    from repro_torch.kernels.decode_attn.decode_attn import SPLIT_ROWS

    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    err, n, t0 = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0, time.perf_counter()
    for hq, hkv, d in K5_GEOMETRIES:
        for s_len in (1, 511, 576, 2048):
            for batch in (1, 8):
                lengths = [s_len] if batch == 1 else \
                    [s_len, 1] + rng.integers(1, s_len + 1, batch - 2).tolist()
                lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn(batch, hq, d, generator=gen, device=dev).to(dtype)
                    k, v = (torch.randn(batch, s_len, hkv, d, generator=gen, device=dev).to(dtype)
                            for _ in range(2))
                    got = decode_attn(q, k, v, lens)
                    want = decode_attn_plain(q, k, v, lens)
                    torch.cuda.synchronize()
                    tol = dict(rtol=K5_TOL, atol=K5_TOL) if dtype == torch.float32 else BF16_TOL
                    torch.testing.assert_close(
                        got.float(), want.float(), **tol,
                        msg=lambda m: f"K5 {hq}/{hkv} D={d} S={s_len} B={batch} {dtype}: {m}")
                    err[dtype] = max(err[dtype], (got.float() - want.float()).abs().max().item())
                    n += 1
        s_len = 2 * SPLIT_ROWS + 7
        lengths = [SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 5, 1, s_len]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(len(lengths), hq, d, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(len(lengths), s_len, hkv, d, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            want = decode_attn_plain(q, k, v, lens)
            for i, length in enumerate(lengths):  # never read
                k[i, length:], v[i, length:] = float("nan"), float("nan")
            got = decode_attn(q, k, v, lens)
            torch.cuda.synchronize()
            tol = dict(rtol=K5_TOL, atol=K5_TOL) if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"K5 {hq}/{hkv} D={d} split edges {dtype}: {m}")
            err[dtype] = max(err[dtype], (got.float() - want.float()).abs().max().item())
            n += 1
    log(f"phase 10 K5 ok: {n} cases ({len(K5_GEOMETRIES)} head geometries, S 1..2048, ragged "
        f"lengths, the split "
        f"edges with NaN past every length, fp32 and bf16), max |kernel - plain| = "
        f"{err[torch.float32]:.3g} in fp32, "
        f"{err[torch.bfloat16]:.3g} in bf16 ({time.perf_counter() - t0:.1f} s)")
    return max(err.values())


def ssd_inputs(gen, dev, batch, t_len, heads, groups, p, n, dtype, nonzero):
    """Model-shaped K4 inputs: dt = softplus(raw + dt_bias) and a = -exp(a_log)
    with random dt_bias and a_log, as the SSM block forms them."""
    import torch
    import torch.nn.functional as F

    dt_bias = torch.randn(heads, generator=gen, device=dev) * 0.5
    a = -torch.exp(torch.randn(heads, generator=gen, device=dev) * 0.5)
    dt = F.softplus(torch.randn(batch, t_len, heads, generator=gen, device=dev) + dt_bias)
    x = torch.randn(batch, t_len, heads, p, generator=gen, device=dev).to(dtype)
    bm, cm = ((torch.randn(batch, t_len, groups, n, generator=gen, device=dev) * 0.3).to(dtype)
              for _ in range(2))
    s0 = (torch.randn(batch, heads, p, n, generator=gen, device=dev) * 0.3) if nonzero else None
    return x, dt, a, bm, cm, s0


def rounding_lean(y, y_plain) -> tuple[int, int]:
    """(elements of y that differ from y_plain, those of them that lie
    toward zero from it)."""
    d = y.float() - y_plain.float()
    differ = d != 0
    away = differ & (d.sign() == y_plain.float().sign())
    return int(differ.sum()), int((differ & ~away).sum())


def k4_phase(dev) -> float:
    """K4 against its plain version at mamba2's shapes (H=24, P=64, N=128,
    G=1, chunk 64) and the serving batch (B=8, two waves of CTAs) over T in
    {1, 64, 500, 512}, plus G=3 at T=500, and at hymba's (H=25, P=64, N=16,
    G=1: one 16-row state block per (row, head)) over T in {1, 64, 512,
    1536}; zero and non-zero s0; fp32 and bf16; over the bf16 cases, the
    lean of the y elements that round apart (K4_LEAN_MAX).  Returns the max
    |kernel - plain|."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    gen = torch.Generator(device=dev).manual_seed(11)
    err = {"y fp32": 0.0, "y bf16": 0.0, "state": 0.0}
    n, t0, differ, toward, n_bf16 = 0, time.perf_counter(), 0, 0, 0
    # (heads, groups, N, T): mamba2-130m's, then hymba-1.5b's
    cases = ([(24, 1, 128, t) for t in (1, 64, 500, 512)] + [(24, 3, 128, 500)]
             + [(25, 1, 16, t) for t in (1, 64, 512, 1536)])
    for heads, groups, n_state, t_len in cases:
        for nonzero in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                args = ssd_inputs(gen, dev, LM_BATCH, t_len, heads, groups, 64, n_state, dtype,
                                  nonzero)
                y, s_f = ssd_scan(*args, chunk=64)
                y_p, s_p = ssd_chunked(*args, chunk=64)
                torch.cuda.synchronize()
                what = (f"K4 B={LM_BATCH} H={heads} G={groups} N={n_state} T={t_len} "
                        f"s0={nonzero} {dtype}")
                tol = dict(rtol=K4_TOL, atol=K4_TOL) if dtype == torch.float32 else BF16_TOL
                torch.testing.assert_close(y.float(), y_p.float(), **tol,
                                           msg=lambda m: f"{what} y: {m}")
                torch.testing.assert_close(s_f, s_p, rtol=K4_TOL, atol=K4_TOL,
                                           msg=lambda m: f"{what} state: {m}")
                key = "y fp32" if dtype == torch.float32 else "y bf16"
                err[key] = max(err[key], (y.float() - y_p.float()).abs().max().item())
                err["state"] = max(err["state"], (s_f - s_p).abs().max().item())
                n += 1
                if dtype == torch.bfloat16:
                    d, tz = rounding_lean(y, y_p)
                    differ, toward, n_bf16 = differ + d, toward + tz, n_bf16 + y.numel()
    share = toward / max(differ, 1)
    lean = (f"bf16 y rounds apart from the plain version in {differ} of {n_bf16} elements "
            f"({differ / n_bf16:.3g}), {share:.3f} of them toward zero")
    if differ >= K4_LEAN_MIN and share > K4_LEAN_MAX:
        raise AssertionError(f"K4 leans toward zero: {lean} (limit {K4_LEAN_MAX})")
    log(f"phase 11 K4 ok: {n} cases (mamba2 shapes at B={LM_BATCH}, T 1..512, G 1 and 3; "
        f"hymba's H=25 N=16, T 1..1536; zero and non-zero s0, fp32 and bf16), "
        f"max |kernel - plain| = "
        + ", ".join(f"{e:.3g} ({k})" for k, e in err.items())
        + f"; {lean} ({time.perf_counter() - t0:.1f} s)")
    return max(err.values())


@contextlib.contextmanager
def recording_routes(moe_mod, store: list):
    """Within the block, ``moe_mod.route`` (which ``moe_ffn`` calls) also
    appends each call's top-k expert indices (G, S, k) to ``store``."""
    route = moe_mod.route

    def recorded(p, x, cfg):
        out = route(p, x, cfg)
        store.append(out[2])
        return out

    moe_mod.route = recorded
    try:
        yield
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def k5_plain_in_path():
    """Within the block, the LM decode path's K5 entry (``decode_attn_op``,
    which ``layers.attention_decode`` imports at each call) runs K5's plain
    version: the kernel path with the kernel taken out."""
    import repro_torch.kernels.decode_attn as k5_pkg

    op = k5_pkg.decode_attn_op
    k5_pkg.decode_attn_op = k5_pkg.decode_attn_plain
    try:
        yield
    finally:
        k5_pkg.decode_attn_op = op


@contextlib.contextmanager
def pinned_routes(moe_mod, decisions: list):
    """Within the block, each ``moe_mod.route`` call returns the next of
    ``decisions`` (top-k expert indices recorded by ``recording_routes``)
    with this run's own probabilities for those experts."""
    import torch

    route, turn = moe_mod.route, iter(decisions)

    def pinned(p, x, cfg):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top_i = next(turn)
        return probs, probs.gather(-1, top_i), top_i

    moe_mod.route = pinned
    try:
        yield
    finally:
        moe_mod.route = route
    if next(turn, None) is not None:
        raise AssertionError("pinned routing: the run made fewer moe_ffn calls than recorded")


def decode_weights(cfg, params: dict) -> list:
    """The weights one LM decode step reads: every leaf but the embedding
    table (a step gathers B of its rows); of an encoder-decoder model only
    the decoder's, without the cross-attention's wk and wv (prefill cached
    their products), and the head."""
    from repro_torch.tree import tree_leaves

    if not cfg.encdec:
        return tree_leaves({k: v for k, v in params.items() if k != "embed"})
    dec = dict(params["dec_layers"])
    dec["cross_attn"] = {k: v for k, v in dec["cross_attn"].items() if k not in ("wk", "wv")}
    return tree_leaves({"dec": dec, "ln_f": params["ln_f"], "lm_head": params["lm_head"]})


def tf_stats(name: str, got: tuple, want: tuple, vocab: int) -> dict:
    """Teacher-forced logits (prefill, decode steps) of two runs over the
    real vocabulary: max |difference|, max |logit| of ``want``, the share
    of equal argmaxes."""
    import torch

    stats = {}
    for what, a, b in (("prefill", got[0], want[0]), ("decode", got[1], want[1])):
        a, b = a[..., :vocab], b[..., :vocab]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{name} {what}: non-finite logits")
        stats[what] = {"max_abs_diff": (a - b).abs().max().item(),
                       "max_abs_logit": b.abs().max().item(),
                       "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}
    return stats


def routing_flips(got: list, want: list) -> dict:
    """The routing decisions of two runs that differ, in prefill calls and
    in decode calls (one token per row): the (token, choice) entries that
    name another expert, and the tokens whose set of k experts differs."""
    if len(got) != len(want):
        raise AssertionError(f"routing: {len(got)} moe_ffn calls against {len(want)}")
    out = {}
    for what in ("prefill", "decode"):
        pairs = [(a, b) for a, b in zip(got, want) if (b.shape[1] == 1) == (what == "decode")]
        out[what] = {
            "decisions": sum(b.numel() for _, b in pairs),
            "choices_differ": sum(int((a != b).sum()) for a, b in pairs),
            "tokens": sum(b.shape[0] * b.shape[1] for _, b in pairs),
            "tokens_with_other_experts": sum(
                int((a.sort(-1).values != b.sort(-1).values).any(-1).sum()) for a, b in pairs)}
    return out


def lm_phases(dev, smi: str) -> tuple[list, dict]:
    """Phases 10-14 and 19: K5 and K4 against their plain versions, the
    reduced LM golden fixtures, full-width serving of the LM_RUNS (graph
    replay, held against the eager kernel path bit for bit and against the
    plain path; for the MoE family with the routing decisions counted and
    held against a control, and the plain path's routing pinned), timing,
    and eager vs replay timing.
    Returns the ``kernels`` entries of K5 and K4 and the eager vs replay
    report."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_numpy, unflatten
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain
    from repro_torch.kernels.decode_attn.decode_attn import SPLIT_ROWS, n_splits
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    from repro_torch.models.api import cache_rows, get_model
    from repro_torch.serve.engine import LmEngine

    k5_mod = sys.modules["repro_torch.kernels.decode_attn.decode_attn"]
    k4_mod = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]
    k5_err, k4_err = k5_phase(dev), k4_phase(dev)

    def refuse_plain(*args, **kwargs):
        raise AssertionError("the LM kernel path reached a plain version on the card")

    def block_plain():
        k5_mod.decode_attn_plain, k4_mod.ssd_chunked = refuse_plain, refuse_plain

    def unblock_plain():
        k5_mod.decode_attn_plain, k4_mod.ssd_chunked = decode_attn_plain, ssd_chunked

    def counts():
        return {"decode_attn": decode_attn.launches, "ssd_scan": ssd_scan.launches}

    def want_launches(cfg, n_steps):
        """K5 once per layer per decode step (dense, moe, hybrid); K4 once per
        layer per prefill (ssm, hybrid)."""
        attends, scans = cfg.family in ("dense", "moe", "hybrid"), cfg.family in ("ssm", "hybrid")
        return {"decode_attn": cfg.n_layers * n_steps if attends else 0,
                "ssd_scan": cfg.n_layers if scans else 0}

    # -- phase 12: the reduced golden fixtures, kernels on -------------------
    t0 = time.perf_counter()
    block_plain()
    for name, path in LM_FIXTURES.items():
        with np.load(path) as data:
            gold = {k: data[k] for k in data.files}
        cfg = get_arch(name).reduced()
        n_new = gold["tokens"].shape[1]
        fe = gold.get("frontend_embeds")  # seamless's frames, llava's patches
        rows = cache_rows(cfg, gold["prompt"].shape[1], n_new, 0 if fe is None else fe.shape[1])
        eng = LmEngine(lm_params_from_numpy(unflatten(gold), dev), cfg, max_len=rows, device=dev)
        pre, steps = eng.teacher_forced(gold["prompt"], gold["tokens"], fe)
        np.testing.assert_allclose(pre.cpu().numpy(), gold["prefill_logits"], **LM_GOLDEN_TOL,
                                   err_msg=f"{name} prefill logits vs reference")
        np.testing.assert_allclose(steps.cpu().numpy(), gold["decode_logits"], **LM_GOLDEN_TOL,
                                   err_msg=f"{name} decode logits vs reference")
        if eng.launches != want_launches(cfg, n_new - 1):
            raise AssertionError(f"{name} golden: launches {eng.launches}, want "
                                 f"{want_launches(cfg, n_new - 1)}")
        np.testing.assert_array_equal(eng.generate(gold["prompt"], n_new, fe), gold["tokens"],
                                      err_msg=f"{name} greedy tokens vs reference")
    unblock_plain()
    log(f"phase 12 LM golden ok: reduced {', '.join(LM_FIXTURES)} logits within 1e-4 "
        f"of the reference's, tokens equal ({time.perf_counter() - t0:.1f} s)")

    # -- phase 13: full-width serving, bf16, B=8 -------------------------------
    # the main path of this slice: every count is set to 0 just before each
    # serving run and read just after it
    rng = np.random.default_rng(0)
    report, path_launches, graphs_report = {}, {"decode_attn": 0, "ssd_scan": 0}, {}
    per_step, per_prefill = {}, {}  # measured on the serving runs (1 prefill, LM_NEW - 1 steps)
    by_run = {}  # each serving run's launches
    moe_mod = sys.modules["repro_torch.models.moe"]
    params = params_of = eng = plain = eager = None
    for name, prompt_len, n_front in LM_RUNS:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        run = f"{name}_p{prompt_len}" + (f"_f{n_front}" if n_front else "")
        if name != params_of:  # one set of weights per model
            params = eng = plain = eager = None
            gc.collect()  # an engine and its captured graphs refer to each other
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = get_model(cfg).init_params(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            params_of, init_s = name, time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            weight_bytes = sum(t.numel() * t.element_size() for t in decode_weights(cfg, params))
            expert_bytes = sum(params["layers"]["moe"][k].numel() * 2
                               for k in ("w_gate", "w_up", "w_down")) if cfg.n_experts else 0
            log(f"phase 13 {name}: init_params {init_s:.1f} s, peak device memory "
                f"{init_peak / 1e9:.2f} GB, {weight_bytes / 1e9:.2f} GB of weights a decode step "
                f"reads (experts {expert_bytes / 1e9:.2f} GB)")
        torch.cuda.reset_peak_memory_stats()
        prompts = rng.integers(0, cfg.vocab, (LM_BATCH, prompt_len)).astype(np.int32)
        fe = None  # llava's patches, seamless's frames: standard normal from a seed
        if n_front:
            fe = torch.randn(LM_BATCH, n_front, cfg.d_model, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(n_front))
            fe = fe.to(cfg.dtype)
        # an encoder-decoder model's runs share one engine, whose keys tell
        # their frame counts apart
        rows = (max(cache_rows(cfg, p, LM_NEW, f) for n, p, f in LM_RUNS if n == name)
                if cfg.encdec else cache_rows(cfg, prompt_len, LM_NEW, n_front))
        if eng is None or not cfg.encdec:
            eng = LmEngine(params, cfg, max_len=rows, device=dev)
        # warm-up (cuBLAS handles, first launches); a frontend-fed run warms
        # up on its own shapes, since a graph of another prompt shape holds
        # a pool of its own as large as the cache (2.26 GB for llava)
        if n_front:
            eng.generate(prompts, 2, fe)
        else:
            eng.generate(prompts[:, :16], 2)
        torch.cuda.synchronize()
        block_plain()
        decode_attn.launches = ssd_scan.launches = 0
        t1 = time.perf_counter()
        tokens = eng.generate(prompts, LM_NEW, fe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        c = counts()
        unblock_plain()
        if c != want_launches(cfg, LM_NEW - 1):
            raise AssertionError(f"{name} serving run: launches {c}, want "
                                 f"{want_launches(cfg, LM_NEW - 1)}")
        for key in path_launches:
            path_launches[key] += c[key]
        by_run[run] = c
        per_step[run] = c["decode_attn"] / (LM_NEW - 1)
        per_prefill[run] = c["ssd_scan"]
        if tokens.shape != (LM_BATCH, LM_NEW) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
            raise AssertionError(f"{name}: bad tokens {tokens.shape} in "
                                 f"[{tokens.min()}, {tokens.max()}]")
        # teacher forcing: the kernel path and the plain path (sdpa,
        # ssd_chunked) fed the same tokens
        step_ms: list = []
        step = eng.step

        def timed_step(cache, toks):  # each decode step's host time, synchronised
            t1 = time.perf_counter()
            out = step(cache, toks)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        eng.step = timed_step
        k_pre, k_steps = eng.teacher_forced(prompts, tokens, fe)
        del eng.step  # the class's method again (an instance attribute would be a cycle)
        plain = LmEngine(params, cfg, max_len=rows, device=dev, use_kernel=False)
        routes = {"plain": [], "eager": []}  # each moe_ffn call's top-k experts (MoE)
        with recording_routes(moe_mod, routes["plain"]):
            p_pre, p_steps = plain.teacher_forced(prompts, tokens, fe)
        plain = None  # engines are freed before the next is built (llava: 68.8 GB of weights)
        torch.cuda.empty_cache()
        stats = tf_stats(name, (k_pre, k_steps), (p_pre, p_steps), cfg.vocab)
        if cfg.encdec:
            # no kernel on this path: the served decode is also held against
            # forward over the same frames and tokens (forward's
            # cross-attention takes flash above 1024 frames, prefill's sdpa)
            with torch.inference_mode():
                seq = torch.as_tensor(np.concatenate([prompts, tokens[:, :-1]], axis=1),
                                      device=dev)
                full = get_model(cfg).forward(params, {"frontend_embeds": fe, "tokens": seq},
                                              cfg)
                fwd = (full[:, prompt_len - 1].float(),
                       full[:, prompt_len:].transpose(0, 1).float())
            stats["vs_forward"] = tf_stats(name, (k_pre, k_steps), fwd, cfg.vocab)
            full = fwd = seq = None
            for what, st in stats["vs_forward"].items():
                if st["max_abs_diff"] > LM_TF_TOL * st["max_abs_logit"]:
                    raise AssertionError(f"{run} {what}: served logits differ from forward's by "
                                         f"{st['max_abs_diff']:.4g} (max |logit| "
                                         f"{st['max_abs_logit']:.4g})")
        # graph replay vs the eager kernel path: the same logits bit for
        # bit, the same greedy tokens
        eager = LmEngine(params, cfg, max_len=rows, device=dev, graphs=False)
        e_step_ms: list = []
        e_step = eager.step

        def timed_eager_step(cache, toks):
            t1 = time.perf_counter()
            out = e_step(cache, toks)
            torch.cuda.synchronize()
            e_step_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        eager.step = timed_eager_step
        with recording_routes(moe_mod, routes["eager"]):
            e_pre, e_steps = eager.teacher_forced(prompts, tokens, fe)
        del eager.step
        torch.cuda.synchronize()
        limits = {what: LM_TF_TOL * stats[what]["max_abs_logit"] for what in ("prefill", "decode")}
        if cfg.n_experts:
            # the control (TF_CONTROL_FACTOR), then the eager kernel path
            # given the plain path's routing decisions: K5's own share of
            # the gap, held to LM_TF_TOL
            routes["control"] = []
            with k5_plain_in_path(), recording_routes(moe_mod, routes["control"]):
                ctrl = tf_stats(name, eager.teacher_forced(prompts, tokens, fe),
                                (p_pre, p_steps), cfg.vocab)
            ctrl["routing"] = routing_flips(routes["control"], routes["plain"])
            stats["routing"] = routing_flips(routes["eager"], routes["plain"])
            stats["control"] = ctrl
            stats["routing_kernel_vs_control"] = routing_flips(routes["eager"],
                                                               routes["control"])
            with pinned_routes(moe_mod, routes["plain"]):
                pinned = tf_stats(name, eager.teacher_forced(prompts, tokens, fe),
                                  (p_pre, p_steps), cfg.vocab)
            stats["routing_pinned"] = pinned
            log(f"phase 13 {name} prompt {prompt_len}: under teacher forcing, against the plain "
                f"path: kernel path routing {stats['routing']}, logits {stats['decode']}; "
                f"control (K5's plain version in the path) routing {ctrl['routing']}, logits "
                f"{ctrl['decode']}; kernel path vs control routing "
                f"{stats['routing_kernel_vs_control']}; kernel path given the plain path's "
                f"routing: logits {pinned['decode']}")
            flips = stats["routing"]["decode"]["choices_differ"]
            flip_limit = TF_CONTROL_FACTOR * ctrl["routing"]["decode"]["choices_differ"]
            if flips > flip_limit:
                raise AssertionError(f"{name}: the kernel path's routing differs from the plain "
                                     f"path's on {flips} decode decisions > {flip_limit:.0f}")
            limits["decode"] = max(limits["decode"],
                                   TF_CONTROL_FACTOR * ctrl["decode"]["max_abs_diff"])
            if pinned["decode"]["max_abs_diff"] > LM_TF_TOL * pinned["decode"]["max_abs_logit"]:
                raise AssertionError(f"{name} decode, given the plain path's routing: kernel path "
                                     f"logits differ by {pinned['decode']['max_abs_diff']:.4g}")
        routes = None
        for what, limit in limits.items():
            if stats[what]["max_abs_diff"] > limit:
                raise AssertionError(f"{name} {what}: kernel path logits differ from the plain "
                                     f"path's by {stats[what]['max_abs_diff']:.4g} > {limit:.4g}")
        if not (torch.equal(k_pre, e_pre) and torch.equal(k_steps, e_steps)):
            raise AssertionError(f"{name}: replayed teacher-forced logits differ from the eager "
                                 f"kernel path's (max {(k_steps - e_steps).abs().max().item()})")
        np.testing.assert_array_equal(eager.generate(prompts, LM_NEW, fe), tokens,
                                      err_msg=f"{name}: greedy tokens, eager vs replay")
        pre_ms = {"eager": [], "replay": []}
        for mode in ("eager", "replay", "replay", "eager"):  # in turns
            e = eager if mode == "eager" else eng
            for _ in range(3):
                t1 = time.perf_counter()
                e.prefill(prompts, fe)
                torch.cuda.synchronize()
                pre_ms[mode].append((time.perf_counter() - t1) * 1e3)
        # device time of a prefill and of one decode step (every kernel a
        # device-only trace records, summed; None where the trace's count
        # of kernels is off); the rest of the host time the card idles
        busy = {}
        for mode, e in (("replay", eng), ("eager", eager)):
            _, cache = e.prefill(prompts, fe)
            # the cache a decode step reads: self K/V (a ring's slots) and
            # an encoder-decoder model's cross K/V
            cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                              for k in ("k", "v", "xk", "xv") if k in cache)
            calls = (lambda: e.prefill(prompts, fe), lambda: e.step(cache, tokens[:, :1]))
            busy[mode] = [device_ms(fn, reps=r, host=False) for fn, r in zip(calls, (2, 5))]
            if mode == "replay":
                top = {what: top_kernels(fn) for what, fn in zip(("prefill", "decode"), calls)}
                log(f"phase 13 {name} prompt {prompt_len}: the kernels that take most of a "
                    f"replayed prefill and decode step (name, ms, launches per call): {top}")
        busy_pre, busy_step = busy["replay"]
        prefill_ms, decode_ms = statistics.median(pre_ms["replay"]), statistics.median(step_ms)
        e_prefill_ms, e_decode_ms = statistics.median(pre_ms["eager"]), statistics.median(e_step_ms)
        e_busy_pre, e_busy_step = busy["eager"]
        # nothing of this run may keep an engine (and with it its caches and
        # graph pools) alive past it: the bound methods and closures too
        cache = eager = e = calls = step = e_step = None
        peak = torch.cuda.max_memory_allocated()
        graphs_report[run] = {
            "replay": {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                       "prefill_device_ms": busy_pre, "decode_step_device_ms": busy_step,
                       "prefill_idle_share": None if busy_pre is None
                       else 1 - busy_pre / prefill_ms,
                       "decode_idle_share": None if busy_step is None
                       else 1 - busy_step / decode_ms},
            "eager": {"prefill_ms": e_prefill_ms, "decode_ms_per_step": e_decode_ms,
                      "prefill_device_ms": e_busy_pre, "decode_step_device_ms": e_busy_step,
                      "prefill_idle_share": None if e_busy_pre is None
                      else 1 - e_busy_pre / e_prefill_ms,
                      "decode_idle_share": None if e_busy_step is None
                      else 1 - e_busy_step / e_decode_ms},
            "bit_equal": True}
        report[run] = {
            "batch": LM_BATCH, "prompt": prompt_len, "frontend_rows": n_front,
            "new_tokens": LM_NEW, "max_memory_allocated_bytes": peak,
            "generate_s": wall, "tokens_per_s": LM_BATCH * LM_NEW / wall,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "prefill_device_ms": busy_pre, "decode_step_device_ms": busy_step,
            "prefill_idle_share": None if busy_pre is None else 1 - busy_pre / prefill_ms,
            "decode_idle_share": None if busy_step is None else 1 - busy_step / decode_ms,
            "launches": c, "teacher_forced": stats, "init_params_s": init_s,
            "top_kernels": top,
            "decode_weight_bytes": weight_bytes,
            "decode_weight_floor_ms": weight_bytes / PEAK_BYTES_PER_S * 1e3,
            "decode_cache_bytes": cache_bytes,
            "decode_floor_ms": (weight_bytes + cache_bytes) / PEAK_BYTES_PER_S * 1e3,
            **({"decode_expert_bytes": expert_bytes,
                "decode_expert_floor_ms": expert_bytes / PEAK_BYTES_PER_S * 1e3}
               if cfg.n_experts else {})}
        log(f"phase 13 {run} ok: B={LM_BATCH}, {LM_NEW} tokens in "
            f"{wall:.3f} s ({LM_BATCH * LM_NEW / wall:.0f} tok/s), prefill {prefill_ms:.2f} ms "
            f"(device {busy_pre} ms), decode {decode_ms:.3f} ms per step (device {busy_step} "
            f"ms), launches {c}, kernel vs plain path under teacher forcing {stats}; "
            f"replay bit-equal to the eager kernel path (eager: prefill {e_prefill_ms:.2f} ms, "
            f"decode {e_decode_ms:.3f} ms per step); decode floor "
            f"{(weight_bytes + cache_bytes) / PEAK_BYTES_PER_S * 1e3:.3f} ms (weights "
            f"{weight_bytes / 1e9:.3f} GB, cache {cache_bytes / 1e9:.3f} GB); peak device memory "
            f"{peak / 1e9:.2f} GB ({time.perf_counter() - t0:.1f} s)")
    params = eng = plain = eager = None
    gc.collect()
    torch.cuda.empty_cache()
    log(smi)
    log(json.dumps({"lm_e2e": report}))

    # -- phase 14: K5 and K4 timing at the serving shapes -----------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(14)
    s_len = LM_PROMPT + LM_NEW
    # (arch, cache rows, lengths): smollm's first and last decode step, the
    # last of qwen2-moe (G=1) and of hymba (G=5) over its 576-slot ring,
    # hymba's wrapped 1024-slot ring (prompt 1536), every slot valid, and
    # llava's (G=7) over 576 patches + 512 tokens + 64 new ones
    llava_rows = 576 + LM_PROMPT + LM_NEW
    k5_cases = (("smollm-360m", s_len, (LM_PROMPT + 1, s_len)),
                ("qwen2-moe-a2.7b", s_len, (s_len,)), ("hymba-1.5b", s_len, (s_len,)),
                ("hymba-1.5b", 1024, (1024,)), ("llava-next-34b", llava_rows, (llava_rows,)))
    k5_rows = []
    for arch, rows, lengths in k5_cases:
        cfg = get_arch(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = torch.randn(LM_BATCH, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(LM_BATCH, rows, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        # a decode step finds its layer's cache cold in L2 (every layer's
        # weights pass between two launches of one layer): the cold timings
        # rotate K5_COPIES copies of the cache (12 x 5.9 MB at smollm's
        # against the 50 MB L2); the warm ones call on one copy
        copies = [(k.clone(), v.clone()) for _ in range(K5_COPIES)]
        n_split = n_splits(rows)
        log(f"phase 14 K5 launch at {arch}'s shape ({hq}/{hkv} heads, D={d}, {rows} rows): "
            f"{n_split} splits of {SPLIT_ROWS} rows, grid {LM_BATCH * hkv} x {n_split} = "
            f"{LM_BATCH * hkv * n_split} CTAs")
        for length in lengths:
            lens = torch.full((LM_BATCH,), length, dtype=torch.int32, device=dev)
            qs = q[:, :, None]
            views = [(kc[:, :length].transpose(1, 2), vc[:, :length].transpose(1, 2))
                     for kc, vc in copies]
            turn = itertools.count()

            def lib_call(cold=False):
                ks, vs = views[next(turn) % K5_COPIES if cold else 0]
                return F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)

            def kernel(cold=False):
                kc, vc = copies[next(turn) % K5_COPIES if cold else 0]
                return decode_attn(q, kc, vc, lens)

            torch.testing.assert_close(kernel().float(), decode_attn_plain(q, k, v, lens).float(),
                                       **BF16_TOL,
                                       msg=lambda m: f"K5 timing inputs {arch} {length}: {m}")
            lib_err = (lib_call()[:, :, 0].float() - kernel().float()).abs().max().item()
            times = {}
            for what, fn in (("kernel", kernel), ("library", lib_call)):
                for cold in (True, False):
                    call = functools.partial(fn, cold)
                    times[what, cold] = (graph_ms(call, K5_COPIES), median_ms(call, reps=50))
            b_ms, b_by = decode_attn_bound(LM_BATCH, hq, hkv, d, LM_BATCH * length, 2)
            k5_rows.append({
                "arch": arch, "B": LM_BATCH, "Hq": hq, "Hkv": hkv, "D": d, "S": rows,
                "length": length, "dtype": "bf16",
                "ms": times["kernel", True][0],
                "call_ms": times["kernel", True][1], "ms_warm": times["kernel", False][0],
                "call_ms_warm": times["kernel", False][1],
                "plain_ms": median_ms(lambda: decode_attn_plain(q, k, v, lens), reps=5),
                "library_ms": times["library", True][0],
                "library_call_ms": times["library", True][1],
                "library_ms_warm": times["library", False][0],
                "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by})
        copies = views = None
    k4_rows = []
    for arch, t_len in (("mamba2-130m", LM_PROMPT), ("mamba2-130m", 500),
                        ("hymba-1.5b", LM_PROMPT), ("hymba-1.5b", 1536)):
        mcfg = get_arch(arch)
        # the SSM's inner width: d_model in a hybrid layer's branch
        heads = (mcfg.d_model if mcfg.hybrid else mcfg.ssm_expand * mcfg.d_model) \
            // mcfg.ssm_head_dim
        args = ssd_inputs(gen, dev, LM_BATCH, t_len, heads, mcfg.ssm_groups, mcfg.ssm_head_dim,
                          mcfg.ssm_state, torch.bfloat16, False)
        kernel = lambda: ssd_scan(*args, chunk=64)  # noqa: E731
        (y, s_f), (y_p, s_p) = kernel(), ssd_chunked(*args, chunk=64)
        torch.testing.assert_close(y.float(), y_p.float(), **BF16_TOL,
                                   msg=lambda m: f"K4 timing inputs {arch} T={t_len} y: {m}")
        torch.testing.assert_close(s_f, s_p, rtol=K4_TOL, atol=K4_TOL,
                                   msg=lambda m: f"K4 timing inputs {arch} T={t_len} state: {m}")
        ms = graph_ms(kernel, 5)  # every kernel one ssd_scan call launches
        call_ms = median_ms(kernel, reps=20)
        b_ms, b_by = ssd_bound(LM_BATCH, t_len, heads, mcfg.ssm_groups, mcfg.ssm_head_dim,
                               mcfg.ssm_state, 64, 2, False)
        k4_rows.append({
            "arch": arch, "B": LM_BATCH, "T": t_len, "H": heads, "G": mcfg.ssm_groups,
            "P": mcfg.ssm_head_dim, "N": mcfg.ssm_state, "chunk": 64, "dtype": "bf16",
            "ms": ms, "call_ms": call_ms,
            "plain_ms": median_ms(lambda: ssd_chunked(*args, chunk=64), reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        r = k4_rows[-1]
        log(f"phase 14 K4 {arch} B={r['B']} T={r['T']} H={r['H']} P={r['P']} N={r['N']} bf16, "
            f"{k4_mod.library().lib.ssd_scan_ctas(LM_BATCH, heads, mcfg.ssm_head_dim)} CTAs: "
            f"{r['ms']:.4g} ms (call {r['call_ms']:.4g} ms, "
            f"plain {r['plain_ms']:.4g} ms), bound {r['bound_ms']:.4g} ms ({r['bound_by']})")
    log(f"phase 14 LM kernel timing ok ({time.perf_counter() - t0:.1f} s)")

    head5, head4 = k5_rows[1], k4_rows[0]  # smollm's last decode step; mamba2's 512-token prefill
    kernels = [
        {"name": "decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/decode_attn.py:96",
         "launches": path_launches["decode_attn"], "max_abs_err": k5_err,
         "ms": head5["ms"], "kernel_ms": head5["ms"], "plain_ms": head5["plain_ms"],
         "bound_ms": head5["bound_ms"], "bound_by": head5["bound_by"],
         "library_ms": head5["library_ms"],
         "launches_per_decode_step": per_step,
         "launches_by_path": {run: c["decode_attn"] for run, c in by_run.items()},
         "shapes": k5_rows},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:94",
         "launches": path_launches["ssd_scan"], "max_abs_err": k4_err,
         "ms": head4["ms"], "kernel_ms": head4["ms"], "plain_ms": head4["plain_ms"],
         "bound_ms": head4["bound_ms"], "bound_by": head4["bound_by"], "library_ms": None,
         "library_note": "none: no single PyTorch call computes the SSD scan",
         "launches_per_prefill": per_prefill,
         "launches_by_path": {run: c["ssd_scan"] for run, c in by_run.items()},
         "shapes": k4_rows},
    ]
    return kernels, graphs_report


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic mode within the block (the fused attention
    backward then gives the same bits run after run), without filling fresh memory
    (the results do not depend on it).  cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before its first call: ``main`` sets
    it."""
    import torch
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def flash_check(cfg, seq: int, seed: int, dev) -> dict:
    """``flash_attention`` (bf16, on a fused SDPA backend: the caller
    disables the math one) at the training shape with B=1: its output and
    gradients against the plain ``sdpa``'s in fp32 on the same bf16
    inputs, each scaled by its largest |value| (``FLASH_GRAD_TOL``); and
    whether two backward passes give the same bits, in the default mode
    and in deterministic mode."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.flash_attention import flash_attention

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, seq, hq, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, seq, hkv, d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    dout = torch.randn(1, seq, hq, d, generator=g, device=dev).to(torch.bfloat16)

    def flash():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, True, None, 0)
        out.backward(dout)
        return [out.detach()] + [t.grad for t in leaves]

    got = flash()
    reproducible = {"default": all(torch.equal(a, b) for a, b in zip(got, flash()))}
    with deterministic():
        first = flash()
        reproducible["deterministic"] = all(torch.equal(a, b) for a, b in zip(first, flash()))
    refs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out_ref = L.sdpa(*refs, causal=True)
    out_ref.backward(dout.float())
    want = [out_ref.detach()] + [t.grad for t in refs]
    errs, failed = {}, []
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        scale = b.abs().max()
        errs[what] = ((a.float() - b).abs().max() / scale).item()
        try:
            torch.testing.assert_close(a.float() / scale, b / scale,
                                       **(FLASH_OUT_TOL if what == "out" else FLASH_GRAD_TOL))
        except AssertionError as exc:
            failed.append(f"{what}: {exc}")
    report = {"shape": [1, seq, hq, hkv, d], "max_err_over_max": errs,
              "tol_out": FLASH_OUT_TOL, "tol_grads": FLASH_GRAD_TOL,
              "fused_backends_only": True, "bit_reproducible": reproducible}
    if failed:
        raise AssertionError(f"{cfg.name} flash at B=1 S={seq}: {report}; " + "; ".join(failed))
    return report


def matmul_params(params: dict) -> int:
    """Weights an LM's products read per token: every matrix (a stacked
    layer leaf of 3 dims, a top-level leaf of 2), without the embedding
    table where the model has its own head (its lookup is a gather)."""
    from repro_torch.tree import flatten

    return sum(t.numel() for k, t in flatten(params).items()
               if t.dim() >= 2 + ("/" in k) and not (k == "embed" and "lm_head" in params))


def lm_train_phases(dev, smi: str) -> tuple[dict, dict]:
    """Phases 29-31, this slice's path: LM training on the card.

    29. The reduced golden fixture (``tests/data/torch_port_lm_train.npz``)
        of every family in fp32: each ``loss_fn`` and every gradient leaf
        against the reference's, and 3 AdamW steps' losses.
    30. smollm-360m at full width through ``launch/train.py``'s
        ``make_trainer`` (bf16 weights, fp32 moments, ``lm_stream`` data,
        S=4096, B=8, 8 steps, each after the first one replayed graph),
        with PyTorch's math attention backend disabled (``sdpa_kernel``):
        a training attention that is not fused raises.  The flash
        gradients at the training shape (B=1) against the plain ``sdpa``'s
        fp32 gradients; from the trained state, replayed steps bit-equal to
        eager ones (parameters and moments) in deterministic mode, and
        within ``LM_TRAIN_DEFAULT_TOL`` of them in the default mode, beside
        two controls (eager twice; one step apart); step times eager and
        replayed, tokens/s, the device's idle share, peak memory, the
        model-FLOP share.
    31. mamba2-130m the same (the backward of ``ssd_chunked`` at 24 heads,
        N=128, 64 chunks), without the attention checks and the idle
        share: a step is hundreds of thousands of small operations (64
        chunks x 24 layers, forward, remat and backward), far more than a
        trace counts exactly (PERF.md §7); its costliest kernels come from
        one trace whose count is not checked.

    K4 and K5 launch on no training path: their counts are set to 0 before
    each run (the golden fixture, the launcher, each mode's replay check)
    and read after it (the reference's training runs no Pallas kernel).  Returns (launches by kernel, the report)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_numpy, unflatten
    from repro_torch.core.graphs import CapturedStep
    from repro_torch.data.lm import LmDataConfig, lm_batch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.api import get_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.tree import flatten, tree_leaves, tree_map

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    launches = {"decode_attn": 0, "ssd_scan": 0}

    def zero_counts():
        decode_attn.launches = ssd_scan.launches = 0

    def read_counts(what, into):
        got = {"decode_attn": decode_attn.launches, "ssd_scan": ssd_scan.launches}
        for k, v in got.items():
            launches[k] += v
            into[k] = into.get(k, 0) + v
        if any(got.values()):
            raise AssertionError(f"{what}: a forward-only kernel launched on a training path: "
                                 f"{got}")

    def on_dev(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def state_gap(got, want, pairs) -> dict:
        """How far the state ``got`` lies from ``want``: the largest gap of
        the (wanted, got) loss pairs over the wanted loss, and the largest
        max |difference| over a leaf's largest |value|, of the bf16
        parameters and of the fp32 moments; whether the integer leaves (the
        step count) are equal."""
        gap = {"loss": max(abs(b - a) / abs(a) for a, b in pairs), "params": 0.0,
               "moments": 0.0, "max_abs_diff": 0.0, "ints_equal": True}
        for key, part in (("params", "params"), ("moments", "opt")):
            for x, y in zip(tree_leaves(got[part]), tree_leaves(want[part]), strict=True):
                if not x.is_floating_point():
                    gap["ints_equal"] &= torch.equal(x, y)
                    continue
                d = (x.float() - y.float()).abs().max().item()
                gap["max_abs_diff"] = max(gap["max_abs_diff"], d)
                gap[key] = max(gap[key], d / max(y.float().abs().max().item(), 1e-30))
        return gap

    report: dict = {}

    # -- phase 29: the reduced golden fixture, fp32 ---------------------------
    t0 = time.perf_counter()
    with np.load(LM_TRAIN_FIXTURE) as data:
        fixture = {k: data[k] for k in data.files}
    golden = {}
    zero_counts()
    for name, path in LM_FIXTURES.items():
        cfg = get_arch(name).reduced()
        api = get_model(cfg)
        with np.load(path) as data:
            params = lm_params_from_numpy(unflatten({k: data[k] for k in data.files}), dev)
        gold = {k[len(name) + 1:]: v for k, v in fixture.items() if k.startswith(name + "/")}

        def batch_at(i, gold=gold):
            b = {"tokens": gold["tokens"][i], "labels": gold["labels"][i]}
            if "frontend_embeds" in gold:
                b["frontend_embeds"] = gold["frontend_embeds"]
            return on_dev(b)

        def loss_fn(p, b, api=api, cfg=cfg):
            return api.loss_fn(p, b, cfg)

        loss, grads = value_and_grad(loss_fn, params, batch_at(0))
        loss_err = abs(loss.item() - float(gold["loss"])) / abs(float(gold["loss"]))
        want = flatten(unflatten(gold, prefix="grads/"))
        got = flatten(grads)
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: gradient leaves {sorted(got)} vs {sorted(want)}")
        worst = (0.0, None)  # (error over its limit, leaf)
        grad_err = 0.0
        for key, ref in want.items():
            err = np.abs(got[key].double().cpu().numpy() - ref).max() / max(
                float(np.abs(ref).max()), 1e-30)
            grad_err = max(grad_err, float(err))
            worst = max(worst, (float(err) / LM_TRAIN_GRAD_REL_LEAF.get(key, LM_TRAIN_GRAD_REL),
                                key))
        step = make_train_step(loss_fn, AdamWConfig(**LM_TRAIN_OPT))
        p, opt, losses = params, init_opt_state(params, AdamWConfig(**LM_TRAIN_OPT)), []
        for i in range(len(gold["step_losses"])):
            value, p, opt = step(p, opt, batch_at(i))
            losses.append(value.item())
        step_err = float(np.max(np.abs(np.array(losses) - gold["step_losses"])
                                / np.abs(gold["step_losses"])))
        golden[name] = {"S": int(gold["tokens"].shape[-1]), "loss_rel_err": loss_err,
                        "grad_rel_err_max": grad_err, "worst_leaf": worst[1],
                        "worst_leaf_over_limit": worst[0], "step_losses_rel_err": step_err}
        if loss_err > LM_TRAIN_LOSS_RTOL or worst[0] > 1 or step_err > LM_TRAIN_LOSS_RTOL:
            raise AssertionError(f"LM training golden {name}: {golden[name]}")
    report["launches_golden"] = {}
    read_counts("phase 29", report["launches_golden"])
    params = grads = p = opt = None
    report["golden"] = golden
    log(f"phase 29 LM training golden ok: reduced {', '.join(golden)} in fp32: loss within "
        f"{max(g['loss_rel_err'] for g in golden.values()):.3g} relative, gradients within "
        f"{max(g['grad_rel_err_max'] for g in golden.values()):.3g} of each leaf's largest, "
        f"3 AdamW steps' losses within "
        f"{max(g['step_losses_rel_err'] for g in golden.values()):.3g}; no K4/K5 launch "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phases 30-31: full width through the launcher -------------------------
    for phase, (arch, seq, batch, steps) in zip((30, 31), LM_TRAIN_RUNS):
        t0 = time.perf_counter()
        cfg = get_arch(arch)
        attends = not cfg.attn_free
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run: dict = {"B": batch, "S": seq, "steps": steps, "dtype": "bf16"}
        with tempfile.TemporaryDirectory() as ckpt, \
                (sdpa_kernel(fused) if attends else contextlib.nullcontext()):
            argv = ["--arch", arch, "--seq-len", str(seq), "--batch", str(batch),
                    "--steps", str(steps), "--ckpt", ckpt]
            trainer = tlaunch.make_trainer(tlaunch.parser().parse_args(argv))
            zero_counts()
            t1 = time.perf_counter()
            result = trainer.run(torch.Generator().manual_seed(tlaunch.SEED))
            torch.cuda.synchronize()
            run["launcher_wall_s"] = time.perf_counter() - t1
            run["launches_launcher"] = {}
            read_counts(f"phase {phase} {arch}", run["launches_launcher"])
            run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            run["losses"] = result.losses
            log(f"phase {phase} {tlaunch.summary(arch, result)} "
                f"(python -m repro_torch.launch.train {' '.join(argv[:-2])}; "
                f"{run['launcher_wall_s']:.1f} s, peak {run['peak_memory_gb']:.2f} GB)")
            if result.step != steps or not all(np.isfinite(result.losses)):
                raise AssertionError(f"{arch}: the launcher's run: {result}")
            state = {"params": trainer.params, "opt": trainer.opt_state}
            step_fn = trainer.step_fn
            n_params = sum(t.numel() for t in tree_leaves(trainer.params))
            n_matmul = matmul_params(trainer.params)
            trainer = result = None
            gc.collect()

            if attends:  # the flash gradients at the training shape, B=1
                run["flash_vs_plain_fp32"] = flash_check(cfg, seq, phase, dev)
                log(f"phase {phase} {arch} flash at B=1 S={seq} (fused backends only) vs the "
                    f"plain sdpa's fp32: {run['flash_vs_plain_fp32']}")

            data_cfg = LmDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
            batches = [on_dev(lm_batch(data_cfg, steps + i)) for i in range(3)]

            def as_state(st, b):
                loss, p, o = step_fn(st["params"], st["opt"], b)
                return loss, {"params": p, "opt": o}

            def timed(fn, b):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                value = fn(b)
                end.record()
                end.synchronize()
                return value, start.elapsed_time(end)

            # from the trained state: 3 replayed steps (the first the
            # capture's eager warm-up) against 3 eager steps.  The fused
            # attention backward (cuDNN's here) is not bit-reproducible
            # unless PyTorch's deterministic mode is on (``flash_check``
            # shows it), so with attention the bits are held in that mode,
            # and the times taken in the default one, from where the first
            # pass's eager steps left the state.  There the replay is held
            # to ``LM_TRAIN_DEFAULT_TOL``, beside two controls: a second
            # eager run from the same state (the mode's own spread) and the
            # eager state one step earlier (what one lost or repeated step
            # would show).  The memory the warm-up cached on the capture's
            # stream is freed before the eager steps.
            run["launches"] = {}
            modes = (True, False) if attends else (False,)
            for det in modes:
                eager_state = [state]
                state = None
                controlled = attends and not det
                control = [tree_map(lambda t: t.clone(), eager_state[0])] if controlled else None
                with (deterministic() if det else contextlib.nullcontext()):
                    captured = CapturedStep(as_state, tree_map(lambda t: t.clone(),
                                                               eager_state[0]), dev)

                    def eager(b, st=eager_state):
                        loss, p, o = step_fn(st[0]["params"], st[0]["opt"], b)
                        st[0] = {"params": p, "opt": o}
                        return float(loss)

                    zero_counts()
                    t1 = time.perf_counter()
                    captured(batches[0])  # the eager warm-up step and the capture
                    torch.cuda.synchronize()
                    capture_s = time.perf_counter() - t1
                    torch.cuda.empty_cache()
                    ms = {"eager": [], "replay": []}
                    pairs, control_pairs, before_last = [], [], None
                    for i, b in enumerate(batches):
                        if controlled and i == len(batches) - 1:
                            before_last = eager_state[0]
                        e_loss, e_ms = timed(eager, b)
                        ms["eager"].append(e_ms)
                        if i:
                            r_loss, r_ms = timed(lambda b: float(captured(b)), b)
                            ms["replay"].append(r_ms)
                            pairs.append((e_loss, r_loss))
                        if controlled:
                            control_pairs.append((e_loss, eager(b, control)))
                    gap = state_gap(captured.state, eager_state[0], pairs)
                    equal = (gap["max_abs_diff"] == 0 and gap["ints_equal"]
                             and all(a == b for a, b in pairs))
                    held = {"replay_bit_equal_eager": equal, **gap, "losses": pairs,
                            "capture_s": capture_s}
                    over = []
                    if controlled:
                        held["limits"] = LM_TRAIN_DEFAULT_TOL
                        held["control_eager_twice"] = state_gap(control[0], eager_state[0],
                                                                control_pairs)
                        held["control_one_step_apart"] = state_gap(
                            before_last, eager_state[0], [(pairs[-1][0], pairs[-2][0])])
                        control = before_last = None
                        over = [k for k, limit in LM_TRAIN_DEFAULT_TOL.items()
                                if not gap[k] <= limit]  # a NaN fails too
                        over += [] if gap["ints_equal"] else ["step count"]
                    run["deterministic_mode" if det else "default_mode"] = held
                    if (not controlled and not equal) or over:
                        raise AssertionError(f"{arch}: 3 replayed steps vs 3 eager steps "
                                             f"(deterministic mode {det}): {held}")
                    if det:
                        read_counts(f"phase {phase} {arch} replay check, deterministic mode",
                                    run["launches"])
                        state = eager_state[0]
                        captured = eager_state = None
                        gc.collect()
                        torch.cuda.empty_cache()
                        continue
                    for _ in range(3):
                        ms["replay"].append(timed(lambda b: float(captured(b)), batches[0])[1])
                    read_counts(f"phase {phase} {arch} replay check", run["launches"])
                    replay_ms = statistics.median(ms["replay"])
                    busy = None
                    if attends:  # mamba2's step is far too many kernels (docstring)
                        busy = device_ms(lambda: float(captured(batches[0])), 1, host=False)
                    t1 = time.perf_counter()
                    top = top_kernels(lambda: float(captured(batches[0])), reps=1, n=8)
                    run["top_kernels_s"] = time.perf_counter() - t1
            tokens = batch * seq
            attn_fwd = (2 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
                        if attends else 0)  # causal: QK^T and PV over half the keys
            flops_model = 6 * n_matmul * tokens + 4 * attn_fwd  # attention fwd + bwd + remat
            flops_run = 8 * n_matmul * tokens + 4 * attn_fwd    # the weight products' remat too
            run.update({
                "params": n_params, "matmul_params": n_matmul,
                "eager_step_ms": ms["eager"], "replay_step_ms": ms["replay"],
                "eager_step_ms_median": statistics.median(ms["eager"]),
                "replay_step_ms_median": replay_ms,
                "tokens_per_s": tokens / (replay_ms / 1e3),
                "device_busy_ms": busy,
                "idle_share": None if busy is None else 1 - busy / replay_ms,
                "top_kernels": top,
                "flops_model": flops_model, "flops_run": flops_run,
                "model_flop_share": flops_model / (replay_ms / 1e3 * PEAK_BF16_FLOPS),
                "run_flop_share": flops_run / (replay_ms / 1e3 * PEAK_BF16_FLOPS),
                "peak_memory_gb_all": torch.cuda.max_memory_allocated() / 1e9,
            })
            captured = eager_state = batches = None
            gc.collect()
            torch.cuda.empty_cache()
        run["phase_s"] = time.perf_counter() - t0
        report[arch] = run
        held = run["deterministic_mode" if attends else "default_mode"]
        log(f"phase {phase} {arch} ok: B={batch} S={seq} bf16, launcher {steps} steps in "
            f"{run['launcher_wall_s']:.1f} s (peak {run['peak_memory_gb']:.2f} GB, losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}); replay bit-equal to eager "
            f"{held['replay_bit_equal_eager']}"
            + (" in deterministic mode; default mode against eager: "
               + ", ".join(f"{k} {run['default_mode'][k]:.3g} (limit {limit:.3g}, eager twice "
                           f"{run['default_mode']['control_eager_twice'][k]:.3g}, one step apart "
                           f"{run['default_mode']['control_one_step_apart'][k]:.3g})"
                           for k, limit in LM_TRAIN_DEFAULT_TOL.items())
               if attends else "")
            + f"; step eager {run['eager_step_ms_median']:.1f} ms, replayed {replay_ms:.1f} ms, "
            f"{run['tokens_per_s']:.0f} tokens/s, device busy {busy} ms, idle share "
            f"{run['idle_share']}, model-FLOP share {run['model_flop_share']:.3f} "
            f"({flops_model:.3g} FLOP a step), peak {run['peak_memory_gb_all']:.2f} GB; "
            f"K4/K5 launches: launcher {run['launches_launcher']}, replay checks "
            f"{run['launches']} ({run['phase_s']:.1f} s)")
    log(smi)
    return launches, report


#: phase 32's real step (smollm-360m train_4k cut to B=8) and phase 33's
#: decode (decode_32k cut to B=8, a 512-token prompt, 16 steps)
DRY_TRAIN = ("smollm-360m", 4096, 8, 3)
DRY_DECODE = ("smollm-360m", 32768, 8, 512, 16)
#: phase 34: production cells traced on the pod_32x8 mesh (256 H100s) on
#: the card's host, one process each, side by side with phases 32-33.
#: llava-next-34b.train_4k traces in about 260 s (PERF.md §4): it is in
#: the --all sweep, not here
DRY_CELLS = (("dbrx-132b", "train_4k"), ("dbrx-132b", "decode_32k"),
             ("llava-next-34b", "decode_32k"))
DRY_PHASE_S = 150
#: the traced peak (fake CPU tensors, MemTracker) against
#: torch.cuda.max_memory_allocated over the real step: the trace sees no
#: cuBLAS or cuDNN workspace and the CPU's fused attention keeps other
#: buffers than the card's, so the two are held to a quarter apart
DRY_PEAK_REL = 0.25
DRY_FLOPS_REL = 0.01
_PREDICT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_cell
arch, name, seq, batch, kind = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
rec = run_cell(get_arch(arch), InputShape(name, seq, batch, kind), mesh_shape=(1, 1))
print("RECORD " + json.dumps(rec))
"""


def _spawn_dryruns(out_dir: Path) -> dict:
    """Phase 34's production cells (``python -m repro_torch.launch.dryrun``)
    and the (1, 1)-mesh predictions of phases 32-33, each a process of
    its own on the host's cores: {name: (process, output file)}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for arch, shape in DRY_CELLS:
        log_path = out_dir / f"{arch}.{shape}.log"
        procs[f"{arch}.{shape}"] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "pod", "--out", str(out_dir)], cwd=ROOT, env=env,
            stdout=open(log_path, "w"), stderr=subprocess.STDOUT), log_path)
    arch, seq, batch, _ = DRY_TRAIN
    darch, dseq, dbatch, _, _ = DRY_DECODE
    for name, args in (("predict_train", (arch, "train_4k", seq, batch, "train")),
                       ("predict_decode", (darch, "decode_32k", dseq, dbatch, "decode"))):
        log_path = out_dir / f"{name}.log"
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _PREDICT, str(ROOT / "src"), *map(str, args)], cwd=ROOT,
            env=env, stdout=open(log_path, "w"), stderr=subprocess.STDOUT), log_path)
    return procs


def _predicted(procs: dict, name: str, timeout: float) -> dict:
    proc, path = procs[name]
    proc.wait(timeout=timeout)
    text = path.read_text()
    lines = [ln for ln in text.splitlines() if ln.startswith("RECORD ")]
    if proc.returncode or not lines:
        raise AssertionError(f"dry-run prediction {name} failed: {text[-3000:]}")
    rec = json.loads(lines[-1][len("RECORD "):])
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run prediction {name}: {rec}")
    return rec


def dryrun_phases(dev, smi: str) -> tuple[dict, dict]:
    """Phases 32-34, this slice's path: the mesh, the sharding rules and
    the dry run (``launch/dryrun.py``).

    32. A real step through the dry run: an NCCL process group of one rank,
        ``make_host_mesh()`` on the card ((1, 1), ("data", "model")),
        smollm-360m ``train_4k`` cut to B=8 through ``build_cell``'s step:
        DTensor parameters, AdamW, 3 steps, in deterministic mode, against
        the plain step (``make_train_step`` on the family's ``loss_fn``)
        from the same seed: bit for bit, or within
        ``LM_TRAIN_DEFAULT_TOL`` (losses, parameters, moments).  The dry run's own
        prediction for that cell (a fake (1, 1) mesh, fake CPU tensors)
        against the card: argument bytes exactly equal to the bytes the
        real parameters, moments and batch occupy; the traced peak
        against ``torch.cuda.max_memory_allocated`` over the first real
        step (``DRY_PEAK_REL``); its dot FLOPs against ``FlopCounterMode``
        over that step (``DRY_FLOPS_REL``).
    33. Decode: smollm-360m ``decode_32k`` cut to B=8 on the same mesh with
        the serve rules, 16 steps after a 512-token prompt, its logits
        against ``LmEngine``'s plain path (``use_kernel=False``, eager)
        under teacher forcing (``LM_TF_TOL``); predicted argument bytes
        against the real ones.
    34. The dry run at production size on the card's host: ``DRY_CELLS``
        on ``pod_32x8``, each ``status: "ok"``, with per-rank argument
        bytes, traced peak, fit against 80 GB, dot FLOPs and collective
        bytes by type; the phase within ``DRY_PHASE_S``.

    K4 and K5 launch on none of these paths (the dry-run cells pass
    ``use_kernel=False``; training runs none): their counts are set to 0
    before phases 32-33 and read after them.  Returns (launches by
    kernel, the report)."""
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    t_c = time.time()  # wall clock: phase 34 ends when its last record is written
    procs = _spawn_dryruns(out_dir)
    try:
        return _dryrun_run(dev, smi, procs, out_dir, t_c)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def _dryrun_run(dev, smi: str, procs: dict, out_dir: Path, t_c: float) -> tuple[dict, dict]:
    """The body of ``dryrun_phases`` (which stops ``procs`` whatever
    happens)."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.costs import argument_bytes, attention_flops
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.data.lm import LmDataConfig, lm_batch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import distribute
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import LmEngine
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten

    report: dict = {}
    decode_attn.launches = ssd_scan.launches = 0
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()

        # -- phase 32: a real train step through the dry run's cell ---------
        t0 = time.perf_counter()
        arch, seq, batch, steps = DRY_TRAIN
        cfg = get_arch(arch)
        api = get_model(cfg)
        shape = InputShape("train_4k", seq, batch, "train")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = api.init_params(cfg, seed=0, device=dev)
        opt = init_opt_state(params)
        data_cfg = LmDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in lm_batch(data_cfg, i).items()}
                   for i in range(steps)]
        plain_step = make_train_step(lambda p, b: api.loss_fn(p, b, cfg), AdamWConfig(),
                                     microbatches=cfg.train_microbatches)
        run: dict = {"arch": arch, "S": seq, "B": batch, "steps": steps, "mesh": [1, 1]}
        with deterministic():
            cell = build_cell(cfg, shape, mesh, state=(params, opt, batches[0]))
            real_args = argument_bytes(*cell.args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counter = FlopCounterMode(display=False, custom_mapping=attention_flops())
            with counter:
                loss, p_d, o_d = cell.fn(*cell.args)
            torch.cuda.synchronize()
            run["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            run["flop_counter_flops"] = counter.get_total_flops()
            sharded_losses = [float(loss.full_tensor())]
            for b in batches[1:]:
                loss, p_d, o_d = cell.fn(p_d, o_d, distribute(mesh, b, cell.specs[2]))
                sharded_losses.append(float(loss.full_tensor()))
            cell = None
            plain_losses, p, o = [], params, opt
            for b in batches:
                loss, p, o = plain_step(p, o, b)
                plain_losses.append(float(loss))
        got = flatten({"params": p_d, "opt": o_d})
        want = flatten({"params": p, "opt": o})
        gap = {"loss": max(abs(a - b) / abs(b) for a, b in zip(sharded_losses, plain_losses)),
               "params": 0.0, "moments": 0.0, "max_abs_diff": 0.0}
        for k, w in want.items():
            if not w.is_floating_point():
                continue
            d = (got[k].full_tensor().float() - w.float()).abs().max().item()
            part = "params" if k.startswith("params/") else "moments"
            gap["max_abs_diff"] = max(gap["max_abs_diff"], d)
            gap[part] = max(gap[part], d / max(w.float().abs().max().item(), 1e-30))
        run.update(losses_sharded=sharded_losses, losses_plain=plain_losses, gap=gap,
                   bit_equal=gap["max_abs_diff"] == 0 and sharded_losses == plain_losses,
                   limits=LM_TRAIN_DEFAULT_TOL)
        p_d = o_d = p = o = params = opt = got = want = None
        if not run["bit_equal"] and not all(gap[k] <= v for k, v in LM_TRAIN_DEFAULT_TOL.items()):
            raise AssertionError(f"phase 32: the dry run's step on the card against the plain "
                                 f"step in deterministic mode: {run}")
        pred = _predicted(procs, "predict_train", 900)
        run["predicted"] = {"argument_bytes": pred["memory"]["argument_bytes"],
                            "peak_bytes": pred["memory"]["peak_bytes"],
                            "dot_flops": pred["hlo_dot_flops"], "trace_s": pred["trace_s"]}
        run["argument_bytes"] = real_args
        run["peak_gap_rel"] = (pred["memory"]["peak_bytes"] - run["peak_bytes"]) / run["peak_bytes"]
        run["flops_gap_rel"] = ((pred["hlo_dot_flops"] - run["flop_counter_flops"])
                                / run["flop_counter_flops"])
        run["phase_s"] = time.perf_counter() - t0
        report["train"] = run
        log(f"phase 32 dry-run train step ok: {arch} S={seq} B={batch} on the (1, 1) mesh, "
            f"{steps} steps against the plain step in deterministic mode: bit-equal "
            f"{run['bit_equal']}, gap {gap} (limits {LM_TRAIN_DEFAULT_TOL}; losses "
            f"{sharded_losses}); predicted "
            f"argument bytes {pred['memory']['argument_bytes']} vs real {real_args}; peak "
            f"predicted {pred['memory']['peak_bytes'] / 1e9:.3f} GB vs max_memory_allocated "
            f"{run['peak_bytes'] / 1e9:.3f} GB (gap {run['peak_gap_rel']:+.3f}, limit "
            f"{DRY_PEAK_REL}); dot FLOPs predicted {pred['hlo_dot_flops']:.4e} vs "
            f"FlopCounterMode {run['flop_counter_flops']:.4e} (gap {run['flops_gap_rel']:+.4f}, "
            f"limit {DRY_FLOPS_REL}) ({run['phase_s']:.1f} s)")
        if pred["memory"]["argument_bytes"] != real_args:
            raise AssertionError(f"phase 32: predicted argument bytes {run['predicted']} != "
                                 f"real {real_args}")
        if not abs(run["peak_gap_rel"]) <= DRY_PEAK_REL:
            raise AssertionError(f"phase 32: traced peak vs the card's: {run}")
        if not abs(run["flops_gap_rel"]) <= DRY_FLOPS_REL:
            raise AssertionError(f"phase 32: dot FLOPs vs FlopCounterMode: {run}")

        # -- phase 33: decode through the dry run's cell ---------------------
        t0 = time.perf_counter()
        arch, rows, batch, n_prompt, n_steps = DRY_DECODE
        cfg = get_arch(arch)
        api = get_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        params = api.init_params(cfg, seed=0, device=dev)
        toks = lm_batch(LmDataConfig(vocab=cfg.vocab, seq_len=n_prompt + n_steps + 1,
                                     global_batch=batch), 0)["tokens"]
        prompt, follow = toks[:, :n_prompt], toks[:, n_prompt:]
        engine = LmEngine(params, cfg, max_len=rows, device=dev, use_kernel=False,
                          graphs=False)
        want = engine.teacher_forced(prompt, follow)
        engine = None
        with torch.no_grad():
            _, cache = api.prefill(params, {"tokens": torch.as_tensor(prompt).to(dev)}, cfg, rows)
        dshape = InputShape("decode_32k", rows, batch, "decode")
        first = {"tokens": torch.as_tensor(follow[:, :1]).to(dev)}
        cell = build_cell(cfg, dshape, mesh, state=(params, cache, first))
        real_args = argument_bytes(*cell.args)
        p_d, c_d = cell.args[0], cell.args[1]
        steps_logits = []
        with torch.no_grad():
            for i in range(n_steps):
                b = distribute(mesh, {"tokens": torch.as_tensor(follow[:, i:i + 1]).to(dev)},
                               cell.specs[2])
                logits, c_d = cell.fn(p_d, c_d, b)
                steps_logits.append(logits.full_tensor()[:, 0].float())
        got = (want[0], torch.stack(steps_logits))
        stats = tf_stats(arch, got, want, cfg.vocab)["decode"]
        cell = cache = c_d = p_d = params = None
        pred = _predicted(procs, "predict_decode", 900)
        run = {"arch": arch, "rows": rows, "B": batch, "prompt": n_prompt, "steps": n_steps,
               "vs_plain_engine": stats, "limit_rel": LM_TF_TOL,
               "argument_bytes": real_args,
               "predicted_argument_bytes": pred["memory"]["argument_bytes"],
               "predicted_peak_bytes": pred["memory"]["peak_bytes"],
               "phase_s": time.perf_counter() - t0}
        report["decode"] = run
        log(f"phase 33 dry-run decode ok: {arch} {n_steps} steps against a {rows}-row cache "
            f"(B={batch}) on the (1, 1) mesh vs LmEngine's plain path: max |diff| "
            f"{stats['max_abs_diff']:.4g} of max |logit| {stats['max_abs_logit']:.4g} (limit "
            f"{LM_TF_TOL}), argmax agree {stats['argmax_agree']:.3f}; argument bytes predicted "
            f"{run['predicted_argument_bytes']} vs real {real_args} ({run['phase_s']:.1f} s)")
        if not stats["max_abs_diff"] <= LM_TF_TOL * stats["max_abs_logit"]:
            raise AssertionError(f"phase 33: decode logits vs the plain engine: {run}")
        if run["predicted_argument_bytes"] != real_args:
            raise AssertionError(f"phase 33: predicted argument bytes != real: {run}")
    finally:
        dist.destroy_process_group()
    launches = {"decode_attn": decode_attn.launches, "ssd_scan": ssd_scan.launches}
    if any(launches.values()):
        raise AssertionError(f"phases 32-33: a kernel launched on the dry run's path: {launches}")

    # -- phase 34: the production cells, traced beside phases 32-33 ----------
    cells = {}
    for arch, shape in DRY_CELLS:
        proc, path = procs[f"{arch}.{shape}"]
        proc.wait(timeout=max(DRY_PHASE_S * 4 - (time.time() - t_c), 1))
        rec_path = out_dir / f"{arch}.{shape}.pod_32x8.json"
        if proc.returncode or not rec_path.exists():
            raise AssertionError(f"phase 34 {arch}.{shape}: {path.read_text()[-3000:]}")
        rec = json.loads(rec_path.read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"phase 34 {arch}.{shape}: {rec}")
        m = rec["memory"]
        cells[rec["cell"]] = {
            "argument_bytes": m["argument_bytes"], "peak_bytes": m["peak_bytes"],
            "fits_80gb": m["fits"], "dot_flops": rec["hlo_dot_flops"],
            "collective_bytes": rec["collective_bytes"], "trace_s": rec["trace_s"]}
        log(f"phase 34 {rec['cell']} ok: {m['argument_bytes'] / 1e9:.3f} GB of arguments "
            f"and a {m['peak_bytes'] / 1e9:.3f} GB peak per rank (fits 80 GB: {m['fits']}), "
            f"{rec['hlo_dot_flops']:.4e} dot FLOPs, collective bytes "
            f"{ {k: f'{v:.4e}' for k, v in rec['collective_bytes'].items()} } "
            f"(traced in {rec['trace_s']} s)")
    phase_s = max((out_dir / f"{a}.{sh}.pod_32x8.json").stat().st_mtime
                  for a, sh in DRY_CELLS) - t_c
    report["production"] = {"cells": cells, "phase_s": phase_s, "limit_s": DRY_PHASE_S}
    log(f"phase 34 ok: {len(cells)} production cells on pod_32x8, the last written "
        f"{phase_s:.1f} s after they started, beside phases 32-33 (limit {DRY_PHASE_S} s)")
    if phase_s > DRY_PHASE_S:
        raise AssertionError(f"phase 34 took {phase_s:.1f} s (limit {DRY_PHASE_S} s)")
    log(smi)
    return launches, report


def main() -> int:
    # deterministic mode (phase 30) needs cuBLAS's workspace fixed before
    # its first call: 8 buffers of 4 MiB
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gw import GW_MODELS
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
    from repro_torch.core.quant import EXACT, HARD, PAPER_HW_KERNEL, make_act_quant
    from repro_torch.device import resolve_device
    from repro_torch.kernels.lstm_scan import (
        lstm_scan,
        lstm_scan_layer,
        lstm_scan_layer_ref,
        lstm_scan_ref,
    )
    from repro_torch.kernels._build import ptxas_report
    from repro_torch.kernels.lstm_stack.lstm_stack import library, lstm_stack
    from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0
    from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step, lstm_stack_step_plain
    from repro_torch.kernels.rowwise import rowwise_matmul
    from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

    # the wrapper modules, whose plain-version references the serving
    # phases block
    k1_mod = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
    k2_mod = sys.modules["repro_torch.kernels.lstm_stack.step"]
    k3_mod = sys.modules["repro_torch.kernels.lstm_scan.lstm_scan"]
    rw_mod = sys.modules["repro_torch.kernels.rowwise.rowwise"]
    import repro_torch.kernels.decode_attn  # noqa: F401
    import repro_torch.kernels.ssd_scan  # noqa: F401
    k5_mod = sys.modules["repro_torch.kernels.decode_attn.decode_attn"]
    k4_mod = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]

    # -- phase 1: environment ----------------------------------------------
    dev = resolve_device("cuda")  # also switches TF32 off for matmul and cuDNN
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 2: build, one nvcc per source, started together --------------
    t0 = time.perf_counter()
    to_build = (library, k3_mod.library, k5_mod.library, k4_mod.library, rw_mod.library)
    with concurrent.futures.ThreadPoolExecutor(len(to_build)) as pool:
        libs = list(pool.map(lambda build: build(), to_build))
    ptxas = {}
    for built in libs:
        report = ptxas[built.path.name.split("-")[0][3:]] = ptxas_report(built.log)
        regs = [k["registers"] for k in report if k["registers"] is not None]
        log(f"phase 2 build ok: {built.path.name}, nvcc {built.seconds:.1f} s, {len(report)} "
            f"kernels, registers {min(regs, default=None)}-{max(regs, default=None)}")
        for k in report:
            if k["spill_stores"] or k["spill_loads"]:
                log(f"  ptxas: {k['kernel']}: {k['spill_stores']} bytes spill stores, "
                    f"{k['spill_loads']} bytes spill loads")
    # every instantiation of K3 and K4; K3's warp-cell kernels keep their
    # weights in registers and must spill nothing
    for lib in ("lstm_scan", "ssd_scan"):
        for k in ptxas[lib]:
            log(f"  ptxas {lib}: {k['kernel']}: {k['registers']} registers, "
                f"{k['stack_frame']} bytes stack, {k['spill_stores']}/{k['spill_loads']} "
                f"bytes spilled (stores/loads)")
    warp_spills = [k for k in ptxas["lstm_scan"]
                   if "warp_kernel" in k["kernel"] and (k["spill_stores"] or k["spill_loads"])]
    if warp_spills or not ptxas["lstm_scan"]:
        raise AssertionError(f"K3's warp-cell kernels spill (or no ptxas report): {warp_spills}")
    log(f"phase 2 build wall {time.perf_counter() - t0:.1f} s")

    with np.load(FIXTURE) as data:
        golden = {k: data[k] for k in data.files}
    tree: dict = {}
    for key, value in golden.items():
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = value
    params = params_from_numpy(tree, dev)
    cfg = GW_MODELS["gw_nominal"]
    T = cfg.timesteps

    def packs(wd, dtype=torch.float32):
        c = dataclasses.replace(cfg, weight_dtype=wd, dtype=dtype)
        return {"enc": pack_stack(*encoder_layers(params, c)),
                "dec": pack_stack(*decoder_layers(params, c))}

    gen = torch.Generator().manual_seed(0)

    def segment_input(seg, pk, batch, t_len):
        """Main-path-shaped input of a segment, padded to the pack width:
        strain windows for the encoder, a repeated latent for the decoder."""
        if seg == "enc":
            x = torch.randn(batch, t_len, 1, generator=gen)
        else:
            x = (torch.rand(batch, 1, pk.in_dims[0], generator=gen) * 2 - 1).expand(
                batch, t_len, pk.in_dims[0])
        return pk.pad_input(x.to(dev))

    def state(pk, batch):
        shape = (pk.n_layers, batch, pk.width_p)
        return ((torch.randn(shape, generator=gen) * 0.3).to(pk.dtype).to(dev),
                (torch.randn(shape, generator=gen) * 0.3).to(dev))

    def plain_kw(pk, acts, act_bits):
        return dict(scales=pk.stacked.get("scales"), sigma=acts.sigma, tanh=acts.tanh,
                    act_quant=make_act_quant(act_bits) if act_bits else None)

    def compare(got, want, what):
        """The LSTM kernels' contract: equal to the plain version bit for bit."""
        err = 0.0
        for a, b in zip(got, want):
            err = max(err, (a.float() - b.float()).abs().max().item())
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: kernel differs from its plain version "
                                     f"(max |difference| {err:.3g})")
        return err

    # storage x compute: fp32 compute with fp32/bf16/int8 storage, bf16
    # compute with bf16/int8 storage (storage is never wider than compute)
    all_packs = {(wd, "fp32"): packs(wd) for wd in ("fp32", "bf16", "int8")}
    all_packs.update({(wd, "bf16"): packs(wd, torch.bfloat16) for wd in ("bf16", "int8")})
    matrix = [(key, acts, bits) for key in all_packs for acts in (EXACT, PAPER_HW_KERNEL)
              for bits in (None, 16)]

    # -- phase 3: K1 against its plain version -----------------------------
    # B 1 and 64 run one row a CTA; SMs + 1 (the least batch the wrapper
    # row-blocks, fewer than two CTAs an SM) and 2 * SMs * R + 3 (more than
    # a wave of row blocks) run the row-blocked instantiation, each with a
    # partial last CTA
    sms = k1_mod.sm_count(dev.index or 0)
    k1_batches = (1, 64, sms + 1, 2 * sms * k1_mod.BLOCKED_ROWS + 3)
    k1_blocked = {b: k1_mod.kernel_path(b, 2, 32, sms).kind == "blocked" for b in k1_batches}
    if list(k1_blocked.values()) != [False, False, True, True]:
        raise AssertionError(f"phase 3: row blocking by batch {k1_blocked}")
    t0, k1_err, n = time.perf_counter(), 0.0, 0
    lstm_stack.launches_by_path.clear()
    for key, acts, bits in matrix:
        for seg, pk in all_packs[key].items():
            s = pk.stacked
            for batch in k1_batches:
                xw0 = project_layer0(segment_input(seg, pk, batch, T), s, key[0])
                h0, c0 = state(pk, batch)
                got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                 scales=s.get("scales"), acts=acts, act_bits=bits)
                want = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                      **plain_kw(pk, acts, bits))
                torch.cuda.synchronize()
                k1_err = max(k1_err, compare(got, want, f"K1 {key} {acts.name} {bits} {seg} "
                                                        f"B={batch}"))
                n += 1
    n_blocked = n // len(k1_batches) * sum(k1_blocked.values())
    if lstm_stack.launches_by_path["blocked"] != n_blocked:
        raise AssertionError(f"phase 3: K1 launches by path {dict(lstm_stack.launches_by_path)}, "
                             f"want {n_blocked} blocked")
    log(f"phase 3 K1 ok: {n} cases (fp32 and bf16 compute; B {k1_batches}, {n_blocked} of them "
        f"row-blocked, {k1_mod.BLOCKED_ROWS} rows a thread), bit-equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    # the same packs at the layers' own widths, as every pack's caller
    # launches them: the row-blocked batches and the nominal cell's 73,728
    # rows, on the zero state and on a state packed from the real widths,
    # each held in all of hs, h_f and c_f (their bits: signed zeros count)
    # against the plain version at the real widths and the padded one
    def bit_view(t):
        return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])

    def real_state(pk, batch):
        return pk.pack_state([((torch.randn(batch, h, generator=gen) * 0.3).to(dev),
                               (torch.randn(batch, h, generator=gen) * 0.3).to(dev))
                              for h in pk.hidden])

    trim_batches = tuple(b for b in k1_batches if k1_blocked[b]) + (73_728,)
    t0, n_trim = time.perf_counter(), 0
    lstm_stack.trimmed_launches = 0
    for key, acts, bits in matrix:
        for seg, pk in all_packs[key].items():
            s = pk.stacked
            if not k1_mod.trims(pk.widths, pk.width_p):
                raise AssertionError(f"phase 3: {seg} {pk.widths} is not trimmed at W={pk.width_p}")
            for batch in trim_batches:
                xw0 = project_layer0(segment_input(seg, pk, batch, T), s, key[0])
                for state_kind in ("zero", "real"):
                    h0, c0 = pk.zero_state(batch) if state_kind == "zero" else real_state(pk, batch)
                    got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                     scales=s.get("scales"), acts=acts, act_bits=bits,
                                     widths=pk.widths)
                    for widths in (pk.widths, None):
                        want = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                              widths=widths, **plain_kw(pk, acts, bits))
                        torch.cuda.synchronize()
                        for a, b in zip(got, want, strict=True):
                            if not torch.equal(bit_view(a), bit_view(b)):
                                raise AssertionError(
                                    f"phase 3: K1 at the layers' own widths {key} {acts.name} "
                                    f"{bits} {seg} B={batch} {state_kind} state: differs from "
                                    f"the plain version at {'real' if widths else 'padded'} "
                                    f"widths")
                        del want
                    n_trim += 1
                    del h0, c0, got
                del xw0
    torch.cuda.empty_cache()
    if lstm_stack.trimmed_launches != n_trim:
        raise AssertionError(f"phase 3: {lstm_stack.trimmed_launches} trimmed K1 launches, "
                             f"want {n_trim}")
    n_blocked += n_trim
    if lstm_stack.launches_by_path["blocked"] != n_blocked:
        raise AssertionError(f"phase 3: K1 launches by path {dict(lstm_stack.launches_by_path)}, "
                             f"want {n_blocked} blocked")
    log(f"phase 3 K1 at the layers' own widths ok: {n_trim} cases (gw_nominal's packs, five "
        f"dtype pairs, {len(matrix) // len(all_packs)} activation and act_bits cases, B "
        f"{trim_batches}, zero and real-width states), every launch trimmed, bit-equal to the "
        f"plain version at the real widths and to the padded one "
        f"({time.perf_counter() - t0:.1f} s)")
    # gw_small's packs over the same matrix: the encoder's and the decoder's
    # (L=1, W=9; the decoder's stream of time stride 0) and both layers as one
    # pack (L=2, W=9), at the row-thread threshold (one row a CTA), one above
    # it and the benchmark's 294,912 rows (one row a thread)
    small = GW_MODELS["gw_small"]
    small_params = init_autoencoder(small, seed=7, device=dev)

    def small_packs(wd, dtype=torch.float32):
        c = dataclasses.replace(small, weight_dtype=wd, dtype=dtype)
        enc_l, dec_l = encoder_layers(small_params, c), decoder_layers(small_params, c)
        return {"enc": pack_stack(*enc_l), "dec": pack_stack(*dec_l),
                "enc+dec": pack_stack(enc_l[0] + dec_l[0], enc_l[1] + dec_l[1])}

    cut = k1_mod.row_thread_threshold(sms)
    small_batches = (cut, cut + 1, 294_912)
    k1_row_thread = [tuple(k1_mod.kernel_path(b, n_layers, 9, sms).kind == "row_thread"
                           for n_layers in (1, 2)) for b in small_batches]
    if k1_row_thread != [(False, False), (True, True), (True, True)]:
        raise AssertionError(f"phase 3: one row a thread at W=9 by batch {small_batches}, "
                             f"L=1 and 2: {k1_row_thread}")
    t0, n_small, n_row = time.perf_counter(), 0, 0
    for wd, compute in all_packs:
        sp = small_packs(wd, torch.float32 if compute == "fp32" else torch.bfloat16)
        for acts in (EXACT, HARD, PAPER_HW_KERNEL):
            for bits in (None, 16):
                for seg, pk in sp.items():
                    s = pk.stacked
                    for batch in small_batches:
                        xs = segment_input("dec" if seg == "dec" else "enc", pk, batch, T)
                        xw0 = project_layer0(xs, s, wd)
                        h0, c0 = state(pk, batch)
                        got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                         scales=s.get("scales"), acts=acts, act_bits=bits)
                        want = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                              **plain_kw(pk, acts, bits))
                        torch.cuda.synchronize()
                        k1_err = max(k1_err, compare(got, want, f"K1 gw_small {wd}/{compute} "
                                                                f"{acts.name} {bits} {seg} "
                                                                f"B={batch}"))
                        n_small += 1
                        n_row += batch > cut
                        del xs, xw0, h0, c0, got, want
    torch.cuda.empty_cache()
    by_path = lstm_stack.launches_by_path
    if (by_path["row_thread"], by_path["blocked"]) != (n_row, n_blocked):
        raise AssertionError(f"phase 3: K1 launches by path {dict(by_path)}, want {n_row} "
                             f"row_thread and {n_blocked} blocked")
    log(f"phase 3 K1 gw_small ok: {n_small} cases (L=1 and 2, W=9, five dtype pairs, three "
        f"activation sets, act_bits None and 16, dense and repeated streams; B {small_batches}, "
        f"{n_row} of them one row a thread, {k1_mod.ROW_THREAD_ROWS} rows a CTA), bit-equal to "
        f"the plain version ({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: K2 against its plain version -----------------------------
    t0, k2_err, n = time.perf_counter(), 0.0, 0
    for key, acts, bits in matrix:
        for seg, pk in all_packs[key].items():
            s = pk.stacked
            for t_len in (1, 25, 32):
                for batch in (1, 8, 64):
                    xs = segment_input(seg, pk, batch, t_len)
                    h0, c0 = state(pk, batch)
                    got = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                                          scales=s.get("scales"), acts=acts, act_bits=bits)
                    want = lstm_stack_step_plain(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                                                 **plain_kw(pk, acts, bits))
                    torch.cuda.synchronize()
                    k2_err = max(k2_err, compare(
                        got, want, f"K2 {key} {acts.name} {bits} {seg} T={t_len} B={batch}"))
                    n += 1
    log(f"phase 4 K2 ok: {n} cases (fp32 and bf16 compute), bit-equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 5: the serving path at full gw_nominal width ----------------
    def refuse_plain(*args, **kwargs):
        raise AssertionError("the main path reached a plain version on the card")

    @contextlib.contextmanager
    def block_plain():
        """K1's, K2's and the row-wise product's plain versions refuse to run."""
        saved = (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, rw_mod.rowwise_matmul_plain)
        (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain,
         rw_mod.rowwise_matmul_plain) = refuse_plain, refuse_plain, refuse_plain
        try:
            yield
        finally:
            k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, rw_mod.rowwise_matmul_plain = saved

    saved = (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, rw_mod.rowwise_matmul_plain)
    (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain,
     rw_mod.rowwise_matmul_plain) = refuse_plain, refuse_plain, refuse_plain
    lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
    t0 = time.perf_counter()
    windows = golden["windows"]
    n_bg = int(golden["n_background"])
    for wd in ("fp32", "bf16", "int8"):
        c = dataclasses.replace(cfg, weight_dtype=wd)
        batch_eng = AnomalyStreamEngine(params, c, impl="fused_stack")
        assert batch_eng.effective_impl == "fused_stack", batch_eng.effective_impl
        np.testing.assert_allclose(batch_eng.score(windows), golden[f"scores/{wd}"], **TOL,
                                   err_msg=f"batch scores vs reference, {wd}")
        lock = StreamingAnomalyEngine(params, c, batch=len(windows))
        streamed = []
        for pos in range(0, T, 25):
            streamed += lock.push(windows[:, pos : pos + 25])
        np.testing.assert_allclose(streamed[0], golden[f"streamed/{wd}"], **TOL,
                                   err_msg=f"streamed scores vs reference, {wd}")
    eng = StreamingAnomalyEngine(params, cfg, batch=1)
    assert eng.effective_impl == "fused_step", eng.effective_impl
    threshold = eng.calibrate(windows[:n_bg], fpr=0.1)
    flags = eng.flag(windows)
    one_shot = eng.score(windows[:1])
    by_25 = [s for pos in range(0, T, 25) for s in eng.push(windows[:1, pos : pos + 25])]
    by_1 = [s for pos in range(T) for s in eng.push(windows[:1, pos : pos + 1])]
    for got in (by_25, by_1):
        assert len(got) == 1
        np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                                   err_msg="chunked streaming vs one-shot")
    n_streams = check_push_many(lambda: StreamingAnomalyEngine(params, cfg, batch=1),
                                windows, T)
    torch.cuda.synchronize()
    launches = {"lstm_stack_wavefront": lstm_stack.launches,
                "lstm_stack_step": lstm_stack_step.launches,
                "rowwise_matmul": rowwise_matmul.launches}
    k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, rw_mod.rowwise_matmul_plain = saved
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the serving path never launched {name}")
    log(f"phase 5 engine ok: scores match the reference (fp32/bf16/int8), threshold "
        f"{threshold:.6g} flags {int(flags.sum())}/{len(flags)}, push_many bit-equal over "
        f"{n_streams} streams, launches {launches} ({time.perf_counter() - t0:.1f} s)")

    # launches per scored window by streaming mode, and per batch score call
    per_window = {}
    for mode, chunk in (("push_T1", 1), ("push_T25", 25)):
        lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
        for pos in range(0, T, chunk):
            eng.push(windows[:1, pos : pos + chunk])
        per_window[mode] = (lstm_stack.launches, lstm_stack_step.launches,
                            rowwise_matmul.launches)
    lstm_stack.launches = lstm_stack_step.launches = rowwise_matmul.launches = 0
    eng.score(windows)
    per_window[f"score_call_B{len(windows)}"] = (lstm_stack.launches, lstm_stack_step.launches,
                                                 rowwise_matmul.launches)
    # a batch score at the benchmark's gw_nominal batch: both segments' K1
    # launches row-blocked at the layers' own widths (trimmed), the
    # decoder's reading its repeated stream in place (time stride 0), and
    # the windows' scores those of a batch of 64, where K1 runs one row a CTA
    big = np.resize(windows, (73_728,) + windows.shape[1:])
    big = big + np.random.RandomState(3).randn(*big.shape).astype(np.float32) * 0.01
    batch_eng = AnomalyStreamEngine(params, cfg, impl="fused_stack")
    def k1_counts_of_score(eng, big):
        """K1's launch counts in one batch score of ``big``, whose first
        and last 64 windows must score as in a batch of 64."""
        with block_plain():
            lstm_stack.launches = lstm_stack.repeated_input_launches = 0
            lstm_stack.trimmed_launches = 0
            lstm_stack.launches_by_path.clear()
            whole = eng.score(big)
            counts = {"B": len(big), "launches": lstm_stack.launches,
                      "launches_by_path": dict(lstm_stack.launches_by_path),
                      "repeated_input_launches": lstm_stack.repeated_input_launches,
                      "trimmed_launches": lstm_stack.trimmed_launches}
            for part in (slice(0, 64), slice(len(big) - 64, len(big))):
                np.testing.assert_array_equal(whole[part], eng.score(big[part]),
                                              err_msg=f"score at B={len(big)} vs B=64, {part}")
        return counts

    blocked_score = k1_counts_of_score(batch_eng, big)
    del big, batch_eng
    torch.cuda.empty_cache()
    if (blocked_score["launches"], blocked_score["launches_by_path"],
            blocked_score["repeated_input_launches"],
            blocked_score["trimmed_launches"]) != (2, {"blocked": 2}, 1, 2):
        raise AssertionError(f"phase 5: a batch score's K1 launches {blocked_score}")
    log(f"phase 5 batch score at B={blocked_score['B']} ok: K1 launches {blocked_score} "
        f"(both row-blocked at the layers' own widths, the decoder's on its repeated stream), "
        f"the first and last 64 windows bit-equal to a score of 64")
    # gw_small at its benchmark batch: both K1 launches one row a thread (W=9)
    small = GW_MODELS["gw_small"]
    big = np.resize(windows, (294_912,) + windows.shape[1:])
    big = big + np.random.RandomState(4).randn(*big.shape).astype(np.float32) * 0.01
    small_eng = AnomalyStreamEngine(init_autoencoder(small, seed=5, device=dev), small,
                                    impl="fused_stack")
    row_thread_score = k1_counts_of_score(small_eng, big)
    del big, small_eng
    torch.cuda.empty_cache()
    if (row_thread_score["launches"], row_thread_score["launches_by_path"],
            row_thread_score["repeated_input_launches"],
            row_thread_score["trimmed_launches"]) != (2, {"row_thread": 2}, 1, 0):
        raise AssertionError(f"phase 5: a gw_small batch score's K1 launches {row_thread_score}")
    log(f"phase 5 gw_small batch score at B={row_thread_score['B']} ok: K1 launches "
        f"{row_thread_score} (both one row a thread), the first and last 64 windows bit-equal "
        f"to a score of 64")

    # -- phase 6: K3 against its plain version -----------------------------
    # every warp-cell instantiation (H=8 and H=32 with x chains of 1, 8 and
    # 32; IN=5 pads to 8) and the run-time-width kernel (H=9, H=16, IN=40),
    # both entries, B 1, 3 and 64, block_b 1 and 2, fp32 and bf16 compute
    # (and bf16 weights under fp32 compute), T 1 and 25 on random operands;
    # then gw_nominal's four layers with their real weights over a T=100
    # window.  Bit for bit (torch.equal)
    from repro_torch.kernels.lstm_scan.lstm_scan import kernel_path

    t0, k3_err, n = time.perf_counter(), 0.0, 0
    lstm_scan.launches_by_path.clear()
    f32, bf16 = torch.float32, torch.bfloat16
    k3_acts = itertools.cycle((EXACT, HARD, PAPER_HW_KERNEL))

    def k3_case(x, w_x, b, w_h, h0, c0, acts, blocks, what):
        fns = dict(sigma=acts.sigma, tanh=acts.tanh)
        xw = ((x.float() @ w_x.float()) + b).transpose(0, 1).contiguous()
        want = lstm_scan_ref(xw, w_h, h0, c0, **fns)
        want_l = lstm_scan_layer_ref(x, w_x, b, w_h, h0, c0, **fns)
        err = 0.0
        for block_b in blocks:
            got = lstm_scan(xw, w_h, h0, c0, block_b=block_b, acts=acts)
            got_l = lstm_scan_layer(x, w_x, b, w_h, h0, c0, block_b=block_b, acts=acts)
            torch.cuda.synchronize()
            err = max(err, compare(got, want, f"K3 lstm_scan {what} block_b={block_b}"),
                      compare(got_l, want_l, f"K3 lstm_scan_layer {what} block_b={block_b}"))
        return err, 2 * len(blocks)

    k3_warp = [(h, i) for h in (8, 32) for i in (1, 5, 8, 32)]
    k3_shapes = k3_warp + [(9, 1), (16, 8), (8, 40)]
    for hidden, n_in in k3_shapes:
        for ct, wd in ((f32, f32), (f32, bf16), (bf16, bf16)):
            for t_len in (1, 25):
                for batch in (1, 3, 64):
                    w_x = (torch.randn(n_in, 4 * hidden, generator=gen) * n_in**-0.5).to(wd)
                    w_h = (torch.randn(hidden, 4 * hidden, generator=gen) * hidden**-0.5).to(wd)
                    b = torch.randn(4 * hidden, generator=gen) * 0.1
                    x = torch.randn(batch, t_len, n_in, generator=gen).to(ct)
                    h0 = (torch.randn(batch, hidden, generator=gen) * 0.3).to(ct)
                    c0 = torch.randn(batch, hidden, generator=gen) * 0.3
                    e, m = k3_case(*(v.to(dev) for v in (x, w_x, b, w_h, h0, c0)),
                                   next(k3_acts), (1, 2),
                                   f"{ct} w {wd} H={hidden} IN={n_in} T={t_len} B={batch}")
                    k3_err, n = max(k3_err, e), n + m
    for layer in (f"lstm_{i}" for i in range(4)):
        p = params[layer]
        hidden, n_in = p["w_h"].shape[0], p["w_x"].shape[0]
        for ct in (f32, bf16):
            x = torch.randn(1, T, n_in, generator=gen).to(ct).to(dev)
            h0 = (torch.randn(1, hidden, generator=gen) * 0.3).to(ct).to(dev)
            c0 = (torch.randn(1, hidden, generator=gen) * 0.3).to(dev)
            e, m = k3_case(x, p["w_x"].to(ct), p["b"], p["w_h"].to(ct), h0, c0, EXACT, (1,),
                           f"{layer} {ct} H={hidden} IN={n_in} T={T}")
            k3_err, n = max(k3_err, e), n + m
    paths = {(h, i): kernel_path(h, i) for h, i in k3_shapes + [(8, 0), (32, 0)]}
    if any(path != (f"warp_cell H={h}" if (h, i) in k3_warp else f"run_time H={h}")
           for (h, i), path in paths.items()):
        raise AssertionError(f"K3 took the wrong kernel: {paths}")
    log(f"phase 6 K3 ok: {n} cases (both entries, fp32 and bf16 compute, bf16 weights under "
        f"fp32 compute, B 1/3/64, block_b 1/2), bit-equal to the plain version; launches by "
        f"kernel {dict(lstm_scan.launches_by_path)} ({time.perf_counter() - t0:.1f} s)")

    # -- phases 7-8: the kernel backend and the StreamServer ---------------
    # the second serving path: counts set to 0 before it, read after it
    with np.load(SERVER_FIXTURE) as data:
        sgold = {k: data[k] for k in data.files}
    saved = (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, k3_mod.lstm_scan_ref,
             k3_mod.lstm_scan_layer_ref)
    k1_mod.lstm_stack_ref = k2_mod.lstm_stack_step_plain = refuse_plain
    k3_mod.lstm_scan_ref = k3_mod.lstm_scan_layer_ref = refuse_plain

    def counts():
        return {"lstm_stack_wavefront": lstm_stack.launches,
                "lstm_stack_step": lstm_stack_step.launches, "lstm_scan": lstm_scan.launches,
                "lstm_scan_by_kernel": dict(lstm_scan.launches_by_path)}

    def zero_counts():
        lstm_stack.launches = lstm_stack_step.launches = lstm_scan.launches = 0
        lstm_scan.launches_by_path.clear()

    def k3_warp_cells_ran(c):
        """gw_nominal's layers (H=32 and H=8) all run K3's warp-cell kernel."""
        by = c["lstm_scan_by_kernel"]
        return by.get("warp_cell H=32", 0) > 0 and by.get("warp_cell H=8", 0) > 0 \
            and sum(by.values()) == c["lstm_scan"]

    zero_counts()
    t0 = time.perf_counter()
    kb = AnomalyStreamEngine(params, cfg, impl="kernel")
    assert kb.effective_impl == "kernel", kb.effective_impl
    np.testing.assert_allclose(kb.score(windows), sgold["scores/kernel"], **TOL,
                               err_msg="kernel backend batch scores vs reference")
    lock = StreamingAnomalyEngine(params, cfg, batch=len(windows), impl="kernel")
    streamed = [s for pos in range(0, T, 25) for s in lock.push(windows[:, pos : pos + 25])]
    np.testing.assert_allclose(streamed[0], sgold["streamed/kernel"], **TOL,
                               err_msg="kernel backend streamed scores vs reference")
    keng = StreamingAnomalyEngine(params, cfg, batch=1, impl="kernel")
    one_shot = keng.score(windows[:1])
    for chunk in (25, 1):
        got = [s for pos in range(0, T, chunk) for s in keng.push(windows[:1, pos : pos + chunk])]
        assert len(got) == 1
        np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                                   err_msg=f"kernel backend, chunks of {chunk} vs one-shot")
    check_push_many(lambda: StreamingAnomalyEngine(params, cfg, batch=1, impl="kernel"),
                    windows, T)
    torch.cuda.synchronize()
    path_launches = {"kernel_engine": counts()}
    if not k3_warp_cells_ran(counts()) or lstm_stack.launches or lstm_stack_step.launches:
        raise AssertionError(f"the kernel backend's launches are wrong: {counts()}")
    log(f"phase 7 kernel backend ok: scores match the reference, chunked == one-shot, "
        f"push_many bit-equal, launches {counts()} ({time.perf_counter() - t0:.1f} s)")

    server_report = {}
    for impl in ("fused_step", "kernel"):
        t0 = time.perf_counter()
        zero_counts()
        server_report[impl] = server_phases(
            impl, lambda impl=impl: StreamingAnomalyEngine(params, cfg, batch=1, impl=impl),
            sgold, T)
        torch.cuda.synchronize()
        path_launches[f"server_{impl}"] = c = counts()
        ran = ((c["lstm_stack_wavefront"] and c["lstm_stack_step"] and not c["lstm_scan"])
               if impl == "fused_step" else
               (k3_warp_cells_ran(c) and not c["lstm_stack_wavefront"]
                and not c["lstm_stack_step"]))
        if not ran:
            raise AssertionError(f"the {impl} server's launches are wrong: {c}")
        th = server_report[impl]["threaded"]
        log(f"phase 8 server ok ({impl}): golden script equal to the reference, 32 "
            f"streams bit-equal to sequential replays, restart_from bit-equal, "
            f"{server_report[impl]['rejected']} NaN chunks rejected, threaded "
            f"{th['chunks_per_s']:.0f} chunks/s p50 {th['p50_us']:.0f} us p99 "
            f"{th['p99_us']:.0f} us max {th['max_us']:.0f} us, launches {c} "
            f"({time.perf_counter() - t0:.1f} s)")
    (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain, k3_mod.lstm_scan_ref,
     k3_mod.lstm_scan_layer_ref) = saved
    log(smi)
    log(json.dumps({"server": server_report}))
    k3_launches = sum(c["lstm_scan"] for c in path_launches.values())

    # K3 launches per scored window by streaming mode, and per score call
    for mode, chunk in (("push_T1", 1), ("push_T25", 25)):
        lstm_scan.launches = 0
        for pos in range(0, T, chunk):
            keng.push(windows[:1, pos : pos + chunk])
        per_window[mode] += (lstm_scan.launches,)  # index 3
    lstm_scan.launches = 0
    kb.score(windows)
    per_window[f"score_call_B{len(windows)}"] += (lstm_scan.launches,)

    # -- phase 9: timing ---------------------------------------------------
    t0 = time.perf_counter()
    enc = all_packs[("fp32", "fp32")]["enc"]
    s = enc.stacked
    L, W = enc.n_layers, enc.width_p
    lib_lstm = torch.nn.LSTM(W, W, num_layers=L).to(dev)
    with torch.no_grad():
        for l in range(L):
            getattr(lib_lstm, f"weight_ih_l{l}").copy_(s["w_x"][l].T)
            getattr(lib_lstm, f"weight_hh_l{l}").copy_(s["w_h"][l].T)
            getattr(lib_lstm, f"bias_ih_l{l}").copy_(s["b"][l])
            getattr(lib_lstm, f"bias_hh_l{l}").zero_()
    rows = {"lstm_stack_wavefront": [], "lstm_stack_step": []}
    # K1 at B 1 and 64 (one row a CTA) and at the benchmark's gw_nominal
    # batch, 73,728 (row-blocked)
    for name, t_len, batch in (("lstm_stack_wavefront", T, 1), ("lstm_stack_wavefront", T, 64),
                               ("lstm_stack_wavefront", T, 73_728),
                               ("lstm_stack_step", 1, 1), ("lstm_stack_step", 25, 1),
                               ("lstm_stack_step", 1, 64), ("lstm_stack_step", 25, 64)):
        xs = segment_input("enc", enc, batch, t_len)
        h0, c0 = state(enc, batch)
        if name == "lstm_stack_wavefront":
            xw0 = project_layer0(xs, s, "fp32")
            kernel = lambda: lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
            plain = lambda: lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
        else:
            kernel = lambda: lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
            plain = lambda: lstm_stack_step_plain(xs, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
        x_tb = xs.transpose(0, 1).contiguous()
        lib_call = lambda: lib_lstm(x_tb, (h0, c0))  # noqa: E731
        with torch.no_grad():
            ours = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0) if t_len <= 32 \
                else lstm_stack(project_layer0(xs, s, "fp32"), s["w_x"], s["w_h"], s["b"], h0, c0)
            lib_err = (lib_call()[1][1] - ours[2]).abs().max().item()
            lib_ms = median_ms(lib_call, reps=50)
            lib_dev = graph_ms(lib_call)
        b_ms, b_by = bound(name == "lstm_stack_step", L, W, t_len, B=batch)
        rows[name].append({
            "L": L, "W": W, "T": t_len, "B": batch, "ms": graph_ms(kernel),
            "call_ms": median_ms(kernel, reps=50), "plain_ms": median_ms(plain, reps=3, warmup=1),
            "library_ms": lib_dev,
            "library_call_ms": lib_ms, "library_max_abs_err_c": lib_err,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    del xs, xw0, x_tb, h0, c0, ours, kernel, plain, lib_call
    torch.cuda.empty_cache()
    # K1 at the nominal cell's batch from the zero state, both segments (the
    # decoder's on its repeated stream), at the layers' own widths (the
    # batch score's launch) and padded, timed in turns in this call; each
    # trimmed launch bit-equal to the padded one
    trim_rows = []
    for seg in ("enc", "dec"):
        pk = all_packs[("fp32", "fp32")][seg]
        ps, batch, widths = pk.stacked, 73_728, pk.widths
        xw0 = project_layer0(segment_input(seg, pk, batch, T), ps, "fp32")
        h0, c0 = pk.zero_state(batch)
        runs = {"padded": lambda: lstm_stack(xw0, ps["w_x"], ps["w_h"], ps["b"], h0, c0),
                "trimmed": lambda: lstm_stack(xw0, ps["w_x"], ps["w_h"], ps["b"], h0, c0,
                                              widths=widths)}
        lstm_stack.trimmed_launches = 0
        with torch.no_grad():
            compare(runs["trimmed"](), runs["padded"](), f"phase 9: K1 at B={batch}, {seg}, "
                    f"trimmed against padded")
        if lstm_stack.trimmed_launches != 1:
            raise AssertionError(f"phase 9: K1 at B={batch}, {seg}: the widths' launch was "
                                 f"not trimmed")
        ms = {name: [] for name in runs}
        for order in (("padded", "trimmed"), ("trimmed", "padded")):
            for name in order:
                ms[name].append(graph_ms(runs[name], n_calls=5))
                torch.cuda.empty_cache()
        trim_rows.append({"segment": seg, "L": pk.n_layers, "W": pk.width_p, "T": T, "B": batch,
                          "in_dims": list(pk.in_dims), "hidden": list(pk.hidden),
                          "padded_ms": statistics.median(ms["padded"]),
                          "trimmed_ms": statistics.median(ms["trimmed"]), "ms_runs": ms})
        del xw0, h0, c0, runs
        torch.cuda.empty_cache()
    rows["lstm_stack_wavefront_trimmed"] = trim_rows
    # K1 at the gw_small benchmark cell's shape (T=100, B=294,912, L=1, W=9,
    # fp32: one row a thread) against its plain version and cuDNN's LSTM on
    # the same weights
    sm_enc = small_packs("fp32")["enc"]
    ss = sm_enc.stacked
    sL, sW, batch = sm_enc.n_layers, sm_enc.width_p, 294_912
    small_lstm = torch.nn.LSTM(sW, sW, num_layers=sL).to(dev)
    with torch.no_grad():
        for l in range(sL):
            getattr(small_lstm, f"weight_ih_l{l}").copy_(ss["w_x"][l].T)
            getattr(small_lstm, f"weight_hh_l{l}").copy_(ss["w_h"][l].T)
            getattr(small_lstm, f"bias_ih_l{l}").copy_(ss["b"][l])
            getattr(small_lstm, f"bias_hh_l{l}").zero_()
    xs = segment_input("enc", sm_enc, batch, T)
    h0, c0 = state(sm_enc, batch)
    xw0 = project_layer0(xs, ss, "fp32")
    kernel = lambda: lstm_stack(xw0, ss["w_x"], ss["w_h"], ss["b"], h0, c0)  # noqa: E731
    plain = lambda: lstm_stack_ref(xw0, ss["w_x"], ss["w_h"], ss["b"], h0, c0)  # noqa: E731
    x_tb = xs.transpose(0, 1).contiguous()
    lib_call = lambda: small_lstm(x_tb, (h0, c0))  # noqa: E731
    lstm_stack.launches_by_path.clear()
    with torch.no_grad():
        ours = kernel()
        if lstm_stack.launches_by_path != {"row_thread": 1}:
            raise AssertionError(f"phase 9: K1 at B={batch}, W={sW} did not run one row a thread")
        compare(ours, plain(), f"phase 9: K1 at B={batch}, W={sW}")
        lib_err = (lib_call()[1][1] - ours[2]).abs().max().item()
        lib_ms = median_ms(lib_call, reps=10)
        lib_dev = graph_ms(lib_call, n_calls=5)
    b_ms, b_by = bound(False, sL, sW, T, B=batch)
    small_row = {
        "L": sL, "W": sW, "T": T, "B": batch, "ms": graph_ms(kernel, n_calls=5),
        "call_ms": median_ms(kernel, reps=20), "plain_ms": median_ms(plain, reps=3, warmup=1),
        "library_ms": lib_dev, "library_call_ms": lib_ms, "library_max_abs_err_c": lib_err,
        "bound_ms": b_ms, "bound_by": b_by, "path": "row_thread",
        "rows_a_cta": k1_mod.ROW_THREAD_ROWS,
    }
    rows["lstm_stack_wavefront"].append(small_row)
    # the last K1 rows' operands (B=73,728: a 3.8 GB stream; B=294,912: 4.2
    # GB) go before the LM phases, whose largest model fills the card
    del xs, xw0, x_tb, h0, c0, ours, kernel, plain, lib_call, small_lstm
    torch.cuda.empty_cache()
    # K3 at gw_nominal's four layer shapes on the kernel path (H=32 IN=1,
    # H=8 IN=32, H=8 IN=8, H=32 IN=8), over a T=100 window and at T=1 (a
    # pushed sample), B=1, through lstm_scan_layer, the kernel backend's
    # entry; then B=64 at the first layer, and the xw entry.  The yardstick
    # is cuDNN's one-layer LSTM on the same weights, which computes the same
    # function (input product and recurrence); the xw entry's, nn.LSTM(H, H,
    # 1), also computes an input product, which lstm_scan is given.  Device
    # time sums every kernel one call launches
    rows["lstm_scan"] = []
    k3_cases = [(f"lstm_{i}", t_len, 1, "lstm_scan_layer") for i in range(4) for t_len in (T, 1)]
    k3_cases += [("lstm_0", T, 64, "lstm_scan_layer"), ("lstm_0", T, 1, "lstm_scan")]
    for layer, t_len, batch, entry in k3_cases:
        p = params[layer]
        H, n_in = p["w_h"].shape[0], p["w_x"].shape[0]
        layer_entry = entry == "lstm_scan_layer"
        lib = torch.nn.LSTM(n_in if layer_entry else H, H, num_layers=1).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(p["w_x"].T if layer_entry
                                   else torch.randn(4 * H, H, generator=gen) * 0.1)
            lib.weight_hh_l0.copy_(p["w_h"].T)
            lib.bias_ih_l0.copy_(p["b"])
            lib.bias_hh_l0.zero_()
        x = torch.randn(batch, t_len, n_in, generator=gen).to(dev)
        xw = ((x @ p["w_x"]) + p["b"]).transpose(0, 1).contiguous()
        h0 = (torch.randn(batch, H, generator=gen) * 0.3).to(dev)
        c0 = (torch.randn(batch, H, generator=gen) * 0.3).to(dev)
        if layer_entry:
            args = (x, p["w_x"], p["b"], p["w_h"], h0, c0)
            kernel = lambda: lstm_scan_layer(*args)  # noqa: E731
            plain = lambda: lstm_scan_layer_ref(*args)  # noqa: E731
            x_lib = x.transpose(0, 1).contiguous()
        else:
            kernel = lambda: lstm_scan(xw, p["w_h"], h0, c0)  # noqa: E731
            plain = lambda: lstm_scan_ref(xw, p["w_h"], h0, c0)  # noqa: E731
            x_lib = torch.randn(t_len, batch, H, generator=gen).to(dev)
        lib_call = lambda: lib(x_lib, (h0[None], c0[None]))  # noqa: E731
        with torch.no_grad():
            lib_ms = median_ms(lib_call, reps=50)
            lib_dev = graph_ms(lib_call)
        call_ms = median_ms(kernel, reps=50)
        ms = graph_ms(kernel)
        b_ms, b_by = scan_bound(H, t_len, batch, n_in if layer_entry else 0)
        rows["lstm_scan"].append({
            "entry": entry, "H": H, "IN": n_in, "T": t_len, "B": batch,
            "kernel_path": kernel_path(H, n_in if layer_entry else 0),
            "ms": ms, "call_ms": call_ms, "plain_ms": median_ms(plain, reps=3, warmup=1),
            "library_ms": lib_dev,
            "library_call_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        })
    # end to end, host clock: one T=1 push (a window completion every T
    # pushes runs the decoder), and one batch score call
    push_ms = []
    for pos in range(2 * T):
        t1 = time.perf_counter()
        eng.push(windows[:1, pos % T : pos % T + 1])
        torch.cuda.synchronize()
        push_ms.append((time.perf_counter() - t1) * 1e3)
    batch_eng = AnomalyStreamEngine(params, cfg, impl="fused_stack")
    score_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        batch_eng.score(windows)
        score_ms.append((time.perf_counter() - t1) * 1e3)
    where = ("shared memory, run-time W", "registers")[
        library().lib.lstm_stack_weights_in_registers(L, W)]
    for name in ("lstm_stack_wavefront", "lstm_stack_step"):
        # a launch runs T + L - 1 wavefront steps
        log(f"phase 9 {name} (L={L}, W={W}, {library().lib.lstm_stack_threads(L, W)} threads, "
            f"weights in {where}): "
            + ", ".join(f"T={r['T']} B={r['B']} {r['ms']:.4g} ms = "
                        f"{r['ms'] / (r['T'] + L - 1) * 1e3:.3g} us x {r['T'] + L - 1} steps "
                        f"(cuDNN {r['library_ms']:.4g} ms)"
                        for r in rows[name] if r["W"] == W))
    for r in rows["lstm_stack_wavefront_trimmed"]:
        log(f"phase 9 lstm_stack_wavefront {r['segment']} (L={r['L']}, W={r['W']}, widths "
            f"{r['in_dims']} -> {r['hidden']}, row-blocked): T={r['T']} B={r['B']} at the "
            f"layers' own widths {r['trimmed_ms']:.4g} ms, padded {r['padded_ms']:.4g} ms")
    r = small_row
    log(f"phase 9 lstm_stack_wavefront (L={r['L']}, W={r['W']}, one row a thread, "
        f"{r['rows_a_cta']} a CTA): T={r['T']} B={r['B']} {r['ms']:.4g} ms (call "
        f"{r['call_ms']:.4g} ms, plain {r['plain_ms']:.4g} ms, cuDNN {r['library_ms']:.4g} ms, "
        f"bound {r['bound_ms']:.4g} ms by {r['bound_by']})")
    for r in rows["lstm_scan"]:
        log(f"phase 9 lstm_scan {r['entry']} H={r['H']} IN={r['IN']} T={r['T']} B={r['B']} "
            f"({r['kernel_path']}): {r['ms']:.4g} ms = {r['ms'] * 1e3 / r['T']:.3g} us x {r['T']} "
            f"steps (cuDNN {r['library_ms']:.4g} ms, call {r['call_ms']:.4g} ms)")
    log(json.dumps({"e2e": {
        "push_T1_B1_ms_median": statistics.median(push_ms),
        "push_T1_B1_ms_p99": float(np.percentile(push_ms, 99)),
        f"score_B{len(windows)}_T{T}_ms_median": statistics.median(score_ms[2:]),
    }}))
    log(f"phase 9 timing ok ({time.perf_counter() - t0:.1f} s)")

    rw_entry, gw_graphs = gw_graph_phases(params, cfg, windows, T, dev, smi,  # phases 15-18
                                          all_packs, state, compare)
    rw_entry["launches"] = launches["rowwise_matmul"]
    rw_entry["launches_per_window"] = {m: v[2] for m, v in per_window.items()}
    if not rw_entry["launches"]:
        raise AssertionError("the serving path never launched rowwise_matmul")

    # phases 20-22: the mixed path (counts set to 0 before it, read after it)
    mixed_launches, mixed_per_window, mixed_report = gw_mixed_phases(dev, smi, compare,
                                                                     block_plain)
    log(json.dumps({"mixed": mixed_report}))
    rw_entry["launches_by_path"] = {"gw": launches["rowwise_matmul"],
                                    "gw_mixed": mixed_launches["rowwise_matmul"]}
    rw_entry["launches_per_window"].update(
        {m: c["rowwise_matmul"] for m, c in mixed_per_window.items()})

    # phases 23-25: GW training (counts set to 0 before the training run and
    # the evaluation, read after each)
    train_launches, train_report = gw_train_phases(dev, smi, block_plain)
    log(smi)
    log(json.dumps({"train": train_report}))
    rw_entry["launches_by_path"].update({"gw_train": train_launches["train"]["rowwise_matmul"],
                                         "gw_train_eval":
                                             train_launches["train_eval"]["rowwise_matmul"]})
    rw_entry["launches_per_window"]["train_step"] = \
        train_report["step_timing"]["gw_small"]["rowwise_launches_per_step"]

    # phases 26-28: sharded placement (counts set to 0 before its main run,
    # read after it)
    sharded_launches, sharded_report = gw_sharded_phases(params, cfg, golden, dev, smi,
                                                         compare, block_plain)
    log(json.dumps({"sharded": sharded_report}))
    rw_entry["launches_by_path"]["gw_sharded"] = sharded_launches["rowwise_matmul"]

    lm_kernels, lm_graphs = lm_phases(dev, smi)  # phases 10-14, 19
    # phases 29-31: LM training (K4 and K5 counts set to 0 before each run,
    # read after it: none launches)
    lm_train_launches, lm_train_report = lm_train_phases(dev, smi)
    log(json.dumps({"lm_train": lm_train_report}))
    # phases 32-34: the mesh and the dry run (K4 and K5 counts set to 0
    # before phases 32-33, read after them: none launches)
    dry_launches, dry_report = dryrun_phases(dev, smi)
    log(json.dumps({"dryrun": dry_report}))
    for entry in lm_kernels:
        entry["launches_by_path"]["lm_train"] = lm_train_launches[entry["name"]]
        entry["launches_by_path"]["dryrun"] = dry_launches[entry["name"]]
    log(smi)
    log(json.dumps({"graphs": {"gw": gw_graphs, "lm": lm_graphs,
                               "server_replay_threaded": server_report["fused_step"]["threaded"]}}))

    kernels = []
    for name, err, replaces, mode in (
        ("lstm_stack_wavefront", k1_err, "src/repro/kernels/lstm_stack/lstm_stack.py:165",
         "push_T1"),
        ("lstm_stack_step", k2_err, "src/repro/kernels/lstm_stack/step.py:210", "push_T1"),
    ):
        head = rows[name][0]  # the B=1 streaming shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/lstm_stack/csrc/lstm_stack.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            **({"launches_per_score": {"gw_nominal": blocked_score,
                                       "gw_small": row_thread_score},
                "shapes_at_real_widths": rows["lstm_stack_wavefront_trimmed"]}
               if name == "lstm_stack_wavefront" else {}),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "launches_per_window": {
                **{m: v[0 if name == "lstm_stack_wavefront" else 1] for m, v in per_window.items()},
                **{m: c[name] for m, c in mixed_per_window.items()},
                **{m: c[name] for m, c in sharded_report["launches_per_window"].items()}},
            "launches_by_path": {"gw": launches[name], "gw_mixed": mixed_launches[name],
                                 **({"gw_train_eval": train_launches["train_eval"][name]}
                                    if name in train_launches["train_eval"] else {}),
                                 "gw_sharded": sharded_launches[name]},
            "shapes": rows[name],
        })
    head = rows["lstm_scan"][0]  # the kernel backend's entry, H=32, T=100, B=1
    kernels.append({
        "name": "lstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_scan/csrc/lstm_scan.cu",
        "replaces": "src/repro/kernels/lstm_scan/lstm_scan.py:91",
        "launches": k3_launches, "max_abs_err": k3_err,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "launches_per_window": {m: v[3] for m, v in per_window.items()},
        "launches_by_kernel": {path: dict(c["lstm_scan_by_kernel"])
                               for path, c in path_launches.items()},
        "shapes": rows["lstm_scan"],
    })
    kernels += lm_kernels
    kernels.append(rw_entry)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
