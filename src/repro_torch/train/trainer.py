"""Training loop with checkpoint/restart, a straggler monitor and prefetch.

As the reference's ``repro.train.trainer``:

* Restart first: the loop is a function of (checkpoint, data, step), so a
  preemption or crash is recovered by restoring the latest checkpoint and
  running on; ``run`` does that whenever the directory holds one.
* A step whose wall time exceeds ``deadline_factor`` x the running median
  is recorded as a straggler event.
* Batches are prefetched on a host thread (depth ``prefetch``).
* A non-finite loss raises ``FloatingPointError``.
* Every ``checkpoint_every`` steps the state is saved on a background
  thread, and once more at the end.

On the card the whole step (forward, backward, clip and AdamW) is captured
once as a CUDA graph and replayed (``core.graphs.CapturedStep``), the
counterpart of the reference's ``jax.jit(..., donate_argnums=(0, 1))``:
parameters and optimizer state live in static tensors that each replay
updates in place, a checkpoint is restored into them before the capture,
and each batch is copied into a static input.  On the CPU, or with
``graphs=False``, the step runs eagerly.  ``run`` copies the parameters
``init_params_fn`` returns, so the caller's tensors are never written;
after it, ``Trainer.params`` and ``Trainer.opt_state`` hold the trained
state.
"""

from __future__ import annotations

import collections
import math
import queue
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map


@dataclass
class TrainerConfig:
    total_steps: int = 300
    log_every: int = 50
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    microbatches: int = 1
    deadline_factor: float = 5.0   # straggler threshold vs running median
    prefetch: int = 2
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Prefetcher:
    """Depth-k host-side prefetch on a daemon thread; an exception of the
    source iterator is raised by ``__next__``."""

    def __init__(self, it: Iterator, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: BaseException | None = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as exc:  # handed to the consumer
                self._error = exc
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


@dataclass
class TrainResult:
    step: int
    losses: list[float]
    straggler_events: list[tuple[int, float]]
    resumed_from: int | None


class Trainer:
    """``loss_fn(params, batch) -> 0-d tensor``; ``init_params_fn(generator)
    -> params`` (a nested dict of tensors on any device; the trainer moves
    them to ``device``); ``data_iter`` yields batches (tensors or arrays, or
    dicts of them)."""

    def __init__(self, loss_fn: Callable, init_params_fn: Callable, data_iter: Iterator,
                 cfg: TrainerConfig, ckpt_dir: str, *, device: str | torch.device = "cuda",
                 graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.data = Prefetcher(data_iter, cfg.prefetch)
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.step_fn = make_train_step(loss_fn, cfg.opt, microbatches=cfg.microbatches)
        self.params: Any = None
        self.opt_state: Any = None

    def run(self, generator: torch.Generator) -> TrainResult:
        cfg = self.cfg
        # a copy: the caller's tensors are never the ones the steps write
        params = tree_map(lambda p: p.detach().to(self.device, copy=True),
                          self.init_params_fn(generator))
        opt_state = init_opt_state(params, cfg.opt)
        start_step, resumed_from = 0, None

        latest = self.ckpt.latest()
        if latest is not None:  # crash/preemption restart path
            state = self.ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = self.ckpt.manifest()["step"]
            resumed_from = start_step

        state = {"params": params, "opt": opt_state}
        if self.graphs:
            from repro_torch.core.graphs import CapturedStep

            def step_fn(st, batch):
                loss, p, o = self.step_fn(st["params"], st["opt"], batch)
                return loss, {"params": p, "opt": o}

            captured = CapturedStep(step_fn, state, self.device)

        losses: list[float] = []
        stragglers: list[tuple[int, float]] = []
        durations: collections.deque = collections.deque(maxlen=50)

        step = start_step
        for step in range(start_step, cfg.total_steps):
            batch = next(self.data)
            t0 = time.time()
            if self.graphs:
                loss = float(captured(batch))  # read after the replay, on its stream
            else:
                batch = tree_map(lambda x: torch.as_tensor(x, device=self.device), batch)
                loss, p, o = self.step_fn(state["params"], state["opt"], batch)
                state = {"params": p, "opt": o}
                loss = float(loss)
            dt = time.time() - t0
            # --- straggler monitor -------------------------------------
            if len(durations) >= 10:
                med = statistics.median(durations)
                if dt > cfg.deadline_factor * med:
                    stragglers.append((step, dt))
            durations.append(dt)
            losses.append(loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}: {loss}")
            if (step + 1) % cfg.checkpoint_every == 0:
                self.ckpt.save_async(step + 1, state, metrics={"loss": loss})
        self.ckpt.wait()
        final_step = step + 1 if cfg.total_steps > start_step else start_step
        self.ckpt.save(final_step, state,
                       metrics={"loss": losses[-1] if losses else float("nan")})
        self.params, self.opt_state = state["params"], state["opt"]
        return TrainResult(step=final_step, losses=losses,
                           straggler_events=stragglers, resumed_from=resumed_from)
