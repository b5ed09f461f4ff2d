"""Measured knob sweeps: time the grid, keep the receipts.

``space.knob_space`` proposes every legal knob assignment for a case; this
module times each one min-of-k through the call surface serving uses and
emits plain-dict records that round-trip through JSONL:

* on the card, the executor's replayed step graph (``step_graph``) for the
  chunked-step backends (``fused_step``, ``mixed``; a chunk longer than
  the plan's ``chunk_len`` runs the eager step, as the engines run it) and
  the forward for ``fused_stack``, ``reps`` calls between two
  ``torch.cuda.synchronize()``, the build and the capture's warm-up
  excluded;
* on the CPU, the eager step or forward (the kernels' plain versions) on
  the host clock, so the tests can run a sweep.

Invariants the rest of the subsystem leans on: every sweep contains the
all-default point first, so ``best_record(records)["us"] <=
default_record(records)["us"]``; records carry the full case identity
(dims, impl, weight dtype, batch, T), so ``model.attach_costs`` and
``cache.put`` work from a record alone; timing is min-of-k, because
scheduling noise is one-sided.  Inputs come from a ``torch.Generator``
seeded from ``seed``.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.executor import plan_stack
from repro_torch.core.lstm import LstmConfig, init_lstm
from repro_torch.device import resolve_device

from .space import KnobPoint, knob_space


@dataclass(frozen=True)
class SweepCase:
    """One (geometry, backend, dtype, batch, chunk length) sweep target."""

    dims: tuple[tuple[int, int], ...]
    impl: str = "fused_step"
    batch: int = 8
    t_len: int = 8
    weight_dtype: str | None = None
    tag: str = ""

    def cfgs(self) -> list[LstmConfig]:
        return [LstmConfig(in_dim=a, hidden=b) for a, b in self.dims]


def sweep_case(dims: Sequence[Sequence[int]], impl: str = "fused_step", *,
               batch: int = 8, t_len: int = 8, weight_dtype: str | None = None,
               tag: str | None = None) -> SweepCase:
    """Build a ``SweepCase`` with a canonical tag."""
    dims_t = tuple((int(a), int(b)) for a, b in dims)
    if tag is None:
        geo = "-".join(str(b) for _, b in dims_t)
        wd = f"_{weight_dtype}" if weight_dtype else ""
        tag = f"{impl}_{geo}{wd}_b{batch}_t{t_len}"
    return SweepCase(dims=dims_t, impl=impl, batch=batch, t_len=t_len,
                     weight_dtype=weight_dtype, tag=tag)


def _case_inputs(case: SweepCase, device: torch.device, seed: int = 0):
    """(cfgs, params, xs) for a case, deterministic per (case, seed)."""
    cfgs = case.cfgs()
    gen = torch.Generator().manual_seed(seed)
    params = [init_lstm(c, gen, device) for c in cfgs]
    xs = torch.randn(case.batch, case.t_len, case.dims[0][0], generator=gen)
    return cfgs, params, xs.to(device)


def _timed_callable(ex, xs: torch.Tensor) -> Callable[[], Any]:
    """The serving-shaped call to time (see the module docstring)."""
    plan = ex.plan
    if not plan.backend.chunked_step:
        return lambda: ex(xs, return_state=False)
    if xs.device.type == "cuda" and xs.shape[1] <= plan.chunk_len:
        graph = ex.step_graph(xs.shape[0])
        return lambda: graph(xs, graph.state)
    state = ex.zero_state(xs.shape[0])
    return lambda: ex.step(xs, state)


def _min_of_k_us(run: Callable[[], Any], k: int, reps: int, device: torch.device) -> float:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        for _ in range(2):  # build, capture (a graph's first call) and first touch
            run()
        sync()
        best = math.inf
        for _ in range(max(1, k)):
            t0 = time.perf_counter()
            for _ in range(max(1, reps)):
                run()
            sync()
            best = min(best, (time.perf_counter() - t0) / max(1, reps))
    return best * 1e6


def measure_point(case: SweepCase, point: KnobPoint, *, k: int = 3, reps: int = 3,
                  seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Time one knob assignment; returns the JSONL-ready record."""
    dev = resolve_device(device)
    cfgs, params, xs = _case_inputs(case, dev, seed)
    ex = plan_stack(cfgs, impl=case.impl, weight_dtype=case.weight_dtype,
                    **point.overrides()).bind(params)
    return {
        "case": case.tag,
        "dims": [list(d) for d in case.dims],
        "impl": case.impl,
        "weight_dtype": case.weight_dtype,
        "batch": case.batch,
        "t_len": case.t_len,
        "knobs": point.overrides(),
        "point": point.describe(),
        "us": _min_of_k_us(_timed_callable(ex, xs), k, reps, dev),
        "k": k,
        "reps": reps,
        "device": dev.type,
    }


def run_sweep(case: SweepCase, *, k: int = 3, reps: int = 3, max_points: int | None = None,
              seed: int = 0, device: str | torch.device = "cuda",
              progress: Callable[[dict], None] | None = None) -> list[dict]:
    """Measure every (thinned) legal knob point of a case, in grid order:
    the default point is always ``records[0]``.  ``progress`` sees each
    record as it lands."""
    get_backend(case.impl)  # an unknown impl fails before any timing
    points = knob_space(case.cfgs(), case.impl, weight_dtype=case.weight_dtype,
                        batch=case.batch, t_len=case.t_len, max_points=max_points)
    records = []
    for point in points:
        rec = measure_point(case, point, k=k, reps=reps, seed=seed, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    return records


# ---------------------------------------------------------------------------
# record selection + JSONL round-trip
# ---------------------------------------------------------------------------

def default_record(records: Sequence[dict]) -> dict:
    """The all-default-knobs record: the baseline every ratio divides by."""
    for rec in records:
        if not rec.get("knobs"):
            return rec
    raise ValueError(
        "sweep records contain no default (all-None knobs) point; the space "
        "generator always emits it first: were the records filtered?"
    )


def best_record(records: Sequence[dict]) -> dict:
    """The fastest record; ties break toward the default point."""
    if not records:
        raise ValueError("no sweep records")
    return min(records, key=lambda r: (r["us"], bool(r.get("knobs"))))


def write_jsonl(records: Sequence[dict], path: str) -> str:
    """One JSON object per line; parent directories created."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def smoke_cases() -> tuple[SweepCase, ...]:
    """The standard small sweep grid of ``launch/tune.py --smoke`` (the
    reference's): GW-small-shaped and 32-wide stacks, chunked-step and
    whole-wavefront backends, one int8-storage case, and the mixed backend
    on the GW nominal autoencoder's geometry.  Every knob axis appears."""
    return (
        sweep_case([(1, 9), (9, 9)], "fused_step", batch=8, t_len=8),
        sweep_case([(1, 9), (9, 9)], "fused_stack", batch=8, t_len=50),
        sweep_case([(1, 32), (32, 32)], "fused_step", batch=8, t_len=8, weight_dtype="int8"),
        sweep_case([(1, 32), (32, 32)], "fused_stack", batch=8, t_len=50),
        sweep_case([(1, 32), (32, 8), (8, 8), (8, 32)], "mixed", batch=8, t_len=8),
    )


def case_from_record(rec: dict) -> SweepCase:
    """Rebuild the case identity a record was measured under."""
    return sweep_case(rec["dims"], rec["impl"], batch=rec["batch"], t_len=rec["t_len"],
                      weight_dtype=rec.get("weight_dtype"), tag=rec.get("case") or None)
