"""The one runner: a cell of ``BENCHMARK.json`` from its seed to its
result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives:

    configs/<config>.json     the model's sizes and the reference it follows
    references/<family>.py    that reference, plain PyTorch
    traffic/<mix>.json        the mix's parameters, and the driver that runs it
    drivers/<driver>.py       how set-up builds the entry and a timed call drives it
    limits/<cell>.json        the limits ``correct`` is held to, with their readings
    metrics/<metric>.py       a reader: ``read(ctx) -> float | None``

A driver module holds ``Cell(config, traffic, seed, device)`` with
``setup()``, ``call(i) -> (work, failed work)``, ``release()`` and
``check(limits) -> {name: {"value", "limit"}}`` (``control`` too, for
``calibrate.py``); its ``keep_answers`` is cleared
before the traced calls, whose answers are not compared.

A run: the driver's set-up (inputs and weights from the seed, the
program built and warmed on the cell's own shapes), the timed window with
tracing off, with ``--trace 1`` a short device trace of further calls,
the peak memory, the program freed, the comparison with the reference,
the metrics read, and the result line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
MANIFEST = REPO / "BENCHMARK.json"

#: top-level module names no run may load (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``gwbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(
        f"gwbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def reported(metrics: list, workload: str, also: set | None = None) -> list:
    """The entries of ``metrics`` a cell reports: those that list it, and
    those with no list whose ``moves`` metric the cell reports (``also``)."""
    out = []
    for m in metrics:
        cells = m.get("workloads")
        if cells is not None:
            if workload in cells:
                out.append(m)
        elif also is None or m.get("moves") in also:
            out.append(m)
    return out


@dataclass
class CellSpec:
    """One workload with everything the files say about it."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def cell_spec(workload: str, manifest: dict | None = None,
              overrides: dict | None = None) -> CellSpec:
    manifest = load_manifest() if manifest is None else manifest
    entries = {w["name"]: w for w in manifest["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(entries)}")
    entry = entries[workload]
    config_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    with open(REPO / config_entry["file"]) as f:
        config = json.load(f)
    traffic = load_json("traffic", entry["traffic"])
    traffic.update(overrides or {})
    e2e = reported(manifest["end_to_end"], workload)
    per_layer = reported(manifest["per_layer"], workload, {m["name"] for m in e2e})
    return CellSpec(workload, config, traffic, load_json("limits", workload)["limits"],
                    e2e, per_layer, entry["chips"])


@dataclass
class Window:
    """The timed window: its length, calls and work units (windows), and
    the work of calls that failed."""

    elapsed_s: float
    calls: int
    work: int
    failed: int


@dataclass
class Reading:
    """What a metric reader reads."""

    workload: str
    config: dict
    traffic: dict
    setup_s: float
    window: Window
    trace: Any = None    # tracing.Trace of the traced calls, or None


def read_metrics(entries: list, ctx: Reading) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every
    module loaded), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", manifest: dict | None = None,
             overrides: dict | None = None, err=sys.stderr) -> dict:
    """Run one cell and return its result object (the last line's)."""
    import torch

    spec = cell_spec(workload, manifest, overrides)
    driver = load_module("drivers", spec.traffic["driver"])
    cuda = device == "cuda"
    cell = driver.Cell(spec.config, spec.traffic, seed, device)
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls = work = failed = 0
    while True:
        done, lost = cell.call(calls)
        calls, work, failed = calls + 1, work + done, failed + lost
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
    window = Window(now - t0, calls, work, failed)

    traced, gaps = None, []
    if trace:
        from gwbench import tracing

        cell.keep_answers = False
        n = spec.traffic["trace_calls"]
        traced = tracing.device_trace(cell.call, calls, n) if cuda else None
        gaps = tracing.host_gaps(cell.call, calls + n, spec.traffic["gap_calls"]) if cuda else []
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    checks = cell.check(spec.limits)

    ctx = Reading(workload, spec.config, spec.traffic, setup_s, window, traced)
    metrics = read_metrics(spec.per_layer if trace else spec.end_to_end, ctx)
    correct = window.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": spec.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {"correct": correct, "attempted": window.work, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": gaps}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    return result
