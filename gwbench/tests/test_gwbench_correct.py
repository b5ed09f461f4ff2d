"""``correct`` on the CPU at a size a test run can hold: a sound run passes,
the control (the reference one precision down, TF32, in the program's
place) fails its cell's limits, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have.
The chip's look is skipped: the program runs its plain versions."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from gwbench import harness

MANIFEST = harness.load_manifest()
SCORE_CELLS = [w["name"] for w in MANIFEST["workloads"] if "score" in w["traffic"]]
#: a test-sized score mix: few windows a call, every call's answers kept
SMALL_SCORE = {"batch": 32, "pool_calls": 2, "keep_stride": 1, "warmup_calls": 2}


def run(workload, overrides, seed=2 ** 31 + 11):
    return harness.run_cell(workload, seed, 0.3, False, t_start=time.perf_counter(),
                            device="cpu", overrides=overrides)


@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_a_sound_run_is_correct(workload):
    result = run(workload, SMALL_SCORE)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= SMALL_SCORE["batch"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_the_control_fails_the_limits(workload):
    spec = harness.cell_spec(workload, overrides=SMALL_SCORE)
    cell = harness.load_module("drivers", "score").Cell(spec.config, spec.traffic, 5, "cpu")
    cell.setup()
    cell.release()
    got = cell.control(spec.limits)["score_rel_err"]
    assert got["value"] > got["limit"], got


@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_the_kept_calls_cover_every_pool_batch(workload):
    """Every pool batch the window scores is among the answers compared."""
    spec = harness.cell_spec(workload)
    traffic = spec.traffic
    cell = harness.load_module("drivers", "score").Cell(spec.config, traffic, 2 ** 31 + 5, "cpu")
    kept = {i % traffic["pool_calls"] for i in range(traffic["keep_stride"] * traffic["pool_calls"])
            if i % cell.stride == cell.offset}
    assert kept == set(range(traffic["pool_calls"]))


def test_a_stride_that_skips_pool_batches_is_refused():
    spec = harness.cell_spec(SCORE_CELLS[0], overrides={"pool_calls": 4, "keep_stride": 8})
    with pytest.raises(ValueError, match="skip pool batches"):
        harness.load_module("drivers", "score").Cell(spec.config, spec.traffic, 1, "cpu")


def _altered(score):
    def wrapped(self, windows):
        out = score(self, windows).copy()
        out[len(out) // 2] = out[0]      # one window answered with another's score
        return out
    return wrapped


def _half(score):
    def wrapped(self, windows):
        return score(self, windows[: len(windows) // 2])
    return wrapped


def _stale(score):
    def wrapped(self, windows):
        out = score(self, windows)
        prev, self._last = getattr(self, "_last", out), out
        return prev                      # the previous call's answers
    return wrapped


@pytest.mark.parametrize("fault", [_altered, _half, _stale], ids=["altered", "half", "stale"])
@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.serve.engine import AnomalyStreamEngine

    monkeypatch.setattr(AnomalyStreamEngine, "score", fault(AnomalyStreamEngine.score))
    result = run(workload, SMALL_SCORE)
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_on_the_card_at_the_cells_size(workload):
    """The program passes and the control fails, at the timed size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.cell_spec(workload)
    cell = harness.load_module("drivers", "score").Cell(spec.config, spec.traffic, 7, "cuda")
    cell.setup()
    for i in range(2 * spec.traffic["keep_stride"] * spec.traffic["pool_calls"]):
        cell.call(i)
    cell.release()
    checks = cell.check(spec.limits)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    control = cell.control(spec.limits)
    assert control["score_rel_err"]["value"] > spec.limits["score_rel_err"]
    assert np.isfinite(control["score_rel_err"]["value"])
