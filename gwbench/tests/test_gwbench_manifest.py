"""``BENCHMARK.json`` against the benchmark's contract, and the files each
of its names points to; a dummy cell and metric added as new files only."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = REPO / "gwbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def cells_of(metric: dict) -> list:
    return metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    command = MANIFEST["command"]
    assert 1 <= len(command) <= 32 and all(one_line(w) for w in command)
    for word in command[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
            assert (REPO / word).is_file()
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    run_s = MANIFEST["run_seconds"]
    assert isinstance(run_s, int) and 1 <= run_s <= 51
    cells = 24
    assert (2 + 14 * cells) * (run_s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    setup = {m["name"]: m for m in MANIFEST["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25


def test_workload_counts_and_chips():
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["configs"]) <= 24
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_are_files_of_their_own_and_used():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        config = json.loads((REPO / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert (BENCH / "references" / f"{config['reference']}.py").is_file()


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_what_it_must(workload):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if workload in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MANIFEST["per_layer"] if workload in cells_of(m)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    entry = {w["name"]: w for w in MANIFEST["workloads"]}[workload]
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())["limits"]
    assert limits and all(math.isfinite(v) and v >= 0 for v in limits.values())


def test_every_metric_has_a_reader_and_known_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
    # one layer, one spelling
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert {layer.lower() for layer in layers} == layers


DUMMY_METRIC = '''"""A dummy per-layer metric: the calls of the timed window."""


def read(ctx):
    return float(ctx.window.calls)
'''


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a traffic mix, its limits, a metric reader and
    their entries (no file of the copy edited), and run the new cell on the
    CPU at a tiny size: the harness finds them by name."""
    shutil.copytree(BENCH, tmp_path / "gwbench", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "gw_small.dummy", "config": "gw_small",
                                  "traffic": "dummy", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "score_windows_per_s":
            m["workloads"].append("gw_small.dummy")
    manifest["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "whole step",
                                  "moves": "score_windows_per_s",
                                  "workloads": ["gw_small.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    small = next(w for w in MANIFEST["workloads"] if w["config"] == "gw_small")
    traffic = json.loads((BENCH / "traffic" / f"{small['traffic']}.json").read_text())
    traffic.update(batch=4, pool_calls=2, keep_stride=1, warmup_calls=1)
    (tmp_path / "gwbench" / "traffic" / "dummy.json").write_text(json.dumps(traffic))
    (tmp_path / "gwbench" / "limits" / "gw_small.dummy.json").write_text(
        (BENCH / "limits" / f"{small['name']}.json").read_text())
    (tmp_path / "gwbench" / "metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    script = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO / 'src')!r}]\n"
        "from gwbench import harness\n"
        "assert harness.HERE.parent == __import__('pathlib').Path(sys.path[0])\n"
        "spec = harness.cell_spec('gw_small.dummy')\n"
        "print(json.dumps([m['name'] for m in spec.end_to_end + spec.per_layer]))\n"
        "r = harness.run_cell('gw_small.dummy', 3, 0.2, True, t_start=time.perf_counter(),"
        " device='cpu')\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    names, result = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert names == ["score_windows_per_s", "setup_s", "dummy_calls"]
    assert result["correct"] is True
    assert result["metrics"]["dummy_calls"]["value"] >= 1
