"""What a run may load and read: no JAX and no JAX package, nothing under
``benchmarks/``; and no result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

GUARD = r"""
import json, sys
from pathlib import Path
repo = Path(sys.argv[1])
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0])) if event == "open" and args else None)
sys.path[:0] = [str(repo / "src"), str(repo)]
from gwbench import harness, run, calibrate, costs, gwdata, gwprogram, tracing
manifest = harness.load_manifest()
for kind in ("drivers", "references", "metrics"):
    for path in sorted((repo / "gwbench" / kind).glob("*.py")):
        harness.load_module(kind, path.stem)
for c in manifest["configs"]:
    harness.load_json("configs", Path(c["file"]).stem)
for w in manifest["workloads"]:
    spec = harness.cell_spec(w["name"])
    harness.load_module("drivers", spec.traffic["driver"])
import repro_torch.serve.engine
bench = str(repo / "benchmarks")
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "benchmarks": sorted({n.split(".")[0] for n in sys.modules} & {"benchmarks"}),
                  "read": [p for p in opened if p.startswith(bench)]}))
"""


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", GUARD, str(REPO)], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == {"forbidden": [], "benchmarks": [], "read": []}


def test_the_guard_compares_whole_top_level_names():
    from gwbench import harness

    clean = ["repro_torch", "repro_torch.core", "jaxon.sub", "flaxen", "torch"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(clean + ["repro.core", "jax", "flax.linen"]) == [
        "flax", "jax", "repro"]


def test_no_card_no_result():
    """Decides about the card inside the run: without one the command
    fails and prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        return  # the card's runs show the other side
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    workload = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "gwbench/run.py", "--workload",
                          workload, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
