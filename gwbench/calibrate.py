"""Readings that a cell's correctness limits are set from: for each seed,
the program's numbers after a short window at the cell's own size and the
control's (the reference in the program's place, one precision down),
read in one process.

    python3 gwbench/calibrate.py --workload <name> --seeds 11,12,13 [--seconds 2]

One JSON line per seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def readings(checks: dict) -> dict:
    return {k: v["value"] for k, v in checks.items()}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for path in (REPO / "src", REPO):
        sys.path.insert(0, str(path))
    from gwbench import harness

    spec = harness.cell_spec(args.workload)
    driver = harness.load_module("drivers", spec.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = driver.Cell(spec.config, spec.traffic, seed, "cuda")
        cell.setup()
        i, t1 = 0, time.perf_counter()
        while time.perf_counter() - t1 < args.seconds:
            cell.call(i)
            i += 1
        cell.release()
        line = {"workload": args.workload, "seed": seed, "calls": i,
                "program": readings(cell.check(spec.limits)),
                "control": readings(cell.control(spec.limits)),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
