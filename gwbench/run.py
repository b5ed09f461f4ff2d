"""Run one cell of the port's benchmark on the card and print its result.

    python3 gwbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error).  With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones.  Without as many CUDA cards as the cell asks for, or if
the JAX package or JAX was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program's nvcc builds already go to ``build/kernels``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(REPO / "build" / sub)


def _finite(obj):
    """Non-finite numbers as null: the line stays JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    for path in (REPO / "src", REPO):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from gwbench import harness

    chips = harness.cell_spec(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gwbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"gwbench: the run loaded {found}; the port must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
