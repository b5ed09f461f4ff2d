"""Device time of one LM decode step, kernel by kernel, on the card.

Serves one model of the port at full width with random weights from a seed
(bf16, batch 8, a 512-token prompt, as ``chip_smoke.py``'s phase 13), then
traces ``--steps`` decode steps with ``torch.profiler`` and prints one JSON
line: for every device kernel name, its launches and device ms per step
(summed over the steps and divided by their count), the total device ms
per step, and the host ms per step (synchronised, untraced).  The package
comes from ``PYTHONPATH``, so two trees can be compared in one run on one
card:

    PYTHONPATH=src python3 tools/decode_step_profile.py --label new
    PYTHONPATH=/path/to/other/checkout/src python3 tools/decode_step_profile.py --label old

Kernel names are shortened to 120 characters.  The first device events of
a trace can go unrecorded on the H100, so the trace opens with spin kernels
and a pause that are not counted (as ``chip_smoke.py``'s ``device_ms``); a
launch count per step that is not a whole number shows events were lost.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--top", type=int, default=12, help="kernel names to print, by time")
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_profile: needs a CUDA device")

    cfg = get_arch(args.arch)
    params = get_model(cfg).init_params(cfg, seed=0, device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt)).astype(np.int32)
    eng = LmEngine(params, cfg, max_len=args.prompt + 2 * args.steps + 1, device="cuda")
    eng.generate(prompts[:, :16], 2)  # warm-up: cuBLAS handles, kernel builds
    tok = torch.zeros(args.batch, 1, dtype=torch.int64, device="cuda")

    # host time per step, synchronised, over the first --steps steps
    _, cache = eng.prefill(prompts)
    host = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        _, cache = eng.step(cache, tok)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)

    # device time per kernel name over the next --steps steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(args.steps):
            _, cache = eng.step(cache, tok)
        torch.cuda.synchronize()
    us, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            us[e.name[:120]] += e.time_range.elapsed_us()
            n[e.name[:120]] += 1
    total_ms = sum(us.values()) / args.steps / 1e3
    kernels = [{"name": name, "launches_per_step": n[name] / args.steps,
                "ms_per_step": t / args.steps / 1e3}
               for name, t in us.most_common(args.top)]
    print(json.dumps({
        "label": args.label, "arch": args.arch, "batch": args.batch, "prompt": args.prompt,
        "steps": args.steps, "cache_rows": [args.prompt + args.steps + 1,
                                            args.prompt + 2 * args.steps],
        "host_ms_per_step_median": statistics.median(host),
        "device_ms_per_step": total_ms,
        "device_launches_per_step": sum(n.values()) / args.steps,
        "idle_share": 1 - total_ms / statistics.median(host),
        "kernels": kernels,
        "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
