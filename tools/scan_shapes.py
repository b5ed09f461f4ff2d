"""Device time of K3 at gw_nominal's four layer shapes, on the card.

Times ``lstm_scan_layer`` (the ``kernel`` backend's entry) at H=32 IN=1,
H=8 IN=32, H=8 IN=8 and H=32 IN=8, over a T=100 window and at T=1 (a
pushed sample), B=1, fp32, with random weights from a seed, and prints one
JSON line: per shape, the device ms per call from ``torch.profiler`` (the
kernel events of ``--reps`` calls summed; the trace opens with spin kernels
and a pause, as ``chip_smoke.py``'s ``device_ms``) and the median CUDA-event
ms of one call.  The package comes from ``PYTHONPATH``, so two trees can be
compared in one run on one card (run them old, new, new, old):

    PYTHONPATH=src python3 tools/scan_shapes.py --label new
    PYTHONPATH=/path/to/other/checkout/src python3 tools/scan_shapes.py --label old
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.lstm_scan import lstm_scan_layer

#: gw_nominal's layers (H, IN): encoder 32, 8; decoder 8, 32
SHAPES = ((32, 1), (8, 32), (8, 8), (32, 8))


def device_ms(fn, reps: int) -> tuple[float | None, int]:
    """(device ms per call, kernel events per call) over ``reps`` calls;
    None where the trace holds no whole number of events per call."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]
    if not times or len(times) % reps:
        return None, len(times)
    return sum(times) / reps / 1e3, len(times) // reps


def event_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_shapes: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = []
    for hidden, n_in in SHAPES:
        w_x = (torch.randn(n_in, 4 * hidden, generator=g) * n_in**-0.5).to(dev)
        w_h = (torch.randn(hidden, 4 * hidden, generator=g) * hidden**-0.5).to(dev)
        b = (torch.randn(4 * hidden, generator=g) * 0.1).to(dev)
        h0 = (torch.randn(1, hidden, generator=g) * 0.3).to(dev)
        c0 = (torch.randn(1, hidden, generator=g) * 0.3).to(dev)
        for t_len in (100, 1):
            x = torch.randn(1, t_len, n_in, generator=g).to(dev)
            call = lambda: lstm_scan_layer(x, w_x, b, w_h, h0, c0)  # noqa: E731
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            ms, per_call = device_ms(call, args.reps)
            rows.append({"H": hidden, "IN": n_in, "T": t_len, "B": 1, "ms": ms,
                         "events_per_call": per_call, "call_ms": event_ms(call, args.reps)})
    print(json.dumps({"label": args.label, "reps": args.reps, "shapes": rows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
