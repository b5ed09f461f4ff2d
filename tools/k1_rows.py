"""K1's wavefront kernel by rows a CTA and rows a thread, on the card.

Times ``lstm_stack``'s wavefront launch (fp32, T=100, random weights and
state from a seed) at several batch sizes on one of two packs.

Each mode is a ``KernelPath`` (kind and rows) passed to ``launch``.
``--pack gw_nominal``: its encoder pack (L=2, W=32, the register path; the
layers' real widths 1 -> 32 -> 8, weights and state zero past them, as a
pack and its zero state are):

* ``one_row 1``: one row a CTA (the launch below the row-blocking threshold);
* ``blocked 8``: the row-blocked instantiation, every thread carrying
  ``BLOCKED_ROWS`` = 8 rows through each step;
* ``blocked 8 trimmed``: the same given the layers' real widths (the batch
  score's launch): only the warps of real elements, each chain ended at its
  layer's width;
* ``one_row R``: an explicit ``block_b`` = R (2, 4, 8), the R rows of a CTA
  one after another inside each step (the control: a mere change of the
  default).

``--pack gw_small``: its pack (L=1, W=9, the run-time-width path):

* ``one_row 1``: one row a CTA of 4W threads (the launch below the
  row-thread threshold);
* ``row_thread R``: the row-thread instantiation, one row a thread and R
  rows (32, 64, 128) a CTA (``ROW_THREAD_ROWS`` is the one the wrapper
  launches).

Each mode's output is held bit for bit against ``one_row 1``'s at every
batch.  Prints one JSON line: the card and its power limit, each K1
instantiation's registers and spills from the build's ptxas log, the CTAs
an SM holds of each mode (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
the path ``kernel_path`` picks at each batch, and per (batch, mode) the
median CUDA-event ms of one launch over rounds that take the modes in turn:

    PYTHONPATH=src:. python3 tools/k1_rows.py
    PYTHONPATH=src:. python3 tools/k1_rows.py --pack gw_small

(``--batches`` 64,512,4096,73728,294912 and 64,512,4096,32768,294912 by
default; ``row_thread_threshold`` cites a run at more batches around the
crossover.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import NamedTuple

import torch

from repro_torch.core.quant import EXACT
from repro_torch.kernels._build import ptxas_report
from repro_torch.kernels.lstm_stack import lstm_stack  # noqa: F401  (binds the module)

k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]

T = 100
#: (L, W) of each pack, the layers' real (input, hidden) widths, and the
#: batches it is timed at by default
PACKS = {"gw_nominal": (2, 32), "gw_small": (1, 9)}
WIDTHS = {"gw_nominal": ((1, 32), (32, 8)), "gw_small": ((1,), (9,))}
BATCHES = {"gw_nominal": "64,512,4096,73728,294912", "gw_small": "64,512,4096,32768,294912"}
SEQ_ROWS = (2, 4, 8)
ROW_THREAD_CTAS = (32, 64, 128)
ONE_ROW = k1.KernelPath("one_row", 1)


class Mode(NamedTuple):
    """A launch's path, and whether it is given the layers' real widths."""

    path: k1.KernelPath
    trimmed: bool = False


def modes(pack: str) -> list:
    if pack == "gw_small":
        return [Mode(ONE_ROW)] + [Mode(k1.KernelPath("row_thread", r)) for r in ROW_THREAD_CTAS]
    blocked = k1.KernelPath("blocked", k1.BLOCKED_ROWS)
    return ([Mode(ONE_ROW), Mode(blocked), Mode(blocked, True)]
            + [Mode(k1.KernelPath("one_row", r)) for r in SEQ_ROWS])


def label(mode: Mode) -> str:
    return f"{mode.path.kind} {mode.path.rows}" + (" trimmed" if mode.trimmed else "")


def operands(batch: int, seed: int, dev, n_layers: int, width: int, widths) -> dict:
    """Random operands, zero past the layers' real widths: each layer's
    weight rows past its input (W_x) and hidden (W_h) width, its gate
    columns and bias past its hidden width, and the state there."""
    g = torch.Generator().manual_seed(seed)
    w4 = 4 * width
    in_dims, hidden = widths
    o = {
        "xw0": torch.randn(T, batch, w4, generator=g),
        "w_x": torch.randn(n_layers, width, w4, generator=g) * width**-0.5,
        "w_h": torch.randn(n_layers, width, w4, generator=g) * width**-0.5,
        "b": torch.randn(n_layers, w4, generator=g) * 0.1,
        "h0": torch.randn(n_layers, batch, width, generator=g) * 0.3,
        "c0": torch.randn(n_layers, batch, width, generator=g) * 0.3,
    }
    for l, (i, h) in enumerate(zip(in_dims, hidden)):
        for gate in range(4):  # the gate columns past the hidden width
            cols = slice(gate * width + h, (gate + 1) * width)
            for key in ("w_x", "w_h"):
                o[key][l, :, cols] = 0.0
            o["b"][l, cols] = 0.0
            if l == 0:
                o["xw0"][..., cols] = 0.0
        o["w_x"][l, i:] = 0.0
        o["w_h"][l, h:] = 0.0
        o["h0"][l, :, h:] = 0.0
        o["c0"][l, :, h:] = 0.0
    return {k: v.to(dev) for k, v in o.items()}


def run(mode: Mode, o, widths) -> tuple:
    out = (torch.empty(T, *o["h0"].shape[1:], device=o["h0"].device),
           torch.empty_like(o["h0"]), torch.empty_like(o["c0"]))
    k1.launch("lstm_stack_wavefront", o["xw0"], o["w_x"], o["w_h"], o["b"], o["h0"], o["c0"],
              None, *out, t_len=T, acts=EXACT, act_bits=None, path=mode.path,
              widths=widths if mode.trimmed else None)
    return out


def event_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pack", choices=sorted(PACKS), default="gw_nominal")
    ap.add_argument("--batches", help="comma-separated; default: the pack's BATCHES")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_rows: needs a CUDA device")
    L, W = PACKS[args.pack]
    widths = WIDTHS[args.pack]
    dev = torch.device("cuda")
    built = k1.library()
    ptxas = [k for k in ptxas_report(built.log) if "lstm_stack_kernel" in k["kernel"]]
    lib = built.lib
    occupancy = {label(m): lib.lstm_stack_ctas_per_sm(
        L, W, m.path.rows, k1.PATH_CODES[m.path.kind], 0, 0,
        k1.widths_arg(widths, L, W) if m.trimmed else None) for m in modes(args.pack)}
    sms = k1.sm_count(0)
    rows = []
    for batch in (int(b) for b in (args.batches or BATCHES[args.pack]).split(",")):
        o = operands(batch, args.seed + batch, dev, L, W, widths)
        want = run(Mode(ONE_ROW), o, widths)
        equal = {}
        for mode in modes(args.pack):
            got = run(mode, o, widths)
            equal[label(mode)] = all(torch.equal(a, b) for a, b in zip(got, want))
        # about 200 ms of launches a measurement
        reps = max(1, min(50, int(200 / max(event_ms(lambda: run(Mode(ONE_ROW), o, widths), 1),
                                            1e-3))))
        times = {label(m): [] for m in modes(args.pack)}
        for i in range(args.rounds):
            order = modes(args.pack) if i % 2 == 0 else modes(args.pack)[::-1]
            for mode in order:
                times[label(mode)].append(event_ms(lambda: run(mode, o, widths), reps))
        rows.append({"B": batch, "reps": reps,
                     "kernel_path": label(Mode(k1.kernel_path(batch, L, W, sms))),
                     "bit_equal_to_one": equal,
                     "ms": {k: statistics.median(v) for k, v in times.items()},
                     "ms_min_max": {k: [min(v), max(v)] for k, v in times.items()}})
        del o, want
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"pack": args.pack, "L": L, "W": W,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "sms": sms,
                      "build_s": built.seconds, "ptxas": ptxas, "ctas_per_sm": occupancy,
                      "batches": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
