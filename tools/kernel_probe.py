"""Clock stamps inside K3's warp-cell kernel and K4, on the card.

Builds ``kernels/lstm_scan/csrc/lstm_scan.cu`` and
``kernels/ssd_scan/csrc/ssd_scan.cu`` with ``-DKERNEL_PROBE`` (beside the
normal builds in ``build/kernels/``, keyed apart), which turns on the
``PROBE`` stamps of ``kernels/csrc/probe.cuh`` placed in the kernels, and
launches those copies through their C entries:

* K3 (``lstm_scan_layer``, B=1, T=100, H=32 IN=1, H=8 IN=8, H=8 IN=32):
  thread 0 of CTA 0 stamps every step after its dot product, its gate's
  activation, the shuffles, the cell and the step's barrier; the SM clock
  comes from ``globaltimer`` over the same window.
* K4 (``ssd_scan``, B=8, T=512, H=24, P=64, N=128, bf16): lane 0 of every
  warp of the scan kernel's CTAs 0 and 400 stamps every chunk: the row
  warps after waiting for cum, after M, and after M @ X, (C e) @ S_prev^T
  and y; the state warps after the scan and the barriers, the stage issue,
  the carry and the state's copy to shared memory.

Prints cycles per step or chunk and the median of each phase, and the
call's time with the stamps in (CUDA events).  The stamps cost cycles of
their own; compare phases, not totals, with an uninstrumented run:

    PYTHONPATH=src python3 tools/kernel_probe.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels._build import build  # noqa: E402
from repro_torch.kernels.lstm_scan.lstm_scan import SOURCE as K3_SOURCE  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import SOURCE as K4_SOURCE  # noqa: E402

F32, BF16 = 0, 1  # the sources' dtype codes


def probe_lib(source: Path):
    lib = build(source, defines=("KERNEL_PROBE",)).lib
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def read(lib, n: int) -> list:
    buf = (ctypes.c_longlong * n)()
    if lib.probe_read(ctypes.addressof(buf), n) != 0:
        raise SystemExit("kernel_probe: cudaMemcpyFromSymbol failed")
    return list(buf)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    lib3 = probe_lib(K3_SOURCE)
    for hidden, n_in in ((32, 1), (8, 8), (8, 32)):
        g = torch.Generator().manual_seed(0)
        x = torch.randn(1, 100, n_in, generator=g).to(dev)
        w_x = (torch.randn(n_in, 4 * hidden, generator=g) * 0.3).to(dev)
        w_h = (torch.randn(hidden, 4 * hidden, generator=g) * 0.3).to(dev)
        b = torch.zeros(4 * hidden, device=dev)
        h0, c0, h_f, c_f = (torch.zeros(1, hidden, device=dev) for _ in range(4))
        hs = torch.empty(100, 1, hidden, device=dev)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w_x, b, w_h, h0, c0, hs, h_f, c_f)]
        for _ in range(3):  # lstm_scan_layer(..., T, B, H, IN, rows, compute, weights, act)
            if lib3.lstm_scan_layer(*ptrs, 100, 1, hidden, n_in, 1, F32, F32, 0, stream()):
                raise SystemExit("kernel_probe: K3 launch failed")
        torch.cuda.synchronize()
        pr = read(lib3, 60004)
        cycles, ns = pr[60000] - pr[60002], pr[60001] - pr[60003]
        steps = [[pr[t * 8 + k] for k in range(6)] for t in range(100)]
        phases = [median([s[k + 1] - s[k] for s in steps]) for k in range(5)]
        lengths = [steps[t + 1][0] - steps[t][0] for t in range(99)]
        slow = sorted(range(99), key=lambda t: -lengths[t])[:4]
        print(f"K3 H={hidden} IN={n_in}: {cycles} cycles in {ns} ns ({cycles / ns:.3f} GHz), "
              f"{steps[99][5] - steps[0][0]} of them in the 100 steps; a step {median(lengths)} "
              f"cycles (median; slowest: " + ", ".join(f"step {t} {lengths[t]}" for t in slow)
              + f"); (dot, activation, shuffles, cell, barrier) {phases}")

    lib4 = probe_lib(K4_SOURCE)
    lib4.ssd_scan_scratch_floats.restype = ctypes.c_longlong
    g = torch.Generator(device=dev).manual_seed(0)
    batch, t_len, heads, p, n = 8, 512, 24, 64, 128
    x = torch.randn(batch, t_len, heads, p, generator=g, device=dev).bfloat16()
    bm, cm = ((torch.randn(batch, t_len, 1, n, generator=g, device=dev) * 0.3).bfloat16()
              for _ in range(2))
    dt = F.softplus(torch.randn(batch, t_len, heads, generator=g, device=dev))
    a = -torch.exp(torch.randn(heads, generator=g, device=dev) * 0.5)
    y = torch.empty_like(x)
    s_f = torch.empty(batch, heads, p, n, device=dev)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, dt, a, bm, cm)]
    cb = torch.empty(lib4.ssd_scan_scratch_floats(batch, 1, t_len, 64), device=dev)
    out = [ctypes.c_void_p(), ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(s_f.data_ptr()),
           ctypes.c_void_p(cb.data_ptr())]
    strides = [ctypes.c_longlong(v) for v in (x.stride(0), x.stride(1), bm.stride(0), bm.stride(1))]

    def call():  # ssd_scan(x, dt, a, b, c, s0, y, s_f, cb, strides, B, T, H, G, P, N, L, dtype, stream)
        if lib4.ssd_scan(*ptrs, *out, *strides, batch, t_len, heads, 1, p, n, 64, BF16,
                         stream()):
            raise SystemExit("kernel_probe: K4 launch failed")

    for _ in range(3):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    print(f"K4 with stamps: {start.elapsed_time(end) / 20:.4f} ms per call (events)")
    pr = read(lib4, 2 * 256 * 8)
    for cta, name in ((0, "0"), (1, "400")):
        for warp in range(16):  # the row group, then the state group
            base = [((cta * 256) + warp * 16 + c) * 8 for c in range(8)]
            n_ph = 3 if warp < 8 else 4
            phases = [median([pr[b + k + 1] - pr[b + k] for b in base]) for k in range(n_ph)]
            chunk = median([pr[b1] - pr[b0] for b0, b1 in zip(base[:-1], base[1:])])
            what = ("(wait for cum, M, M @ X and (C e) @ S_prev^T)" if warp < 8 else
                    "(scan and barriers, stage, carry, state to shared memory)")
            print(f"K4 CTA {name} warp {warp}: a chunk {chunk} cycles; {what} {phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
