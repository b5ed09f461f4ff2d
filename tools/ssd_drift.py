"""K4's roundings against its plain version, and mamba2's drift, on the card.

For the package on ``PYTHONPATH`` (so that two trees can be compared in one
run on one card: run them old, new, new, old), it prints one JSON line:

* the share of bf16 y that rounds apart from ``ssd_chunked`` at mamba2-130m's
  prefill shape (B=8, T=512, H=24, P=64, N=128, chunk 64; model-like
  inputs, as ``tools/ssd_roundings.py``) and the share of those toward zero;
* K4's time per call at that shape (CUDA events, median of 20 calls);
* mamba2-130m's teacher-forced gap as ``chip_smoke.py`` phase 13 measures
  it (bf16, random weights from seed 0, B=8, prompts of 512 and 500
  tokens, the 64 tokens the kernel path generates): the largest |logit
  difference| between the kernel path and the plain path over the largest
  |logit| of the plain path, prefill and decode.

    PYTHONPATH=src python3 tools/ssd_drift.py --label new
    PYTHONPATH=/path/to/other/checkout/src python3 tools/ssd_drift.py --label old
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.kernels.ssd_scan  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine

k4 = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]

BATCH, PROMPT, NEW = 8, 512, 64


def roundings(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    shape_x, shape_bc = (BATCH, PROMPT, 24, 64), (BATCH, PROMPT, 1, 128)
    x, bm, cm = (F.silu(torch.randn(*s, generator=g, device=dev)).bfloat16()
                 for s in (shape_x, shape_bc, shape_bc))
    a = -torch.ones(24, device=dev)
    dt = F.softplus(torch.randn(BATCH, PROMPT, 24, generator=g, device=dev))
    y, _ = k4.ssd_scan(x, dt, a, bm, cm, chunk=64)
    y_p, _ = k4.ssd_chunked(x, dt, a, bm, cm, chunk=64)
    d = y.float() - y_p.float()
    differ = d != 0
    toward_zero = differ & (d.sign() != y_p.float().sign())
    times = []
    for _ in range(22):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        k4.ssd_scan(x, dt, a, bm, cm, chunk=64)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"differ_share": differ.float().mean().item(),
            "toward_zero_share": (toward_zero.sum() / differ.sum().clamp(min=1)).item(),
            "ms": statistics.median(times[2:])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssd_drift: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"label": args.label, "device": torch.cuda.get_device_name(0),
              **roundings(dev)}
    # the prompts and weights of chip_smoke.py phase 13 (smollm's prompts
    # are drawn first from the same generator)
    rng = np.random.default_rng(0)
    rng.integers(0, get_arch("smollm-360m").vocab, (BATCH, PROMPT))
    cfg = get_arch("mamba2-130m")
    prompts = {n: rng.integers(0, cfg.vocab, (BATCH, n)).astype(np.int32) for n in (PROMPT, 500)}
    params = get_model(cfg).init_params(cfg, seed=0, device=dev)
    for n, prompt in prompts.items():
        eng = LmEngine(params, cfg, max_len=n + NEW, device=dev)
        plain = LmEngine(params, cfg, max_len=n + NEW, device=dev, use_kernel=False)
        tokens = eng.generate(prompt, NEW)  # as phase 13: the kernel path's tokens
        k_pre, k_steps = eng.teacher_forced(prompt, tokens)
        p_pre, p_steps = plain.teacher_forced(prompt, tokens)
        for what, a, b in (("prefill", k_pre, p_pre), ("decode", k_steps, p_steps)):
            a, b = a[..., : cfg.vocab], b[..., : cfg.vocab]
            report[f"tf_gap_p{n}_{what}"] = ((a - b).abs().max() / b.abs().max()).item()
    print(json.dumps({"ssd_drift": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
