"""Where K4's bf16 output rounds differently from its plain version, on the card.

Runs ``ssd_scan`` (the kernel) and ``ssd_chunked`` (the plain version, fp32
math, TF32 off) on the same bf16 inputs at mamba2-130m's prefill shape (B=8,
T=512, H=24, P=64, N=128, chunk 64): model-like inputs (x, B and C after
SiLU, a = -1, dt = softplus of a normal draw) and zero-mean ones.  Prints
the share of y elements whose bf16 values differ (by one ulp: both round
fp32 sums once), how many of those lie away from zero, and the largest
relative state difference.  A share well above two fp32 summation orders'
(about 3e-5 at this shape, see tests/test_torch_ssd_split.py) or a lean
toward zero is carried on by every later layer of a bf16 model
(``chip_smoke.py`` fails past 55% toward zero):

    PYTHONPATH=src python3 tools/ssd_roundings.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_roundings: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    shape_x, shape_bc = (8, 512, 24, 64), (8, 512, 1, 128)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    for name, model_like in (("SiLU inputs, a = -1", True), ("zero-mean inputs", False)):
        if model_like:
            x, bm, cm = (F.silu(randn(*s)).bfloat16() for s in (shape_x, shape_bc, shape_bc))
            a = -torch.ones(24, device=dev)
        else:
            x = randn(*shape_x).bfloat16()
            bm, cm = ((randn(*shape_bc) * 0.3).bfloat16() for _ in range(2))
            a = -torch.exp(randn(24) * 0.5)
        dt = F.softplus(randn(8, 512, 24))
        y, s = ssd_scan(x, dt, a, bm, cm, chunk=64)
        y_p, s_p = ssd_chunked(x, dt, a, bm, cm, chunk=64)
        d = y.float() - y_p.float()
        differ = d != 0
        away = differ & (d.sign() == y_p.float().sign())
        print(f"{name}: y differs in {differ.float().mean().item():.3e} of elements, "
              f"{(away.sum() / differ.sum().clamp(min=1)).item():.3f} of them away from zero; "
              f"state: max relative difference "
              f"{((s - s_p).abs() / s_p.abs().clamp(min=1e-3)).max().item():.3e} "
              f"({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
