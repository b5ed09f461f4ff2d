"""Quantization and latency-reduced activations (paper Sec. IV-A / V-B).

The paper runs 16-bit fixed-point weights and activations with a 32-bit cell
state, a BRAM-LUT sigmoid and a piecewise-linear tanh.  This module holds
the same functions on torch tensors:

* ``ActivationSet`` picks the gate/state activations per deployment:
  EXACT, PAPER_HW (LUT sigmoid + PWL tanh), HARD and PAPER_HW_KERNEL (the
  LUT replaced by its PWL twin, which the CUDA kernels evaluate in-kernel).
* ``fixed_quant`` (with its straight-through gradient) and
  ``quantize_tree`` snap weights onto a fixed-point grid, the paper's
  16-bit weights; ``make_act_quant`` does the same to the layer hand-off;
  ``int8_symmetric_quant`` builds the power-of-two int8 weight grid
  the packed stacks store.

Every elementwise function here is written as the sequence of single
operations the kernels in ``kernels/lstm_stack/csrc`` perform (one rounding
per operation, no fused multiply-add), so a kernel and its plain version
agree bit for bit on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import tree_map

def _fixed_grid(total_bits: int, frac_bits: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Snap onto the signed fixed-point grid ``<total_bits, frac_bits>``:
    scale, round half to even, unscale, saturate."""
    scale = float(2**frac_bits)
    lo = -(2.0 ** (total_bits - 1)) / scale
    hi = (2.0 ** (total_bits - 1) - 1) / scale

    def snap(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x * scale) / scale, lo, hi)

    return snap


class _FixedQuant(torch.autograd.Function):
    """Forward: the exact grid point.  Backward: the upstream gradient
    unchanged, also where the forward saturates (the reference's JVP)."""

    @staticmethod
    def forward(ctx, x, total_bits, frac_bits):
        return _fixed_grid(total_bits, frac_bits)(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def fixed_quant(x: torch.Tensor, total_bits: int = 16, frac_bits: int = 8) -> torch.Tensor:
    """Round to the signed fixed-point grid ``<total_bits, frac_bits>``
    (fake quant, saturating, round to nearest even), with a
    straight-through gradient.  The forward value is exactly the grid
    point (``x + (q - x).detach()`` would lose it to fp32 cancellation for
    large ``|x|``)."""
    return _FixedQuant.apply(x, total_bits, frac_bits)


def quantize_tree(tree, total_bits: int = 16, frac_bits: int = 8):
    """``fixed_quant`` on every tensor of a nested dict."""
    return tree_map(lambda x: fixed_quant(x, total_bits, frac_bits), tree)


#: ``act_bits`` plan-knob values the kernels accept (paper: activations are
#: fixed to 16 bits; 8 is the aggressive point the accuracy study probes).
ACT_BITS = (8, 16)


def make_act_quant(total_bits: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation fake-quant for the layer hand-off.

    Snaps to the signed fixed-point grid ``<total_bits, total_bits // 2>``
    (<16, 8> is the paper's activation precision) with ``fixed_quant``'s
    op chain, without its gradient rule (the kernels evaluate it in-kernel).
    """
    if total_bits not in ACT_BITS:
        raise ValueError(
            f"act_bits={total_bits!r} unsupported; choose from {ACT_BITS}"
        )
    return _fixed_grid(total_bits, total_bits // 2)


# ---------------------------------------------------------------------------
# storage quantization for packed kernel weights
# ---------------------------------------------------------------------------

#: Weight storage dtypes a packed stack can carry (kernels/lstm_stack).
WEIGHT_DTYPES = ("fp32", "bf16", "int8")

#: log2(x) is evaluated as log(x) * f32(1 / ln 2), the form the reference's
#: compiler gives it; near powers of two this decides where the floor lands
_INV_LN2 = np.float32(1.0 / math.log(2.0))


def native_weight_dtype(compute_dtype: torch.dtype) -> str | None:
    """The storage name matching a compute dtype, or None if there is none."""
    return {torch.float32: "fp32", torch.bfloat16: "bf16"}.get(compute_dtype)


def int8_symmetric_quant(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a weight tensor to int8 on a power-of-two fixed-point grid.

    The scale is ``2**-f`` with ``f = floor(log2(127 / amax))``: the finest
    grid <8, f> that still covers the tensor's range, so ``q * scale`` lands
    exactly on that fixed-point grid.  Returns ``(q int8, scale fp32
    scalar)``; codes are symmetric in [-127, 127].

    ``f`` is computed on the host: the log in float64, rounded to fp32,
    times fp32 ``1/ln 2``.  That reproduces the reference's fp32 ``log2``
    wherever ``127 / amax`` sits next to a power of two, so codes and scales
    are equal to the reference's, not merely close.
    """
    w32 = w.detach().to(torch.float32)
    amax = np.float32(w32.abs().max().item()) if w32.numel() else np.float32(0)
    scale = np.float32(1.0)  # an all-zero (padded) tensor: any scale works
    if amax > 0:
        safe = max(amax, np.finfo(np.float32).tiny)
        with np.errstate(over="ignore"):  # subnormal amax: as the reference
            ratio = np.float32(127.0) / np.float32(safe)
        log2 = np.float32(np.log(np.float64(ratio))) * _INV_LN2
        scale = np.float32(np.exp2(-np.float64(np.floor(log2))))
    scale_t = torch.tensor(float(scale), dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w32 / scale_t), -127, 127)
    return q.to(torch.int8), scale_t


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def sigmoid_exact(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def tanh_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def make_sigmoid_lut(n_entries: int = 1024, x_max: float = 8.0) -> np.ndarray:
    """Precompute the BRAM sigmoid table over [-x_max, x_max]."""
    xs = np.linspace(-x_max, x_max, n_entries, dtype=np.float32)
    return np.where(
        xs >= 0, 1.0 / (1.0 + np.exp(-xs)), np.exp(xs) / (1.0 + np.exp(xs))
    ).astype(np.float32)


_DEFAULT_LUT = make_sigmoid_lut()


def sigmoid_lut(
    x: torch.Tensor, table: torch.Tensor | None = None, x_max: float = 8.0
) -> torch.Tensor:
    """LUT sigmoid: nearest-entry gather, saturating outside the range.

    Used for accuracy parity; a gather cannot sit inside the kernels, which
    run its PWL twin (``kernel_safe``).
    """
    if table is None:
        table = torch.from_numpy(_DEFAULT_LUT).to(x.device)
    n = table.shape[0]
    idx = torch.clamp(
        torch.round((x + x_max) * (n - 1) / (2 * x_max)).to(torch.int32), 0, n - 1
    )
    return table[idx.long()].to(x.dtype)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear sigmoid (Keras/QKeras hard_sigmoid): clip(x/4+0.5)."""
    return torch.clamp(x * 0.25 + 0.5, 0.0, 1.0)


#: PWL tanh knots: interpolate tanh at 0, 0.5, ..., 3.0; constant beyond.
#: The CUDA kernels hold the same constants (csrc/lstm_stack.cu).
TANH_KNOTS = (0.0, 0.5, 1.0, 1.5, 2.0, 2.5)
TANH_SLOPES = (0.92423, 0.58891, 0.28699, 0.11786, 0.04513, 0.01702)
_TANH_SEG_W = 0.5


def tanh_pwl(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear tanh: a sum of clipped ramps times ``sign(x)``.

        tanh(|x|) ~= sum_i  s_i * clip(|x| - k_i, 0, 0.5)
    """
    ax = torch.abs(x)
    y = torch.zeros_like(ax)
    for k, s in zip(TANH_KNOTS, TANH_SLOPES):
        y = y + s * torch.clamp(ax - k, 0.0, _TANH_SEG_W)
    return torch.sign(x) * y


def sigmoid_pwl(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear sigmoid via the tanh identity: 0.5*tanh_pwl(x/2)+0.5."""
    return 0.5 * tanh_pwl(0.5 * x) + 0.5


@dataclass(frozen=True)
class ActivationSet:
    """Gate/state activations for an LSTM cell; pick per deployment target."""

    sigma: Callable[[torch.Tensor], torch.Tensor]
    tanh: Callable[[torch.Tensor], torch.Tensor]
    name: str = "exact"


EXACT = ActivationSet(sigma=sigmoid_exact, tanh=tanh_exact, name="exact")
#: The paper's hardware configuration: LUT sigmoid + piecewise-linear tanh.
PAPER_HW = ActivationSet(sigma=sigmoid_lut, tanh=tanh_pwl, name="paper_hw")
#: Both activations piecewise-linear.
HARD = ActivationSet(sigma=hard_sigmoid, tanh=tanh_pwl, name="hard")
#: paper_hw with the LUT replaced by its PWL twin: what the kernels run.
PAPER_HW_KERNEL = ActivationSet(
    sigma=sigmoid_pwl, tanh=tanh_pwl, name="paper_hw_kernel"
)

ACTIVATION_SETS = {a.name: a for a in (EXACT, PAPER_HW, HARD, PAPER_HW_KERNEL)}


def kernel_safe(acts: ActivationSet) -> ActivationSet:
    """The kernel-safe twin of an activation set (no lookup table)."""
    return PAPER_HW_KERNEL if acts.name == "paper_hw" else acts
