"""Split-sublayer LSTM (paper Sec. III-C) on torch tensors.

The paper splits an LSTM layer into ``mvm_x`` (the input projection, which
has no recurrent dependency) and the recurrent sub-layer (``mvm_h``, gate
activations and the elementwise tail):

    naive  : loop_t [ x_t @ W_x  +  h_{t-1} @ W_h  -> gates -> tail ]
    split  : XW = X @ W_x                     (one matmul over all timesteps)
             loop_t [ XW_t + h_{t-1} @ W_h -> gates -> tail ]

Gate order along the 4H axis is [i, f, g, o]; weights are stored as
``x @ W`` with ``W`` of shape (in, 4H), the reference's layout.  The cell
state ``c`` is carried in fp32 even when weights/activations are bf16 (the
paper's 32-bit cell).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import resolve_device

from .quant import EXACT, ActivationSet

Params = dict[str, Any]


@dataclass(frozen=True)
class LstmConfig:
    in_dim: int
    hidden: int
    dtype: torch.dtype = torch.float32       # weight/activation compute dtype
    cell_dtype: torch.dtype = torch.float32  # carry dtype for c_t (paper: 32-bit)
    acts: ActivationSet = EXACT
    #: weight *storage* dtype for the fused packed stack: "fp32" | "bf16" |
    #: "int8", or None = native storage at ``dtype``.  Only the fused
    #: backends honour non-native storage; others raise at plan time.
    weight_dtype: str | None = None


def init_lstm(cfg: LstmConfig, generator: torch.Generator,
              device: str | torch.device = "cuda") -> Params:
    """Glorot-uniform W_x/W_h and a forget-gate bias of 1.0.

    Draws on the CPU from ``generator`` (so a seed gives the same weights on
    every device), then moves to ``device``.
    """
    dev = resolve_device(device)
    lim_x = (6.0 / (cfg.in_dim + 4 * cfg.hidden)) ** 0.5
    lim_h = (6.0 / (cfg.hidden + 4 * cfg.hidden)) ** 0.5

    def uniform(shape, lim):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (2 * lim) - lim

    w_x = uniform((cfg.in_dim, 4 * cfg.hidden), lim_x)
    w_h = uniform((cfg.hidden, 4 * cfg.hidden), lim_h)
    b = torch.zeros(4 * cfg.hidden, dtype=torch.float32)
    b[cfg.hidden : 2 * cfg.hidden] = 1.0  # forget-gate bias
    return {
        "w_x": w_x.to(cfg.dtype).to(dev),
        "w_h": w_h.to(cfg.dtype).to(dev),
        "b": b.to(dev),  # paper: bias kept 32-bit
    }


def _gates_to_hc(gates: torch.Tensor, c_prev: torch.Tensor,
                 cfg: LstmConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The LSTM tail: activations + elementwise ops. gates: (..., 4H) fp32."""
    h4 = cfg.hidden
    i = cfg.acts.sigma(gates[..., 0 * h4 : 1 * h4])
    f = cfg.acts.sigma(gates[..., 1 * h4 : 2 * h4])
    g = cfg.acts.tanh(gates[..., 2 * h4 : 3 * h4])
    o = cfg.acts.sigma(gates[..., 3 * h4 : 4 * h4])
    c = (f * c_prev.to(gates.dtype) + i * g).to(cfg.cell_dtype)
    h = (o * cfg.acts.tanh(c.to(gates.dtype))).to(cfg.dtype)
    return h, c


def lstm_step(params: Params, h_prev: torch.Tensor, c_prev: torch.Tensor,
              x_t: torch.Tensor, cfg: LstmConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One reference timestep (both MVMs inline). x_t: (B, in_dim)."""
    gates = (
        x_t.to(cfg.dtype) @ params["w_x"] + h_prev.to(cfg.dtype) @ params["w_h"]
    ).to(torch.float32) + params["b"]
    return _gates_to_hc(gates, c_prev, cfg)


def lstm_forward_naive(params: Params, xs: torch.Tensor, cfg: LstmConfig,
                       state: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Unsplit baseline: both MVMs inside the timestep loop. xs: (B, T, in)."""
    h, c = zero_state(xs.shape[0], cfg, xs.device) if state is None else state
    hs = []
    for t in range(xs.shape[1]):
        h, c = lstm_step(params, h, c, xs[:, t], cfg)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


def lstm_forward_split(params: Params, xs: torch.Tensor, cfg: LstmConfig,
                       state: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Paper-split execution: one batched mvm_x, then the recurrent loop."""
    h, c = zero_state(xs.shape[0], cfg, xs.device) if state is None else state
    xw = (xs.to(cfg.dtype) @ params["w_x"]).to(torch.float32)  # (B, T, 4H)
    hs = []
    # unbind, not xw[:, t]: the same views, but autograd then stacks the
    # T step gradients once instead of adding T zero-padded (B, T, 4H) ones
    for xw_t in xw.unbind(1):
        gates = (
            xw_t + (h.to(cfg.dtype) @ params["w_h"]).to(torch.float32)
            + params["b"]
        )
        h, c = _gates_to_hc(gates, c, cfg)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


def lstm_forward(params: Params, xs: torch.Tensor, cfg: LstmConfig,
                 state: tuple[torch.Tensor, torch.Tensor] | None = None,
                 impl: str = "split"):
    """Dispatch: impl in {naive, split, kernel}."""
    if impl == "naive":
        return lstm_forward_naive(params, xs, cfg, state)
    if impl == "split":
        return lstm_forward_split(params, xs, cfg, state)
    if impl == "kernel":
        from repro_torch.kernels.lstm_scan.ops import lstm_forward_kernel

        return lstm_forward_kernel(params, xs, cfg, state)
    raise ValueError(f"unknown layer-by-layer impl {impl!r}")


def zero_state(batch: int, cfg: LstmConfig, device: str | torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros(batch, cfg.hidden, dtype=cfg.dtype, device=device),
        torch.zeros(batch, cfg.hidden, dtype=cfg.cell_dtype, device=device),
    )
