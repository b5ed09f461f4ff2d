"""Wrappers around the per-layer scan kernel: layout, padding, dispatch.

Public entry points:

* ``lstm_scan_op(xw, w_h, h0, c0)``: batch-major wrapper.  The kernel runs
  at the exact H and B (shared memory has no 128-lane or 8-sublane tiling
  to pad to); ``block_b`` is the number of batch rows one CTA runs.
* ``lstm_forward_kernel(params, xs, cfg, state)``: the backend behind
  ``core.lstm.lstm_forward(..., impl="kernel")``: one launch per layer
  (``lstm_scan_layer``) that forms the paper's ``mvm_x`` sub-layer (plus
  the bias) and runs the recurrent scan.
* ``pad_gates``: gate-aware padding of a 4H axis.  The 4H axis is four
  [i|f|g|o] segments, so padding H pads each segment on its own, never the
  tail of the concatenated axis.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quant import EXACT, ActivationSet, kernel_safe

from .lstm_scan import lstm_scan, lstm_scan_layer


def pad_gates(x: torch.Tensor, hidden: int, hidden_p: int) -> torch.Tensor:
    """Pad the trailing 4H axis gate-segment-wise to 4 * hidden_p."""
    if hidden == hidden_p:
        return x
    lead = x.shape[:-1]
    x = x.reshape(*lead, 4, hidden)
    x = torch.nn.functional.pad(x, (0, hidden_p - hidden))
    return x.reshape(*lead, 4 * hidden_p)


def lstm_scan_op(
    xw: torch.Tensor,   # (B, T, 4H) fp32
    w_h: torch.Tensor,  # (H, 4H)
    h0: torch.Tensor,   # (B, H)
    c0: torch.Tensor,   # (B, H)
    *,
    block_b: int | None = None,
    acts: ActivationSet = EXACT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hs (B, T, H), h_final (B, H), c_final fp32 (B, H))."""
    hs, h_f, c_f = lstm_scan(
        xw.to(torch.float32).transpose(0, 1).contiguous(), w_h, h0,
        c0.to(torch.float32), block_b=block_b, acts=kernel_safe(acts),
    )
    return hs.transpose(0, 1), h_f, c_f


def lstm_forward_kernel(
    params: dict[str, Any],
    xs: torch.Tensor,  # (B, T, in_dim)
    cfg,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Backend for ``core.lstm.lstm_forward(impl="kernel")``.

    Sub-layer 1 (paper ``mvm_x``): the input product at the compute dtype,
    widened to fp32, plus the bias, as the reference's
    ``(xs @ W_x).astype(f32) + b``.  Sub-layer 2: the scan, which adds
    ``h @ W_h`` to that stream (the bias therefore enters before the
    recurrent product, as in the reference's kernel backend; ``split``
    adds it last).  Both run in one launch per layer, so a row's result
    does not depend on the batch it shares the launch with.
    """
    from repro_torch.core.lstm import zero_state

    if state is None:
        state = zero_state(xs.shape[0], cfg, xs.device)
    h0, c0 = state
    hs, h_f, c_f = lstm_scan_layer(
        xs, params["w_x"], params["b"].to(torch.float32), params["w_h"],
        h0.to(cfg.dtype), c0.to(torch.float32), acts=kernel_safe(cfg.acts))
    return hs.transpose(0, 1), (h_f.to(cfg.dtype), c_f.to(cfg.cell_dtype))
