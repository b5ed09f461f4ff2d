"""Homogeneous stage packing for LSTM stacks.

The fused kernels run every layer of a segment at one common width, so each
layer's weights are zero-padded to (D, H) and stacked.  Zero padding is
exact: padded input columns multiply zero W_x rows, padded hidden lanes
multiply zero W_h rows, and padded gate outputs never feed back into real
lanes.
"""

from __future__ import annotations

import torch


def pack_lstm_stack(params_list: list[dict], in_dims: list[int],
                    hidden_dims: list[int], d_target: int | None = None,
                    h_target: int | None = None) -> tuple[dict, int, int]:
    """Zero-pad per-layer LSTM weights to common (D, H) and stack.

    Padding is gate-aware: each of the [i|f|g|o] segments pads ``lh`` to
    ``h_max`` on its own.  Returns (stacked params with a leading layer
    axis, D_max, H_max).
    """
    d_max = d_target or max(in_dims)
    h_max = h_target or max(hidden_dims)

    def place(src, rows, lh, n_rows):
        dst = torch.zeros(n_rows, 4, h_max, dtype=src.dtype, device=src.device)
        dst[:rows, :, :lh] = src.reshape(rows, 4, lh)
        return dst.reshape(n_rows, 4 * h_max)

    padded = []
    for p, lx, lh in zip(params_list, in_dims, hidden_dims):
        b = torch.zeros(4, h_max, dtype=p["b"].dtype, device=p["b"].device)
        b[:, :lh] = p["b"].reshape(4, lh)
        padded.append({
            "w_x": place(p["w_x"], lx, lh, d_max),
            "w_h": place(p["w_h"], lh, lh, h_max),
            "b": b.reshape(-1),
        })
    stacked = {k: torch.stack([p[k] for p in padded]) for k in ("w_x", "w_h", "b")}
    return stacked, d_max, h_max
