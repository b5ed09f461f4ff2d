"""Plain PyTorch versions of the per-layer scan kernel (gate order [i,f,g,o]).

Written to match the CUDA kernel (``csrc/lstm_scan.cu``) operation for
operation, as ``kernels/lstm_stack/ref.py`` is for the fused stack:
``h @ W_h`` is a sequential fp32 sum over k (``seq_dot``) of ``h`` and
``W_h`` widened to fp32, added to the streamed ``xw[t]``; the tail is the
shared ``cell_tail`` with an fp32 cell and ``h`` cast to its own dtype.
``lstm_scan_layer_ref`` first forms ``xw`` from the raw input the same
way: a sequential sum over k, rounded to the compute dtype, plus the bias.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.quant import sigmoid_exact, tanh_exact
from repro_torch.kernels.lstm_stack.ref import cell_tail, seq_dot


def lstm_scan_ref(
    xw: torch.Tensor,   # (T, B, 4H) fp32 (mvm_x output + bias)
    w_h: torch.Tensor,  # (H, 4H) fp32 or bf16
    h0: torch.Tensor,   # (B, H) compute dtype
    c0: torch.Tensor,   # (B, H) fp32
    *,
    sigma: Callable = sigmoid_exact,
    tanh: Callable = tanh_exact,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hs (T, B, H), h_final (B, H), c_final fp32 (B, H))."""
    w = w_h.to(torch.float32)
    h, c = h0, c0.to(torch.float32)
    out = []
    for t in range(xw.shape[0]):
        h, c = cell_tail(xw[t] + seq_dot(h.to(torch.float32), w), c, sigma, tanh,
                         None, h0.dtype)
        out.append(h)
    return torch.stack(out), h, c


def lstm_scan_layer_ref(
    xs: torch.Tensor,   # (B, T, IN) compute dtype
    w_x: torch.Tensor,  # (IN, 4H) fp32 or bf16
    b: torch.Tensor,    # (4H,) fp32
    w_h: torch.Tensor,  # (H, 4H)
    h0: torch.Tensor,   # (B, H) compute dtype
    c0: torch.Tensor,   # (B, H) fp32
    *,
    sigma: Callable = sigmoid_exact,
    tanh: Callable = tanh_exact,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``lstm_scan_ref`` over ``xw = round(xs @ W_x) + b``; returns
    (hs (T, B, H), h_final (B, H), c_final fp32 (B, H))."""
    gx = seq_dot(xs.to(torch.float32), w_x.to(torch.float32))
    xw = gx.to(h0.dtype).to(torch.float32) + b
    return lstm_scan_ref(xw.transpose(0, 1), w_h, h0, c0, sigma=sigma, tanh=tanh)
