"""Plain oracle for the SSD scan: the literal per-timestep recurrence, in
the reference kernel's folded (batch*heads, time, ...) layout."""

from __future__ import annotations

import torch


def ssd_scan_ref(
    x: torch.Tensor,      # (BH, T, P)
    dt: torch.Tensor,     # (BH, T)
    alpha: torch.Tensor,  # (BH, T)
    b: torch.Tensor,      # (BH, T, N)
    c: torch.Tensor,      # (BH, T, N)
    s0: torch.Tensor,     # (BH, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """S_t = exp(alpha_t) S_{t-1} + dt_t (x_t outer B_t);  y_t = S_t . C_t"""
    x32, dt32, al32 = x.float(), dt.float(), alpha.float()
    b32, c32 = b.float(), c.float()
    s = s0.float()
    ys = []
    for t in range(x.shape[1]):
        s = (torch.exp(al32[:, t])[:, None, None] * s
             + dt32[:, t, None, None] * x32[:, t, :, None] * b32[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", s, c32[:, t]))
    y = torch.stack(ys, dim=1) if ys else x32[:, :0]
    return y.to(x.dtype), s
