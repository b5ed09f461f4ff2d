"""Wrappers for the SSD scan: argument normalisation and dispatch, and the
one-token decode step.

The reference's ``ssd_scan_op`` folds heads into the batch, repeats B and C
to H heads (``jnp.repeat``) and pads T to a chunk multiple; the kernel here
reads the model layout, indexes the groups and runs the ragged last chunk
itself, so ``ssd_scan_op`` only settles dtypes.
"""

from __future__ import annotations

import torch

from .ssd_scan import ssd_scan


def ssd_scan_op(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H)
    a: torch.Tensor,      # (H,) negative decay rates
    b: torch.Tensor,      # (B, T, G, N)   G groups (G divides H)
    c: torch.Tensor,      # (B, T, G, N)
    s0: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, T, H, P) in x's dtype, s_final: (B, H, P, N) fp32)."""
    f32 = torch.float32
    return ssd_scan(x, dt.to(f32), a.to(f32), b.to(x.dtype), c.to(x.dtype),
                    None if s0 is None else s0.to(f32), chunk=chunk)


def ssd_decode_step(
    x: torch.Tensor,      # (B, H, P) one token
    dt: torch.Tensor,     # (B, H)
    a: torch.Tensor,      # (H,)
    b: torch.Tensor,      # (B, G, N)
    c: torch.Tensor,      # (B, G, N)
    s: torch.Tensor,      # (B, H, P, N) running state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-step recurrence for decode (plain PyTorch: one step has no
    scan).  The SSM analogue of the KV-cache append: an O(1) state update
    per token."""
    heads, groups = x.shape[1], b.shape[1]
    rep = heads // groups
    b_h = b.repeat_interleave(rep, dim=1)  # (B, H, N)
    c_h = c.repeat_interleave(rep, dim=1)
    alpha = dt * a[None, :]  # (B, H)
    s_new = (
        torch.exp(alpha)[:, :, None, None] * s
        + dt[:, :, None, None] * x[:, :, :, None] * b_h[:, :, None, :]
    )
    y = torch.einsum("bhpn,bhn->bhp", s_new, c_h)
    return y.to(x.dtype), s_new
