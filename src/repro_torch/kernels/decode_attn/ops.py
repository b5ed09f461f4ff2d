"""Wrapper for decode attention: argument normalisation and dispatch.

The reference's ``decode_attn_op`` pads S to a multiple of its block
(``jnp.pad`` of the whole cache on every call); here the kernel masks the
ragged last block itself, so the cache is passed as it is.
"""

from __future__ import annotations

import torch

from .decode_attn import decode_attn


def decode_attn_op(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid cache lengths, each in [1, S]
) -> torch.Tensor:
    """Returns the attention output (B, Hq, D) in q's dtype."""
    return decode_attn(q, k, v, lengths.to(device=q.device, dtype=torch.int32))
