"""Attention over long sequences without an (S x S) tensor: the forward pass of
``repro/models/flash_attention.py``.

The reference writes blocked attention with an online softmax in jnp for
prefill above 1024 tokens.  Here the blocked forward is PyTorch's
``scaled_dot_product_attention`` (fused, no S x S score tensor on the card),
with GQA through ``enable_gqa`` (query head h reads KV head h // G, as the
reference's reshape into (Hkv, G) groups does) and causality as one of
PyTorch's implicit causal masks, never an explicit boolean S x S mask.

A sliding window is refused: it needs an explicit mask or a windowed ring,
which comes with the hybrid family's slice.  The backward pass (the
reference's custom VJP) comes with LM training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right


def _sdpa(q, k, v, mask=None, is_causal=False):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                          enable_gqa=q.shape[1] != k.shape[1])


def flash_attention(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, D)
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,          # absolute position of q[0]
) -> torch.Tensor:
    """Query i (at position q_offset + i) attends to keys j <= q_offset + i
    when causal, to every key otherwise.  Returns (B, Sq, Hq, D) in q's
    dtype."""
    if window is not None:
        raise ValueError(
            f"flash_attention: a sliding window (window={window}) above 1024 tokens "
            "is not ported yet; it comes with a later slice of the port: the hybrid "
            "family (ROADMAP queue 1, item 13)")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    if not causal:
        out = _sdpa(qt, kt, vt)
    else:
        stop = min(sk, sq + q_offset)  # keys past stop are never visible
        kt, vt = kt[:, :, :stop], vt[:, :, :stop]
        if stop == sq + q_offset:  # query i sees keys j <= i + (stop - sq)
            out = (_sdpa(qt, kt, vt, is_causal=True) if q_offset == 0
                   else _sdpa(qt, kt, vt, mask=causal_lower_right(sq, stop)))
        else:
            # the first m queries see a causal prefix; the rest see every key
            m = max(stop - 1 - q_offset, 0)
            parts = []
            if m:
                kv = m + q_offset
                parts.append(_sdpa(qt[:, :, :m], kt[:, :, :kv], vt[:, :, :kv],
                                   mask=causal_lower_right(m, kv)))
            parts.append(_sdpa(qt[:, :, m:], kt, vt))
            out = torch.cat(parts, dim=2)
    return out.transpose(1, 2).to(q.dtype)
