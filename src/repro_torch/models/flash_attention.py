"""Attention over long sequences without an (S x S) tensor: the forward pass of
``repro/models/flash_attention.py``.

The reference writes blocked attention with an online softmax in jnp for
prefill above 1024 tokens.  Here the blocked forward is PyTorch's
``scaled_dot_product_attention`` (fused, no S x S score tensor on the card),
with GQA through ``enable_gqa`` (query head h reads KV head h // G, as the
reference's reshape into (Hkv, G) groups does) and causality as one of
PyTorch's implicit causal masks, never an explicit boolean S x S mask.

With a sliding window (key j is visible from query i when j > i - window,
on top of causality and ``q_offset``, as the reference's block mask has
it) the queries go in blocks of ``_Q_BLOCK``, each against its band of at
most ``_Q_BLOCK + window - 1`` keys with an explicit band mask, and the
K/V heads of the band repeated for GQA: memory grows with S, never S x S.

The backward pass is ``scaled_dot_product_attention``'s own autograd, the
counterpart of the reference's custom VJP (``_flash_bwd``, the
FlashAttention-2 recurrences): on the card the fused backends recompute
the score tiles from the saved log-sum-exp instead of keeping S x S, which
is why the reference wrote its VJP.  Its gradients match the reference's
to about 1e-6 of their largest in fp32 (``tests/test_torch_lm_train.py``),
so no ``autograd.Function`` of this package stands in for it.  A training
shape that falls back to PyTorch's math backend would build S x S
silently: ``chip_smoke.py`` runs smollm-360m's training with that backend
disabled, so such a fallback raises there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

_Q_BLOCK = 512  # queries per block of the windowed path


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
    when causal, to every key otherwise, and only to keys j > q_offset + i -
    window when ``window`` is given.  Returns (B, Sq, Hq, D) in q's dtype."""
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    if window is not None:
        out = _windowed(qt, kt, vt, causal, window, q_offset)
    elif not causal:
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


def _windowed(qt, kt, vt, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    """The windowed path over (B, H, S, D) views: each block of queries
    against its band of keys, with the band mask."""
    sq, sk = qt.shape[2], kt.shape[2]
    if window < 1 or q_offset + sq - window >= sk:
        raise ValueError(f"flash_attention: window={window} leaves a query of the {sq} at "
                         f"q_offset={q_offset} with none of the {sk} keys")
    group = qt.shape[1] // kt.shape[1]
    parts = []
    for i0 in range(0, sq, _Q_BLOCK):
        i1 = min(i0 + _Q_BLOCK, sq)
        q_pos = torch.arange(q_offset + i0, q_offset + i1, device=qt.device)[:, None]
        lo = max(0, q_offset + i0 - window + 1)  # the band of keys the block can see
        hi = min(sk, q_offset + i1) if causal else sk
        k_pos = torch.arange(lo, hi, device=qt.device)[None, :]
        mask = k_pos > q_pos - window
        if causal:
            mask &= k_pos <= q_pos
        kb, vb = (t[:, :, lo:hi].repeat_interleave(group, dim=1) for t in (kt, vt))
        parts.append(F.scaled_dot_product_attention(qt[:, :, i0:i1], kb, vb, attn_mask=mask))
    return torch.cat(parts, dim=2)
