"""Plain oracle for single-query GQA attention with length masking: the
reference's ``decode_attn_ref`` (a softmax over the whole row, K and V
repeated to the query heads)."""

from __future__ import annotations

import torch


def decode_attn_ref(q, k, v, lengths):
    """q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,). -> (B, Hq, D)"""
    batch, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=2).float()  # (B, S, Hq, D)
    v = v.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) / d**0.5
    mask = torch.arange(s_len, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    scores = torch.where(mask, scores, -torch.inf)
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bhs,bshd->bhd", w, v).to(q.dtype)
