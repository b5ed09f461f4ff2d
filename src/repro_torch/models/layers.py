"""Shared model building blocks: norms, RoPE, GQA attention, MLPs, embeddings.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors made by the ``init_*`` functions; every forward function is pure
except ``attention_decode``, which writes the new token's K and V into the
cache in place.  Each cast stands where the reference puts it, so bf16
models round at the same points: ``rms_norm`` accumulates x*x in fp32 and
normalises in the input dtype, ``apply_rope`` computes in fp32 and casts
back, ``_proj_qkv`` adds biases in fp32, ``sdpa`` forms scores and the
weighted sum in fp32 from operands at their own dtype (bf16 products are
exact in fp32), with the softmax weights rounded to V's dtype first.

``softmax_xent`` is the training loss and ``remat`` the per-layer
rematerialisation every family's ``forward`` runs its layers through (the
reference's ``jax.checkpoint``).  The reference's mesh code (``ShardCtx``,
``constrain_residual``) belongs to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# initializers (drawn on the explicit generator's device; ``lead`` stacks a
# leading axis, e.g. (n_layers,))
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, n_in: int, n_out: int, dtype: torch.dtype,
               lead: tuple = ()) -> torch.Tensor:
    """x @ W weights (*lead, n_in, n_out) at ``dtype`` on ``gen``'s device,
    drawn in fp32 one (n_in, n_out) matrix at a time: a stacked leaf is
    never held in fp32 (llava-next-34b's MLP leaves would be 35 GB)."""
    scale = (1.0 / n_in) ** 0.5
    out = torch.empty(*lead, n_in, n_out, dtype=dtype, device=gen.device)
    for idx in np.ndindex(*lead):
        out[idx] = torch.randn(n_in, n_out, generator=gen, device=gen.device).mul_(scale).to(dtype)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(vocab, d, generator=gen, device=gen.device).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: statistics accumulated in fp32, normalisation applied in the
    input dtype (bf16 products are exact in fp32)."""
    xf = x.float()
    ms = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv = torch.rsqrt(ms + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given integer positions: (..., head_dim/2) fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, cross: bool = False,
                   lead: tuple = ()) -> dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, cfg.dtype, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype, lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, cfg.dtype, lead),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(*lead, cfg.n_heads * hd)
        p["bk"] = torch.zeros(*lead, cfg.n_kv_heads * hd)
        p["bv"] = torch.zeros(*lead, cfg.n_kv_heads * hd)
    return p


def _proj_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor, cfg: ArchConfig):
    b, s = x.shape[:2]
    s_kv = x_kv.shape[1]
    hd = cfg.hd
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if "bq" in p:
        q = (q.float() + p["bq"]).to(q.dtype)
        k = (k.float() + p["bk"]).to(k.dtype)
        v = (v.float() + p["bv"]).to(v.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s_kv, cfg.n_kv_heads, hd)
    v = v.reshape(b, s_kv, cfg.n_kv_heads, hd)
    return q, k, v


def sdpa(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,              # (B, Sk, Hkv, D)
    *,
    causal: bool,
    q_offset: int | torch.Tensor = 0,        # absolute position of q[0] (decode)
    kv_len: int | torch.Tensor | None = None,  # valid cache length (masks padded tail)
    window: int | None = None,    # sliding-window width (tokens back)
) -> torch.Tensor:
    """Masked GQA scaled-dot-product attention (plain PyTorch).

    Returns (B, Sq, Hq, D).  GQA is computed by reshaping q heads into
    (Hkv, G) groups, with no repeat of K/V.  Scores and the weighted sum are
    fp32; masked entries take -1e30, as in the reference.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf.float(), k.float()) / d**0.5

    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= (k_pos < kv_len)[None, :]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    causal: bool = True,
    x_kv: torch.Tensor | None = None,   # cross-attention source
    window: int | None = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill)."""
    b, s, _ = x.shape
    q, k, v = _proj_qkv(p, x, x_kv if x_kv is not None else x, cfg)
    if rope is not None and x_kv is None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if max(s, k.shape[1]) > 1024:  # blocked path: no (Sq x Sk) tensor
        from repro_torch.models.flash_attention import flash_attention

        out = flash_attention(q, k, v, causal and x_kv is None, window, 0)
    else:
        out = sdpa(q, k, v, causal=causal and x_kv is None, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd)
    return out @ p["wo"]


def attention_decode(
    p: dict,
    x: torch.Tensor,              # (B, 1, d)
    cache_k: torch.Tensor,        # (B, S_max, Hkv, D): written in place at pos
    cache_v: torch.Tensor,
    pos: torch.Tensor | int,      # index of the new token (0-d int32 tensor)
    cfg: ArchConfig,
    *,
    window: int | None = None,
    ring: bool = False,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write this token's K/V into the cache at ``pos``
    (in place), attend over the valid prefix ``[0, pos]``.  ``pos`` is read
    with device ops only (no host copy), so the step can be captured in a
    CUDA graph; the caller keeps it inside the cache (``LmEngine`` checks
    the range on the host before the step).

    ``ring=True`` treats the cache as a ring of S_max slots (the hybrid
    family's window cache): the token goes to slot ``pos % S_max`` and
    attention runs over the first ``min(pos + 1, S_max)`` slots, with no
    window mask (every slot of a wrapped ring is inside the window).

    ``use_kernel=True`` runs the decode-attention kernel (K5), which has no
    window mask: a window with the kernel raises instead of being dropped
    (the reference's kernel branch drops it).  ``use_kernel=False`` runs
    ``sdpa`` over the whole cache with the length and window masks.

    Returns (out (B,1,d), cache_k, cache_v).
    """
    b = x.shape[0]
    hd = cfg.hd
    if use_kernel and window is not None:
        raise ValueError(
            f"attention_decode: the decode-attention kernel has no window mask "
            f"(window={window}); pass use_kernel=False for a windowed cache")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).reshape(1)
    q, k, v = _proj_qkv(p, x, x, cfg)
    cos, sin = rope_tables(pos, hd, cfg.rope_theta)  # (1, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = cache_k.shape[1]
    row = (pos % rows if ring else pos).long()
    cache_k.index_copy_(1, row, k.to(cache_k.dtype))
    cache_v.index_copy_(1, row, v.to(cache_v.dtype))
    kv_len = torch.clamp(pos + 1, max=rows) if ring else pos + 1
    if use_kernel:
        from repro_torch.kernels.decode_attn import decode_attn_op

        lengths = kv_len.expand(b).contiguous()
        out = decode_attn_op(q[:, 0], cache_k, cache_v, lengths)[:, None]
    else:
        out = sdpa(q, cache_k, cache_v, causal=False, q_offset=pos, kv_len=kv_len,
                   window=window)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
             lead: tuple = ()) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# training: the loss and per-layer rematerialisation
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels, valid_vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: logits (B, S, V_padded),
    labels (B, S) integers.  ``valid_vocab`` masks the padded vocabulary
    columns with -1e30, so the pad takes no probability mass."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    lf = logits.float()
    if valid_vocab is not None and valid_vocab < lf.shape[-1]:
        lf = torch.where(torch.arange(lf.shape[-1], device=lf.device) < valid_vocab, lf, -1e30)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def remat(fn, *args):
    """``fn(*args)``, one layer of a forward.  Under grad the layer keeps
    only its inputs and recomputes its activations in the backward, as the
    reference's ``jax.checkpoint`` does; with grad off (prefill, serving
    graphs) it is the plain call.  No layer draws random numbers, so no
    RNG state is saved (saving the CUDA one fails inside a graph capture)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree (views, no copy)."""
    return tree_map(lambda t: t[i], stacked)
