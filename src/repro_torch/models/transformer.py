"""Dense GQA decoder-only transformer (llama-style) and the VLM-backbone variant.

The port of ``repro/models/transformer.py``: yi-9b, qwen1.5-4b (QKV bias),
granite-3-2b, smollm-360m, llava-next-34b (precomputed frontend embeddings
spliced in front of the token embeddings).

Layer parameters keep the reference's stacked (L, ...) tree, so converting
the reference's params is a copy; the forward functions loop over the
layers and index the stack.  Prefill attends with ``sdpa`` up to
``_FLASH_THRESHOLD`` tokens and with ``flash_attention`` above it.  The KV
cache is (L, B, S_max, Hkv, D) per K and V plus the next position ``pos``,
a 0-d int32 tensor on the cache's device as in the reference: the decode
step reads it only with device ops, so a step can be captured once and
replayed (``serve/engine.LmEngine``).  ``decode_step`` writes each layer's
new row and advances ``pos`` in place and attends through the
decode-attention kernel (K5) unless the caller asks for the plain path or
the model has a sliding window.

``init_params`` draws on the target device, each stacked leaf one layer
at a time: at llava-next-34b's width a stacked fp32 MLP leaf would be
35.2 GB, and the bf16 weights alone are 68.8 GB.

``loss_fn`` is the training loss over ``forward``, whose layers run
through ``layers.remat`` under grad (the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.flash_attention import flash_attention

_FLASH_THRESHOLD = 1024  # use flash attention above this sequence length


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed``: the reference's shapes, dtypes and
    scales.  Every weight is drawn on ``device`` (a generator there, seeded
    from ``seed``), a stacked leaf one layer's matrix at a time, so the
    same seed gives other weights on the CPU than on the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (cfg.n_layers,)
    layers = {
        "attn": L.init_attention(gen, cfg, lead=lead),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead),
        "ln1": torch.ones(*lead, cfg.d_model),
        "ln2": torch.ones(*lead, cfg.d_model),
    }
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "layers": layers,
        "ln_f": torch.ones(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg.dtype)
    return L.tree_map(lambda t: t.to(dev), params)


def _head(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _attn_core(q, k, v, cfg: ArchConfig):
    if q.shape[1] > _FLASH_THRESHOLD:
        return flash_attention(q, k, v, True, cfg.sliding_window, 0)
    return L.sdpa(q, k, v, causal=True, window=cfg.sliding_window)


def _attn_full(p, x, cfg: ArchConfig, rope, ctx: L.ShardCtx = L.NO_SHARD):
    """Causal self-attention over the sequence; returns (out, k, v)."""
    b, s, _ = x.shape
    x = L.replicate_features(x, ctx)
    q, k, v = L._proj_qkv(p, x, x, cfg)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    q = ctx.constrain(q, (ctx.batch_spec, None, ctx.model_axis, None))
    out = L.attend(lambda q, k, v: _attn_core(q, k, v, cfg), q, k, v)
    return L.merge_heads(out) @ p["wo"], k, v


def _layer_fwd(x, lp, cfg: ArchConfig, rope, ctx: L.ShardCtx = L.NO_SHARD):
    """One block; returns (x, k, v) with this layer's K and V."""
    lp = ctx.gather(lp)
    out, k, v = _attn_full(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope, ctx)
    x = x + out
    x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
    # the carried residual stream sharded over "model" (ShardCtx.residual):
    # the remat stack (L, B, S, d) must not be replicated over the model axis
    return L.constrain_residual(x, ctx), k, v


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings, with frontend embeddings spliced in front (VLM)."""
    embed = params["embed"]
    x = L.embed_lookup(embed, batch["tokens"])
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = torch.as_tensor(batch["frontend_embeds"], device=embed.device).to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    return x


def _layer_out(x, lp, cfg: ArchConfig, rope, ctx: L.ShardCtx):
    return _layer_fwd(x, lp, cfg, rope, ctx)[0]


def forward(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Full-sequence causal LM forward -> logits (B, S, V_padded); each
    layer rematerialised under grad."""
    params = L.gather_top(params, ctx)
    x = embed_inputs(params, batch, cfg)
    s = x.shape[1]
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = L.remat(_layer_out, x, L.layer(params["layers"], i), cfg, rope, ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.head_logits(x, _head(params, cfg), ctx)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward`` against
    ``batch["labels"]``; with frontend embeddings (a VLM's patches) only
    the text tail is scored."""
    logits = forward(params, batch, cfg, ctx)
    labels = batch["labels"]
    if cfg.frontend is not None and "frontend_embeds" in batch:
        logits = logits[:, -labels.shape[1]:]
    return L.softmax_xent(logits, labels, cfg.vocab)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int | None = None,
            ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, dict]:
    """Process the whole prompt; returns (last-token logits (B, 1, V_padded),
    the cache filled up to the prompt length).  Prefill runs no kernel of
    this package."""
    params = L.gather_top(params, ctx)
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    sharded = isinstance(x, DTensor)
    cache = None if sharded else init_cache(cfg, b, max_len, device=x.device)
    ks, vs = [], []
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, k, v = _layer_fwd(x, L.layer(params["layers"], i), cfg, rope, ctx)
        if sharded:
            ks.append(k.to(cfg.dtype))
            vs.append(v.to(cfg.dtype))
        else:
            cache["k"][i, :, :s] = k.to(cfg.dtype)
            cache["v"][i, :, :s] = v.to(cfg.dtype)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    if sharded:
        cache = {"k": L.stack_rows(ks, max_len), "v": L.stack_rows(vs, max_len),
                 "pos": torch.zeros((), dtype=torch.int32)}
    cache["pos"].fill_(s)
    return L.head_logits(x, _head(params, cfg), ctx), cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                ctx: L.ShardCtx = L.NO_SHARD, *, use_kernel: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """One new token against the cache; batch["tokens"]: (B, 1).  Writes the
    token's K/V rows into ``cache`` and advances its ``pos`` in place (the
    caller keeps ``pos`` inside the cache: ``LmEngine`` checks it on the
    host) and returns (logits (B, 1, V_padded), the cache).  Attention runs
    through the decode-attention kernel when ``use_kernel`` and the model
    has no sliding window."""
    x = embed_inputs(params, {"tokens": batch["tokens"]}, cfg)  # (B, 1, d)
    pos = cache["pos"]
    kernel = use_kernel and cfg.sliding_window is None
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _, _ = L.attention_decode(lp["attn"], xn, cache["k"][i], cache["v"][i], pos,
                                       cfg, window=cfg.sliding_window, use_kernel=kernel)
        x = x + out
        x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    pos.add_(1)
    return L.head_logits(x, _head(params, cfg), ctx), cache
