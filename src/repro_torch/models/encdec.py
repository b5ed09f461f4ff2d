"""Encoder-decoder backbone (seamless-m4t-large-v2): the port of
``repro/models/encdec.py``.

The audio frontend is a stub, as in the reference: ``frontend_embeds``
delivers precomputed frame embeddings (B, S_enc, d) straight to the
encoder.  The encoder is bidirectional self-attention; the decoder is causal
self-attention, cross-attention over the encoder output and a SwiGLU MLP.

Each attention takes the branch the reference takes, since the two
packages only agree branch by branch:
- the encoder's self-attention: ``sdpa`` up to ``_FLASH_THRESHOLD``
  frames, non-causal ``flash_attention`` above it;
- ``forward``'s cross-attention: ``layers.attention``, which takes flash
  when max(S_dec, S_enc) > 1024;
- ``prefill``'s cross-attention: always plain ``sdpa``, whose K and V go
  into the cache at the encoder's length;
- ``decode_step``: self-attention through ``attention_decode(...,
  use_kernel=False)`` (the reference runs no kernel in this family), and
  cross-attention ``sdpa`` over the cached ``xk``/``xv``.

``decode_step`` writes each layer's new row and advances ``pos`` in place,
as ``transformer.decode_step`` does, so a step can be captured once and
replayed.  ``init_params`` draws on the target device, each stacked leaf
one layer at a time, as the dense transformer's does.  ``loss_fn`` scores
``forward``'s logits; every encoder and decoder layer is rematerialised
under grad, as the reference's are.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: encoder frames fed to cross-attention in decode shapes (~30 s of speech);
#: ``init_cache`` sizes the cross K/V with it, ``prefill`` at the encoder's length
ENC_LEN_DECODE = 4096


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_enc_layer(gen: torch.Generator, cfg: ArchConfig, n_layers: int) -> dict:
    lead = (n_layers,)
    return {
        "attn": L.init_attention(gen, cfg, lead=lead),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead),
        "ln1": torch.ones(*lead, cfg.d_model),
        "ln2": torch.ones(*lead, cfg.d_model),
    }


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig, n_layers: int) -> dict:
    lead = (n_layers,)
    return {
        "self_attn": L.init_attention(gen, cfg, lead=lead),
        "cross_attn": L.init_attention(gen, cfg, cross=True, lead=lead),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead),
        "ln1": torch.ones(*lead, cfg.d_model),
        "ln_x": torch.ones(*lead, cfg.d_model),
        "ln2": torch.ones(*lead, cfg.d_model),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed``, drawn on ``device``: the reference's
    tree, shapes, dtypes and scales (layers stacked along a leading axis)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "enc_layers": init_enc_layer(gen, cfg, cfg.n_enc_layers),
        "dec_layers": init_dec_layer(gen, cfg, cfg.n_layers),
        "ln_enc": torch.ones(cfg.d_model),
        "ln_f": torch.ones(cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg.dtype),
    }
    return L.tree_map(lambda t: t.to(dev), params)


def _frames(batch: dict, device: torch.device) -> torch.Tensor:
    if "frontend_embeds" not in batch:
        raise ValueError("encdec: the batch needs 'frontend_embeds', the encoder's frame "
                         "embeddings (B, S_enc, d_model), beside 'tokens'")
    return torch.as_tensor(batch["frontend_embeds"], device=device)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_layer(x, lp, cfg: ArchConfig, rope, ctx: L.ShardCtx = L.NO_SHARD):
    lp = ctx.gather(lp)
    # layers.attention takes the reference encoder's branches: non-causal
    # flash above T._FLASH_THRESHOLD (1024) frames, sdpa up to it
    x = x + L.attention(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope=rope,
                        causal=False, ctx=ctx)
    return L.constrain_residual(
        x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx), ctx)


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
           ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed frontend embeddings -> (B, S_enc, d);
    each layer rematerialised under grad."""
    x = torch.as_tensor(frames, device=params["embed"].device).to(cfg.dtype)
    rope = L.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_enc_layers):
        x = L.remat(_enc_layer, x, L.layer(params["enc_layers"], i), cfg, rope, ctx)
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder (forward / prefill)
# ---------------------------------------------------------------------------

def _dec_layer(x, lp, enc_out, cfg: ArchConfig, rope, ctx: L.ShardCtx = L.NO_SHARD):
    lp = ctx.gather(lp)
    out, _, _ = T._attn_full(lp["self_attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope,
                             ctx)
    x = x + out
    x = x + L.attention(lp["cross_attn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg,
                        rope=None, causal=False, x_kv=enc_out, ctx=ctx)
    return L.constrain_residual(
        x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx), ctx)


def forward(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """batch: {"frontend_embeds": (B, S_enc, d), "tokens": (B, S_dec)} ->
    logits (B, S_dec, V_padded); each layer rematerialised under grad.  A
    batch without frames raises ValueError."""
    params = L.gather_top(params, ctx)
    enc_out = encode(params, _frames(batch, params["embed"].device), cfg, ctx)
    x = T.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)
    rope = L.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = L.remat(_dec_layer, x, L.layer(params["dec_layers"], i), enc_out, cfg, rope, ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.head_logits(x, params["lm_head"], ctx)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder's logits."""
    return L.softmax_xent(forward(params, batch, cfg, ctx), batch["labels"], cfg.vocab)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> dict:
    """The decoder's self-attention K/V at ``max_len`` rows and the cross
    K/V at ``ENC_LEN_DECODE`` rows, as the reference sizes them (``prefill``
    returns the cross K/V at the encoder's length instead)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cross_shape = (cfg.n_layers, batch, ENC_LEN_DECODE, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
            "v": torch.zeros(self_shape, dtype=dtype, device=dev),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int | None = None,
            ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, dict]:
    """Encode the frames and process the decoder prompt; returns (last-token
    logits (B, 1, V_padded), the cache: self K/V filled up to S_dec of
    ``max(max_len, S_dec)`` rows, the cross K/V at the encoder's length,
    ``pos`` = S_dec)."""
    params = L.gather_top(params, ctx)
    enc_out = encode(params, _frames(batch, params["embed"].device), cfg, ctx)
    x = T.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)
    b, s, _ = x.shape
    s_enc = enc_out.shape[1]
    max_len = max(max_len or s, s)
    dev = x.device
    self_shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.hd)
    cross_shape = (cfg.n_layers, b, s_enc, cfg.n_kv_heads, cfg.hd)
    sharded = isinstance(x, DTensor)
    rows = {"k": [], "v": [], "xk": [], "xv": []}
    cache = None if sharded else {
        "k": torch.zeros(self_shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(self_shape, dtype=cfg.dtype, device=dev),
        "xk": torch.empty(cross_shape, dtype=cfg.dtype, device=dev),
        "xv": torch.empty(cross_shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    rope = L.rope_tables(torch.arange(s, device=dev), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = ctx.gather(L.layer(params["dec_layers"], i))
        out, k, v = T._attn_full(lp["self_attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 rope)
        x = x + out
        xn = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
        xq, xk, xv = L._proj_qkv(lp["cross_attn"], xn, enc_out, cfg)
        xq = ctx.constrain(xq, (ctx.batch_spec, None, ctx.model_axis, None))
        xout = L.attend(lambda q, k, v: L.sdpa(q, k, v, causal=False), xq, xk, xv)
        x = x + xout.reshape(b, s, cfg.n_heads * cfg.hd) @ lp["cross_attn"]["wo"]
        x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
        if sharded:
            for key, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                rows[key].append(t.to(cfg.dtype))
            continue
        cache["k"][i, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :s] = v.to(cfg.dtype)
        cache["xk"][i] = xk.to(cfg.dtype)
        cache["xv"][i] = xv.to(cfg.dtype)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    if sharded:
        cache = {key: L.stack_rows(rows[key], max_len if key in ("k", "v") else s_enc)
                 for key in rows}
        cache["pos"] = torch.zeros((), dtype=torch.int32)
    cache["pos"].fill_(s)
    return L.head_logits(x, params["lm_head"], ctx), cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, dict]:
    """One new decoder token against the cache; batch["tokens"]: (B, 1).
    Writes the token's self-attention K/V rows into ``cache`` and advances
    its ``pos`` in place (the caller keeps ``pos`` inside the cache:
    ``LmEngine`` checks it on the host) and returns (logits (B, 1,
    V_padded), the cache)."""
    x = T.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)  # (B, 1, d)
    b = x.shape[0]
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        lp = L.layer(params["dec_layers"], i)
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _, _ = L.attention_decode(lp["self_attn"], xn, cache["k"][i], cache["v"][i], pos,
                                       cfg, use_kernel=False)
        x = x + out
        xn = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
        xq = (xn @ lp["cross_attn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
        if isinstance(cache["xk"], DTensor):
            xout = L.split_decode_attend(xq, cache["xk"][i], cache["xv"][i])
        else:
            xout = L.sdpa(xq, cache["xk"][i], cache["xv"][i], causal=False)
        x = x + xout.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["cross_attn"]["wo"]
        x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    pos.add_(1)
    return L.head_logits(x, params["lm_head"], ctx), cache
