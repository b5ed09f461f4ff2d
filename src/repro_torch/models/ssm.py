"""Mamba-2 (SSD) blocks and the attention-free mamba2 model.

The port of ``repro/models/ssm.py``.  The block follows the Mamba-2
structure: one fused input projection to (z | x | B | C | dt), a short
causal depthwise conv over (x|B|C), softplus dt, the SSD scan (scalar decay
per head), D skip, silu(z) gating, RMSNorm, output projection.

The full-sequence scan (prefill) runs through ``ssd_scan_op``, the chunked
SSD kernel (K4), with chunk 64; ``use_kernel=False`` runs its plain
version ``ssd_chunked`` instead, the pure-jnp path the reference's
``ssm_block`` takes.  K4 has no backward (its wrapper raises when a
gradient is asked for), so ``loss_fn`` runs the forward on
``ssd_chunked``, as the reference's training does, each layer
rematerialised under grad.  Decode keeps O(1) state per token, (conv window, SSD
state), updated by ``ssd_decode_step`` in plain PyTorch.

The conventions that are easy to flip, as in the reference: ``causal_conv``
pairs the newest sample with ``w[:, k-1]`` (``ssm_block_decode`` flips
``conv_w`` for its window), the projection splits z | xBC | dt, and the conv
state keeps the raw, pre-conv xBC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_decode_step, ssd_scan_op
from repro_torch.models import layers as L


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), as ``jax.nn.softplus`` (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# depthwise causal conv (width K, shift-add form)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """x (B,T,Ch), w (Ch,K) -> (B,T,Ch). state (B,K-1,Ch) prepends history."""
    k = w.shape[1]
    if state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = sum(x_pad[:, i : i + t, :] * w[None, None, :, k - 1 - i] for i in range(k))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _dims(cfg: ArchConfig, hybrid_branch: bool):
    d_inner = cfg.d_model if hybrid_branch else cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_ch = d_inner + 2 * gn
    return d_inner, heads, gn, conv_ch


def init_ssm_block(gen: torch.Generator, cfg: ArchConfig, hybrid_branch: bool = False,
                   lead: tuple = ()) -> dict:
    d_inner, heads, gn, conv_ch = _dims(cfg, hybrid_branch)
    proj_out = 2 * d_inner + 2 * gn + heads  # z | x | B | C | dt
    return {
        "in_proj": L.dense_init(gen, cfg.d_model, proj_out, cfg.dtype, lead),
        "conv_w": torch.randn(*lead, conv_ch, cfg.conv_kernel, generator=gen) * 0.2,
        "a_log": torch.zeros(*lead, heads),        # A = -exp(a_log) = -1
        "d_skip": torch.ones(*lead, heads),
        "dt_bias": torch.zeros(*lead, heads),
        "norm": torch.ones(*lead, d_inner),
        "out_proj": L.dense_init(gen, d_inner, cfg.d_model, cfg.dtype, lead),
    }


def _split_proj(u: torch.Tensor, cfg: ArchConfig, hybrid_branch: bool):
    d_inner, heads, gn, _ = _dims(cfg, hybrid_branch)
    z = u[..., :d_inner]
    xbc = u[..., d_inner : 2 * d_inner + 2 * gn]
    dt_raw = u[..., 2 * d_inner + 2 * gn :]
    return z, xbc, dt_raw, (d_inner, heads, gn)


def ssm_block(
    p: dict, x_in: torch.Tensor, cfg: ArchConfig,
    hybrid_branch: bool = False, chunk: int = 64,
    state: dict | None = None, *, use_kernel: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence SSM block. Returns (out (B,T,d), final decode state)."""
    b, t, _ = x_in.shape
    u = x_in @ p["in_proj"]
    z, xbc_raw, dt_raw, (d_inner, heads, gn) = _split_proj(u, cfg, hybrid_branch)
    conv_state_in = None if state is None else state["conv"]
    xbc = F.silu(causal_conv(xbc_raw, p["conv_w"], conv_state_in))
    n, g = cfg.ssm_state, cfg.ssm_groups
    xh = xbc[..., :d_inner].reshape(b, t, heads, cfg.ssm_head_dim)
    bm = xbc[..., d_inner : d_inner + gn].reshape(b, t, g, n)
    cm = xbc[..., d_inner + gn :].reshape(b, t, g, n)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    s0 = None if state is None else state["ssd"]
    scan = ssd_scan_op if use_kernel else ssd_chunked
    y, s_f = scan(xh, dt, a, bm, cm, s0, chunk=chunk)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, d_inner).to(x_in.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    k = cfg.conv_kernel
    if state is not None:
        hist = torch.cat([state["conv"].to(xbc_raw.dtype), xbc_raw], dim=1)
    else:
        hist = F.pad(xbc_raw, (0, 0, k - 1, 0))
    new_state = {"conv": hist[:, -(k - 1):, :].float(), "ssd": s_f}
    return out, new_state


def ssm_block_decode(
    p: dict, x_in: torch.Tensor, state: dict, cfg: ArchConfig,
    hybrid_branch: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One-token decode: O(1) update of (conv window, SSD state)."""
    b = x_in.shape[0]
    u = x_in @ p["in_proj"]                       # (B, 1, proj)
    z, xbc, dt_raw, (d_inner, heads, gn) = _split_proj(u, cfg, hybrid_branch)
    conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    k = cfg.conv_kernel
    # causal_conv convention: the NEWEST sample pairs with w[:, 0] of the
    # flipped weights, rounded to the activations' dtype as the reference does
    xbc_c = F.silu(torch.einsum("bkc,ck->bc", conv_in[:, -k:, :],
                                p["conv_w"].flip(1).to(xbc.dtype)))[:, None, :]
    n, g = cfg.ssm_state, cfg.ssm_groups
    xh = xbc_c[..., :d_inner].reshape(b, heads, cfg.ssm_head_dim)
    bm = xbc_c[..., d_inner : d_inner + gn].reshape(b, g, n)
    cm = xbc_c[..., d_inner + gn :].reshape(b, g, n)
    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, s_new = ssd_decode_step(xh.float(), dt, a, bm.float(), cm.float(), state["ssd"])
    y = y + p["d_skip"][None, :, None] * xh.float()
    y = y.reshape(b, 1, d_inner).to(x_in.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    new_conv = conv_in[:, -(k - 1):, :].float()
    return out, {"conv": new_conv, "ssd": s_new}


def init_ssm_state(cfg: ArchConfig, batch: int, hybrid_branch: bool = False,
                   device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    d_inner, heads, gn, conv_ch = _dims(cfg, hybrid_branch)
    return {
        "conv": torch.zeros(batch, cfg.conv_kernel - 1, conv_ch, device=dev),
        "ssd": torch.zeros(batch, heads, cfg.ssm_head_dim, cfg.ssm_state, device=dev),
    }


# ---------------------------------------------------------------------------
# full mamba2 model (attention-free)
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed`` (drawn on the CPU, then moved).  As in
    the reference, the model has its own ``lm_head`` even where
    ``tie_embeddings`` is set."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    lead = (cfg.n_layers,)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "layers": {"ssm": init_ssm_block(gen, cfg, lead=lead),
                   "ln": torch.ones(*lead, cfg.d_model)},
        "ln_f": torch.ones(cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg.dtype),
    }
    return L.tree_map(lambda t: t.to(dev), params)


def _embed(params: dict, tokens) -> torch.Tensor:
    return L.embed_lookup(params["embed"], tokens)


def _layer_out(x, lp, cfg: ArchConfig, use_kernel: bool, ctx: L.ShardCtx):
    lp = ctx.gather(lp)
    h, _ = ssm_block(lp["ssm"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                     use_kernel=use_kernel)
    return L.constrain_residual(x + h, ctx)


def forward(params: dict, batch: dict, cfg: ArchConfig, ctx: L.ShardCtx = L.NO_SHARD, *,
            use_kernel: bool = True):
    """Full-sequence forward -> logits (B, S, V_padded); each layer
    rematerialised under grad."""
    params = L.gather_top(params, ctx)
    x = _embed(params, batch["tokens"])
    for i in range(cfg.n_layers):
        x = L.remat(_layer_out, x, L.layer(params["layers"], i), cfg, use_kernel, ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.head_logits(x, params["lm_head"], ctx)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Mean next-token cross-entropy; the scan on ``ssd_chunked``."""
    return L.softmax_xent(forward(params, batch, cfg, ctx, use_kernel=False), batch["labels"],
                          cfg.vocab)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device = "cuda") -> dict:
    """SSM 'cache' = per-layer (conv, ssd) state, O(1) in sequence length
    (``max_len`` and ``dtype`` are unused: the state is fp32)."""
    one = init_ssm_state(cfg, batch, device=device)
    return {"state": {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
                      for k, v in one.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=resolve_device(device))}


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int | None = None,
            ctx: L.ShardCtx = L.NO_SHARD, *, use_kernel: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """Process the prompt (the scan through K4 unless ``use_kernel`` is
    False); returns (last-token logits (B, 1, V_padded), the per-layer
    state)."""
    params = L.gather_top(params, ctx)
    x = _embed(params, batch["tokens"])
    s = x.shape[1]
    states = []
    for i in range(cfg.n_layers):
        lp = ctx.gather(L.layer(params["layers"], i))
        h, st = ssm_block(lp["ssm"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                          use_kernel=use_kernel)
        x = x + h
        states.append(st)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    state = {k: torch.stack([st[k] for st in states]) for k in ("conv", "ssd")}
    pos = torch.full((), s, dtype=torch.int32, device=x.device)
    return L.head_logits(x, params["lm_head"], ctx), {"state": state, "pos": pos}


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, dict]:
    """One new token; batch["tokens"]: (B, 1).  Updates the per-layer state
    in ``cache`` and advances its ``pos`` (a 0-d int32 tensor, as in the
    transformer's cache) in place.  Decode runs no kernel of this package."""
    x = _embed(params, batch["tokens"])
    state = cache["state"]
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        st = {"conv": state["conv"][i], "ssd": state["ssd"][i]}
        h, st = ssm_block_decode(lp["ssm"], L.rms_norm(x, lp["ln"], cfg.norm_eps), st, cfg)
        x = x + h
        state["conv"][i] = st["conv"]
        state["ssd"][i] = st["ssd"]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["pos"].add_(1)
    return L.head_logits(x, params["lm_head"], ctx), cache
