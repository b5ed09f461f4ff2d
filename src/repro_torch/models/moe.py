"""Mixture-of-Experts transformer (qwen2-moe-a2.7b, dbrx-132b): the port of
``repro/models/moe.py``.

Expert FFNs use the reference's capacity-based dense dispatch: one group
per batch row, each token routed to its top-k experts with a per-expert
capacity ``C = capacity(cfg, S)``, dispatch and combine as one-hot einsums
over (G, S, E, C).  A choice whose slot in its expert's buffer is ``>= C``
is dropped.  At a decode step each group holds one token, so C = 1 and
every expert runs for every row: the step reads all the expert weights, as
the reference's does.  qwen2-moe's shared experts are one dense SwiGLU of
width ``n_shared * d_ff`` beside the routed ones.

Routing as the reference does it: fp32 router logits, softmax, top-k with
the lower expert index first among equal probabilities (a stable sort, so
the CPU and the card order ties alike), each (token, choice)'s slot from a
cumulative count in (s, k) priority order.  Nothing in ``moe_ffn`` reads a
value back to the host or makes a shape from data, so prefill and decode
can be captured as CUDA graphs.  The expert products and the shared SwiGLU
are plain ``torch.einsum``/``matmul`` (the reference runs them outside any
Pallas kernel); decode attention runs through K5 as the dense
transformer's does.  ``aux`` is the Switch load-balance loss, which
``loss_fn`` adds at ``AUX_COEF``.

Attention, embeddings and the KV cache are the dense transformer's.
``init_params`` draws the routed experts on the target device, one layer
at a time, cast to the model dtype as drawn: at qwen2-moe's full width a
stacked fp32 expert leaf would be 16.6 GB, and the CPU's generator would
take minutes over the 14 B values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _expert_leaf(gen: torch.Generator, n_layers: int, shape: tuple, scale: float,
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(n_layers, *shape) at ``dtype`` on ``device``, drawn a layer at a time."""
    out = torch.empty(n_layers, *shape, dtype=dtype, device=device)
    for i in range(n_layers):
        out[i] = (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)
    return out


def init_moe_ffn(gen: torch.Generator, expert_gen: torch.Generator, cfg: ArchConfig,
                 n_layers: int, device: torch.device) -> dict:
    """The routed FFN of ``n_layers`` layers: the fp32 router and the shared
    SwiGLU from ``gen`` (CPU), the experts from ``expert_gen`` on ``device``."""
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = (1.0 / d) ** 0.5
    p = {
        "router": torch.randn(n_layers, d, e, generator=gen) * scale,  # fp32 (routing)
        "w_gate": _expert_leaf(expert_gen, n_layers, (e, d, ff), scale, cfg.dtype, device),
        "w_up": _expert_leaf(expert_gen, n_layers, (e, d, ff), scale, cfg.dtype, device),
        "w_down": _expert_leaf(expert_gen, n_layers, (e, ff, d), (1.0 / ff) ** 0.5,
                               cfg.dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, d, cfg.n_shared_experts * ff, cfg.dtype, (n_layers,))
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed``: the reference's shapes, dtypes and
    scales.  The routed experts are drawn on ``device`` (a generator there,
    seeded from ``seed``), the rest on the CPU and moved."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    expert_gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (cfg.n_layers,)
    layers = {
        "attn": L.init_attention(gen, cfg, lead=lead),
        "moe": init_moe_ffn(gen, expert_gen, cfg, cfg.n_layers, dev),
        "ln1": torch.ones(*lead, cfg.d_model),
        "ln2": torch.ones(*lead, cfg.d_model),
    }
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "layers": layers,
        "ln_f": torch.ones(cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg.dtype),
    }
    return L.tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# routed FFN
# ---------------------------------------------------------------------------

def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: the reference's float floor division, as is."""
    c = -(-tokens_per_group * cfg.top_k * cfg.moe_capacity_factor // cfg.n_experts)
    return max(int(c), 1)


def route(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x (G, S, d) -> (probs (G, S, E) fp32, top_p, top_i (G, S, k)): the
    top-k experts of each token, by probability, the lower index first
    among equal ones (``jax.lax.top_k``'s order)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top_p[..., : cfg.top_k], top_i[..., : cfg.top_k]


def slots(top_i: torch.Tensor, n_experts: int, c: int):
    """Each (token, choice)'s slot in its expert's buffer, counted in (s, k)
    priority order, and whether it is kept (slot < c): (pos, keep), (G, S, k)."""
    g, s, k = top_i.shape
    choice = (top_i[..., None] == torch.arange(n_experts, device=top_i.device)).to(torch.int32)
    flat = choice.reshape(g, s * k, n_experts)
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1).reshape(g, s, k)
    return pos, pos < c


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (G, S, d) -> (out (G, S, d), aux_loss 0-d fp32)."""
    g, s, d = x.shape
    e = cfg.n_experts
    c = capacity(cfg, s)
    probs, top_p, top_i = route(p, x, cfg)
    pos, keep = slots(top_i, e, c)

    # combine[g,s,e,c] = prob of the kept (s -> e, slot c) assignment; a
    # token's k choices name k different experts, so the sum over k adds
    # one term and zeros
    oh_e = (top_i[..., None] == torch.arange(e, device=x.device)).float()   # (G,S,k,E)
    oh_c = (pos[..., None] == torch.arange(c, device=x.device)).float()     # (G,S,k,C)
    combine = torch.einsum("gsk,gske,gskc->gsec", top_p * keep, oh_e, oh_c)
    dispatch = (combine > 0).to(cfg.dtype)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, x.to(cfg.dtype))
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(cfg.dtype), ye)

    if "shared" in p:
        out = out + L.mlp(p["shared"], x)

    # Switch load-balance loss: the share of first choices times the mean
    # probability, per expert
    frac_tokens = oh_e[:, :, 0].mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# model: forward / serving
# ---------------------------------------------------------------------------

def _layer_fwd(x, lp, cfg: ArchConfig, rope):
    """One block; returns (x, aux, k, v)."""
    out, k, v = T._attn_full(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope)
    x = x + out
    h, aux = moe_ffn(lp["moe"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + h, aux, k, v


def _layer_out(x, lp, cfg: ArchConfig, rope):
    return _layer_fwd(x, lp, cfg, rope)[:2]


def forward(params: dict, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, V_padded), mean aux loss per
    layer); each layer rematerialised under grad."""
    x = T.embed_inputs(params, batch, cfg)
    s = x.shape[1]
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, a = L.remat(_layer_out, x, L.layer(params["layers"], i), cfg, rope)
        aux = aux + a
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], aux / cfg.n_layers


#: weight of the Switch load-balance loss in ``loss_fn``, as the reference's
AUX_COEF = 1e-2


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross-entropy plus ``AUX_COEF`` x the aux loss."""
    logits, aux = forward(params, batch, cfg)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab) + AUX_COEF * aux


init_cache = T.init_cache  # the dense transformer's KV cache


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-token logits (B, 1, V_padded), the
    KV cache filled up to the prompt length).  Prefill runs no kernel of
    this package."""
    x = T.embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=x.device)
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, _, k, v = _layer_fwd(x, L.layer(params["layers"], i), cfg, rope)
        cache["k"][i, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :s] = v.to(cfg.dtype)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    cache["pos"].fill_(s)
    return x @ params["lm_head"], cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                *, use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """One new token against the cache; batch["tokens"]: (B, 1).  Writes
    each layer's K/V row and advances ``pos`` in place, as the dense
    transformer's ``decode_step`` does; attention through K5 unless
    ``use_kernel`` is False."""
    x = T.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)  # (B, 1, d)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _, _ = L.attention_decode(lp["attn"], xn, cache["k"][i], cache["v"][i], pos, cfg,
                                       use_kernel=use_kernel)
        x = x + out
        h, _ = moe_ffn(lp["moe"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        x = x + h
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    pos.add_(1)
    return x @ params["lm_head"], cache
