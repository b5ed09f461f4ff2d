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
from torch.distributed.tensor import DTensor, Shard

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


def _routed(p: dict, x: torch.Tensor, cfg: ArchConfig, experts: tuple | None = None):
    """The routed experts on tokens x (G, S, d): (out (G, S, d), the share
    of first choices per expert, the mean router probability per expert).
    ``experts = (lo, hi)``: ``p`` holds only those experts' weights, and
    ``out`` sums only their outputs (a rank's part of an expert-sharded
    layer); the routing is always over all experts."""
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
    if experts is not None:
        combine = combine[:, :, experts[0]:experts[1]]
    dispatch = (combine > 0).to(cfg.dtype)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, x.to(cfg.dtype))
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(cfg.dtype), ye)
    return out, oh_e[:, :, 0].mean(dim=(0, 1)), probs.mean(dim=(0, 1))


def _routed_sharded(p: dict, x: DTensor, cfg: ArchConfig, ctx: L.ShardCtx):
    """``_routed`` on DTensors, on each rank's groups (``local_map``).  The
    groups stay sharded over x's batch axes; the model axis splits the
    experts where it divides them (the reference's ``xe`` constraint over
    (batch, model)), else each expert's ``d_ff``, else nothing; either split
    leaves ``out`` a partial sum over the model axis.  The router's shares
    for the aux loss are taken on the DTensors (a second routing), so
    their gradient reaches the router once, not once per model rank."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    batch = [i for i, pl in enumerate(x.placements) if pl == Shard(0)]
    m_dim = names.index(ctx.model_axis) if ctx.model_axis in names else None
    n_model = mesh.size(m_dim) if m_dim is not None and m_dim not in batch else 1
    split = ("experts" if n_model > 1 and cfg.n_experts % n_model == 0 else
             "ff" if n_model > 1 and cfg.d_ff % n_model == 0 else None)

    def on(pl_model, pl_batch=Replicate()):
        return tuple(pl_model if i == m_dim and split else pl_batch if i in batch
                     else Replicate() for i in range(mesh.ndim))

    xpl = on(Replicate(), Shard(0))
    rep = on(Replicate())
    w_in, w_out = {"experts": (Shard(0), Shard(0)), "ff": (Shard(2), Shard(1)),
                   None: (Replicate(), Replicate())}[split]
    lo = mesh.get_coordinate()[m_dim] * (cfg.n_experts // n_model) if split == "experts" else 0
    experts = (lo, lo + cfg.n_experts // n_model) if split == "experts" else None

    def local(x, router, w_gate, w_up, w_down):
        return _routed({"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                       x, cfg, experts)[0]

    w_pl = (rep, on(w_in), on(w_in), on(w_out))
    # gradients of a rank's inputs cover only its own groups (a partial sum
    # over the batch axes) and, when the model axis splits the layer, only
    # its own experts or d_ff slice (a partial sum over that axis too)
    split_grad = Partial() if split else Replicate()
    w_grad = tuple(tuple(Partial() if i in batch
                         else split_grad if i == m_dim and p == Replicate() else p
                         for i, p in enumerate(pl)) for pl in w_pl)
    out = local_map(local, out_placements=[*on(Partial(), Shard(0))],
                    in_placements=(xpl, *w_pl), in_grad_placements=(on(split_grad, Shard(0)), *w_grad),
                    device_mesh=mesh, redistribute_inputs=True)(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    # the router's shares for the aux loss, on the DTensors themselves
    probs, _, top_i = route(p, x, cfg)
    first = (top_i[..., 0, None] == torch.arange(cfg.n_experts, device=x.device)).float()
    return out, first.mean(dim=(0, 1)), probs.mean(dim=(0, 1))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, torch.Tensor]:
    """x (G, S, d) -> (out (G, S, d), aux_loss 0-d fp32)."""
    routed = _routed_sharded(p, x, cfg, ctx) if isinstance(x, DTensor) else _routed(p, x, cfg)
    out, frac_tokens, frac_probs = routed
    if "shared" in p:
        out = out + L.mlp(p["shared"], x, ctx)
    # Switch load-balance loss: the share of first choices times the mean
    # probability, per expert
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# model: forward / serving
# ---------------------------------------------------------------------------

def _layer_fwd(x, lp, cfg: ArchConfig, rope, ctx: L.ShardCtx = L.NO_SHARD):
    """One block; returns (x, aux, k, v)."""
    lp = ctx.gather(lp)
    out, k, v = T._attn_full(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope,
                             ctx)
    x = x + out
    h, aux = moe_ffn(lp["moe"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
    return L.constrain_residual(x + h, ctx), aux, k, v


def _layer_out(x, lp, cfg: ArchConfig, rope, ctx: L.ShardCtx):
    return _layer_fwd(x, lp, cfg, rope, ctx)[:2]


def forward(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, V_padded), mean aux loss per
    layer); each layer rematerialised under grad."""
    params = L.gather_top(params, ctx)
    x = T.embed_inputs(params, batch, cfg)
    s = x.shape[1]
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, a = L.remat(_layer_out, x, L.layer(params["layers"], i), cfg, rope, ctx)
        aux = aux + a
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.head_logits(x, params["lm_head"], ctx), aux / cfg.n_layers


#: weight of the Switch load-balance loss in ``loss_fn``, as the reference's
AUX_COEF = 1e-2


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Next-token cross-entropy plus ``AUX_COEF`` x the aux loss."""
    logits, aux = forward(params, batch, cfg, ctx)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab) + AUX_COEF * aux


init_cache = T.init_cache  # the dense transformer's KV cache


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int | None = None,
            ctx: L.ShardCtx = L.NO_SHARD) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-token logits (B, 1, V_padded), the
    KV cache filled up to the prompt length).  Prefill runs no kernel of
    this package."""
    params = L.gather_top(params, ctx)
    x = T.embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    sharded = isinstance(x, DTensor)
    cache = None if sharded else init_cache(cfg, b, max_len, device=x.device)
    ks, vs = [], []
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, _, k, v = _layer_fwd(x, L.layer(params["layers"], i), cfg, rope, ctx)
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
    return L.head_logits(x, params["lm_head"], ctx), cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                ctx: L.ShardCtx = L.NO_SHARD, *, use_kernel: bool = True
                ) -> tuple[torch.Tensor, dict]:
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
        h, _ = moe_ffn(lp["moe"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
        x = x + h
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    pos.add_(1)
    return L.head_logits(x, params["lm_head"], ctx), cache
