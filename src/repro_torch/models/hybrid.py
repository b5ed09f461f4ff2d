"""Hymba-style hybrid blocks (hymba-1.5b): the port of ``repro/models/hybrid.py``.

Each layer runs a GQA attention branch and a Mamba-2 SSM branch in
parallel on the same normed input; each branch's output is RMS-normed
(``norm_attn``, ``norm_ssm``) and the two are averaged, then a SwiGLU MLP
follows.  Attention is sliding-window (``cfg.sliding_window``) in every
layer.

Serving keeps a ring of ``w = min(window, max_len)`` KV slots per layer
beside the SSM state: position ``pos`` lives in slot ``pos % w``.  Prefill
writes the last ``min(w, S)`` prompt positions into their slots; a decode
step writes its token at ``pos % w`` (a device index) and attends over the
first ``min(pos + 1, w)`` slots with no window mask: once the ring has
wrapped every slot holds one of the last ``w`` positions, RoPE was applied
at write time, and softmax does not care about slot order.  So decode
attention is K5 with ``lengths = min(pos + 1, w)`` per row.  The SSM
branch is ``ssm.ssm_block`` (the scan through K4 in prefill) and
``ssm.ssm_block_decode`` with ``hybrid_branch=True``.  ``loss_fn``, as
the reference's training, runs the scan on ``ssd_chunked``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def init_params(cfg: ArchConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed`` (drawn on the CPU, then moved); the
    reference's shapes, dtypes and scales."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    lead = (cfg.n_layers,)
    layers = {
        "attn": L.init_attention(gen, cfg, lead=lead),
        "ssm": S.init_ssm_block(gen, cfg, hybrid_branch=True, lead=lead),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead),
        **{name: torch.ones(*lead, cfg.d_model)
           for name in ("ln1", "ln2", "norm_attn", "norm_ssm")},
    }
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "layers": layers,
        "ln_f": torch.ones(cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg.dtype),
    }
    return L.tree_map(lambda t: t.to(dev), params)


def _mix(lp: dict, a_out: torch.Tensor, s_out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return 0.5 * (L.rms_norm(a_out, lp["norm_attn"], cfg.norm_eps)
                  + L.rms_norm(s_out, lp["norm_ssm"], cfg.norm_eps))


def _fused_branches(lp: dict, xn: torch.Tensor, cfg: ArchConfig, rope, use_kernel: bool,
                    ctx: L.ShardCtx = L.NO_SHARD):
    """Both branches over the sequence: (mixed output, k, v, SSM state)."""
    a_out, k, v = T._attn_full(lp["attn"], xn, cfg, rope, ctx)
    s_out, state = S.ssm_block(lp["ssm"], xn, cfg, hybrid_branch=True, use_kernel=use_kernel)
    return _mix(lp, a_out, s_out, cfg), k, v, state


def _layer_fwd(x, lp, cfg: ArchConfig, rope, use_kernel: bool, ctx: L.ShardCtx = L.NO_SHARD):
    """One block; returns (x, k, v, SSM state)."""
    lp = ctx.gather(lp)
    mixed, k, v, state = _fused_branches(lp, L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, rope,
                                         use_kernel, ctx)
    x = x + mixed
    x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
    return L.constrain_residual(x, ctx), k, v, state


def _layer_out(x, lp, cfg: ArchConfig, rope, use_kernel: bool, ctx: L.ShardCtx):
    return _layer_fwd(x, lp, cfg, rope, use_kernel, ctx)[0]


def forward(params: dict, batch: dict, cfg: ArchConfig, ctx: L.ShardCtx = L.NO_SHARD, *,
            use_kernel: bool = True):
    """Full-sequence forward -> logits (B, S, V_padded); each layer
    rematerialised under grad."""
    params = L.gather_top(params, ctx)
    x = T.embed_inputs(params, batch, cfg)
    s = x.shape[1]
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = L.remat(_layer_out, x, L.layer(params["layers"], i), cfg, rope, use_kernel, ctx)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.head_logits(x, params["lm_head"], ctx)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            ctx: L.ShardCtx = L.NO_SHARD) -> torch.Tensor:
    """Mean next-token cross-entropy; the SSM branch's scan on ``ssd_chunked``."""
    return L.softmax_xent(forward(params, batch, cfg, ctx, use_kernel=False), batch["labels"],
                          cfg.vocab)


# ---------------------------------------------------------------------------
# serving: ring-buffer window KV cache + SSM state
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> dict:
    """A ring of ``min(window, max_len)`` KV slots per layer, the per-layer
    SSM state and ``pos`` (a 0-d int32 tensor): decode memory is bounded by
    the window, whatever the sequence length."""
    dev = resolve_device(device)
    w = min(cfg.sliding_window or max_len, max_len)
    shape = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.hd)
    one = S.init_ssm_state(cfg, batch, hybrid_branch=True, device=dev)
    return {"k": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "state": {k: v[None].repeat(cfg.n_layers, *([1] * v.dim())) for k, v in one.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _write_ring(dst: torch.Tensor, t: torch.Tensor) -> None:
    """Write the last min(w, S) positions of t (B, S, ...) at their slots
    (pos % w) of the zeroed ring dst (B, w, ...)."""
    s, w = t.shape[1], dst.shape[1]
    if s <= w:
        dst[:, :s] = t
    else:
        dst.copy_(torch.roll(t[:, s - w:], (s - w) % w, dims=1))


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int | None = None,
            ctx: L.ShardCtx = L.NO_SHARD, *, use_kernel: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """Process the prompt (the SSM scan through K4 unless ``use_kernel`` is
    False); returns (last-token logits (B, 1, V_padded), the cache: ring,
    SSM state and ``pos``)."""
    params = L.gather_top(params, ctx)
    x = T.embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    sharded = isinstance(x, DTensor)
    cache = None if sharded else init_cache(cfg, b, max_len, device=x.device)
    rows = {"k": [], "v": [], "conv": [], "ssd": []}
    rope = L.rope_tables(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, k, v, state = _layer_fwd(x, L.layer(params["layers"], i), cfg, rope, use_kernel, ctx)
        if sharded:
            w = min(cfg.sliding_window or max_len, max_len)
            for key, t in (("k", k), ("v", v)):
                t = t.to(cfg.dtype)
                rows[key].append(t[:, s - w:].roll((s - w) % w, 1) if s > w else t)
            rows["conv"].append(state["conv"])
            rows["ssd"].append(state["ssd"])
            continue
        _write_ring(cache["k"][i], k.to(cfg.dtype))
        _write_ring(cache["v"][i], v.to(cfg.dtype))
        for key in ("conv", "ssd"):
            cache["state"][key][i] = state[key]
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    if sharded:
        w = min(cfg.sliding_window or max_len, max_len)
        cache = {"k": L.stack_rows(rows["k"], w), "v": L.stack_rows(rows["v"], w),
                 "state": {key: torch.stack(rows[key]) for key in ("conv", "ssd")},
                 "pos": torch.zeros((), dtype=torch.int32)}
    cache["pos"].fill_(s)
    return L.head_logits(x, params["lm_head"], ctx), cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                ctx: L.ShardCtx = L.NO_SHARD, *, use_kernel: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """One new token; batch["tokens"]: (B, 1).  Writes the token's K/V at
    its ring slot, updates the SSM state and advances ``pos``, all in place;
    attention through K5 unless ``use_kernel`` is False."""
    x = T.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)  # (B, 1, d)
    pos, state = cache["pos"], cache["state"]
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a_out, _, _ = L.attention_decode(lp["attn"], xn, cache["k"][i], cache["v"][i], pos, cfg,
                                         ring=True, use_kernel=use_kernel)
        s_out, st = S.ssm_block_decode(lp["ssm"], xn, {k: v[i] for k, v in state.items()}, cfg,
                                       hybrid_branch=True)
        x = x + _mix(lp, a_out, s_out, cfg)
        x = x + L.mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
        for key in ("conv", "ssd"):
            state[key][i] = st[key]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    pos.add_(1)
    return L.head_logits(x, params["lm_head"], ctx), cache
