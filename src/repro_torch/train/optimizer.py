"""AdamW as functions on tensor trees, with the reference's semantics.

Not ``torch.optim.AdamW``: the reference clips by the global norm first,
follows a linear-warmup cosine schedule, decays only weights of two or more
dimensions, and adds the decay to the Adam direction before the learning
rate scales both.  Optimizer state is a tree ``{"m": ..., "v": ...,
"step": 0-d int32}`` mirroring the parameters, with fp32 moments whatever
the parameters' dtype.  Everything stays on the parameters' device and
nothing reads a value back to the host (the step counter, the schedule and
the bias corrections are tensors), so a whole step can be captured as one
CUDA graph.

A tree is a nested dict of tensors.  Leaves are taken in the reference's
order, dict keys sorted at every level (``repro_torch.tree``): the global
norm sums its squares in that order.

Optional gradient compression (bf16 with fp32 error feedback) is the
reference's too: gradients are cast down and the rounding error is fed
back at the next step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False  # bf16 gradients + error feedback


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``: a 0-d
    fp32 tensor on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params: Any, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments (fp32) and a 0-d int32 step counter, on the params'
    device."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    state = {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg is not None and cfg.compress_grads:
        state["err"] = tree_map(zeros32, params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, in leaf order, of each leaf's sum of squares."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """(fp32 grads scaled so their global norm is at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def compress_decompress(grads: Any, err: Any) -> tuple[Any, Any]:
    """bf16 round trip with error feedback: ``q = bf16(g + e)``,
    ``e' = g + e - q``."""
    summed = tree_map(lambda g, e: g.to(torch.float32) + e, grads, err)
    q = tree_map(lambda s: s.to(torch.bfloat16), summed)
    return q, tree_map(lambda s, qq: s - qq.to(torch.float32), summed, q)


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict]:
    """One AdamW step; returns (new params, new state), both fresh trees."""
    if cfg.compress_grads and "err" in state:
        grads, new_err = compress_decompress(grads, state["err"])
    else:
        new_err = state.get("err")
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)

    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}
    if new_err is not None:
        new_state["err"] = new_err
    return _pick(out, 0), new_state


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every tuple leaf of a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
