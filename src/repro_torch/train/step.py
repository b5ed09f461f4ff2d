"""The train step: loss and gradient (with microbatch accumulation), then
AdamW.

Gradients come from ``torch.autograd.grad`` on detached copies of the
parameters that require grad, the counterpart of the reference's
``jax.value_and_grad``: nothing accumulates into ``.grad``, the caller's
tensors need not require grad, and a leaf the loss does not reach gets a
zero gradient, as JAX gives it.  Microbatch gradients accumulate in fp32 in
microbatch order and are averaged once at the end.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def value_and_grad(loss_fn: Callable, params: Any, batch: Any) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree of ``loss_fn(params, batch)`` w.r.t. params)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], leaves)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """``loss_fn(params, batch) -> 0-d loss``; returns
    ``train_step(params, opt_state, batch) -> (loss, new params, new
    opt_state)``.  A batch is a tensor or a dict of tensors whose leading
    axes divide by ``microbatches``."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch of {x.shape[0]} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])

            mbs = tree_map(split, batch)
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params, tree_map(lambda x: x[i], mbs))
                loss = loss + l
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg)
        return loss, new_params, new_opt

    return train_step
