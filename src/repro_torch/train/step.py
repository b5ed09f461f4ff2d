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
from torch.distributed.tensor import DTensor

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


def _split_sharded(x: DTensor, microbatches: int) -> list:
    """Microbatches of a DTensor batch, each a DTensor placed as ``x``: each
    rank splits its own rows, so a batch sharded over the data axes stays
    sharded (a global reshape would gather it).  Microbatch i then holds
    each shard's i-th slice of rows rather than the batch's i-th slice;
    every row is in one microbatch, so the averaged loss and gradient are
    the same sums."""
    local = x.to_local()
    if local.shape[0] % microbatches:
        raise ValueError(f"a shard of {local.shape[0]} rows does not split into "
                         f"{microbatches} microbatches")
    shape = (x.shape[0] // microbatches, *x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                               shape=shape, stride=stride)
            for part in local.reshape(microbatches, -1, *local.shape[1:]).unbind(0)]


def accumulate(loss_fn: Callable, params: Any, batch: Any,
               microbatches: int = 1) -> tuple[torch.Tensor, Any]:
    """(mean loss, mean gradient) over ``microbatches`` slices of the
    batch's leading axes; fp32 accumulation in microbatch order."""
    if microbatches == 1:
        return value_and_grad(loss_fn, params, batch)

    def split(x):
        if x.shape[0] % microbatches:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{microbatches} microbatches")
        if isinstance(x, DTensor):
            return _split_sharded(x, microbatches)
        return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])

    mbs = tree_map(split, batch)
    loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for i in range(microbatches):
        l, g = value_and_grad(loss_fn, params, tree_map(lambda x: x[i], mbs))
        loss = loss + l
        grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
    return loss / microbatches, tree_map(lambda g: g / microbatches, grads)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """``loss_fn(params, batch) -> 0-d loss``; returns
    ``train_step(params, opt_state, batch) -> (loss, new params, new
    opt_state)``.  A batch is a tensor or a dict of tensors whose leading
    axes divide by ``microbatches``."""

    def train_step(params, opt_state, batch):
        loss, grads = accumulate(loss_fn, params, batch, microbatches)
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg)
        return loss, new_params, new_opt

    return train_step
