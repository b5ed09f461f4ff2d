"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from __future__ import annotations

import torch


def refuse_grad(entry: str, *tensors) -> None:
    """Raise where a forward-only kernel would be asked for a gradient.

    The LSTM kernels (and their plain versions, which stand in for them on
    the CPU) have no backward, as the reference's Pallas kernels have none:
    their outputs carry no ``grad_fn``, so a loss built on them would train
    only what lies outside them, and say nothing."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry} has no backward: an input or weight requires grad. Train "
            "through impl='split' (or 'naive'), as the reference does, or call "
            "it under torch.no_grad()")
