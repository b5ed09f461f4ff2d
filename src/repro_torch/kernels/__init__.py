"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from __future__ import annotations

import torch


def refuse_grad(entry: str, *tensors) -> None:
    """Raise where a forward-only kernel would be asked for a gradient.

    Every kernel here (and its plain version, which stands in for it on
    the CPU) is forward-only, as the reference's Pallas kernels are: a
    kernel's output carries no ``grad_fn``, so a loss built on it would
    train only what lies outside it, and say nothing.  The check runs
    before the dispatch to the CPU or the card, so a CPU test shows what
    the card would do; with grad off it costs nothing."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry} has no backward: an input or weight requires grad. Train "
            "through the plain path, as the reference does (impl='split' or "
            "'naive' for an LSTM stack, a model's loss_fn for an LM), or call "
            "it under torch.no_grad()")
