"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``ModelApi`` with the entry points a family's
serving and training paths need.  The port has every family of the
reference: ``dense`` (with the VLM backbone), ``moe``, ``ssm``, ``hybrid``
and ``encdec``.  ``cache_rows`` says how many cache rows a request takes.
``forward`` returns logits only, as the reference's does
(MoE's own ``forward`` returns ``(logits, aux)``).  ``loss_fn`` is the
training loss on the reference's training path: plain PyTorch with each
layer rematerialised, never a kernel of this package (none has a
backward).  The reference's ``input_specs`` and ``abstract_*`` helpers
belong to the dry run, which comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, moe, ssm, transformer


@dataclass(frozen=True)
class ModelApi:
    family: str
    init_params: Callable    # (cfg, seed, device) -> params
    forward: Callable        # (params, batch, cfg) -> logits
    prefill: Callable        # (params, batch, cfg, max_len) -> (logits, cache)
    decode_step: Callable    # (params, cache, batch, cfg) -> (logits, cache)
    init_cache: Callable     # (cfg, batch, max_len, dtype, device) -> cache
    loss_fn: Callable        # (params, batch, cfg) -> 0-d fp32 loss
    kernel_entry: tuple      # of "prefill", "decode_step": the ones that take use_kernel
    ring_cache: bool         # the KV cache is a ring: a position may pass its rows


#: per family: its module, the entry points through which it reaches its
#: kernels (K5 in the attention decode, K4 in the SSM prefill; ``encdec``
#: runs none, as the reference's), and whether its KV cache is a ring
_FAMILIES = {"dense": (transformer, ("decode_step",), False),
             "moe": (moe, ("decode_step",), False),
             "ssm": (ssm, ("prefill",), False),
             "hybrid": (hybrid, ("prefill", "decode_step"), True),
             "encdec": (encdec, (), False)}


def cache_rows(cfg: ArchConfig, n_prompt: int, n_new: int = 0, n_front: int = 0) -> int:
    """Rows of the self-attention cache that ``n_front`` frontend
    embeddings, ``n_prompt`` tokens and ``n_new`` decode steps take, and
    the position after them: a VLM's patches are rows of its cache, an
    encoder-decoder model's frames are not."""
    return (0 if cfg.encdec else n_front) + n_prompt + n_new


def _moe_logits(*args, **kwargs):
    return moe.forward(*args, **kwargs)[0]


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    mod, kernel_entry, ring_cache = _FAMILIES[cfg.family]
    return ModelApi(
        family=cfg.family,
        init_params=mod.init_params,
        forward=_moe_logits if mod is moe else mod.forward,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_cache=mod.init_cache,
        loss_fn=mod.loss_fn,
        kernel_entry=kernel_entry,
        ring_cache=ring_cache,
    )
