"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``ModelApi`` with the entry points a family's
serving path needs.  The port has the ``dense`` and ``ssm`` families; the
others raise a ``ValueError`` naming their later slice.  The reference's
``input_specs`` and ``abstract_*`` helpers belong to the dry run, and
``loss_fn`` to LM training: both come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm, transformer


@dataclass(frozen=True)
class ModelApi:
    family: str
    init_params: Callable    # (cfg, seed, device) -> params
    forward: Callable        # (params, batch, cfg) -> logits
    prefill: Callable        # (params, batch, cfg, max_len) -> (logits, cache)
    decode_step: Callable    # (params, cache, batch, cfg) -> (logits, cache)
    init_cache: Callable     # (cfg, batch, max_len, dtype, device) -> cache
    kernel_entry: str        # "prefill" | "decode_step": the one that takes use_kernel


_FAMILIES = {"dense": transformer, "ssm": ssm}
#: the entry point through which each family reaches its kernel: K5 in the
#: dense decode, K4 in the SSM prefill
_KERNEL_ENTRY = {"dense": "decode_step", "ssm": "prefill"}

#: families of the reference that later slices of the port bring
_LATER = {
    "moe": "the MoE family (ROADMAP queue 1, item 13)",
    "hybrid": "the hybrid family: window ring and SSM branch (ROADMAP queue 1, item 13)",
    "encdec": "the encoder-decoder family (ROADMAP queue 1, item 13)",
}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in _LATER:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not ported yet; it comes "
                         f"with a later slice of the port: {_LATER[cfg.family]}")
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    mod = _FAMILIES[cfg.family]
    return ModelApi(
        family=cfg.family,
        init_params=mod.init_params,
        forward=mod.forward,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_cache=mod.init_cache,
        kernel_entry=_KERNEL_ENTRY[cfg.family],
    )
