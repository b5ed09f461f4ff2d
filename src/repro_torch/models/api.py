"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``ModelApi`` with the entry points a family's
serving and training paths need.  The port has every family of the
reference: ``dense`` (with the VLM backbone), ``moe``, ``ssm``, ``hybrid``
and ``encdec``.  ``cache_rows`` says how many cache rows a request takes.
``forward`` returns logits only, as the reference's does
(MoE's own ``forward`` returns ``(logits, aux)``).  ``loss_fn`` is the
training loss on the reference's training path: plain PyTorch with each
layer rematerialised, never a kernel of this package (none has a
backward).  Every entry point takes the reference's ``ctx`` (a
``layers.ShardCtx``, ``NO_SHARD`` by default) after its positional
arguments.

The dry run's half (``launch/dryrun.py``): ``input_specs(cfg, shape)``
gives the reference's inputs of one (arch x shape) cell as ``TensorSpec``
(shape, dtype) pairs, ``fake_inputs`` makes them fake tensors, and
``abstract_params`` / ``abstract_cache`` run the family's own
``init_params`` / ``init_cache`` on the CPU under a ``FakeTensorMode``:
tensors with shapes and dtypes and no storage, so a 132 B-parameter
model takes no memory.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import encdec, hybrid, moe, ssm, transformer


@dataclass(frozen=True)
class ModelApi:
    family: str
    init_params: Callable    # (cfg, seed, device) -> params
    forward: Callable        # (params, batch, cfg, ctx) -> logits
    prefill: Callable        # (params, batch, cfg, max_len, ctx) -> (logits, cache)
    decode_step: Callable    # (params, cache, batch, cfg, ctx) -> (logits, cache)
    init_cache: Callable     # (cfg, batch, max_len, dtype, device) -> cache
    loss_fn: Callable        # (params, batch, cfg, ctx) -> 0-d fp32 loss
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


# ---------------------------------------------------------------------------
# input specs and abstract state (the dry-run contract)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """An input's shape and dtype: the reference's ``ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype


def _tok(shape) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.int32)


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The inputs of one (arch x shape) cell, as the reference's:

    train:   {"tokens", "labels"} (+ frontend embeds for vlm/audio)
    prefill: {"tokens"} (+ frontend embeds)
    decode:  {"tokens": (B, 1)}; the cache is built separately
             (``abstract_cache``): it is carried state, not input.
    """
    b, s = shape.global_batch, shape.seq_len
    emb = torch.bfloat16 if cfg.dtype == torch.bfloat16 else torch.float32
    if shape.kind == "decode":
        return {"tokens": _tok((b, 1))}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    if cfg.encdec:  # half the budget to the encoder (frames), half to the decoder
        front, s_tok = s // 2, s // 2
    elif cfg.frontend is not None:
        front, s_tok = cfg.frontend_tokens, s - cfg.frontend_tokens
    else:
        front, s_tok = 0, s
    out = {}
    if front:
        out["frontend_embeds"] = TensorSpec((b, front, cfg.d_model), emb)
    out["tokens"] = _tok((b, s_tok))
    if shape.kind == "train":
        out["labels"] = _tok((b, s_tok))
    return out


def fake_mode():
    """The active ``FakeTensorMode``, or a new one entered for the call."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_inputs(specs: dict) -> dict:
    """Fake (storage-free) CPU tensors for ``input_specs``' specs."""
    with fake_mode():
        return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in specs.items()}


def abstract_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """The parameter tree as fake CPU tensors (no allocation)."""
    with fake_mode():
        return get_model(cfg).init_params(cfg, seed, device="cpu")


def abstract_cache(cfg: ArchConfig, shape: InputShape) -> dict:
    """The decode cache of a cell as fake CPU tensors (no allocation)."""
    with fake_mode():
        return get_model(cfg).init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
