"""Architecture + input-shape schema for the assigned (arch x shape) grid.

Every assigned architecture is an ``ArchConfig`` in ``configs/<id>.py``;
``repro_torch.configs.registry`` maps ``--arch <id>`` to it.  Each config also
provides ``reduced()`` — a small same-family variant for CPU smoke tests.
The four assignment shapes are ``SHAPES``; eligibility rules (sub-quadratic
for long_500k, decoder presence for decode shapes) live here so the dry-run
and the roofline table agree on the 40-cell grid.

A copy of the reference's schema with ``dtype`` as a ``torch.dtype``
(``torch.bfloat16`` at full width, ``torch.float32`` in ``reduced()``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads
    qkv_bias: bool = False         # qwen1.5 style
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0      # qwen2-moe: always-on shared experts
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0             # N (d_state); 0 = no SSM path
    ssm_head_dim: int = 64         # P
    ssm_expand: int = 2            # d_inner = expand * d_model (pure SSM)
    ssm_groups: int = 1            # G groups for B/C (mamba2 ngroups)
    conv_kernel: int = 4           # depthwise conv width in the SSM branch
    attn_free: bool = False        # mamba2: no attention at all
    hybrid: bool = False           # hymba: parallel attn + SSM heads per layer
    sliding_window: int | None = None  # bounded attention window (hybrid)
    # --- encoder-decoder -----------------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0          # encoder depth (decoder depth = n_layers)
    # --- modality frontend stub (assignment: embeddings arrive precomputed) --
    frontend: str | None = None    # None | "vision" | "audio"
    frontend_tokens: int = 0       # patch/frame positions per example
    # --- numerics -------------------------------------------------------------
    dtype: Any = torch.bfloat16
    #: gradient-accumulation microbatches for train_4k (memory fit; the
    #: remat/residual stacks scale with per-device microbatch size)
    train_microbatches: int = 1
    #: serve with 2-D (FSDP-style) weight sharding: per-layer gathers on the
    #: decode path in exchange for 16x less resident weight memory (needed
    #: when serve-mode params + KV cache exceed 16 GB/chip)
    serve_2d: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding/lm_head rows padded to a 256 multiple so the vocab dim
        shards evenly on any production mesh (GSPMD in_shardings require
        divisibility; unpadded odd vocabs like granite's 49155 would
        replicate 13 GB of logits per device).  The loss masks the pad."""
        return (self.vocab + 255) // 256 * 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """long_500k eligibility: SSM state or bounded attention window."""
        return self.attn_free or (self.hybrid and self.sliding_window is not None)

    @property
    def ssm_heads(self) -> int:
        if not (self.attn_free or self.hybrid):
            return 0
        d_inner = self.ssm_expand * self.d_model if self.attn_free else self.d_model
        return d_inner // self.ssm_head_dim

    def n_params(self) -> float:
        """Approximate parameter count (embeddings included once)."""
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d
        dense_mlp = 3 * d * ff
        per_layer = 0.0
        if not self.attn_free:
            per_layer += attn
        if self.hybrid:
            din = self.d_model
            per_layer += d * (2 * din + 2 * self.ssm_groups * self.ssm_state) + din * d
        if self.attn_free:
            din = self.ssm_expand * d
            per_layer += d * (2 * din + 2 * self.ssm_groups * self.ssm_state
                              + din // self.ssm_head_dim) + din * d
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * ff
            per_layer += self.n_shared_experts * 3 * d * ff
            per_layer += d * self.n_experts  # router
        elif ff:
            per_layer += dense_mlp
        total = l * per_layer + self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.encdec:  # encoder layers: self-attn + mlp; decoder adds cross
            total += self.n_enc_layers * (attn + dense_mlp)
            total += self.n_layers * attn  # cross-attention blocks
        return float(total)

    def n_active_params(self) -> float:
        """Active (per-token) params — MoE counts top_k+shared experts only."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * ff * self.n_layers
        return self.n_params() - inactive

    def reduced(self) -> "ArchConfig":
        """Small same-family variant: CPU smoke tests run a real fwd/train step."""
        return replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            # no-drop capacity so decode == forward exactly (drop semantics
            # only differ when tokens compete for capacity, which a 1-token
            # decode step never does)
            moe_capacity_factor=(
                min(self.n_experts, 4) / max(min(self.top_k, 2), 1)
                if self.n_experts else self.moe_capacity_factor
            ),
            ssm_state=min(self.ssm_state, 8),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            sliding_window=16 if self.sliding_window else None,
            n_enc_layers=2 if self.encdec else 0,
            frontend_tokens=8 if self.frontend else 0,
            dtype=torch.float32,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason) for one (arch x shape) cell, per assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic (assignment rule)"
    return True, ""
