"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) ff20480 v64000 — anyres tiling.

Backbone only (Yi-34B-class decoder); the vision tower is a STUB per the
assignment: input_specs provides 576 precomputed patch embeddings per image
(one base anyres tile) spliced ahead of the text tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    rope_theta=5e6,
    frontend="vision", frontend_tokens=576,
    train_microbatches=4,  # 60L x d7168 remat stacks: fit 16 GB/chip
    serve_2d=True,          # 34B weights + 32k KV cache: fit 16 GB/chip
)
