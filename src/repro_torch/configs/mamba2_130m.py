"""mamba2-130m [ssm]: 24L d768 attn-free, v50280, ssm_state=128 — SSD.

d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads, 1 B/C group.
Runs long_500k (O(1) decode state). [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,  # unused (attn-free)
    d_ff=0, vocab=50280,
    attn_free=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, conv_kernel=4, tie_embeddings=True,
)
