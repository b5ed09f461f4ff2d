"""qwen2-moe-a2.7b [moe]: 24L d2048 16H (kv=16) ff1408/expert v151936,
60 routed experts top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    n_experts=60, top_k=4, n_shared_experts=4,
    train_microbatches=2,  # MoE dispatch/expert transients: fit 16 GB/chip
)
