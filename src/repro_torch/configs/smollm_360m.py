"""smollm-360m [dense]: 32L d960 15H (GQA kv=5) ff2560 v49152 — llama-arch small.

Closest assigned arch to the paper's regime (small model, latency-critical).
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64, tie_embeddings=True,
)
