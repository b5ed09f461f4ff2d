"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) ff5504 v32001, ssm_state=16.

Parallel attention + mamba heads per layer; sliding-window attention (1024)
everywhere (Hymba's three global layers approximated by the window — see
DESIGN.md). Runs long_500k (window KV ring + O(1) SSM state).
[arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    hybrid=True, ssm_state=16, ssm_head_dim=64, ssm_groups=1,
    conv_kernel=4, sliding_window=1024,
)
