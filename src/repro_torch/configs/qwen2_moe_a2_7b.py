"""qwen2-moe-a2.7b [moe]: 24L d2048 16H (kv=16) ff1408/expert v151936,
60 routed experts top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    n_experts=60, top_k=4, n_shared_experts=4,
    # the reference's value.  The dry run (python -m repro_torch.launch.dryrun
    # --arch qwen2-moe-a2.7b --shape train_4k --mesh pod, sized for one NVIDIA
    # H100 80GB HBM3, 700 W) traces a 14.82 GB peak per rank on pod_32x8 with
    # 2 microbatches and 18.83 GB with 1 (--variant mb2): the H100 does not
    # need it to fit 80 GB
    train_microbatches=2,
)
