"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) ff10752 v100352, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    n_experts=16, top_k=4,
    # the reference's value.  The dry run (python -m repro_torch.launch.dryrun
    # --arch dbrx-132b --shape train_4k --mesh pod, sized for one NVIDIA H100
    # 80GB HBM3, 700 W) traces a 18.06 GB peak per rank on pod_32x8 with 2
    # microbatches and 20.64 GB with 1 (--variant mb2): the H100 does not
    # need it to fit 80 GB
    train_microbatches=2,
)
