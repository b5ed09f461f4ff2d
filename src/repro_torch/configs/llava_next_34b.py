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
    # the reference's values.  The dry run (python -m repro_torch.launch.dryrun
    # --mesh pod, sized for one NVIDIA H100 80GB HBM3, 700 W) traces on
    # pod_32x8: train_4k a 4.69 GB peak per rank with 4 microbatches and
    # 6.63 GB with 2 (--variant mb2); decode_32k with serve_2d 4.30 GB of
    # arguments and a 4.44 GB peak.  The H100 needs neither to fit 80 GB:
    # 1-D serve sharding (not traced) holds 68.8 GB / 8 = 8.6 GB of weights
    # a rank
    train_microbatches=4,
    serve_2d=True,
)
