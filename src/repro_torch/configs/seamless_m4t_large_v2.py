"""seamless-m4t-large-v2 [audio]: enc-dec, 24L enc + 24L dec, d1024 16H
ff8192 v256206. Audio frontend is a STUB (input_specs provides precomputed
frame embeddings). [arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    encdec=True, n_enc_layers=24,
)
