"""PyTorch / CUDA port of the GW LSTM-autoencoder serving stack.

The package mirrors ``repro`` (the JAX reference) module for module:

  core/      quantization and activations, the LSTM cell, weight packing,
             the backend table, plan/bind/execute, the autoencoder
  kernels/   hand-written CUDA kernels for Hopper (sm_90a) with their plain
             PyTorch versions beside them
  serve/     batch and streaming anomaly-scoring engines
  configs/   the paper's GW models
  convert    carries the reference's weights (as numpy) into this package

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing GPU raises instead of silently running on the CPU.
"""

from .device import resolve_device  # noqa: F401
