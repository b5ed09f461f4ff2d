"""Carry the reference's autoencoder weights into this package.

The reference keeps params as ``{"lstm_i": {"w_x", "w_h", "b"}, "dense":
{"w", "b"}}`` with ``x @ W`` weights of shape (in, 4H) and gate order
[i|f|g|o].  This package uses the same tree and layout (no transpose to
``nn.LSTM``'s), so conversion is a dtype-preserving copy onto a device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree: dict, device: str | torch.device,
                      dtype: torch.dtype | None = None) -> dict:
    """Numpy params tree -> torch params tree on ``device``.

    ``dtype`` (optional) casts every weight matrix to that compute dtype;
    biases (``"b"``) stay fp32, as the reference keeps them.
    """
    dev = resolve_device(device)

    def convert(node, name):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = _tensor(node)
        if dtype is not None and name != "b" and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, "")
