"""Carry the reference's weights into this package.

The reference keeps the autoencoder's params as ``{"lstm_i": {"w_x", "w_h",
"b"}, "dense": {"w", "b"}}`` with ``x @ W`` weights of shape (in, 4H) and
gate order [i|f|g|o]; its LM params as nested dicts with the layers stacked
along a leading (L, ...) axis.  This package uses the same trees and
layouts (no transpose to ``nn.LSTM``'s or ``nn.Linear``'s), so conversion
is a dtype-preserving copy onto a device, bf16 carried bit for bit.
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


#: LM leaves the reference stores at the model dtype; every other LM leaf
#: (norm scales, QKV biases, conv weights, a_log, d_skip, dt_bias) is fp32
LM_MODEL_DTYPE_LEAVES = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj",
})


def unflatten(data, prefix: str = "params/") -> dict:
    """A flat mapping whose keys under ``prefix`` are paths (``params/a/b``,
    as the LM golden fixtures store the reference's params) -> the nested
    params tree."""
    tree: dict = {}
    for key in data:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def lm_params_from_numpy(tree: dict, device: str | torch.device,
                         dtype: torch.dtype | None = None) -> dict:
    """The reference's LM params (nested dicts of numpy arrays, layers
    stacked) -> the same tree of tensors on ``device``.

    ``dtype`` (optional) casts the leaves the reference keeps at the model
    dtype (``LM_MODEL_DTYPE_LEAVES``); the fp32 leaves stay fp32.
    """
    dev = resolve_device(device)

    def convert(node, name):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = _tensor(node)
        if dtype is not None and name in LM_MODEL_DTYPE_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, "")
