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


def to_tensor(arr) -> torch.Tensor:
    """A host array as a tensor.  bf16 arrives as ml_dtypes' bfloat16 or as
    2-byte void items (the form numpy gives bf16 on disk without
    ml_dtypes, and ``to_numpy`` writes): both carry the bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.itemsize == 2):
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
        t = to_tensor(node)
        if dtype is not None and name != "b" and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, "")


def opt_state_from_numpy(tree: dict, device: str | torch.device) -> dict:
    """The reference's AdamW state (``{"m", "v", "step"[, "err"]}`` of numpy
    arrays, as ``repro.train.optimizer.init_opt_state`` lays it out) -> the
    same tree of tensors on ``device``: fp32 moments, a 0-d int32 step."""
    if not {"m", "v", "step"} <= set(tree):
        raise ValueError(f"optimizer state needs m, v and step; got {sorted(tree)}")
    state = params_from_numpy(tree, device)
    if state["step"].shape != () or state["step"].dtype != torch.int32:
        raise ValueError(f"optimizer step must be a 0-d int32, got {state['step'].dtype} "
                         f"{tuple(state['step'].shape)}")
    return state


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's (and the reference's) spelling of a dtype: ``float32``,
    ``int32``, ``bfloat16``."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 goes out as 2-byte void items (numpy
    has no bf16), which ``to_tensor`` reads back."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(np.dtype("V2"))
    return t.numpy().copy()


#: LM leaves the reference stores at the model dtype (the MoE experts and
#: shared SwiGLU use the MLP's names, the SSM branch its projections', an
#: encoder-decoder model's ``enc_layers``, ``dec_layers`` and
#: ``cross_attn`` the attention's and the MLP's); every other LM leaf (norm
#: scales with ``norm_attn``, ``norm_ssm``, ``ln_x`` and ``ln_enc``, QKV
#: biases, the MoE router, conv weights, a_log, d_skip, dt_bias) is fp32
LM_MODEL_DTYPE_LEAVES = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj",
})


def unflatten(data, prefix: str = "params/") -> dict:
    """A flat mapping whose keys under ``prefix`` are paths (``params/a/b``,
    as the LM golden fixtures store the reference's params) -> the nested
    params tree; the inverse of ``tree.flatten``."""
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
        t = to_tensor(node)
        if dtype is not None and name in LM_MODEL_DTYPE_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, "")
