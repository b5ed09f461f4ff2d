"""Low-latency step kernel for the fused stack: short chunks, one launch.

The serving-time critical path is the latency of a streamed sample: a new
strain sample arrives every sampling period and must advance the resident
LSTM state.  The wavefront kernel (``lstm_stack.py``) is built for windows:
its layer-0 projection is a separate matmul whose ``(T, B, 4W)`` result
round-trips through device memory.  At chunk scale (T up to ``chunk_len``)
that matmul costs more than the math, so this kernel takes the raw chunk
``(B, T, W)`` and computes layer 0's projection in-kernel; nothing the size
of the gate tensor ever leaves the chip.

Same cell body as the wavefront kernel (``csrc/lstm_stack.cu``); the plain
PyTorch version is ``lstm_stack_step_plain``.  ``lstm_stack_step`` runs the
plain version for CPU tensors and launches the kernel for CUDA tensors.

``fuse_gates=True`` is the reference's single ``[x ; h] @ [W_x ; W_h]``
product per cell: each gate's sum is one 2W-long chain over the
concatenation (the x terms first), then ``+ b``, and layer 0's sum is not
rounded to the compute dtype.  It refuses int8 packs: ``s_x`` and ``s_h``
scale two different accumulators, which one chain would mix.  The default
is separate chains.  The reference turns fusion on for compiled TPU
backends because it halves the MXU issues of a cell; here the weights sit
in registers and each gate column is a dependent chain of fp32 adds, so
one 2W-long chain takes longer than two W-long chains run side by side,
and only separate chains keep a T=1 step bit-equal to the wavefront
kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.quant import (
    EXACT,
    ActivationSet,
    kernel_safe,
    make_act_quant,
    sigmoid_exact,
    tanh_exact,
)
from repro_torch.kernels import refuse_grad

from .lstm_stack import KernelPath, check_operands, kernel_act_id, launch
from .ops import check_packed_weight_dtype
from .ref import apply_gate_scales, cell_tail, normalize_scales, seq_dot

#: hard ceiling on T*L cell updates per call: the step kernel runs the chunk
#: strictly sequentially (its win is latency, not throughput); longer chunks
#: belong to the wavefront kernel (``core/backends`` routes them there)
MAX_STEP_UNROLL = 512


def lstm_stack_step_plain(
    xs: torch.Tensor,   # (B, T, W) raw layer-0 chunk, compute dtype
    w_x: torch.Tensor,  # (L, W, 4W)
    w_h: torch.Tensor,  # (L, W, 4W)
    b: torch.Tensor,    # (L, 4W) fp32
    h0: torch.Tensor,   # (L, B, W) compute dtype
    c0: torch.Tensor,   # (L, B, W) fp32
    *,
    scales: torch.Tensor | None = None,  # (L, 2) or (L, 2, 4) fp32, int8 only
    sigma: Callable = sigmoid_exact,
    tanh: Callable = tanh_exact,
    act_quant: Callable | None = None,
    fuse_gates: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the step kernel: a chunk loop, layers ascending in
    each timestep, with layer 0's product hoisted over the whole chunk and
    rounded to the compute dtype (the reference's ``(x @ W_x[0])`` at the
    compute dtype).  Every layer's tail is ``(gx * s_x + b) + hh * s_h``;
    with ``fuse_gates`` it is ``seq_dot([x ; h], [W_x ; W_h]) + b``.
    Returns (hs (B, T, W), h_final (L, B, W), c_final fp32)."""
    n_layers = w_h.shape[0]
    compute = h0.dtype
    if scales is not None:
        scales = normalize_scales(scales, n_layers)
    wx = [w_x[l].to(compute).to(torch.float32) for l in range(n_layers)]
    wh = [w_h[l].to(compute).to(torch.float32) for l in range(n_layers)]
    h = [h0[l] for l in range(n_layers)]
    c = [c0[l].to(torch.float32) for l in range(n_layers)]
    out = []
    if fuse_gates:
        if scales is not None:
            raise ValueError("fuse_gates: int8 packs keep separate chains (their s_x and s_h "
                             "scale two different accumulators)")
        w_cat = [torch.cat([wx[l], wh[l]]) for l in range(n_layers)]
        for t in range(xs.shape[1]):
            for l in range(n_layers):
                x_in = xs[:, t] if l == 0 else h[l - 1]
                pre = seq_dot(torch.cat([x_in, h[l]], dim=1).to(torch.float32), w_cat[l])
                h[l], c[l] = cell_tail(pre + b[l], c[l], sigma, tanh, act_quant, compute)
            out.append(h[-1])
        return torch.stack(out, dim=1), torch.stack(h), torch.stack(c)
    gx0 = seq_dot(xs.to(torch.float32), wx[0]).to(compute).to(torch.float32)
    for t in range(xs.shape[1]):
        for l in range(n_layers):
            gx = gx0[:, t] if l == 0 else seq_dot(h[l - 1].to(torch.float32), wx[l])
            hh = seq_dot(h[l].to(torch.float32), wh[l])
            if scales is not None:
                gx = apply_gate_scales(gx, scales[l, 0])
                hh = apply_gate_scales(hh, scales[l, 1])
            h[l], c[l] = cell_tail((gx + b[l]) + hh, c[l], sigma, tanh,
                                   act_quant, compute)
        out.append(h[-1])
    return torch.stack(out, dim=1), torch.stack(h), torch.stack(c)


def lstm_stack_step(
    xs: torch.Tensor,   # (B, T, W) raw layer-0 chunk, batch-major, pre-padded
    w_x: torch.Tensor,  # (L, W, 4W) packed input projections
    w_h: torch.Tensor,  # (L, W, 4W) packed recurrent weights
    b: torch.Tensor,    # (L, 4W) fp32 packed biases
    h0: torch.Tensor,   # (L, B, W) compute dtype
    c0: torch.Tensor,   # (L, B, W) fp32
    *,
    scales: torch.Tensor | None = None,  # (L, 2) or (L, 2, 4) fp32, int8 only
    acts: ActivationSet = EXACT,
    act_bits: int | None = None,
    block_b: int | None = None,
    fuse_gates: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a short chunk through the whole stack in one launch.

    Returns (hs (B, T, W), h_final (L, B, W), c_final fp32), freshly
    allocated.  ``block_b`` is the number of batch rows one CTA runs;
    ``fuse_gates`` (not with int8 ``scales``) is described above.
    """
    refuse_grad("lstm_stack_step", xs, w_x, w_h, b, h0, c0, scales)
    batch, t_len, width = xs.shape
    n_layers = w_h.shape[0]
    check_operands("lstm_stack_step", w_x, w_h, b, h0, c0, scales, width, batch)
    if xs.dtype != h0.dtype:
        raise ValueError(
            f"lstm_stack_step: chunk dtype {xs.dtype} != compute dtype {h0.dtype}"
        )
    if t_len * n_layers > MAX_STEP_UNROLL:
        raise ValueError(
            f"lstm_stack_step runs T*L={t_len * n_layers} sequential cells in "
            f"one call (> {MAX_STEP_UNROLL}); chunks this long belong to the "
            "wavefront kernel: lower the plan's chunk_len"
        )
    kernel_act_id(acts)  # both paths take only activation sets with a kernel form
    if scales is not None:
        if fuse_gates:
            raise ValueError("lstm_stack_step: fuse_gates is incompatible with int8 packs: s_x "
                             "and s_h scale two different accumulators, which one chain "
                             "would mix")
        scales = normalize_scales(scales, n_layers)
    if xs.device.type == "cpu":
        return lstm_stack_step_plain(
            xs, w_x, w_h, b, h0, c0, scales=scales, sigma=acts.sigma,
            tanh=acts.tanh,
            act_quant=make_act_quant(act_bits) if act_bits is not None else None,
            fuse_gates=fuse_gates,
        )
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_stack_step: unsupported device {xs.device}")
    hs = torch.empty(batch, t_len, width, dtype=h0.dtype, device=h0.device)
    h_f = torch.empty_like(h0)
    c_f = torch.empty_like(c0)
    launch("lstm_stack_step", xs, w_x, w_h, b, h0, c0, scales, hs, h_f, c_f,
           t_len=t_len, acts=acts, act_bits=act_bits,
           path=KernelPath("one_row", 1 if block_b is None else int(block_b)),
           fuse_gates=fuse_gates)
    lstm_stack_step.launches += 1
    return hs, h_f, c_f


#: kernel launches since the count was last set to 0 (plain-version calls
#: on CPU tensors do not count)
lstm_stack_step.launches = 0


def lstm_stack_step_op(
    xs: torch.Tensor,     # (B, T, W) layer-0 chunk, pre-padded to the pack width
    stacked: dict,        # pack_stack output: w_x/w_h/b[, scales]
    h0: torch.Tensor,     # (L, B, W)
    c0: torch.Tensor,     # (L, B, W)
    *,
    block_b: int | None = None,
    acts: ActivationSet = EXACT,
    weight_dtype: str = "fp32",
    act_bits: int | None = None,
    fuse_gates: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step-path twin of ``ops.lstm_stack_op`` for short chunks: no
    out-of-kernel mvm_x and no time-major transposes.  ``fuse_gates=None``
    is separate chains.  Returns (hs (B, T, W), h_final (L, B, W), c_final
    fp32)."""
    check_packed_weight_dtype(stacked, weight_dtype, h0.dtype)
    return lstm_stack_step(
        xs, stacked["w_x"], stacked["w_h"], stacked["b"].to(torch.float32), h0,
        c0.to(torch.float32),
        scales=stacked["scales"] if weight_dtype == "int8" else None,
        acts=kernel_safe(acts), act_bits=act_bits, block_b=block_b,
        fuse_gates=bool(fuse_gates),
    )
