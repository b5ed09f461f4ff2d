"""Plain PyTorch version of the fused stack: layer-by-layer execution.

Same packed shapes and gate order [i, f, g, o] as the wavefront kernel
(``lstm_stack.py``); each layer runs its whole time loop before the next
starts, the schedule the kernel reorders without changing any cell's math.

Arithmetic is written to match the CUDA kernels operation for operation:

* every matrix product is a sequential sum over k (``seq_dot``), each step
  one fp32 multiply and one fp32 add, the order the kernel's threads use;
* weights are cast (not dequantized) to the compute dtype, products are
  accumulated in fp32, and int8 dequant scales multiply the fp32
  accumulator per gate: ``(h @ q) * s``, not ``h @ (q * s)``;
* the per-gate tail is ``(gx * s_x + b) + hh * s_h``, then sigma/tanh, the
  fp32 cell, and the optional activation fake-quant on h before the cast to
  the compute dtype.

On the card the kernel and this version therefore agree bit for bit, which
an ``act_bits`` or bf16 rounding of h needs: a one-ulp difference before a
rounding step would become a whole grid step after it.

Given a pack's real widths (``widths``), this version does what the
row-blocked kernel does with them: each layer computes only its real gate
columns, each chain ends at its layer's width rounded up to 4, and the
padded positions of every output are +0.  The terms it drops are products
of the pack's zero rows with finite h, each +0 or -0, added to a chain from
+0 that is never -0, so every real output keeps the padded version's bits
whatever the state holds at its padded positions.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.quant import sigmoid_exact, tanh_exact

#: a pack's real layer widths, ``(in_dims, hidden)``: one input and one
#: hidden width a layer (``PackedStack.in_dims``, ``.hidden``)
Widths = tuple[tuple[int, ...], tuple[int, ...]]


def normalize_scales(scales: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Canonical per-gate ``(L, 2, 4)`` dequant scales.

    Packs quantize each [i|f|g|o] 4W-slice on its own grid; legacy
    per-matrix ``(L, 2)`` scales broadcast to every gate.
    """
    if scales.dim() == 2:
        scales = scales[:, :, None]
    return torch.broadcast_to(scales, (n_layers, 2, 4)).to(torch.float32)


def apply_gate_scales(x: torch.Tensor, gate_scales: torch.Tensor) -> torch.Tensor:
    """Scale a ``(..., 4W)`` gate accumulator per gate. ``gate_scales``: (4,)."""
    lead, w4 = x.shape[:-1], x.shape[-1]
    x = x.reshape(*lead, 4, w4 // 4) * gate_scales[:, None]
    return x.reshape(*lead, w4)


def seq_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in fp32 as a sequential sum over k, in the kernels' order.

    x: (..., K) fp32, w: (K, N) fp32 -> (..., N) fp32.
    """
    acc = torch.zeros(*x.shape[:-1], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[..., k : k + 1] * w[k]
    return acc


def cell_tail(pre: torch.Tensor, c: torch.Tensor, sigma: Callable,
              tanh: Callable, act_quant: Callable | None,
              compute: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate pre-activations (B, 4W) fp32 -> (h compute dtype, c fp32)."""
    width = pre.shape[-1] // 4
    i = sigma(pre[:, 0 * width : 1 * width])
    f = sigma(pre[:, 1 * width : 2 * width])
    g = tanh(pre[:, 2 * width : 3 * width])
    o = sigma(pre[:, 3 * width : 4 * width])
    c_new = f * c + i * g
    h_new = o * tanh(c_new)
    if act_quant is not None:
        # hand-off fake-quant before the compute cast; the fp32 cell carry
        # stays untouched (paper: 32-bit cell state)
        h_new = act_quant(h_new)
    return h_new.to(compute), c_new


def lstm_stack_ref(
    xw0: torch.Tensor,   # (T, B, 4W) fp32: layer 0 mvm_x output + bias
    w_x: torch.Tensor,   # (L, W, 4W) fp32/bf16/int8 codes
    w_h: torch.Tensor,   # (L, W, 4W) fp32/bf16/int8 codes
    b: torch.Tensor,     # (L, 4W) fp32
    h0: torch.Tensor,    # (L, B, W) compute dtype
    c0: torch.Tensor,    # (L, B, W) fp32
    *,
    scales: torch.Tensor | None = None,  # (L, 2) or (L, 2, 4) fp32, int8 packs
    sigma: Callable = sigmoid_exact,
    tanh: Callable = tanh_exact,
    act_quant: Callable | None = None,
    widths: Widths | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hs of the last layer (T, B, W), h_final (L, B, W), c_final).

    ``widths``: the real ``(in_dims, hidden)`` of a pack, whose weights are
    zero past each layer's widths (``lstm_stack``'s contract); the padded
    positions of ``h0`` and ``c0`` are then not read."""
    n_layers, width = w_h.shape[0], w_h.shape[1]
    compute = h0.dtype
    if scales is not None:
        scales = normalize_scales(scales, n_layers)
    in_dims, hidden = widths if widths is not None else ((width,) * n_layers,) * 2

    def matmul_w(x, w, scale):
        out = seq_dot(x.to(torch.float32), w.to(compute).to(torch.float32))
        return out if scales is None else apply_gate_scales(out, scale)

    def chain(n):  # a chain's length: the real width rounded up to 4
        return min(width, -(-n // 4) * 4)

    def pad(v):  # (..., h) -> (..., W), +0 at the padded positions
        return v if v.shape[-1] == width else torch.nn.functional.pad(v, (0, width - v.shape[-1]))

    hs, h_fs, c_fs = None, [], []
    for layer in range(n_layers):
        s_x, s_h = (None, None) if scales is None else (
            scales[layer, 0], scales[layer, 1]
        )
        hid = hidden[layer]
        # the layer's real gate columns: [i | f | g | o], hid of each
        cols = (slice(None) if hid == width
                else (torch.arange(4)[:, None] * width + torch.arange(hid)).reshape(-1))
        if layer > 0:
            nx = chain(in_dims[layer])
            xw = matmul_w(hs[..., :nx], w_x[layer][:nx, cols], s_x) + b[layer][cols]
        else:
            xw = xw0[..., cols]
        nh, w_hl = chain(hid), w_h[layer][:, cols]
        h, c = pad(h0[layer][:, :hid]), c0[layer][:, :hid].to(torch.float32)
        out = []
        for t in range(xw.shape[0]):
            h, c = cell_tail(xw[t] + matmul_w(h[:, :nh], w_hl[:nh], s_h), c,
                             sigma, tanh, act_quant, compute)
            h = pad(h)
            out.append(h)
        hs = torch.stack(out)
        h_fs.append(h)
        c_fs.append(pad(c))
    return hs, torch.stack(h_fs), torch.stack(c_fs)
