"""Row-wise product ``(M, K) @ (K, N) (+ b)``: each output element one
K-long fp32 chain in a fixed order, whatever M is.

The GW score tail's products (layer 0's input projection of the wavefront
kernel, the dense head, and the sum of each window's squared error) go
through it on the card, so that a batched window decode gives each row the
bits it gets alone: cuBLAS and PyTorch's reductions pick their order by
shape.  The kernel and its notes are in ``csrc/rowwise.cu``; the plain
version is ``rowwise_matmul_plain``, the LSTM kernels' ``seq_dot`` then
``+ b``.  ``rowwise_matmul`` runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other.  Its gradient (the GW autoencoder's dense head and error sum are
trained through it) is the same three plain products on both routes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.lstm_stack.ref import seq_dot

SOURCE = Path(__file__).parent / "csrc" / "rowwise.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.rowwise_matmul.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    built.lib.rowwise_matmul.restype = i32
    return built


def rowwise_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: (M, N) fp32."""
    out = seq_dot(x.float(), w.float())
    return out if b is None else out + b


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) fp32 or bf16, w (K, N) fp32, b (N,) fp32 or None ->
    (M, N) fp32, freshly allocated.  Differentiable in x, w and b on both
    routes (``_RowwiseMatmul``)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"rowwise_matmul: x {tuple(x.shape)} and w {tuple(w.shape)}; "
                         "want (M, K) and (K, N)")
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise ValueError(f"rowwise_matmul: x must be fp32 or bf16 and w fp32, got "
                         f"{x.dtype} and {w.dtype}")
    if b is not None and (tuple(b.shape) != (w.shape[1],) or b.dtype != torch.float32):
        raise ValueError(f"rowwise_matmul: b must be fp32 ({w.shape[1]},), got "
                         f"{b.dtype} {tuple(b.shape)}")
    if any(t is not None and t.device != x.device for t in (w, b)):
        raise ValueError("rowwise_matmul: operands on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rowwise_matmul: unsupported device {x.device}")
    return _RowwiseMatmul.apply(x, w, b)


class _RowwiseMatmul(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the CPU.
    Backward: ``g @ w^T`` (at x's dtype), ``x^T @ g`` and ``g.sum(0)``, as
    plain products; the reference leaves them to its compiler too."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return rowwise_matmul_plain(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        grad_x = (grad @ w.t()).to(x.dtype) if need_x else None
        grad_w = x.float().t() @ grad if need_w else None
        grad_b = grad.sum(0) if need_b else None
        return grad_x, grad_w, grad_b


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"rowwise_matmul: empty operand ({m}, {k}) @ ({k}, {n})")
    x, w = x.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library().lib.rowwise_matmul(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            m, k, n, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rowwise_matmul launch failed: CUDA error {err}")
    rowwise_matmul.launches += 1
    return out


#: kernel launches since the count was last set to 0 (plain-version calls
#: on CPU tensors do not count)
rowwise_matmul.launches = 0
