"""Per-layer LSTM recurrence: one CUDA launch runs one layer over T steps.

The paper's dependency-bound recurrent sub-layer (Sec. III-C): ``mvm_h``,
the gate activations and the elementwise tail, iterated over timesteps,
with ``W_h``, ``h`` and the fp32 cell ``c`` resident on chip.

* ``lstm_scan`` takes the input projection (the paper's ``mvm_x``) and the
  bias precomputed as ``xw``: the reference kernel's interface.
* ``lstm_scan_layer`` takes the layer's raw input with ``W_x`` and ``b``
  and forms that projection inside the same launch, row by row in a fixed
  order, so a row's result never depends on how many rows share the call
  (a cuBLAS product picks its reduction by shape).  The ``kernel`` backend
  runs this entry.

Both launch the kernels of ``csrc/lstm_scan.cu`` (with its design notes:
``lstm_scan_layer`` runs a warp-cell kernel with H at compile time for
H = 8 and 32, the widths ``gw_nominal`` runs; every other shape, and
``lstm_scan`` at any width, runs a run-time-width kernel) and count into ``lstm_scan.launches``, and by path into
``lstm_scan.launches_by_path``; the plain PyTorch versions are
``ref.lstm_scan_ref`` and ``ref.lstm_scan_layer_ref``.  Each wrapper runs
its plain version for CPU tensors and launches the kernel for CUDA
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.quant import EXACT, ActivationSet
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.lstm_stack.lstm_stack import (
    MAX_SMEM_BYTES,
    kernel_act_id,
)

from .ref import lstm_scan_layer_ref, lstm_scan_ref

SOURCE = Path(__file__).parent / "csrc" / "lstm_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.lstm_scan.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    built.lib.lstm_scan.restype = i32
    built.lib.lstm_scan_layer.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
    built.lib.lstm_scan_layer.restype = i32
    built.lib.lstm_scan_smem_bytes.argtypes = [i32] * 4
    built.lib.lstm_scan_smem_bytes.restype = ctypes.c_longlong
    built.lib.lstm_scan_warp_cell.argtypes = [i32] * 2
    built.lib.lstm_scan_warp_cell.restype = i32
    return built


@functools.lru_cache(maxsize=None)
def kernel_path(hidden: int, n_in: int = 0) -> str:
    """The kernel a launch at (H, IN) runs (``n_in`` = 0 for ``lstm_scan``):
    ``"warp_cell H=<H>"`` (H at compile time, weights in registers) or
    ``"run_time H=<H>"``.  Builds the library at first use."""
    warp = library().lib.lstm_scan_warp_cell(hidden, n_in)
    return f"{'warp_cell' if warp else 'run_time'} H={hidden}"


def _check(entry: str, batch: int, hidden: int, w_h, h0, c0, device) -> None:
    """Shape/dtype/device checks of the recurrent operands."""
    want = {"w_h": (w_h, (hidden, 4 * hidden)), "h0": (h0, (batch, hidden)),
            "c0": (c0, (batch, hidden))}
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{entry}: {arg} has shape {tuple(t.shape)}, want {shape}")
        if t.device != device:
            raise ValueError(f"{entry}: operands on {t.device} and {device}")
    if c0.dtype != torch.float32:
        raise ValueError(f"{entry}: c0 must be fp32, got {c0.dtype}")
    for arg, t in (("w_h", w_h), ("h0", h0)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{entry}: unsupported {arg} dtype {t.dtype}")


def lstm_scan(
    xw: torch.Tensor,    # (T, B, 4H) fp32: mvm_x output + bias, time-major
    w_h: torch.Tensor,   # (H, 4H) fp32 or bf16
    h0: torch.Tensor,    # (B, H) compute dtype (fp32 or bf16)
    c0: torch.Tensor,    # (B, H) fp32
    *,
    block_b: int | None = None,
    acts: ActivationSet = EXACT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one layer's recurrence over a window.

    Returns (hs (T, B, H), h_final (B, H), c_final fp32 (B, H)), freshly
    allocated; ``h`` is at ``h0``'s dtype.  ``block_b`` is the number of
    batch rows one CTA runs (default 1).  ``acts`` must have a kernel form
    (EXACT, HARD or PAPER_HW_KERNEL).
    """
    refuse_grad("lstm_scan", xw, w_h, h0, c0)
    t_len, batch, h4 = xw.shape
    if h4 % 4 or xw.dtype != torch.float32:
        raise ValueError(f"lstm_scan: xw must be fp32 (T, B, 4H), got {xw.dtype} "
                         f"{tuple(xw.shape)}")
    _check("lstm_scan", batch, h4 // 4, w_h, h0, c0, xw.device)
    act = kernel_act_id(acts)  # both paths take only activation sets with a kernel form
    if xw.device.type == "cpu":
        return lstm_scan_ref(xw, w_h, h0, c0, sigma=acts.sigma, tanh=acts.tanh)
    return _launch("lstm_scan", [xw], w_h, h0, c0, t_len=t_len, n_in=0,
                   block_b=block_b, act=act)


def lstm_scan_layer(
    xs: torch.Tensor,    # (B, T, IN) raw layer input
    w_x: torch.Tensor,   # (IN, 4H) same dtype as w_h
    b: torch.Tensor,     # (4H,) fp32
    w_h: torch.Tensor,   # (H, 4H) fp32 or bf16
    h0: torch.Tensor,    # (B, H) compute dtype (fp32 or bf16)
    c0: torch.Tensor,    # (B, H) fp32
    *,
    block_b: int | None = None,
    acts: ActivationSet = EXACT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer from its raw input: ``xw = round(xs @ W_x) + b`` in the
    launch (``xs`` cast to ``h0``'s dtype, the product summed in fp32 and
    rounded to it), then the recurrence.  Returns (hs (T, B, H), h_final
    (B, H), c_final fp32 (B, H)), as ``lstm_scan``."""
    refuse_grad("lstm_scan_layer", xs, w_x, b, w_h, h0, c0)
    batch, t_len, n_in = xs.shape
    hidden = w_h.shape[0]
    _check("lstm_scan_layer", batch, hidden, w_h, h0, c0, xs.device)
    if tuple(w_x.shape) != (n_in, 4 * hidden) or w_x.dtype != w_h.dtype:
        raise ValueError(f"lstm_scan_layer: w_x is {tuple(w_x.shape)} {w_x.dtype}, want "
                         f"{(n_in, 4 * hidden)} {w_h.dtype}")
    if tuple(b.shape) != (4 * hidden,) or b.dtype != torch.float32:
        raise ValueError(f"lstm_scan_layer: b is {tuple(b.shape)} {b.dtype}, want fp32 "
                         f"({4 * hidden},)")
    if w_x.device != xs.device or b.device != xs.device:
        raise ValueError("lstm_scan_layer: operands on different devices")
    act = kernel_act_id(acts)
    xs = xs.to(h0.dtype)
    if xs.device.type == "cpu":
        return lstm_scan_layer_ref(xs, w_x, b, w_h, h0, c0, sigma=acts.sigma,
                                   tanh=acts.tanh)
    return _launch("lstm_scan_layer", [xs, w_x, b], w_h, h0, c0, t_len=t_len,
                   n_in=n_in, block_b=block_b, act=act)


def _launch(entry: str, inputs: list, w_h, h0, c0, *, t_len: int, n_in: int,
            block_b: int | None, act: int):
    """Launch one entry on the current stream; raise if the launch is
    refused (``cudaGetLastError`` of the launch is non-zero)."""
    if h0.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {h0.device}")
    batch, hidden = h0.shape
    if 4 * hidden > 1024:
        raise ValueError(f"hidden {hidden} needs {4 * hidden} threads per block (> 1024)")
    rows = 1 if block_b is None else int(block_b)
    if rows < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    built = library()
    smem = built.lib.lstm_scan_smem_bytes(hidden, n_in, rows, _DTYPES[w_h.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{entry}: H={hidden}, IN={n_in} with block_b={rows} needs {smem} B of "
            f"shared memory per block (> {MAX_SMEM_BYTES}); use a smaller block_b"
        )
    # the kernel reads whole 4-byte words: operands contiguous and aligned
    ops = [t if t.is_contiguous() and t.data_ptr() % 16 == 0
           else t.clone(memory_format=torch.contiguous_format)
           for t in (*inputs, w_h, h0, c0)]
    hs = torch.empty(t_len, batch, hidden, dtype=h0.dtype, device=h0.device)
    h_f = torch.empty_like(ops[-2])
    c_f = torch.empty_like(ops[-1])
    dims = [t_len, batch, hidden] + ([n_in] if n_in else [])
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        err = getattr(built.lib, entry)(
            *[t.data_ptr() for t in ops], hs.data_ptr(), h_f.data_ptr(),
            c_f.data_ptr(), *dims, rows, _DTYPES[h0.dtype], _DTYPES[w_h.dtype], act,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    lstm_scan.launches += 1
    lstm_scan.launches_by_path[kernel_path(hidden, n_in)] += 1
    return hs, h_f, c_f


#: launches of the kernel, through either entry, since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
lstm_scan.launches = 0
#: the same launches by the kernel they ran (``kernel_path``); cleared with
#: ``lstm_scan.launches_by_path.clear()``
lstm_scan.launches_by_path = collections.Counter()
