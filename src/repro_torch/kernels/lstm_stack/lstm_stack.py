"""Fused multi-layer wavefront LSTM stack: one CUDA launch for L layers.

The paper's coarse-grained pipeline (Sec. III-B/III-D) as one kernel: at
wavefront step s layer l runs timestep s - l, all layers in the same phase;
all L layers' W_x and W_h stay on chip (in registers at W = 32 with
L <= 2, else in shared memory), every layer's h and c stay on chip for the
whole window, only layer 0's precomputed gate stream ``xw0`` streams in and
only the last layer's hidden sequence streams out.  Inner layers compute
``h_{l-1} @ W_x[l]`` in-kernel.  The kernel source and its design notes are
in ``csrc/lstm_stack.cu``; the plain PyTorch version of the same function
is ``ref.lstm_stack_ref``.

``lstm_stack`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
``kernel_path`` chooses the launch's path by shape and batch: one row a CTA,
several batch rows carried through every thread of a wavefront step on the
register path (``"blocked"``), or one batch row a thread at a narrow width
(``"row_thread"``), each row's bits unchanged whichever it takes.  A gate
stream that repeats one (B, 4W) block over the window
(time stride 0: the decoder's RepeatVector input, ``ops.project_layer0``)
is read in place, every step from the same rows.  Given the layers' real
widths (``widths``: a pack's ``in_dims`` and ``hidden``), the row-blocked
launch runs only the warps of real elements and ends each chain at its
layer's width (``trims``), with the padded launch's bits.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.core.quant import (
    ActivationSet,
    EXACT,
    PAPER_HW_KERNEL,
    HARD,
    make_act_quant,
)
from repro_torch.kernels import refuse_grad

from .ref import Widths, lstm_stack_ref, normalize_scales

SOURCE = Path(__file__).parent / "csrc" / "lstm_stack.cu"

#: Hopper's per-block shared-memory ceiling (227 KB, opt-in above 48 KB)
MAX_SMEM_BYTES = 232_448

#: the kernel's compile-time geometry (``csrc/lstm_stack.cu``): threads per
#: CTA with the weights in registers, and the width whose weights live there
K_REG_THREADS, K_REG_W = 256, 32

#: rows every thread of the row-blocked wavefront kernel carries through
#: each step (``kBlockedRows`` in ``csrc/lstm_stack.cu``, register path only)
BLOCKED_ROWS = 8

#: the widths with a row-thread instantiation (``by_width`` in
#: ``csrc/lstm_stack.cu``): gw_small's.  A width is 15 instantiations (five
#: dtype pairs, three activation sets); built for the H100, ptxas spilled
#: those of W = 8 with the hard sigmoid, and the source took 57 s of nvcc at
#: W = 9 alone against 171 s with W = 8 and 16 too (without --split-compile)
ROW_THREAD_WIDTHS = (9,)

#: batch rows (threads) of the wrapper's row-thread CTAs (``tools/k1_rows.py``:
#: 32, 64 and 128 within 5% of one another at every batch, 64 never the
#: slowest); ``launch`` takes any multiple of 32 up to ``ROW_THREAD_MAX_ROWS``
ROW_THREAD_ROWS = 64
ROW_THREAD_MAX_ROWS = 128  # kRowThreadMax in csrc/lstm_stack.cu


def weights_in_registers(n_layers: int, width: int) -> bool:
    """Whether the kernels keep the weights in registers at this shape
    (``in_regs`` in ``csrc/lstm_stack.cu``)."""
    return width == K_REG_W and n_layers * 4 * width <= K_REG_THREADS


def row_thread_smem_bytes(n_layers: int, width: int, rows: int = ROW_THREAD_ROWS) -> int:
    """Dynamic shared memory one row-thread CTA of ``rows`` rows takes at
    any storage dtype (the weights are widened to fp32): the Python twin of
    ``row_layout`` in ``csrc/lstm_stack.cu``, which a ``gpu`` test holds
    equal to the library's ``lstm_stack_row_thread_smem_bytes``."""
    def align16(n: int) -> int:
        return (n + 15) & ~15

    w4 = 4 * width
    pitch = w4 if width % 2 else w4 + 4
    state = align16(n_layers * width * rows * 4)
    return (align16(2 * n_layers * width * w4 * 4) + align16(n_layers * w4 * 4)
            + align16(n_layers * 8 * 4) + 2 * state + align16(2 * rows * pitch * 4))


def row_thread_threshold(sm_count: int) -> int:
    """The largest batch that keeps one row a CTA at a row-thread width on a
    card of ``sm_count`` SMs: 24 rows an SM, never fewer than 64
    (``kernel_path`` gives the sweep)."""
    return max(64, 24 * sm_count)


class KernelPath(NamedTuple):
    """A launch's path, which ``kernel_path`` chooses: ``"one_row"`` (one row
    a CTA, or ``rows`` rows one after another: an explicit ``block_b``; the
    step kernel's only path), ``"blocked"`` (``BLOCKED_ROWS`` rows through
    every thread) or ``"row_thread"`` (one row a thread, ``rows`` a CTA)."""

    kind: str
    rows: int


def kernel_path(batch: int, n_layers: int, width: int, sm_count: int,
                block_b: int | None = None) -> KernelPath:
    """The path a wavefront launch of ``batch`` rows at (L, W) takes on a
    card of ``sm_count`` SMs.  An explicit ``block_b`` keeps one row a CTA
    with its rows one after another.  Otherwise a width in
    ``ROW_THREAD_WIDTHS`` whose row-thread layout fits shared memory runs
    one row a thread above ``row_thread_threshold``; the register path runs
    row-blocked above one wave of one-row CTAs (``max(64, sm_count)``); all
    else runs one row a CTA.

    From sweeps on the H100 (``tools/k1_rows.py``, T=100):

    * L=2, W=32: a one-row CTA takes 137 registers a thread, so an SM holds
      one, and up to one wave (B <= the SMs) each runs at the lone CTA's
      latency, which the row block does not beat (B=64: 0.082 ms, against
      0.258).  Past it, 8 rows a thread (two CTAs an SM) run faster (B=512:
      0.299 ms against 0.319; B=4,096: 0.775 against 2.517; B=73,728: 13.07
      against 43.95).
    * L=1, W=9 (``--pack gw_small``): a row-thread launch takes at least
      ~0.35 ms, one warp's 100 dependent steps, while one row a CTA grows by
      ~0.22 ms a wave of 2,112 rows, 16 CTAs an SM (B=2,048: 0.260 ms against
      0.368; 3,072: 0.366 against 0.367; 3,584: 0.420 against 0.368; 32,768:
      3.40 against 0.44; 294,912: 30.17 against 2.78)."""
    if block_b is not None:
        return KernelPath("one_row", int(block_b))
    if (width in ROW_THREAD_WIDTHS
            and row_thread_smem_bytes(n_layers, width) <= MAX_SMEM_BYTES
            and batch > row_thread_threshold(sm_count)):
        return KernelPath("row_thread", ROW_THREAD_ROWS)
    if weights_in_registers(n_layers, width) and batch > max(64, sm_count):
        return KernelPath("blocked", BLOCKED_ROWS)
    return KernelPath("one_row", 1)


def smem_bytes(n_layers: int, width: int, rows: int, w_bytes: int, step: bool) -> int:
    """Dynamic shared memory one CTA of either kernel takes: the Python
    twin of ``smem_layout`` in ``csrc/lstm_stack.cu`` (the library's
    ``lstm_stack_smem_bytes``, which the launch checks), for callers that
    must know it without the library (``autotune.space``'s ``block_b``
    axis).  A ``gpu`` test holds the two equal."""
    def align16(n: int) -> int:
        return (n + 15) & ~15

    w4 = 4 * width
    weights = (0 if weights_in_registers(n_layers, width)
               else align16(n_layers * width * w4 * w_bytes))
    return (2 * weights + align16(n_layers * w4 * 4) + align16(n_layers * 8 * 4)
            + align16(2 * n_layers * rows * width * 4) + align16(n_layers * rows * width * 4)
            + align16(n_layers * rows * w4 * 4) + align16(2 * rows * (width if step else w4) * 4))


_COMPUTE = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ACT_IDS = {EXACT.name: 0, HARD.name: 1, PAPER_HW_KERNEL.name: 2}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE, split=True)  # the row-thread kernels unroll whole rows
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, ints in (("lstm_stack_wavefront", [i32] * 10 + [i64, ptr]),  # ..., widths
                       ("lstm_stack_step", [i32] * 10)):
        fn = getattr(built.lib, name)
        fn.argtypes = [ptr] * 10 + ints + [ptr]
        fn.restype = i32
    built.lib.lstm_stack_smem_bytes.argtypes = [i32] * 5
    built.lib.lstm_stack_smem_bytes.restype = ctypes.c_longlong
    built.lib.lstm_stack_row_thread_smem_bytes.argtypes = [i32] * 3
    built.lib.lstm_stack_row_thread_smem_bytes.restype = ctypes.c_longlong
    for name in ("lstm_stack_threads", "lstm_stack_weights_in_registers"):
        getattr(built.lib, name).argtypes = [i32] * 2
        getattr(built.lib, name).restype = i32
    built.lib.lstm_stack_ctas_per_sm.argtypes = [i32] * 6 + [ptr]
    built.lib.lstm_stack_ctas_per_sm.restype = i32
    return built


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operands(name: str, w_x, w_h, b, h0, c0, scales, width: int,
                   batch: int) -> None:
    """Shape/dtype/device checks shared by both kernel wrappers."""
    n_layers = w_h.shape[0]
    w4 = 4 * width
    shapes = {
        "w_x": (w_x, (n_layers, width, w4)), "w_h": (w_h, (n_layers, width, w4)),
        "b": (b, (n_layers, w4)), "h0": (h0, (n_layers, batch, width)),
        "c0": (c0, (n_layers, batch, width)),
    }
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {want}")
    if w_x.dtype != w_h.dtype or w_h.dtype not in _WEIGHT:
        raise ValueError(
            f"{name}: weights must share one storage dtype of "
            f"{sorted(map(str, _WEIGHT))}; got {w_x.dtype}/{w_h.dtype}"
        )
    if h0.dtype not in _COMPUTE:
        raise ValueError(f"{name}: unsupported compute dtype {h0.dtype}")
    if w_h.dtype == torch.float32 and h0.dtype != torch.float32:
        raise ValueError(
            f"{name}: fp32 weight storage is wider than compute dtype "
            f"{h0.dtype}"
        )
    if b.dtype != torch.float32 or c0.dtype != torch.float32:
        raise ValueError(f"{name}: b and c0 must be fp32")
    if w_h.dtype == torch.int8 and scales is None:
        raise ValueError(
            f"{name}: int8 weights need per-layer dequant `scales`; pack them "
            "with pack_stack(weight_dtype='int8') instead of casting"
        )


def kernel_act_id(acts: ActivationSet) -> int:
    if acts.name not in _ACT_IDS:
        raise ValueError(
            f"activation set {acts.name!r} has no kernel form; pass its "
            "kernel_safe() twin"
        )
    return _ACT_IDS[acts.name]


def repeated_stream(x: torch.Tensor) -> bool:
    """Whether a (T, B, 4W) gate stream is one (B, 4W) block repeated over
    T > 1 steps that the wavefront kernel reads in place: time stride 0,
    each step's rows contiguous and 16-byte aligned."""
    return (x.shape[0] > 1 and x.stride(0) == 0 and x[0].is_contiguous()
            and x.data_ptr() % 16 == 0)


#: each path's code in ``csrc/lstm_stack.cu`` (``enum Path``)
PATH_CODES = {"one_row": 0, "blocked": 1, "row_thread": 2}


def trims(widths: Widths | None, width: int) -> bool:
    """Whether real widths ``(in_dims, hidden)`` run a layer narrower than
    the pack width on the row-blocked path: a hidden width, or an inner
    layer's input width, under ``width`` (layer 0's input product is
    streamed in, so its input width does not count)."""
    if widths is None:
        return False
    in_dims, hidden = widths
    return any(h < width for h in hidden) or any(i < width for i in in_dims[1:])


def widths_arg(widths: Widths | None, n_layers: int, width: int):
    """``widths`` as the library takes them: 2L C ints, the input widths
    then the hidden widths (None: the padded work).  Refuses a geometry
    that is not the pack's: the wrong number of layers, or a width outside
    [1, ``width``]."""
    if widths is None:
        return None
    in_dims, hidden = (tuple(int(w) for w in ws) for ws in widths)
    if len(in_dims) != n_layers or len(hidden) != n_layers or not all(
            1 <= w <= width for w in in_dims + hidden):
        raise ValueError(f"widths {widths} are not the real widths of an L={n_layers}, "
                         f"W={width} pack")
    return (ctypes.c_int * (2 * n_layers))(*in_dims, *hidden)


def launch(entry: str, x, w_x, w_h, b, h0, c0, scales, hs, h_f, c_f, *,
           t_len: int, acts: ActivationSet, act_bits: int | None,
           path: KernelPath, fuse_gates: bool = False, widths: Widths | None = None) -> None:
    """Launch one of the two kernels on ``path`` (a ``KernelPath``; the step
    kernel's is one row a CTA) on the current stream.  ``widths`` (the
    row-blocked path only): the layers' real ``(in_dims, hidden)`` of a
    pack; the launch then runs only the warps of real elements and ends
    each chain at its layer's width.  A path with no instantiation for ``entry`` at
    (L, W), or widths off the row-blocked path, is refused before the
    library loads; raise also if the launch is refused
    (``cudaGetLastError`` of the launch is non-zero)."""
    n_layers, width, batch = w_h.shape[0], w_h.shape[1], h0.shape[1]
    if 4 * width > 1024:
        raise ValueError(f"width {width} needs {4 * width} threads per block (> 1024)")
    kind, rows = path
    wavefront = entry == "lstm_stack_wavefront"
    if not {"one_row": rows >= 1,
            "blocked": wavefront and rows == BLOCKED_ROWS
            and weights_in_registers(n_layers, width),
            "row_thread": wavefront and width in ROW_THREAD_WIDTHS and rows % 32 == 0
            and 0 < rows <= ROW_THREAD_MAX_ROWS}.get(kind, False):
        raise ValueError(
            f"{entry}: no kernel for path {kind!r} with {rows} rows at L={n_layers}, W={width} "
            f"(blocked and row_thread: wavefront only, {BLOCKED_ROWS} rows on the register "
            f"path, and 32-{ROW_THREAD_MAX_ROWS} rows in steps of 32 at W in {ROW_THREAD_WIDTHS})")
    if widths is not None and kind != "blocked":
        raise ValueError(f"{entry}: real widths are taken on the blocked path only, not {kind!r}")
    c_widths = widths_arg(widths, n_layers, width)
    built = library()
    smem = (built.lib.lstm_stack_row_thread_smem_bytes(n_layers, width, rows)
            if kind == "row_thread"
            else built.lib.lstm_stack_smem_bytes(n_layers, width, rows, _WEIGHT[w_h.dtype],
                                                 int(not wavefront)))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{entry}: L={n_layers}, W={width} at {w_h.dtype} storage needs "
            f"{smem} B of shared memory per block (> {MAX_SMEM_BYTES}); use "
            "narrower weight storage or a smaller block_b"
        )
    ops = [x, w_x, w_h, b, scales, h0, c0]  # scales None: the kernel uses ones
    for t in ops:
        if t is not None and t.device != h0.device:
            raise ValueError(f"{entry}: operands on {t.device} and {h0.device}")
    # the kernel reads whole 4-byte words, so every operand is contiguous
    # and 16-byte aligned (a fresh allocation is; an offset view is copied),
    # but for the wavefront kernel's stream repeated over time, read in place
    repeated = wavefront and repeated_stream(x)
    ops = [t if t is None or (t is x and repeated)
           or (t.is_contiguous() and t.data_ptr() % 16 == 0)
           else t.clone(memory_format=torch.contiguous_format) for t in ops]
    # floats between timesteps of the stream, and the real widths (wavefront only)
    tail = [0 if repeated else batch * 4 * width, c_widths] if wavefront else []
    last = PATH_CODES[kind] if wavefront else int(fuse_gates)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        err = getattr(built.lib, entry)(
            *[None if t is None else t.data_ptr() for t in ops],
            hs.data_ptr(), h_f.data_ptr(), c_f.data_ptr(),
            t_len, batch, n_layers, width, rows, _COMPUTE[h0.dtype],
            _WEIGHT[w_h.dtype], kernel_act_id(acts), act_bits or 0, last, *tail,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def lstm_stack(
    xw0: torch.Tensor,    # (T, B, 4W) fp32: layer 0 mvm_x output + bias, time-major
                          # (time stride 0 where one (B, 4W) block repeats)
    w_x: torch.Tensor,    # (L, W, 4W) packed input projections
    w_h: torch.Tensor,    # (L, W, 4W) packed recurrent weights
    b: torch.Tensor,      # (L, 4W) fp32 packed biases
    h0: torch.Tensor,     # (L, B, W) compute dtype
    c0: torch.Tensor,     # (L, B, W) fp32
    *,
    scales: torch.Tensor | None = None,  # (L, 2) or (L, 2, 4) fp32, int8 only
    acts: ActivationSet = EXACT,
    act_bits: int | None = None,
    block_b: int | None = None,
    widths: Widths | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the fused L-layer stack over a window.

    Returns (hs of the last layer (T, B, W), h_final (L, B, W), c_final
    fp32 (L, B, W)), freshly allocated; the initial state is not written.
    ``block_b`` is the number of batch rows one CTA runs one after another;
    without it ``kernel_path`` chooses the path by the shape and the batch.
    Weight storage may be narrower than the compute dtype; int8 codes need
    ``scales``, applied per gate to the fp32 accumulators.  ``widths``: the
    real ``(in_dims, hidden)`` of a pack (weights zero past each layer's
    widths); the row-blocked launch and the plain version then skip the
    padding's work.  Every real output keeps the padded work's bits, and so
    does every padded one where ``h0`` and ``c0`` hold +0 at the padded
    positions (a zero state, or one packed from the real widths); a state
    with other values there is not read by a real output.
    """
    refuse_grad("lstm_stack", xw0, w_x, w_h, b, h0, c0, scales)
    t_len, batch, w4 = xw0.shape
    width = w4 // 4
    check_operands("lstm_stack", w_x, w_h, b, h0, c0, scales, width, batch)
    if xw0.dtype != torch.float32:
        raise ValueError(f"lstm_stack: xw0 must be fp32, got {xw0.dtype}")
    kernel_act_id(acts)  # both paths take only activation sets with a kernel form
    if scales is not None:
        scales = normalize_scales(scales, w_h.shape[0])
    if xw0.device.type == "cpu":
        return lstm_stack_ref(
            xw0, w_x, w_h, b, h0, c0, scales=scales, sigma=acts.sigma,
            tanh=acts.tanh,
            act_quant=make_act_quant(act_bits) if act_bits is not None else None,
            widths=widths,
        )
    if xw0.device.type != "cuda":
        raise ValueError(f"lstm_stack: unsupported device {xw0.device}")
    hs = torch.empty(t_len, batch, width, dtype=h0.dtype, device=h0.device)
    h_f = torch.empty_like(h0)
    c_f = torch.empty_like(c0)
    path = kernel_path(batch, w_h.shape[0], width, sm_count(h0.device.index), block_b)
    trimmed = path.kind == "blocked" and trims(widths, width)
    launch("lstm_stack_wavefront", xw0, w_x, w_h, b, h0, c0, scales, hs, h_f,
           c_f, t_len=t_len, acts=acts, act_bits=act_bits, path=path,
           widths=widths if trimmed else None)
    lstm_stack.launches += 1
    lstm_stack.launches_by_path[path.kind] += 1
    lstm_stack.repeated_input_launches += repeated_stream(xw0)
    lstm_stack.trimmed_launches += trimmed
    return hs, h_f, c_f


#: kernel launches since the count was last set to 0 (plain-version calls
#: on CPU tensors do not count), those whose layer-0 stream repeated one
#: block over time (time stride 0), and those that ran at least one layer
#: narrower than the pack (``trims``)
lstm_stack.launches = 0
lstm_stack.repeated_input_launches = 0
lstm_stack.trimmed_launches = 0
#: the same launches by the kind of their ``KernelPath``; cleared with
#: ``lstm_stack.launches_by_path.clear()``
lstm_stack.launches_by_path = collections.Counter()
