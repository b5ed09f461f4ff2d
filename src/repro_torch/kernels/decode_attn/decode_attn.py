"""Single-query (decode) GQA attention over a KV cache: one CUDA launch per
call.

One new token per batch row attends to the first ``lengths[b]`` rows of a
(B, S, Hkv, D) cache; G = Hq / Hkv query heads share each cache head.  The
kernel (``csrc/decode_attn.cu``, with its design notes) splits each (row,
KV head)'s cache into splits of ``SPLIT_ROWS`` rows, one CTA each, staged
through shared memory in blocks of ``BLOCK_S`` rows; each split's softmax
partial (m, l, acc) goes to a scratch, and the last CTA of the (row, head)
combines them in split order.  ``decode_attn_plain`` is the same arithmetic
in PyTorch: q scaled first, fp32 scores, one partial per split over its
valid rows (rows at or past the length contribute 0 and are never read),
the combine in split order 0..n-1, one rounding to q's dtype at the end.

``decode_attn`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.lstm_stack.lstm_stack import MAX_SMEM_BYTES

SOURCE = Path(__file__).parent / "csrc" / "decode_attn.cu"

#: cache rows per split: one CTA, one softmax partial (the kernel's
#: kSplitRows).  A constant, so a row's output does not depend on the batch
SPLIT_ROWS = 64

#: cache rows per staged block inside a split (the kernel's kBlockS); the
#: stages carry no arithmetic of their own: a split's softmax is taken over
#: all its rows at once
BLOCK_S = 32

#: the TPU kernel's mask value; an empty split's maximum
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    built.lib.decode_attn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    built.lib.decode_attn.restype = i32
    built.lib.decode_attn_smem_bytes.argtypes = [i32] * 3
    built.lib.decode_attn_smem_bytes.restype = i64
    built.lib.decode_attn_part_floats.argtypes = [i32] * 5
    built.lib.decode_attn_part_floats.restype = i64
    for name in ("decode_attn_max_gd", "decode_attn_split_rows", "decode_attn_block_rows"):
        getattr(built.lib, name).argtypes = []
        getattr(built.lib, name).restype = i32
    if (built.lib.decode_attn_split_rows(), built.lib.decode_attn_block_rows()) != \
            (SPLIT_ROWS, BLOCK_S):
        raise RuntimeError("decode_attn: SPLIT_ROWS/BLOCK_S differ from the kernel's")
    return built


def n_splits(s_len: int) -> int:
    """Splits (CTAs per row and KV head) of a cache of ``s_len`` rows."""
    return -(-s_len // SPLIT_ROWS)


def decode_attn_plain(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch; returns (B, Hq, D) in q's dtype."""
    batch, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d**0.5
    qf = (q.float() * scale).reshape(batch, hkv, g, d)
    lengths = lengths.to(device=q.device, dtype=torch.int64).clamp(0, s_len)
    # one partial per split: m = max of its valid scores, l = sum of
    # exp(score - m), acc = exp(score - m) @ V; a split past a row's length
    # is empty (m = NEG_INF, l = 0, acc = 0)
    parts = []
    stop = int(lengths.max()) if batch else 0
    for s0 in range(0, stop, SPLIT_ROWS):
        s1 = min(s0 + SPLIT_ROWS, s_len)
        rows = torch.arange(s0, s1, device=q.device)[None] < lengths[:, None]  # (B, Sb)
        # rows past a length are never read by the kernel: zero them here
        kb = torch.where(rows[..., None, None], k[:, s0:s1].float(), 0.0)
        vb = torch.where(rows[..., None, None], v[:, s0:s1].float(), 0.0)
        valid = rows[:, None, None, :]                     # (B, 1, 1, Sb)
        scores = torch.where(valid, torch.einsum("bhgd,bshd->bhgs", qf, kb), NEG_INF)
        m = scores.amax(dim=-1)
        p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bhgs,bshd->bhgd", p, vb)))
    # the combine, in split order 0..n-1 (empty splits weigh exp(NEG_INF - m*) = 0)
    m_star = torch.full((batch, hkv, g), NEG_INF, device=q.device)
    for m, _, _ in parts:
        m_star = torch.maximum(m_star, m)
    l_sum = torch.zeros(batch, hkv, g, device=q.device)
    acc = torch.zeros(batch, hkv, g, d, device=q.device)
    for m, l_i, acc_i in parts:
        w = torch.exp(m - m_star)
        l_sum = l_sum + w * l_i
        acc = acc + w[..., None] * acc_i
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    return out.reshape(batch, hq, d).to(q.dtype)


def decode_attn(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32, each in [1, S]
) -> torch.Tensor:
    """Attention of each row's query heads over its first ``lengths[b]``
    cache rows; returns (B, Hq, D) in q's dtype, freshly allocated.  q, k
    and v share one dtype (fp32 or bf16) and one device; on the card k and
    v must be contiguous and 16-byte aligned (ValueError otherwise)."""
    if q.dim() != 3 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B, Hq, D) and two (B, S, Hkv, D)")
    batch, hq, d = q.shape
    if k.shape[0] != batch or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"decode_attn: q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k.shape)} (Hq must be a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"decode_attn: q, k, v must share fp32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(lengths.shape) != (batch,):
        raise ValueError(f"decode_attn: lengths has shape {tuple(lengths.shape)}, "
                         f"want ({batch},)")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attn: operands on different devices")
    refuse_grad("decode_attn", q, k, v)
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, lengths)
    return _launch(q, k, v, lengths)


#: per (device, stream): the kernel's per-(row, KV head) counters, zero
#: between launches (each launch leaves them zero); grown on demand
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


def _launch(q, k, v, lengths):
    """Launch the kernel on the current stream; raise if the launch is
    refused (``cudaGetLastError`` of the launch is non-zero)."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    batch, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    built = library()
    if g * d > built.lib.decode_attn_max_gd():
        raise ValueError(f"decode_attn: G*D = {g}*{d} exceeds the "
                         f"{built.lib.decode_attn_max_gd()} one CTA holds")
    vec = 16 // q.element_size()
    if d % vec:
        raise ValueError(f"decode_attn: D={d} is not a multiple of {vec}, the "
                         f"{q.dtype} elements of one 16-byte load")
    smem = built.lib.decode_attn_smem_bytes(g, d, _DTYPES[q.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attn: D={d}, G={g} needs {smem} B of shared memory "
                         f"per block (> {MAX_SMEM_BYTES})")
    if lengths.dtype != torch.int32:
        raise ValueError(f"decode_attn: lengths must be int32, got {lengths.dtype}")
    if batch == 0 or s_len == 0:
        raise ValueError(f"decode_attn: empty batch or cache ({batch}, {s_len})")
    # the cache is read by 16-byte copies in place: a copy of it would cost
    # as much as the kernel, so a cache that is not contiguous and 16-byte
    # aligned is refused; q (read 16 bytes at a time) and lengths are a few
    # KB and are copied when they are not
    for name, t in (("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attn: the cache {name} must be contiguous and "
                             f"16-byte aligned (strides {t.stride()}, address "
                             f"{t.data_ptr():#x})")
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.clone(memory_format=torch.contiguous_format)
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    part = torch.empty(built.lib.decode_attn_part_floats(batch, s_len, hkv, g, d),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        count = _counters(q.device, stream, batch * hkv)
        err = built.lib.decode_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                                    count.data_ptr(), batch, s_len, hkv, g, d,
                                    _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: CUDA error {err}")
    decode_attn.launches += 1
    return out


#: launches of the kernel since the count was last set to 0 (plain-version
#: calls on CPU tensors do not count)
decode_attn.launches = 0
