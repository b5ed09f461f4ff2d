"""Single-query (decode) GQA attention over a KV cache: one CUDA launch per
call.

One new token per batch row attends to the first ``lengths[b]`` rows of a
(B, S, Hkv, D) cache; G = Hq / Hkv query heads share each cache head.  The
kernel (``csrc/decode_attn.cu``, with its design notes) runs one CTA per
(batch row, KV head) and streams that head's valid rows through shared
memory with an fp32 online softmax.  ``decode_attn_plain`` is the same
arithmetic in PyTorch: q scaled first, fp32 scores, the running (m, l, acc)
updated block by block of ``BLOCK_S`` rows, rows at or past the length
contributing 0, one rounding to q's dtype at the end.

``decode_attn`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.lstm_stack.lstm_stack import MAX_SMEM_BYTES

SOURCE = Path(__file__).parent / "csrc" / "decode_attn.cu"

#: cache rows per staged block (the kernel's kBlockS)
BLOCK_S = 32

#: the TPU kernel's mask value; the running max starts here
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.decode_attn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    built.lib.decode_attn.restype = i32
    built.lib.decode_attn_smem_bytes.argtypes = [i32, i32]
    built.lib.decode_attn_smem_bytes.restype = ctypes.c_longlong
    built.lib.decode_attn_max_gd.argtypes = []
    built.lib.decode_attn_max_gd.restype = i32
    return built


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
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    m = torch.full((batch, hkv, g), NEG_INF, device=q.device)
    l_sum = torch.zeros(batch, hkv, g, device=q.device)
    acc = torch.zeros(batch, hkv, g, d, device=q.device)
    stop = min(int(lengths.max()), s_len) if batch else 0
    for s0 in range(0, stop, BLOCK_S):
        rows = (torch.arange(s0, min(s0 + BLOCK_S, s_len), device=q.device)[None]
                < lengths[:, None])                        # (B, Sb)
        # rows past a length are never read by the kernel: zero them here
        kb = torch.where(rows[..., None, None], k[:, s0 : s0 + BLOCK_S].float(), 0.0)
        vb = torch.where(rows[..., None, None], v[:, s0 : s0 + BLOCK_S].float(), 0.0)
        valid = rows[:, None, None, :]                     # (B, 1, 1, Sb)
        scores = torch.where(valid, torch.einsum("bhgd,bshd->bhgs", qf, kb), NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(valid, torch.exp(scores - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l_sum = corr * l_sum + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bhgs,bshd->bhgd", p, vb)
        m = m_new
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
    and v share one dtype (fp32 or bf16) and one device."""
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
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, lengths)
    return _launch(q, k, v, lengths)


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
    smem = built.lib.decode_attn_smem_bytes(g, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attn: D={d}, G={g} needs {smem} B of shared memory "
                         f"per block (> {MAX_SMEM_BYTES})")
    if lengths.dtype != torch.int32:
        raise ValueError(f"decode_attn: lengths must be int32, got {lengths.dtype}")
    q, k, v, lengths = (t if t.is_contiguous() else t.contiguous()
                        for t in (q, k, v, lengths))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = built.lib.decode_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    lengths.data_ptr(), out.data_ptr(), batch, s_len,
                                    hkv, g, d, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: CUDA error {err}")
    decode_attn.launches += 1
    return out


#: launches of the kernel since the count was last set to 0 (plain-version
#: calls on CPU tensors do not count)
decode_attn.launches = 0
