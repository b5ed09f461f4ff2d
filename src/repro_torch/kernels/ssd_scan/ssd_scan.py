"""Chunked Mamba-2 SSD scan: two CUDA launches per call.

The state-space-duality recurrence (per batch row and head, scalar decay
per head):

    S_t = exp(dt_t a) S_{t-1} + dt_t (x_t outer B_t),    y_t = C_t . S_t

in chunks of L steps: the intra-chunk part as products of L x L and L x P
tiles, the inter-chunk part through the carried fp32 state.  The kernels
(``csrc/ssd_scan.cu``, with their design notes) compute C B^T once per
(batch row, group, chunk) into a scratch, then run one CTA per (batch row,
head, tile of 16 state rows) that keeps its S tile in registers across the
chunks.  Every product is an fp32 FMA chain in the plain version's order on
the CUDA cores, so the kernel's results equal the plain version's on the
card bit for bit.  It reads the model's (B, T, H, P) and (B, T, G, N)
tensors as they are (views into one projection included), indexes each
head's B/C group itself and runs a ragged last chunk at its real length.

``ssd_chunked`` is the plain version: the reference's pure-jnp chunked
algorithm (``repro/models/ssm.py``) in PyTorch, the same steps in the same
order (its T padding with zero dt is the exact no-op the kernel's ragged
chunk computes).  ``ssd_scan`` runs it for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.lstm_stack.lstm_stack import MAX_SMEM_BYTES

SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library; returns ``Built``."""
    from repro_torch.kernels._build import build

    built = build(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    built.lib.ssd_scan.argtypes = [ptr] * 9 + [i64] * 4 + [i32] * 8 + [ptr]
    built.lib.ssd_scan.restype = i32
    built.lib.ssd_scan_smem_bytes.argtypes = [i32] * 2
    built.lib.ssd_scan_smem_bytes.restype = i64
    built.lib.ssd_scan_ctas.argtypes = [i32] * 3
    built.lib.ssd_scan_ctas.restype = i64
    built.lib.ssd_scan_scratch_floats.argtypes = [i32] * 4
    built.lib.ssd_scan_scratch_floats.restype = i64
    return built


#: the kernel's limits: chunks of at most MAX_CHUNK steps (four warps of 16
#: rows), P and N whole multiples of 8, N at most MAX_STATE
MAX_CHUNK, MAX_STATE = 64, 128


def ssd_chunked(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) fp32
    a: torch.Tensor,      # (H,) negative decay rates
    bm: torch.Tensor,     # (B, T, G, N)
    cm: torch.Tensor,     # (B, T, G, N)
    s0: torch.Tensor | None = None,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,P) in x's dtype, final state (B,H,P,N) fp32)."""
    batch, t_len, heads, p = x.shape
    groups, n = bm.shape[2], bm.shape[3]
    rep = heads // groups
    chunk = min(chunk, max(t_len, 1))
    pad = (-t_len) % chunk
    if pad:  # zero dt => exact no-op steps
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    n_chunks = (t_len + pad) // chunk

    bm_h = bm.repeat_interleave(rep, dim=2).float()           # (B,T,H,N)
    cm_h = cm.repeat_interleave(rep, dim=2).float()
    alpha = (dt * a[None, None, :]).float()                   # (B,T,H)

    def to_chunks(v):
        return v.reshape(batch, n_chunks, chunk, *v.shape[2:]).movedim(1, 0)

    xs, dts, als = to_chunks(x.float()), to_chunks(dt.float()), to_chunks(alpha)
    bs, cs = to_chunks(bm_h), to_chunks(cm_h)
    s_prev = (torch.zeros(batch, heads, p, n, device=x.device) if s0 is None
              else s0.float())
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for i in range(n_chunks):
        xc, dtc, alc, bc, cc = xs[i], dts[i], als[i], bs[i], cs[i]
        cum = torch.cumsum(alc, dim=1)                         # (B,L,H)
        rel = cum[:, :, None, :] - cum[:, None, :, :]          # (B,L,L,H)
        mask = tril[None, :, :, None]
        decay = torch.where(mask, torch.exp(torch.where(mask, rel, 0.0)), 0.0)
        scores = torch.einsum("blhn,bshn->blsh", cc, bc)       # (B,L,L,H)
        m = scores * decay * dtc[:, None, :, :]                # dt_s on col s
        y = torch.einsum("blsh,bshp->blhp", m, xc)             # intra-chunk
        y = y + torch.einsum(                                  # inter-chunk
            "blhn,bhpn->blhp", cc * torch.exp(cum)[..., None], s_prev)
        total = cum[:, -1, :]                                  # (B,H)
        xw = xc * (dtc * torch.exp(total[:, None, :] - cum))[..., None]
        s_prev = torch.exp(total)[:, :, None, None] * s_prev + torch.einsum(
            "bshp,bshn->bhpn", xw, bc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(batch, t_len + pad, heads, p)[:, :t_len]
    return y.to(x.dtype), s_prev


def ssd_scan(
    x: torch.Tensor,      # (B, T, H, P) fp32 or bf16
    dt: torch.Tensor,     # (B, T, H) fp32
    a: torch.Tensor,      # (H,) fp32, negative
    bm: torch.Tensor,     # (B, T, G, N) x's dtype
    cm: torch.Tensor,     # (B, T, G, N) x's dtype
    s0: torch.Tensor | None = None,  # (B, H, P, N) fp32
    *,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan over T steps in chunks of ``chunk`` (at most T).  Returns
    (y (B,T,H,P) in x's dtype, s_final (B,H,P,N) fp32), freshly allocated."""
    if x.dim() != 4 or bm.dim() != 4 or tuple(cm.shape) != tuple(bm.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, b {tuple(bm.shape)}, c "
                         f"{tuple(cm.shape)}; want (B,T,H,P) and two (B,T,G,N)")
    batch, t_len, heads, p = x.shape
    groups, n = bm.shape[2], bm.shape[3]
    if tuple(bm.shape[:2]) != (batch, t_len) or groups < 1 or heads % groups:
        raise ValueError(f"ssd_scan: b {tuple(bm.shape)} does not fit x "
                         f"{tuple(x.shape)} (G must divide H)")
    if tuple(dt.shape) != (batch, t_len, heads) or tuple(a.shape) != (heads,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, a {tuple(a.shape)}; want "
                         f"{(batch, t_len, heads)} and ({heads},)")
    if s0 is not None and tuple(s0.shape) != (batch, heads, p, n):
        raise ValueError(f"ssd_scan: s0 {tuple(s0.shape)}, want {(batch, heads, p, n)}")
    if x.dtype not in _DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, b, c must share fp32 or bf16, got {x.dtype}, "
                         f"{bm.dtype}, {cm.dtype}")
    for name, t in (("dt", dt), ("a", a), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be fp32, got {t.dtype}")
    if any(t is not None and t.device != x.device for t in (dt, a, bm, cm, s0)):
        raise ValueError("ssd_scan: operands on different devices")
    if chunk < 1 or t_len < 1:
        raise ValueError(f"ssd_scan: chunk and T must be >= 1, got {chunk} and {t_len}")
    refuse_grad("ssd_scan", x, dt, a, bm, cm, s0)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, bm, cm, s0=s0, chunk=chunk)
    return _launch(x, dt, a, bm, cm, s0, min(chunk, max(t_len, 1)))


def _strided_ok(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` (B, T, heads or groups, width) in
    place: the last two dims contiguous, every row 16-byte aligned."""
    size = t.element_size()
    rows = all(t.stride(d) * size % 16 == 0 for d in (0, 1) if t.shape[d] > 1)
    inner = t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == t.shape[3])
    return rows and inner and t.data_ptr() % 16 == 0


def _launch(x, dt, a, bm, cm, s0, chunk):
    """Launch the kernel on the current stream; raise if the launch is
    refused (``cudaGetLastError`` of the launch is non-zero)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    batch, t_len, heads, p = x.shape
    groups, n = bm.shape[2], bm.shape[3]
    if chunk > MAX_CHUNK or p % 8 or n % 8 or n > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK}, P and N multiples "
                         f"of 8 and N <= {MAX_STATE}; got chunk={chunk}, P={p}, N={n}")
    y = torch.empty(batch, t_len, heads, p, dtype=x.dtype, device=x.device)
    s_f = torch.empty(batch, heads, p, n, dtype=torch.float32, device=x.device)
    built = library()
    smem = built.lib.ssd_scan_smem_bytes(n, _DTYPES[x.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: N={n} needs {smem} B of shared memory per block "
                         f"(> {MAX_SMEM_BYTES})")
    # x, B and C are read in place where their layout allows (the SSM
    # block's views into its projection do); anything else is copied once
    if not _strided_ok(x):
        x = x.clone(memory_format=torch.contiguous_format)
    if not (_strided_ok(bm) and _strided_ok(cm) and bm.stride() == cm.stride()):
        bm, cm = (t.clone(memory_format=torch.contiguous_format) for t in (bm, cm))
    dt, a = dt.contiguous(), a.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    # C B^T of every (batch row, group, chunk), made by the first of the
    # call's two kernels for the second
    cb = torch.empty(built.lib.ssd_scan_scratch_floats(batch, groups, t_len, chunk),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_f.data_ptr(), cb.data_ptr(),
            x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
            batch, t_len, heads, groups, p, n, chunk, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, s_f


#: launches of the kernel since the count was last set to 0 (plain-version
#: calls on CPU tensors do not count)
ssd_scan.launches = 0
