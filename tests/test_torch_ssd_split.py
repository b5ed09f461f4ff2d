"""The roundings of K4's tensor-core path, on the CPU, at mamba2's widths.

The SSD scan kernel (``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``)
runs its four chunk products as bf16 x bf16 products with fp32 sums (the
tensor cores' ``mma.m16n8k16``).  A bf16 operand (x, B, C of a bf16 model)
enters as it is.  An fp32 operand the kernel derives (M, the state S, xw =
x * dt * exp(total - cum)) enters as three bf16 parts that sum to it
exactly; fp32 x, B and C (an fp32 model) enter as a bf16 high and low part.
A product is each part of one operand times the other's high part, plus
the high part times the other's remaining parts.  ``split_twin`` below is
that arithmetic in PyTorch: each operand split as the kernel splits it,
every product of two bf16 values exact in fp32, the sums in IEEE fp32.  It
shows on the CPU, without a card, that the operand splits' roundings fit
the limits the kernel is held to:

* against the port's plain version ``ssd_chunked``: rtol/atol 2e-4 for fp32
  y and for the state (the reference's own tolerance for this kernel), and
  rtol 8e-3 / atol 1e-3 for bf16 y (one bf16 ulp), as ``chip_smoke.py``
  holds the kernel on the card;
* against the reference's pure-jnp ``ssd_chunked`` (``repro.models.ssm``):
  the tolerances of ``tests/test_torch_ssd_scan.py`` (2e-4; 0.03 for bf16
  y, rounded once in each package).

What the twin does not model is the tensor cores' own accumulation, which
drops the low bits of its sums toward zero rather than rounding them; the
kernel keeps each split's small parts in accumulators of their own for
that reason, and only the card shows what is left of it: ``chip_smoke.py``
(phase 11) and ``tests/test_torch_cuda.py`` fail when the bf16 y elements
that round apart from ``ssd_chunked`` lean toward zero.

Widths are mamba2-130m's (H=24, P=64, N=128, chunk 64) at B=1 and T=130
(two full chunks and a ragged one), inputs made by numpy from a seed as the
SSM block forms them.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as _r_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402

r_chunked = jax.jit(_r_chunked, static_argnames="chunk")

K4_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=8e-3, atol=1e-3)     # kernel vs plain, bf16 y (chip_smoke.py)
REF_BF16_TOL = dict(rtol=0.03, atol=0.03)  # vs the reference, bf16 y (test_torch_ssd_scan.py)
CHUNK = 64


def _parts(v: torch.Tensor, n: int) -> list:
    """fp32 -> n bf16 parts (widened back to fp32): bf16(v), then bf16 of
    each residual.  One part for a bf16 value; three sum to v exactly."""
    out = []
    for _ in range(n):
        part = v.to(torch.bfloat16).float()
        out.append(part)
        v = v - part
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, eq: str, na: int, nb: int):
    """einsum ``eq`` of a (in ``na`` parts) and b (in ``nb`` parts) as the
    kernel forms it: every part of a times b's high part, plus a's high
    part times b's other parts."""
    pa, pb = _parts(a, na), _parts(b, nb)
    out = torch.einsum(eq, pa[0], pb[0])
    for part in pa[1:]:
        out = out + torch.einsum(eq, part, pb[0])
    for part in pb[1:]:
        out = out + torch.einsum(eq, pa[0], part)
    return out


def split_twin(x, dt, a, bm, cm, s0=None, chunk=CHUNK):
    """The kernel's chunked scan with its operand roundings.  Shapes as
    ``ssd_chunked``; returns (y in x's dtype, final state fp32)."""
    batch, t_len, heads, p = x.shape
    groups, n = bm.shape[2], bm.shape[3]
    n_in = 1 if x.dtype == torch.bfloat16 else 2  # parts of x, B, C; derived operands: 3
    rep = heads // groups
    xf = x.float().movedim(2, 1)                                   # (B, H, T, P)
    bf = bm.float().repeat_interleave(rep, dim=2).movedim(2, 1)    # (B, H, T, N)
    cf = cm.float().repeat_interleave(rep, dim=2).movedim(2, 1)
    dtf = dt.float().movedim(2, 1)                                 # (B, H, T)
    s = (torch.zeros(batch, heads, p, n) if s0 is None else s0.float().clone())
    ys = []
    for t0 in range(0, t_len, chunk):
        lc = min(chunk, t_len - t0)
        xc, bc, cc = xf[:, :, t0:t0 + lc], bf[:, :, t0:t0 + lc], cf[:, :, t0:t0 + lc]
        dtc = dtf[:, :, t0:t0 + lc]
        cum = torch.cumsum(dtc * a[None, :, None], dim=-1)       # (B, H, lc)
        total = cum[..., -1:]
        cb = _mm(cc, bc, "bhtn,bhsn->bhts", n_in, n_in)
        tril = torch.ones(lc, lc, dtype=torch.bool).tril()
        rel = torch.where(tril, cum[..., :, None] - cum[..., None, :], 0.0)
        m = torch.where(tril, cb * torch.exp(rel) * dtc[..., None, :], 0.0)
        y = _mm(m, xc, "bhts,bhsp->bhtp", 3, n_in)
        y = y + torch.exp(cum)[..., None] * _mm(cc, s, "bhtn,bhpn->bhtp", n_in, 3)
        xw = xc * (dtc * torch.exp(total - cum))[..., None]
        s = torch.exp(total)[..., None] * s + _mm(xw, bc, "bhsp,bhsn->bhpn", 3, n_in)
        ys.append(y)
    y = torch.cat(ys, dim=2).movedim(1, 2)
    return y.to(x.dtype), s


def _inputs(seed, batch, t_len, heads, groups, p, n, dtype, nonzero):
    """Model-shaped inputs: dt = softplus(raw + dt_bias), a = -exp(a_log)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt_bias = rng.standard_normal(heads) * 0.5
    a = (-np.exp(rng.standard_normal(heads) * 0.5)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, t_len, heads)) + dt_bias)).astype(f32)
    x = rng.standard_normal((batch, t_len, heads, p)).astype(f32)
    bm = (rng.standard_normal((batch, t_len, groups, n)) * 0.3).astype(f32)
    cm = (rng.standard_normal((batch, t_len, groups, n)) * 0.3).astype(f32)
    s0 = (rng.standard_normal((batch, heads, p, n)) * 0.3).astype(f32) if nonzero else None
    tx, tb, tc = (torch.from_numpy(v).to(dtype) for v in (x, bm, cm))
    torch_args = (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                  None if s0 is None else torch.from_numpy(s0))
    # the reference reads the same values: bf16 inputs rounded once, here
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_args = [jnp.asarray(v.float().numpy(), jdt) for v in (tx, tb, tc)]
    jax_args = (jax_args[0], jnp.asarray(dt), jnp.asarray(a), jax_args[1], jax_args[2],
                None if s0 is None else jnp.asarray(s0))
    return torch_args, jax_args


CASES = [(torch.float32, False, 1), (torch.float32, True, 1), (torch.bfloat16, False, 1),
         (torch.bfloat16, True, 1), (torch.bfloat16, True, 3)]


@pytest.mark.parametrize("dtype,nonzero,groups", CASES,
                         ids=["fp32", "fp32-s0", "bf16", "bf16-s0", "bf16-s0-G3"])
def test_split_twin_fits_the_kernel_limits(dtype, nonzero, groups):
    """At mamba2 widths the twin stays within the limits the card holds
    the kernel to (vs ``ssd_chunked``) and within the reference's."""
    targs, jargs = _inputs(7 + groups + 2 * nonzero, 1, 130, 24, groups, 64, 128, dtype,
                           nonzero)
    y, s = split_twin(*targs)
    y_p, s_p = ssd_chunked(*targs, chunk=CHUNK)
    assert y.dtype == dtype and s.dtype == torch.float32
    tol = K4_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    torch.testing.assert_close(s, s_p, **K4_TOL)
    y_r, s_r = r_chunked(*jargs[:5], s0=jargs[5], chunk=CHUNK)
    ref_tol = K4_TOL if dtype == torch.float32 else REF_BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32), **ref_tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **K4_TOL)


def test_split_parts():
    """Three parts sum to an fp32 value exactly; two are within 2^-16 of it
    (relative); a bf16 value is its own high part and leaves nothing."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    v = v * torch.exp(torch.linspace(-30.0, 30.0, 4096))
    hi, mid, lo = _parts(v, 3)
    assert torch.equal(hi + mid + lo, v) and torch.equal((hi + mid) + lo, v)
    hi, lo = _parts(v, 2)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -16).all()
    b = v.to(torch.bfloat16).float()
    hi, mid, lo = _parts(b, 3)
    assert torch.equal(hi, b) and not mid.any() and not lo.any()


def test_fp32_inputs_rounded_to_bf16_miss_the_state_limit():
    """Why fp32 x, B and C are split too: rounded to bf16 once, they move
    the state past its fp32 limit at these widths; split, they do not."""
    targs, _ = _inputs(3, 1, 130, 24, 1, 64, 128, torch.float32, True)
    _, s_p = ssd_chunked(*targs, chunk=CHUNK)
    _, s = split_twin(*targs)
    torch.testing.assert_close(s, s_p, **K4_TOL)
    x, dt, a, bm, cm, s0 = targs
    rounded = [v.to(torch.bfloat16) for v in (x, bm, cm)]
    _, s_hi_only = ssd_chunked(rounded[0], dt, a, rounded[1], rounded[2],
                               s0.to(torch.bfloat16).float(), chunk=CHUNK)
    assert not torch.allclose(s_hi_only, s_p, **K4_TOL)


def test_bf16_y_rounds_as_fp32_math_does():
    """With the derived operands split in three, the twin's fp32 y lands on
    the plain version's bf16 roundings almost everywhere: under 0.1% of y
    differs (by one ulp), as for two fp32 summation orders.  Each extra
    flip is carried on by every later layer of a bf16 model."""
    targs, _ = _inputs(11, 1, 130, 24, 1, 64, 128, torch.bfloat16, True)
    y, _ = split_twin(*targs)
    y_p, _ = ssd_chunked(*targs, chunk=CHUNK)
    assert (y != y_p).float().mean().item() < 1e-3


def _warp_scan_cumsum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum over 64 steps as a 32-lane warp scan adds: a
    Kogge-Stone scan of each half, then the first half's total added to
    the second (another order than torch.cumsum's sequential one)."""
    v = v.movedim(dim, -1)
    n = v.shape[-1]
    out = []
    for lo in range(0, n, 32):
        w = v[..., lo : lo + 32].clone()
        off = 1
        while off < w.shape[-1]:
            shifted = torch.cat([torch.zeros_like(w[..., :off]), w[..., :-off]], dim=-1)
            w = w + shifted
            off *= 2
        out.append(w)
    for i in range(1, len(out)):
        out[i] = out[i] + out[i - 1][..., -1:]
    return torch.cat(out, dim=-1).movedim(-1, dim)


def test_cum_in_cumsums_order_keeps_bf16_roundings(monkeypatch):
    """Why the kernel sums cum in torch.cumsum's sequential order: on
    model-like inputs (x, B, C after SiLU, a = -1), a warp-scan cum makes
    several times more bf16 roundings of y differ from the plain version's
    (|cum| reaches tens, where one ulp of it moves exp(cum_t - cum_s) by
    about 4e-6)."""
    g = torch.Generator().manual_seed(0)
    silu = torch.nn.functional.silu
    x = silu(torch.randn(2, 512, 24, 64, generator=g)).to(torch.bfloat16)
    bm, cm = (silu(torch.randn(2, 512, 1, 128, generator=g)).to(torch.bfloat16)
              for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(2, 512, 24, generator=g))
    a = -torch.ones(24)
    y_p, _ = ssd_chunked(x, dt, a, bm, cm, chunk=CHUNK)
    sequential = (split_twin(x, dt, a, bm, cm)[0] != y_p).float().mean().item()
    monkeypatch.setattr(torch, "cumsum", _warp_scan_cumsum)
    warp_scan = (split_twin(x, dt, a, bm, cm)[0] != y_p).float().mean().item()
    # about 3e-5 against 5e-4 (seeds 0-2 and 12)
    assert sequential < 1e-4 and warp_scan > 8 * sequential, (sequential, warp_scan)
