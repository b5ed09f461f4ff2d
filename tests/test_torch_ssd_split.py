"""The roundings of K4's tensor-core design (PR 15), on the CPU, at mamba2's widths.

PR 15's SSD scan kernel ran its four chunk products as bf16 x bf16
products with fp32 sums (the tensor cores' ``mma.m16n8k16``).  A bf16
operand (x, B, C of a bf16 model) entered as it is.  An fp32 operand the
kernel derived (M, the state S, xw = x * dt * exp(total - cum)) entered as
three bf16 parts that sum to it exactly; fp32 x, B and C (an fp32 model)
as a bf16 high and low part.  ``split_twin`` below is that arithmetic with
IEEE fp32 sums: each operand split as the kernel split it, every product of
two bf16 values exact in fp32.  It shows that the operand splits' roundings
fit the limits the kernel was held to:

* against the port's plain version ``ssd_chunked``: rtol/atol 2e-4 for fp32
  y and for the state (the reference's own tolerance for this kernel), and
  rtol 8e-3 / atol 1e-3 for bf16 y (one bf16 ulp), as ``chip_smoke.py``
  holds the kernel on the card;
* against the reference's pure-jnp ``ssd_chunked`` (``repro.models.ssm``):
  the tolerances of ``tests/test_torch_ssd_scan.py`` (2e-4; 0.03 for bf16
  y, rounded once in each package).

``tensor_core_twin`` adds what the IEEE twin leaves out, the tensor cores'
own accumulation: an ``mma`` aligns its 16 products and its accumulator to
the largest term and cuts the sum toward zero (``_mma``), and the kernel
chained some of its sums over several ``mma``s.  That twin reproduces the
lean PR 15 measured on the card: more bf16 y round apart from the plain
version than with IEEE sums, and most of those toward zero, which every
later layer of a bf16 model carried on (mamba2-130m's teacher-forced
logits drifted 3.9-4.1% of the largest |logit|).  The kernel now runs its
products as fp32 FMA chains in the plain version's order instead
(``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``).

Widths are mamba2-130m's (H=24, P=64, N=128, chunk 64) at B=1 and T=130
(two full chunks and a ragged one) or 256, inputs made by numpy from a
seed as the SSM block forms them.
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


# ---------------------------------------------------------------------------
# PR 15's tensor-core kernel, with the truncating sum of one mma modelled
# ---------------------------------------------------------------------------

def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ``mma.m16n8k16`` step as the tensor cores sum it: ``acc + a @ b``
    over 16 products that are exact in fp32 (bf16 x bf16), aligned to the
    largest of the 17 terms and cut toward zero at its 24th bit, the result
    cut toward zero again to 24 bits.  All float64 holding fp32 values;
    a (..., M, 16), b (..., 16, N), acc (..., M, N)."""
    terms = torch.cat([acc[..., :, None, :], a[..., :, :, None] * b[..., None, :, :]], dim=-2)
    total = terms.sum(dim=-2)

    def cut(v, ref):
        e = torch.floor(torch.log2(ref.abs().clamp(min=1e-300)))
        q = torch.exp2(e - 23)
        return torch.where(ref == 0, v, torch.trunc(v / q) * q)

    out = cut(total, terms.abs().amax(dim=-2))
    return cut(out, out)


def _f32(v: torch.Tensor) -> torch.Tensor:
    """Round a float64 value to fp32 (one IEEE rounding), back in float64."""
    return v.float().double()


def _steps(a, b, k_len):
    """The k16 steps of ``a @ b`` (a (..., M, K), b (..., K, N))."""
    for k in range(0, k_len, 16):
        yield a[..., k : k + 16], b[..., k : k + 16, :]


def tensor_core_twin(x, dt, a, bm, cm, chunk=CHUNK):
    """PR 15's K4 on bf16 inputs (G=1, zero s0): C B^T's high-part sums
    from zero at every k16 step (IEEE adds between steps); M @ X with M in
    three parts, the high part's steps from zero, the small parts chained
    in an accumulator of their own; C @ S_prev^T with S in three parts,
    each chained over the k16 steps; the carry chained over all its steps
    and parts, then S = exp(total) S + u; y = M @ X + exp(cum) * (C @
    S_prev^T) with one rounding (a fused multiply-add)."""
    batch, t_len, heads, p = x.shape
    n = bm.shape[3]
    xf = x.double().movedim(2, 1)                                   # (B, H, T, P)
    bf = bm.double().expand(batch, t_len, heads, n).movedim(2, 1)   # (B, H, T, N)
    cf = cm.double().expand(batch, t_len, heads, n).movedim(2, 1)
    dtf = dt.float().movedim(2, 1)
    s = torch.zeros(batch, heads, p, n, dtype=torch.float64)
    ys = []
    for t0 in range(0, t_len, chunk):
        lc = min(chunk, t_len - t0)
        pad = (-lc) % 16
        def rows(v, t0=t0, lc=lc, pad=pad):
            return torch.nn.functional.pad(v[:, :, t0 : t0 + lc], (0, 0, 0, pad))

        xc, bc, cc = rows(xf), rows(bf), rows(cf)
        dtc = torch.nn.functional.pad(dtf[:, :, t0 : t0 + lc], (0, pad))
        cum = torch.cumsum(dtc * a.float()[None, :, None], dim=-1)
        ll = lc + pad
        cb = torch.zeros(batch, heads, ll, ll, dtype=torch.float64)
        for ak, bk in _steps(cc, bc.transpose(-1, -2), n):
            cb = _f32(cb + _mma(torch.zeros_like(cb), ak, bk))
        tril = torch.ones(ll, ll, dtype=torch.bool).tril()
        rel = torch.where(tril, cum[..., :, None] - cum[..., None, :], 0.0)
        m = torch.where(tril, cb.float() * torch.exp(rel) * dtc[..., None, :], 0.0)
        hi, mid, lo = (v.double() for v in _parts(m, 3))
        yo = torch.zeros(batch, heads, ll, p, dtype=torch.float64)
        yl = torch.zeros_like(yo)
        for k in range(0, ll, 16):
            xk = xc[..., k : k + 16, :]
            yl = _mma(_mma(yl, lo[..., k : k + 16], xk), mid[..., k : k + 16], xk)
            yo = _f32(yo + _mma(torch.zeros_like(yo), hi[..., k : k + 16], xk))
        yo = _f32(yo + yl)
        parts = [v.double() for v in _parts(s.float(), 3)]
        yp = []
        for part in parts:
            acc = torch.zeros(batch, heads, ll, p, dtype=torch.float64)
            for ak, bk in _steps(cc, part.transpose(-1, -2), n):
                acc = _mma(acc, ak, bk)
            yp.append(acc)
        yi = _f32(yp[0] + _f32(yp[1] + yp[2]))
        y = _f32(yo + torch.exp(cum).double()[..., None] * yi)
        total = cum[..., -1:]
        xw = (xc.float() * (dtc * torch.exp(total - cum))[..., None])
        xparts = [v.double() for v in _parts(xw, 3)]
        u = torch.zeros(batch, heads, p, n, dtype=torch.float64)
        for k in range(0, ll, 16):
            bk = bc[..., k : k + 16, :]
            for part in (xparts[2], xparts[1], xparts[0]):
                u = _mma(u, part[..., k : k + 16, :].transpose(-1, -2), bk)
        s = _f32(_f32(torch.exp(total).double()[..., None] * s) + u)
        ys.append(y[:, :, :lc])
    y = torch.cat(ys, dim=2).movedim(1, 2)
    return y.to(x.dtype), s.float()


def _lean(y, y_p):
    d = y.float() - y_p.float()
    differ = d != 0
    toward = differ & (d.sign() != y_p.float().sign())
    return differ.float().mean().item(), (toward.sum() / differ.sum().clamp(min=1)).item()


def test_truncating_mma_model_reproduces_pr15_lean():
    """PR 15's kernel on the card (tools/ssd_roundings.py): 6.6e-5-8.6e-5 of
    the bf16 y round apart from the plain version's, 53.5-54.9% of them
    toward zero.  Its twin with the tensor cores' truncating sums leans the
    same way, and rounds apart about twice as often as the IEEE twin."""
    g = torch.Generator().manual_seed(0)
    silu = torch.nn.functional.silu
    x = silu(torch.randn(1, 256, 24, 64, generator=g)).to(torch.bfloat16)
    bm, cm = (silu(torch.randn(1, 256, 1, 128, generator=g)).to(torch.bfloat16)
              for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(1, 256, 24, generator=g))
    a = -torch.ones(24)
    y_p, _ = ssd_chunked(x, dt, a, bm, cm, chunk=CHUNK)
    tc_share, tc_lean = _lean(tensor_core_twin(x, dt, a, bm, cm)[0], y_p)
    ieee_share, ieee_lean = _lean(split_twin(x, dt, a, bm, cm)[0], y_p)
    assert 0.52 < tc_lean < 0.62, (tc_lean, ieee_lean)
    assert tc_share > 1.5 * ieee_share, (tc_share, ieee_share)
