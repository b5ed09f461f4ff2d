"""The SSD scan (K4) against the reference, on the CPU.

The port's ``ssd_scan_op`` runs its plain version here (``ssd_chunked``, the
chunked algorithm in the CUDA kernel's order).  It is held to the
reference's Pallas ``ssd_scan_op`` in interpret mode and to its pure-jnp
``ssd_chunked`` (the path the reference's ``ssm_block`` runs), with inputs
made by numpy from a seed: chunkings with and without a ragged last chunk,
B/C group broadcast, a non-zero initial state, and decode steps against one
scan.  Tolerance rtol/atol 2e-4, the reference's own for this kernel
(``tests/test_ssd_decode_kernels.py``): exponentials of prefix sums and the
chunk products round differently in the two packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_decode_step as _r_decode  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_op as r_op  # noqa: E402
from repro.models.ssm import ssd_chunked as _r_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked,
    ssd_decode_step,
    ssd_scan,
    ssd_scan_op,
    ssd_scan_ref,
)

# the reference's plain functions under jax.jit (op-by-op dispatch compiles
# every op on its own and takes several times longer on the CPU)
r_chunked = jax.jit(_r_chunked, static_argnames="chunk")
r_decode = jax.jit(_r_decode)

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.03, atol=0.03)  # y is rounded to bf16 once in each package


def _inputs(seed, b, t, h, g, p, n, s0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 1.0)).astype(np.float32)
    a = (-np.log1p(np.exp(rng.standard_normal(h)))).astype(np.float32)
    bm = (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32)
    out = [x, dt, a, bm, cm]
    if s0:
        out.append((rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32))
    return out


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jnp(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("t,chunk", [(8, 4), (16, 16), (12, 5), (64, 16), (1, 64), (70, 64)])
def test_plain_matches_reference_kernel_and_chunked(t, chunk):
    arrs = _inputs(t, 2, t, 4, 2, 8, 16)
    y, s = ssd_scan_op(*_torch(arrs), chunk=chunk)
    y_k, s_k = r_op(*_jnp(arrs), chunk=chunk, interpret=True)
    y_c, s_c = r_chunked(*_jnp(arrs), chunk=chunk)
    for want_y, want_s in ((y_k, s_k), (y_c, s_c)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (6, 1), (6, 3)])
def test_group_broadcast(h, g):
    arrs = _inputs(h * 10 + g, 1, 8, h, g, 4, 8)
    y, s = ssd_scan_op(*_torch(arrs), chunk=4)
    y_k, s_k = r_op(*_jnp(arrs), chunk=4, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)


def test_time_padding_is_noop():
    """T not a chunk multiple: the final state equals the per-step
    recurrence's (the zero-dt tail moves nothing)."""
    x, dt, a, bm, cm = _torch(_inputs(0, 1, 10, 2, 2, 4, 8))
    y, s = ssd_scan_op(x, dt, a, bm, cm, chunk=8)
    fold = lambda v: v.movedim(2, 1).reshape(2, 10, *v.shape[3:])  # noqa: E731
    y_r, s_r = ssd_scan_ref(fold(x), fold(dt[..., None])[..., 0],
                            fold((dt * a)[..., None])[..., 0], fold(bm), fold(cm),
                            torch.zeros(2, 4, 8))
    np.testing.assert_allclose(y.numpy(), y_r.reshape(1, 2, 10, 4).movedim(1, 2).numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_r.reshape(1, 2, 4, 8).numpy(), **TOL)


def test_initial_state_and_bf16_inputs():
    arrs = _inputs(5, 2, 20, 4, 1, 8, 16, s0=True)
    x, dt, a, bm, cm, s0 = arrs
    y, s = ssd_scan_op(*_torch(arrs[:5]), torch.from_numpy(s0), chunk=8)
    y_k, s_k = r_op(*_jnp(arrs[:5]), jnp.asarray(s0), chunk=8, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)
    tb = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, bm, cm)]
    jb = [jnp.asarray(v, jnp.bfloat16) for v in (x, bm, cm)]
    y, s = ssd_scan_op(tb[0], torch.from_numpy(dt), torch.from_numpy(a), tb[1], tb[2],
                       torch.from_numpy(s0), chunk=8)
    y_c, s_c = r_chunked(jb[0], jnp.asarray(dt), jnp.asarray(a), jb[1], jb[2],
                         s0=jnp.asarray(s0), chunk=8)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_c, np.float32), **BF16_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_c), **TOL)


def test_decode_steps_equal_one_scan():
    """T sequential decode steps == one scan over T tokens (both packages)."""
    arrs = _inputs(3, 2, 6, 4, 2, 4, 8)
    x, dt, a, bm, cm = _torch(arrs)
    y_scan, s_scan = ssd_scan_op(x, dt, a, bm, cm, chunk=2)
    s, s_ref = torch.zeros(2, 4, 4, 8), jnp.zeros((2, 4, 4, 8), jnp.float32)
    ys = []
    for t in range(6):
        y_t, s = ssd_decode_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], s)
        y_r, s_ref = r_decode(*(jnp.asarray(v[:, t]) for v in (arrs[0], arrs[1])),
                              jnp.asarray(arrs[2]),
                              *(jnp.asarray(v[:, t]) for v in (arrs[3], arrs[4])), s_ref)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **TOL)
        ys.append(y_t)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_scan.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_scan.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)


def test_cpu_runs_plain_and_counts_no_launch():
    x, dt, a, bm, cm = _torch(_inputs(1, 1, 9, 2, 1, 4, 8))
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, a, bm, cm, chunk=4)
    y_p, s_p = ssd_chunked(x, dt, a, bm, cm, chunk=4)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(s, s_p, rtol=0, atol=0)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("bad", ["groups", "dtype", "dt_dtype", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, dt, a, bm, cm = _torch(_inputs(1, 1, 9, 4, 2, 4, 8))
    if bad == "groups":
        bm, cm = bm[:, :, :1].repeat(1, 1, 3, 1), cm[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "dtype":
        x = x.to(torch.bfloat16)
    elif bad == "dt_dtype":
        dt = dt.double()
    else:
        x, dt, bm, cm = x[:, :0], dt[:, :0], bm[:, :0], cm[:, :0]
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan(x, dt, a, bm, cm)
