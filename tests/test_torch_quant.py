"""Port numerics leaf vs the JAX reference: activations, fake-quant, int8 grids.

Inputs are made with numpy from a seed and fed to both packages.  The int8
codes and power-of-two scales must be equal, not close: both frameworks
round half to even, and the port reproduces the reference's fp32 log2 at
the floor's edges (amax next to 127 / 2**k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as rq
from repro_torch.core import quant as tq

ELEMENTWISE = ["sigmoid_exact", "tanh_exact", "tanh_pwl", "sigmoid_pwl",
               "hard_sigmoid", "sigmoid_lut"]


def _x(seed, n=4096, scale=4.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * scale).astype(np.float32)
    # knots, exact zeros and the saturation edges of the PWL functions
    edges = np.array([0.0, -0.0, 0.5, -0.5, 2.5, 3.0, -3.0, 8.0, -8.0, 1e-8],
                     np.float32)
    return np.concatenate([x, edges])


@pytest.mark.parametrize("name", ELEMENTWISE)
@pytest.mark.parametrize("seed", [0, 1])
def test_elementwise_matches_reference(name, seed):
    x = _x(seed)
    want = np.asarray(getattr(rq, name)(jnp.asarray(x)))
    got = getattr(tq, name)(torch.from_numpy(x)).numpy()
    # transcendental implementations differ between the frameworks by an ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 16])
def test_act_quant_matches_reference_exactly(bits):
    x = np.concatenate([_x(3, scale=60.0),
                        (np.arange(-600, 600) / 2 ** (bits // 2 + 1)).astype(np.float32)])
    want = np.asarray(rq.make_act_quant(bits)(jnp.asarray(x)))
    got = tq.make_act_quant(bits)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_act_quant_rejects_other_widths():
    with pytest.raises(ValueError, match="act_bits"):
        tq.make_act_quant(4)


def _int8_inputs():
    rng = np.random.RandomState(7)
    cases = [(rng.randn(32, 32) * s).astype(np.float32)
             for s in (0.05, 0.3, 1.0, 7.0)]
    for amax in (0.5, 1.0, 2.0, 0.25,                    # powers of two
                 127 / 128, 127 / 64, 127 / 256, 127 / 32,  # 127/amax a power of two
                 np.nextafter(np.float32(127 / 128), np.float32(0)),
                 np.nextafter(np.float32(127 / 128), np.float32(2))):
        w = (rng.uniform(-1, 1, (9, 36)) * 0.5 * amax).astype(np.float32)
        w[3, 4] = np.float32(amax)
        cases.append(w)
    cases.append(np.zeros((4, 16), np.float32))
    return cases


@pytest.mark.parametrize("case", range(len(_int8_inputs())))
def test_int8_codes_and_scales_equal_reference(case):
    w = _int8_inputs()[case]
    q_ref, s_ref = rq.int8_symmetric_quant(jnp.asarray(w))
    q, s = tq.int8_symmetric_quant(torch.from_numpy(w))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.item() == float(s_ref)


def test_kernel_safe_and_native_dtypes():
    assert tq.kernel_safe(tq.PAPER_HW) is tq.PAPER_HW_KERNEL
    for acts in (tq.EXACT, tq.HARD, tq.PAPER_HW_KERNEL):
        assert tq.kernel_safe(acts) is acts
    assert tq.native_weight_dtype(torch.float32) == "fp32"
    assert tq.native_weight_dtype(torch.bfloat16) == "bf16"
    assert tq.native_weight_dtype(torch.float16) is None
    assert tq.WEIGHT_DTYPES == rq.WEIGHT_DTYPES
    assert tuple(tq.ACTIVATION_SETS) == tuple(rq.ACTIVATION_SETS)
