"""``fuse_gates``: the step kernel's single ``[x ; h] @ [W_x ; W_h]`` chain.

The plain version of the port's step kernel with ``fuse_gates=True`` is
held against the reference's ``lstm_stack_step_op(..., fuse_gates=True)``
run as the reference's own tests run it on the CPU (Pallas interpret
mode), on gw_nominal's encoder and decoder packs in fp32 compute with fp32
and bf16 storage: rtol/atol 1e-5, the reference's kernel tolerance (the
two sum one 2W-long contraction in different orders).  ``plan_stack``
passes the knob through to the step path, refuses it on int8 packs and on
backends without a step kernel; the wrapper refuses int8 scales.  Inputs
are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lstm as rlstm
from repro.kernels.lstm_stack import ops as rops
from repro.kernels.lstm_stack.step import lstm_stack_step_op as r_step_op
from repro_torch.convert import params_from_numpy
from repro_torch.core import lstm as tlstm
from repro_torch.core.executor import plan_stack
from repro_torch.kernels.lstm_stack import ops as tops
from repro_torch.kernels.lstm_stack.step import lstm_stack_step, lstm_stack_step_op

TOL = dict(rtol=1e-5, atol=1e-5)
SEGMENTS = {"enc": [(1, 32), (32, 8)], "dec": [(8, 8), (8, 32)]}


def _stack(dims, weight_dtype=None, seed=0):
    kw = {} if weight_dtype is None else {"weight_dtype": weight_dtype}
    r_cfgs = [rlstm.LstmConfig(in_dim=a, hidden=b, **kw) for a, b in dims]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dims))
    r_params = [rlstm.init_lstm(k, c) for k, c in zip(keys, r_cfgs)]
    t_params = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
                for p in r_params]
    t_cfgs = [tlstm.LstmConfig(in_dim=a, hidden=b, **kw) for a, b in dims]
    return r_params, r_cfgs, t_params, t_cfgs


def _inputs(width, n_layers, batch, t_len, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randn(batch, t_len, width).astype(np.float32)
    h0 = (rng.randn(n_layers, batch, width) * 0.3).astype(np.float32)
    c0 = (rng.randn(n_layers, batch, width) * 0.3).astype(np.float32)
    return xs, h0, c0


@pytest.mark.parametrize("seg", sorted(SEGMENTS))
@pytest.mark.parametrize("weight_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("t_len", [1, 5])
def test_fused_plain_matches_reference(seg, weight_dtype, t_len):
    r_params, r_cfgs, t_params, t_cfgs = _stack(SEGMENTS[seg], weight_dtype)
    rp, tp = rops.pack_stack(r_params, r_cfgs), tops.pack_stack(t_params, t_cfgs)
    xs, h0, c0 = _inputs(tp.width_p, tp.n_layers, 3, t_len, seed=t_len)
    want = r_step_op(jnp.asarray(xs), rp.stacked, jnp.asarray(h0), jnp.asarray(c0),
                     weight_dtype=weight_dtype, fuse_gates=True, interpret=True)
    got = lstm_stack_step_op(torch.from_numpy(xs), tp.stacked, torch.from_numpy(h0),
                             torch.from_numpy(c0), weight_dtype=weight_dtype,
                             fuse_gates=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL)


def test_fused_and_separate_chains_agree():
    """One layer, T=1: the fused chain and the separate chains reorder one
    fp32 sum, so they agree within the kernel tolerance."""
    _, _, t_params, t_cfgs = _stack([(1, 32)])
    tp = tops.pack_stack(t_params, t_cfgs)
    xs, h0, c0 = _inputs(tp.width_p, 1, 4, 1, seed=9)
    args = [torch.from_numpy(a) for a in (xs, h0, c0)]
    s = tp.stacked
    fused = lstm_stack_step(args[0], s["w_x"], s["w_h"], s["b"], args[1], args[2],
                            fuse_gates=True)
    apart = lstm_stack_step(args[0], s["w_x"], s["w_h"], s["b"], args[1], args[2])
    for f, a in zip(fused, apart):
        np.testing.assert_allclose(f.numpy(), a.numpy(), **TOL)


def test_plan_passes_fuse_gates_to_the_step():
    """``plan_stack(fuse_gates=True)``: an executor step on a short chunk
    equals the fused step kernel's plain version on the same pack."""
    _, _, t_params, t_cfgs = _stack(SEGMENTS["enc"])
    plan = plan_stack(t_cfgs, impl="fused_step", fuse_gates=True)
    assert plan.fuse_gates is True and "fuse_gates=True" in plan.describe()
    ex = plan.bind(t_params)
    xs, _, _ = _inputs(1, 2, 2, 4, seed=5)
    h, c = ex.step(torch.from_numpy(xs), ex.zero_state(2))
    s = ex.packed.stacked
    z = ex.packed.zero_state(2)
    _, h_w, c_w = lstm_stack_step(ex.packed.pad_input(torch.from_numpy(xs)), s["w_x"],
                                  s["w_h"], s["b"], z[0], z[1], fuse_gates=True)
    assert torch.equal(h, h_w) and torch.equal(c, c_w)


@pytest.mark.parametrize("impl,weight_dtype,match", [
    ("fused_step", "int8", "incompatible with int8"),
    ("fused_stack", None, "only applies to the chunked-step backend"),
    ("kernel", None, "only applies to the chunked-step backend"),
])
def test_plan_refuses_fuse_gates(impl, weight_dtype, match):
    _, _, _, t_cfgs = _stack(SEGMENTS["enc"])
    with pytest.raises(ValueError, match=match):
        plan_stack(t_cfgs, impl=impl, weight_dtype=weight_dtype, fuse_gates=True)


def test_wrapper_refuses_fuse_gates_with_int8_scales():
    _, _, t_params, t_cfgs = _stack(SEGMENTS["enc"], "int8")
    tp = tops.pack_stack(t_params, t_cfgs)
    xs, h0, c0 = _inputs(tp.width_p, 2, 1, 1, seed=2)
    with pytest.raises(ValueError, match="fuse_gates"):
        lstm_stack_step_op(torch.from_numpy(xs), tp.stacked, torch.from_numpy(h0),
                           torch.from_numpy(c0), weight_dtype="int8", fuse_gates=True)
