"""Port LSTM layer, packing and the two kernels' plain versions vs the reference.

On the CPU each kernel wrapper runs its plain PyTorch version; here those
versions are held against the JAX package: the reference's plain oracle
(``lstm_stack_ref``) and its Pallas kernels in interpret mode.  Inputs are
made with numpy from a seed and fed to both packages.

Tolerances: 1e-5 for fp32 compute (the reference's own kernel tolerance).
bf16 compute rounds h to bf16 every cell, so a one-ulp fp32 difference
before a rounding becomes one bf16 ulp (2**-8 relative) after it; those
cases use the reference's own bf16 tolerance (rtol 2e-2, atol 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lstm as rlstm
from repro.core import quant as rq
from repro.kernels.lstm_stack import ops as rops
from repro.kernels.lstm_stack.lstm_stack import lstm_stack as r_lstm_stack
from repro.kernels.lstm_stack.ref import lstm_stack_ref as r_lstm_stack_ref
from repro.kernels.lstm_stack.step import lstm_stack_step_op as r_step_op
from repro_torch.convert import params_from_numpy
from repro_torch.core import lstm as tlstm
from repro_torch.core import quant as tq
from repro_torch.kernels.lstm_stack import ops as tops
from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack as t_lstm_stack
from repro_torch.kernels.lstm_stack.step import (
    MAX_STEP_UNROLL,
    lstm_stack_step,
    lstm_stack_step_op as t_step_op,
)

GW_ENC = [(1, 32), (32, 8)]
GW_DEC = [(8, 8), (8, 32)]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t2np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_t2np(g), _np(w), **(tol or TOL))


# ---------------------------------------------------------------------------
# the layer-by-layer forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "split"])
@pytest.mark.parametrize("acts", ["exact", "hard", "paper_hw"])
def test_layer_forward_matches_reference(impl, acts):
    r_cfg = rlstm.LstmConfig(in_dim=3, hidden=8, acts=rq.ACTIVATION_SETS[acts])
    t_cfg = tlstm.LstmConfig(in_dim=3, hidden=8, acts=tq.ACTIVATION_SETS[acts])
    params = rlstm.init_lstm(jax.random.PRNGKey(3), r_cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.RandomState(1)
    xs = rng.randn(2, 10, 3).astype(np.float32)
    h0, c0 = (rng.randn(2, 8) * 0.5).astype(np.float32), rng.randn(2, 8).astype(np.float32)
    want = getattr(rlstm, f"lstm_forward_{impl}")(
        params, jnp.asarray(xs), r_cfg, (jnp.asarray(h0), jnp.asarray(c0)))
    got = getattr(tlstm, f"lstm_forward_{impl}")(
        tparams, torch.from_numpy(xs), t_cfg, (torch.from_numpy(h0), torch.from_numpy(c0)))
    _close([got[0], *got[1]], [want[0], *want[1]])


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _stack(dims, seed=0, **cfg_kw):
    r_cfgs = [rlstm.LstmConfig(in_dim=a, hidden=b, **cfg_kw) for a, b in dims]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dims))
    r_params = [rlstm.init_lstm(k, c) for k, c in zip(keys, r_cfgs)]
    t_params = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
                for p in r_params]
    t_kw = {k: v for k, v in cfg_kw.items() if k != "dtype"}
    if cfg_kw.get("dtype") == jnp.bfloat16:
        t_kw["dtype"] = torch.bfloat16
    t_cfgs = [tlstm.LstmConfig(in_dim=a, hidden=b, **t_kw) for a, b in dims]
    return r_params, r_cfgs, t_params, t_cfgs


WEIGHT_CASES = [
    pytest.param(dict(), id="fp32"),
    pytest.param(dict(weight_dtype="bf16"), id="bf16"),
    pytest.param(dict(weight_dtype="int8"), id="int8"),
    pytest.param(dict(dtype=jnp.bfloat16, weight_dtype="int8"), id="bf16c-int8"),
]


PACK_CASES = [pytest.param(GW_ENC, c.values[0], id=f"enc-{c.id}") for c in WEIGHT_CASES] + [
    pytest.param(GW_DEC, {"weight_dtype": "int8"}, id="dec-int8"),
    pytest.param([(9, 9)], {}, id="small-fp32"),
]


@pytest.mark.parametrize("dims,cfg_kw", PACK_CASES)
def test_pack_equals_reference_cpu_pack(dims, cfg_kw):
    r_params, r_cfgs, t_params, t_cfgs = _stack(dims, **cfg_kw)
    rp = rops.pack_stack(r_params, r_cfgs)
    tp = tops.pack_stack(t_params, t_cfgs)
    assert tp.width_p == rp.width_p == max(max(d) for d in dims)
    assert tp.weight_dtype == rp.weight_dtype
    assert set(tp.stacked) == set(rp.stacked)
    for k, v in rp.stacked.items():
        assert str(tp.stacked[k].dtype).removeprefix("torch.") == str(v.dtype)
        np.testing.assert_array_equal(_t2np(tp.stacked[k]), _np(v))
    assert tp.packed_bytes == rp.packed_bytes


def test_pack_cache_identity_and_inplace_update():
    _, _, t_params, t_cfgs = _stack(GW_ENC)
    a = tops.pack_stack_cached(t_params, t_cfgs)
    assert tops.pack_stack_cached(t_params, t_cfgs) is a
    t_params[1]["w_h"].mul_(0.5)  # an in-place update must not serve a stale pack
    b = tops.pack_stack_cached(t_params, t_cfgs)
    assert b is not a
    packed_wh = _t2np(b.stacked["w_h"][1, :8]).reshape(8, 4, 32)[:, :, :8]
    np.testing.assert_array_equal(packed_wh, _t2np(t_params[1]["w_h"]).reshape(8, 4, 8))
    tops.pack_cache_evict(a, b)
    assert tops.pack_stack_cached(t_params, t_cfgs) is not b


def test_pack_state_roundtrip():
    _, _, t_params, t_cfgs = _stack(GW_ENC)
    pk = tops.pack_stack(t_params, t_cfgs)
    rng = np.random.RandomState(0)
    states = [(torch.from_numpy(rng.randn(3, h).astype(np.float32)),
               torch.from_numpy(rng.randn(3, h).astype(np.float32))) for _, h in GW_ENC]
    h, c = pk.pack_state(states)
    assert h.shape == c.shape == (2, 3, 32)
    for (h0, c0), (h1, c1) in zip(states, pk.unpack_state(h, c)):
        assert torch.equal(h0, h1) and torch.equal(c0, c1)


# ---------------------------------------------------------------------------
# K1 (wavefront) and K2 (step): plain versions vs the reference
# ---------------------------------------------------------------------------

def _raw(seed, L, B, T, W, wd, compute="fp32"):
    rng = np.random.RandomState(seed)
    d = dict(
        xw0=rng.randn(T, B, 4 * W).astype(np.float32),
        xs=rng.randn(B, T, W).astype(np.float32),
        b=(rng.randn(L, 4 * W) * 0.1).astype(np.float32),
        h0=(rng.randn(L, B, W) * 0.5).astype(np.float32),
        c0=(rng.randn(L, B, W) * 0.5).astype(np.float32),
    )
    if wd == "int8":
        d["w_x"] = rng.randint(-127, 128, (L, W, 4 * W)).astype(np.int8)
        d["w_h"] = rng.randint(-127, 128, (L, W, 4 * W)).astype(np.int8)
        d["scales"] = (2.0 ** -rng.randint(8, 11, (L, 2, 4))).astype(np.float32)
    else:
        d["w_x"] = (rng.randn(L, W, 4 * W) * 0.3).astype(np.float32)
        d["w_h"] = (rng.randn(L, W, 4 * W) * 0.3).astype(np.float32)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    if wd == "bf16":
        for k in ("w_x", "w_h"):
            jd[k], td[k] = jd[k].astype(jnp.bfloat16), td[k].to(torch.bfloat16)
    if compute == "bf16":
        for k in ("h0", "xs"):
            jd[k], td[k] = jd[k].astype(jnp.bfloat16), td[k].to(torch.bfloat16)
    return jd, td


KERNEL_CASES = [
    pytest.param("fp32", "fp32", "exact", None, id="fp32-exact"),
    pytest.param("fp32", "fp32", "paper_hw_kernel", None, id="fp32-pwl"),
    pytest.param("fp32", "fp32", "hard", 16, id="fp32-hard-a16"),
    pytest.param("bf16", "fp32", "exact", 16, id="bf16w-exact-a16"),
    pytest.param("int8", "fp32", "paper_hw_kernel", None, id="int8-pwl"),
    pytest.param("int8", "fp32", "exact", 8, id="int8-exact-a8"),
    pytest.param("int8", "bf16", "exact", None, id="bf16c-int8-exact"),
]
#: every case at one shape (L, B, T, W); the fp32 case at the others
SHAPE = (2, 3, 9, 8)
MORE_SHAPES = [(1, 1, 1, 4), (2, 2, 6, 9), (3, 2, 5, 6)]
MATRIX = [pytest.param(SHAPE, *c.values, id=c.id) for c in KERNEL_CASES] + [
    pytest.param(s, "fp32", "fp32", "exact", None, id="fp32-exact-L{}B{}T{}W{}".format(*s))
    for s in MORE_SHAPES
]


@pytest.mark.parametrize("shape,wd,compute,acts,act_bits", MATRIX)
def test_wavefront_plain_matches_reference(shape, wd, compute, acts, act_bits):
    L, B, T, W = shape
    jd, td = _raw(sum(shape), L, B, T, W, wd, compute)
    r_acts = rq.ACTIVATION_SETS[acts]
    aq = rq.make_act_quant(act_bits) if act_bits else None
    args = [jd[k] for k in ("xw0", "w_x", "w_h", "b", "h0", "c0")]
    kw = dict(scales=jd.get("scales"), sigma=r_acts.sigma, tanh=r_acts.tanh, act_quant=aq)
    got = t_lstm_stack(*[td[k] for k in ("xw0", "w_x", "w_h", "b", "h0", "c0")],
                       scales=td.get("scales"), acts=tq.ACTIVATION_SETS[acts],
                       act_bits=act_bits)
    tol = BF16_TOL if compute == "bf16" else TOL
    _close(got, r_lstm_stack(*args, interpret=True, **kw), **tol)
    if compute == "fp32":  # the reference's oracle rounds bf16 products; its kernel does not
        _close(got, r_lstm_stack_ref(*args, **kw), **tol)


@pytest.mark.parametrize("shape,wd,compute,acts,act_bits", MATRIX)
def test_step_plain_matches_reference_interpret(shape, wd, compute, acts, act_bits):
    L, B, T, W = shape
    jd, td = _raw(sum(shape) + 100, L, B, T, W, wd, compute)
    r_stacked = {k: jd[k] for k in ("w_x", "w_h", "b", "scales") if k in jd}
    t_stacked = {k: td[k] for k in ("w_x", "w_h", "b", "scales") if k in td}
    want = r_step_op(jd["xs"], r_stacked, jd["h0"], jd["c0"],
                     acts=rq.ACTIVATION_SETS[acts], weight_dtype=wd, act_bits=act_bits)
    got = t_step_op(td["xs"], t_stacked, td["h0"], td["c0"],
                    acts=tq.ACTIVATION_SETS[acts], weight_dtype=wd, act_bits=act_bits)
    _close(got, want, **(BF16_TOL if compute == "bf16" else TOL))


@pytest.mark.parametrize("cfg_kw", WEIGHT_CASES[:3])
def test_ops_on_gw_packs_match_reference(cfg_kw, dims=GW_DEC):
    """lstm_stack_op (layer-0 matmul outside + K1) and the step op (K2) on
    the GW nominal segment packs, with a non-zero initial state."""
    r_params, r_cfgs, t_params, t_cfgs = _stack(dims, **cfg_kw)
    rp, tp = rops.pack_stack(r_params, r_cfgs), tops.pack_stack(t_params, t_cfgs)
    rng = np.random.RandomState(4)
    x = rng.randn(3, 11, dims[0][0]).astype(np.float32)
    h0 = np.full((2, 3, tp.width_p), 0.25, np.float32)
    c0 = np.full((2, 3, tp.width_p), -0.5, np.float32)
    for r_fn, t_fn in ((rops.lstm_stack_op, tops.lstm_stack_op), (r_step_op, t_step_op)):
        want = r_fn(rp.pad_input(jnp.asarray(x)), rp.stacked, jnp.asarray(h0),
                    jnp.asarray(c0), acts=rp.acts, weight_dtype=rp.weight_dtype)
        got = t_fn(tp.pad_input(torch.from_numpy(x)), tp.stacked, torch.from_numpy(h0),
                   torch.from_numpy(c0), acts=tp.acts, weight_dtype=tp.weight_dtype)
        _close(got, want)


def test_wrappers_refuse_bad_operands():
    _, td = _raw(0, 2, 2, 3, 4, "int8")
    args = [td[k] for k in ("xw0", "w_x", "w_h", "b", "h0", "c0")]
    with pytest.raises(ValueError, match="scales"):
        t_lstm_stack(*args)
    with pytest.raises(ValueError, match="kernel form"):
        t_lstm_stack(*args, scales=td["scales"], acts=tq.PAPER_HW)
    with pytest.raises(ValueError, match="shape"):
        t_lstm_stack(args[0][:, :1], *args[1:], scales=td["scales"])
    long = torch.zeros(2, MAX_STEP_UNROLL // 2 + 1, 4)
    with pytest.raises(ValueError, match="sequential cells"):
        lstm_stack_step(long, *args[1:], scales=td["scales"])
    _, tf = _raw(0, 2, 2, 3, 4, "fp32")
    with pytest.raises(ValueError, match="wider"):
        t_lstm_stack(tf["xw0"], tf["w_x"], tf["w_h"], tf["b"],
                     tf["h0"].to(torch.bfloat16), tf["c0"])


def test_resolve_weight_dtype_rules():
    cfg = tlstm.LstmConfig(in_dim=1, hidden=4)
    assert tops.resolve_weight_dtype(cfg) == "fp32"
    assert tops.resolve_weight_dtype(dataclasses.replace(cfg, weight_dtype="int8")) == "int8"
    with pytest.raises(ValueError, match="wider"):
        tops.resolve_weight_dtype(
            tlstm.LstmConfig(in_dim=1, hidden=4, dtype=torch.bfloat16, weight_dtype="fp32"))
    with pytest.raises(ValueError, match="native"):
        tops.resolve_weight_dtype(tlstm.LstmConfig(in_dim=1, hidden=4, dtype=torch.float16))
    with pytest.raises(ValueError, match="unknown"):
        tops.resolve_weight_dtype(cfg, override="fp8")
