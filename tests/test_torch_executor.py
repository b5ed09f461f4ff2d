"""Port plan/bind/execute vs the reference, for every ported backend.

Each backend (naive, split, fused_stack, fused_step) runs the GW nominal
encoder and decoder segments with the reference's weights and a non-zero
initial state; full-sequence outputs, finals and the streaming ``step``
surface are held to the reference executor at 1e-5.  Plan-time legality
(unknown backends and placements, stage meshes, knobs on the wrong
backend, storage rules) and the engines' ``resolve_impl`` fallbacks follow
the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as rae
from repro.core import backends as rbk
from repro.core import executor as rex
from repro.core import quant as rq
from repro_torch.convert import params_from_numpy
from repro_torch.core import autoencoder as tae
from repro_torch.core import backends as tbk
from repro_torch.core import executor as tex
from repro_torch.core import quant as tq
from repro_torch.core.lstm import LstmConfig
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_step

TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ["naive", "split", "fused_stack", "fused_step"]


@pytest.fixture(scope="module")
def model():
    r_cfg = rae.AutoencoderConfig(hidden=(32, 8, 8, 32), timesteps=12)
    params = rae.init_autoencoder(jax.random.PRNGKey(5), r_cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    t_cfg = tae.AutoencoderConfig(hidden=(32, 8, 8, 32), timesteps=12)
    return params, r_cfg, t_params, t_cfg


def _segment(model, seg, **kw):
    params, r_cfg, t_params, t_cfg = model
    r_fn = rae.encoder_layers if seg == "enc" else rae.decoder_layers
    t_fn = tae.encoder_layers if seg == "enc" else tae.decoder_layers
    (rp, rc), (tp, tc) = r_fn(params, r_cfg), t_fn(t_params, t_cfg)
    if "weight_dtype" in kw:
        wd = kw["weight_dtype"]
        rc = [dataclasses.replace(c, weight_dtype=wd) for c in rc]
        tc = [dataclasses.replace(c, weight_dtype=wd) for c in tc]
    return rp, rc, tp, tc


def _np(x):
    return np.asarray(x.to(torch.float32)) if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32))


def _states(rc, batch, seed):
    rng = np.random.RandomState(seed)
    return [((rng.randn(batch, c.hidden) * 0.3).astype(np.float32),
             (rng.randn(batch, c.hidden) * 0.3).astype(np.float32)) for c in rc]


CASES = [pytest.param(b, None, None, id=b) for b in BACKENDS] + [
    pytest.param("fused_stack", "int8", None, id="fused_stack-int8"),
    pytest.param("fused_step", "bf16", 16, id="fused_step-bf16-a16"),
]


@pytest.mark.parametrize("seg", ["enc", "dec"])
@pytest.mark.parametrize("impl,wd,act_bits", CASES)
def test_call_matches_reference(model, seg, impl, wd, act_bits):
    kw = {} if wd is None else {"weight_dtype": wd}
    rp, rc, tp, tc = _segment(model, seg, **kw)
    x = np.random.RandomState(2).randn(3, 12, rc[0].in_dim).astype(np.float32)
    st = _states(rc, 3, 9)
    r_ex = rex.plan_stack(rc, impl=impl, act_bits=act_bits).bind(rp)
    t_ex = tex.plan_stack(tc, impl=impl, act_bits=act_bits).bind(tp)
    want_h, want_f = r_ex(jnp.asarray(x), [(jnp.asarray(h), jnp.asarray(c)) for h, c in st])
    got_h, got_f = t_ex(torch.from_numpy(x), [(torch.from_numpy(h), torch.from_numpy(c))
                                              for h, c in st])
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)
    for (gh, gc), (wh, wc) in zip(got_f, want_f):
        np.testing.assert_allclose(_np(gh), _np(wh), **TOL)
        np.testing.assert_allclose(_np(gc), _np(wc), **TOL)
    assert t_ex.packed_bytes == r_ex.packed_bytes


@pytest.mark.parametrize("t_len", [1, 5, 40], ids=["T1", "T5-step", "T40-wavefront"])
@pytest.mark.parametrize("impl", ["fused_step", "fused_stack", "split"])
def test_step_surface_matches_reference(model, impl, t_len):
    rp, rc, tp, tc = _segment(model, "enc")
    r_ex = rex.plan_stack(rc, impl=impl).bind(rp)
    t_ex = tex.plan_stack(tc, impl=impl).bind(tp)
    x = np.random.RandomState(t_len).randn(2, t_len, 1).astype(np.float32)
    r_state, t_state = r_ex.zero_state(2), t_ex.zero_state(2)
    for _ in range(2):  # two chunks: state carried across calls
        r_state = r_ex.step(jnp.asarray(x), r_state)
        t_state = t_ex.step(torch.from_numpy(x), t_state)
    np.testing.assert_allclose(_np(t_ex.last_hidden(t_state)),
                               _np(r_ex.last_hidden(r_state)), **TOL)
    r_hs, _ = r_ex.step_with_output(jnp.asarray(x), r_state)
    t_hs, _ = t_ex.step_with_output(torch.from_numpy(x), t_state)
    np.testing.assert_allclose(_np(t_hs), _np(r_hs), **TOL)


def test_fused_step_routes_by_chunk_len(model):
    """T <= chunk_len runs the step kernel's plain version, longer chunks the
    wavefront's; on the CPU the kernels' launch counts stay at zero."""
    _, _, tp, tc = _segment(model, "enc")
    ex = tex.plan_stack(tc, impl="fused_step", chunk_len=4).bind(tp)
    assert ex.plan.chunk_len == 4
    lstm_stack.launches = lstm_stack_step.launches = 0
    state = ex.zero_state(1)
    a = ex.step(torch.zeros(1, 4, 1), state)
    b = ex.step(torch.zeros(1, 5, 1), state)
    assert a[0].shape == b[0].shape == (2, 1, 32)
    assert lstm_stack.launches == lstm_stack_step.launches == 0


def test_update_params_rebinds_and_evicts(model):
    _, _, tp, tc = _segment(model, "enc")
    ex = tex.plan_stack(tc, impl="fused_stack").bind(tp)
    new = [{k: v * 0.5 for k, v in p.items()} for p in tp]
    ex2 = ex.update_params(new)
    assert ex2.packed is not ex.packed
    assert torch.equal(ex2.packed.stacked["b"], ex.packed.stacked["b"] * 0.5)
    assert ex2.plan is ex.plan


def test_plans_are_memoised():
    cfgs = [LstmConfig(in_dim=1, hidden=4), LstmConfig(in_dim=4, hidden=4)]
    assert tex.plan_stack(cfgs, impl="fused_step") is tex.plan_stack(cfgs, impl="fused_step")
    plan = tex.plan_stack(cfgs, impl="fused_step", weight_dtype="int8", block_b=2)
    assert plan.weight_dtype == "int8" and plan.chunk_len == 32 and plan.block_b == 2
    assert "fused_step" in plan.describe()
    assert tex.plan_stack([], impl="fused_stack").impl == "identity"


PLAN_ERRORS = [
    (dict(impl="nope"), "unknown impl"),
    (dict(impl="split", placement="sharded"), "requires the fused_stack backend"),
    (dict(impl="fused_stack", placement="orbital"), "unknown placement"),
    (dict(impl="fused_stack", mesh=("cpu",)), "placement='sharded'"),
    (dict(impl="fused_stack_sharded", mesh=("cpu",) * 3), "sub-stacks"),
    (dict(impl="split", weight_dtype="int8"), "quantized-capable"),
    (dict(impl="fused_stack", chunk_len=4), "chunk_len only applies"),
    (dict(impl="split", block_b=2), "block_b only applies"),
    (dict(impl="fused_stack", block_b=0), "block_b must be"),
    (dict(impl="naive", act_bits=16), "act_bits only applies"),
    (dict(impl="fused_stack", act_bits=4), "unsupported"),
    (dict(impl="fused_step", chunk_len=300), "ceiling"),
    (dict(impl="fused_step", weight_dtype="int8", fuse_gates=True), "incompatible with int8"),
    (dict(impl="fused_stack", n_chunks=2), "n_chunks only applies"),
    (dict(impl="wavefront", tune="balanced"), "only impl='mixed'"),
    (dict(impl="fused_stack", weight_dtype="fp8"), "unknown weight_dtype"),
    (dict(impl="fused_stack", fuse_gates=True), "fuse_gates only applies"),
    (dict(impl="fused_step", tune="aggressive"), "unknown tune mode"),
    (dict(impl="fused_step", tune="balanced"), "only impl='mixed'"),
    (dict(impl="fused_step", split=1), "mixed backend's per-layer"),
    (dict(impl="fused_step", weight_dtype=("int8", "fp32")), "require impl='mixed'"),
    (dict(impl="mixed", split=1, weight_dtype="int8"), "not both"),
    (dict(impl="mixed", split=3), "outside"),
    (dict(impl="mixed", weight_dtype=("int8",)), "one entry per layer"),
    (dict(impl="mixed", chunk_len=(4, 4, 4)), "one entry per layer"),
    (dict(impl="mixed", fuse_gates=True, split=1), "incompatible with int8"),
    (dict(impl="fused_stack_sharded", act_bits=16), "act_bits only applies"),
    (dict(impl="fused_step", placement="sharded", act_bits=16), "act_bits only applies"),
    (dict(impl="wavefront", weight_dtype="int8"), "quantized-capable"),
    (dict(impl="mixed", placement="sharded"), "single-host"),
    (dict(impl="mixed", mesh=("cpu",)), "single-host"),
    (dict(impl="mixed", n_chunks=2), "n_chunks only applies"),
    (dict(impl="fused_stack_sharded", n_chunks=0), "n_chunks must be"),
    (dict(impl="fused_stack_sharded", mesh=()), "at least one device"),
    (dict(impl="fused_stack_sharded", mesh=("meta",)), "neither the CPU"),
]


@pytest.mark.parametrize("kw,match", PLAN_ERRORS, ids=[e[1] + "-" + str(i)
                                                        for i, e in enumerate(PLAN_ERRORS)])
def test_plan_time_errors(kw, match):
    cfgs = [LstmConfig(in_dim=1, hidden=4), LstmConfig(in_dim=4, hidden=4)]
    with pytest.raises(ValueError, match=match):
        tex.plan_stack(cfgs, **kw)


def test_heterogeneous_fused_segment_refused():
    cfgs = [LstmConfig(in_dim=1, hidden=4), LstmConfig(in_dim=4, hidden=4, acts=tq.HARD)]
    with pytest.raises(ValueError, match="homogeneous activations"):
        tex.plan_stack(cfgs, impl="fused_stack")
    cfgs = [LstmConfig(in_dim=1, hidden=4), LstmConfig(in_dim=4, hidden=4, weight_dtype="int8")]
    with pytest.raises(ValueError, match="homogeneous weight_dtype"):
        tex.plan_stack(cfgs, impl="fused_stack")


RESOLVE_CASES = [
    ("exact", None, None, "fused_stack"),
    ("exact", None, None, "fused_step"),
    ("exact", None, None, None),
    ("paper_hw", None, None, "fused_stack"),
    ("paper_hw", None, None, "fused_step"),
    ("hard", None, None, "fused_step"),
    ("exact", "int8", None, "fused_stack"),
    ("exact", "int8", "fp32", "fused_step"),
]


@pytest.mark.parametrize("acts,wd,dec_wd,impl", RESOLVE_CASES)
def test_resolve_impl_matches_reference(acts, wd, dec_wd, impl):
    r_cfg = rae.AutoencoderConfig(acts=rq.ACTIVATION_SETS[acts], weight_dtype=wd,
                                  dec_weight_dtype=dec_wd)
    t_cfg = tae.AutoencoderConfig(acts=tq.ACTIVATION_SETS[acts], weight_dtype=wd,
                                  dec_weight_dtype=dec_wd)
    r_out, t_out = rbk.resolve_impl(r_cfg, impl), tbk.resolve_impl(t_cfg, impl)
    assert t_out[0].impl == r_out[0].impl
    assert t_out[1] == r_out[1]
    assert (t_out[2] is None) == (r_out[2] is None)


@pytest.mark.parametrize("impl", [None, "paper_hw"])
def test_resolve_impl_refuses_quantized_fallback(impl):
    """int8 storage with a request the engine must decline keeps cfg.impl
    ('split'), which cannot honour int8: both packages raise."""
    acts = "paper_hw" if impl else "exact"
    kw = dict(weight_dtype="int8")
    with pytest.raises(ValueError):
        rbk.resolve_impl(rae.AutoencoderConfig(acts=rq.ACTIVATION_SETS[acts], **kw),
                         "fused_stack" if impl else None)
    with pytest.raises(ValueError, match="fused backend"):
        tbk.resolve_impl(tae.AutoencoderConfig(acts=tq.ACTIVATION_SETS[acts], **kw),
                         "fused_stack" if impl else None)
