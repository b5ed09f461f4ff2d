"""The port's ``mixed`` backend: per-layer storage splits as chained
``fused_step`` segments, against itself and against the reference.

* Inside the port, ``mixed`` equals hand-chaining one homogeneous
  ``fused_step`` executor per maximal equal-dtype run, bit for bit
  (``torch.equal``): the batch forward, its finals, chunked streaming
  (pieces above and below ``chunk_len``), ``update_params`` and
  ``act_bits`` on every segment.
* Against the reference (its params carried over with
  ``repro_torch.convert``, inputs from numpy with a seed): the same
  segments, per-layer dtypes, ``split``, ``layer_assignment()`` and knob
  provenance for the same requests; equal int8 codes and scales; outputs
  within the reference's own 1e-5 of its ``mixed`` executor (interpret
  mode).
* The engines: scores within 1e-5 of the reference's mixed engines,
  streaming within rtol 1e-6 / atol 1e-7 of one-shot, ``push_many`` equal
  to sequential pushes, fingerprints with the ``int8+fp32`` signature and
  ``act_bits``, snapshots across the two packages both ways, and a
  different split refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.autotune import cache as rcache  # noqa: E402
from repro.core import executor as rex  # noqa: E402
from repro.core.autoencoder import AutoencoderConfig as RConfig  # noqa: E402
from repro.core.autoencoder import init_autoencoder as r_init  # noqa: E402
from repro.core.backends import resolve_impl as r_resolve_impl  # noqa: E402
from repro.core.lstm import LstmConfig as RLstmConfig  # noqa: E402
from repro.core.lstm import init_lstm as r_init_lstm  # noqa: E402
from repro.kernels.lstm_stack import ops as rops  # noqa: E402
from repro.serve import engine as reng  # noqa: E402
from repro.serve import health as rhealth  # noqa: E402
from repro_torch.autotune import cache as tcache  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core.autoencoder import AutoencoderConfig  # noqa: E402
from repro_torch.core.backends import resolve_impl  # noqa: E402
from repro_torch.core.lstm import LstmConfig  # noqa: E402
from repro_torch.core.stage_balance import segment_runs  # noqa: E402
from repro_torch.kernels.lstm_stack import ops as tops  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import health as thealth  # noqa: E402

GW_DIMS = [(1, 32), (32, 8), (8, 8), (8, 32)]
TOL = dict(rtol=1e-5, atol=1e-5)
STREAM_TOL = dict(rtol=1e-6, atol=1e-7)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def stack():
    """(reference params, port params, reference cfgs, port cfgs, x)."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(GW_DIMS))
    r_cfgs = [RLstmConfig(in_dim=a, hidden=b) for a, b in GW_DIMS]
    r_params = [r_init_lstm(k, c) for k, c in zip(keys, r_cfgs)]
    t_cfgs = [LstmConfig(in_dim=a, hidden=b) for a, b in GW_DIMS]
    x = np.random.RandomState(1).randn(3, 8, 1).astype(np.float32)
    return r_params, [_to_torch(p) for p in r_params], r_cfgs, t_cfgs, x


def _chained(cfgs, params, wds, **plan_kw):
    """One homogeneous fused_step executor per maximal equal-dtype run."""
    return [tex.plan_stack(cfgs[a:b], impl="fused_step", weight_dtype=wds[a], **plan_kw)
            .bind(params[a:b]) for a, b in segment_runs(wds)]


def _equal(got, want):
    got, want = tex.state_leaves(got), tex.state_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (a) mixed == hand-chained fused_step segments, bit for bit
# ---------------------------------------------------------------------------

WDS = ("int8", "bf16", "bf16", "fp32")  # three segments, three storages


class TestMixedEqualsChained:
    def test_batch_forward_and_finals(self, stack):
        _, params, _, cfgs, x = stack
        xs = torch.from_numpy(x)
        got_h, got_f = tex.plan_stack(cfgs, impl="mixed", weight_dtype=WDS).bind(params)(xs)
        h, finals = xs, []
        for sub in _chained(cfgs, params, WDS):
            h, f = sub(h)
            finals.extend(f)
        assert torch.equal(got_h, h)
        _equal(got_f, finals)

    def test_initial_state_threads_through_segments(self, stack):
        _, params, _, cfgs, x = stack
        xs = torch.from_numpy(x)
        mex = tex.plan_stack(cfgs, impl="mixed", weight_dtype=WDS).bind(params)
        _, init = mex(xs)
        got_h, got_f = mex(xs, init)
        h, finals, i = xs, [], 0
        for sub in _chained(cfgs, params, WDS):
            n = sub.plan.n_layers
            h, f = sub(h, init[i:i + n])
            finals.extend(f)
            i += n
        assert torch.equal(got_h, h)
        _equal(got_f, finals)

    @pytest.mark.parametrize("chunk_len", [None, 4])
    def test_chunked_streaming(self, stack, chunk_len):
        """Uneven pushes with carried state; with chunk_len=4 the 5-sample
        piece is longer than chunk_len and takes the wavefront kernel in
        every segment.  The mixed native state is the tuple of the
        segments' native states."""
        _, params, _, cfgs, x = stack
        mex = tex.plan_stack(cfgs, impl="mixed", weight_dtype=WDS,
                             chunk_len=chunk_len).bind(params)
        subs = _chained(cfgs, params, WDS, chunk_len=chunk_len)
        state = mex.zero_state(3)
        sub_states = [s.zero_state(3) for s in subs]
        for lo, hi in ((0, 1), (1, 3), (3, 8)):
            chunk = torch.from_numpy(x[:, lo:hi])
            h_got, state = mex.step_with_output(chunk, state)
            h = chunk
            for i, sub in enumerate(subs):
                h, sub_states[i] = sub.step_with_output(h, sub_states[i])
            assert torch.equal(h_got, h)
        _equal(state, tuple(sub_states))
        assert torch.equal(mex.last_hidden(state), subs[-1].last_hidden(sub_states[-1]))

    def test_step_then_forward_consistent(self, stack):
        """Chunked steps against one whole-window forward: causality up to
        the step and wavefront kernels' different layer-0 products."""
        _, params, _, cfgs, x = stack
        mex = tex.plan_stack(cfgs, impl="mixed", weight_dtype=WDS).bind(params)
        state = mex.zero_state(3)
        for lo, hi in ((0, 4), (4, 8)):
            state = mex.step(torch.from_numpy(x[:, lo:hi]), state)
        _, finals = mex(torch.from_numpy(x))
        np.testing.assert_allclose(mex.last_hidden(state).numpy(), finals[-1][0].numpy(),
                                   rtol=1e-4, atol=1e-6)

    def test_update_params_rebinds_all_segments(self, stack):
        _, params, _, cfgs, x = stack
        mex = tex.plan_stack(cfgs, impl="mixed", weight_dtype=WDS).bind(params)
        params2 = [{k: v * 0.5 for k, v in p.items()} for p in params]
        mex2 = mex.update_params(params2)
        h = torch.from_numpy(x)
        subs = _chained(cfgs, params2, WDS)
        for sub in subs:
            h = sub(h, return_state=False)
        assert torch.equal(mex2(torch.from_numpy(x), return_state=False), h)
        assert mex2.packed_bytes == sum(s.packed_bytes for s in subs)
        assert mex2.plan is mex.plan

    def test_act_bits_reach_every_segment(self, stack):
        _, params, _, cfgs, x = stack
        wds = ("int8", "int8", "fp32", "fp32")
        mex = tex.plan_stack(cfgs, impl="mixed", weight_dtype=wds, act_bits=16).bind(params)
        h = torch.from_numpy(x)
        for sub in _chained(cfgs, params, wds, act_bits=16):
            h = sub(h, return_state=False)
        assert torch.equal(mex(torch.from_numpy(x), return_state=False), h)
        assert all(sp.act_bits == 16 for sp in mex.plan.segments)


# ---------------------------------------------------------------------------
# plan-time surfaces of the port
# ---------------------------------------------------------------------------

class TestMixedPlan:
    def test_split_shorthand_and_provenance(self, stack):
        cfgs = stack[3]
        plan = tex.plan_stack(cfgs, impl="mixed", split=2)
        assert plan.weight_dtype == ("int8", "int8", "fp32", "fp32")
        assert plan.split == 2 and len(plan.segments) == 2
        assert plan.knob_provenance()["weight_dtype"][1] == "explicit"
        assert "int8+int8+fp32+fp32" in plan.describe() and "segments=2" in plan.describe()
        assert tex.plan_stack(cfgs, impl="mixed", split=2) is plan

    def test_segments_are_the_hand_built_fused_step_plans(self, stack):
        cfgs = stack[3]
        seg = tex.plan_stack(cfgs, impl="mixed", split=2).segments[0]
        hand = tex.plan_stack(cfgs[:2], impl="fused_step", weight_dtype="int8")
        assert seg == hand and seg.impl == "fused_step"

    def test_layer_assignment_only_on_mixed(self, stack):
        with pytest.raises(ValueError, match="mixed-plan surface"):
            tex.plan_stack(stack[3], impl="fused_step").layer_assignment()

    def test_resolve_impl_keeps_mixed_for_heterogeneous_cfg(self):
        cfg = AutoencoderConfig(hidden=(32, 8, 8, 32), impl="mixed",
                                weight_dtypes=("int8", "fp32", "fp32", "int8"))
        _, eff, reason = resolve_impl(cfg, "fused_step")
        assert eff == "mixed" and "mixed" in reason
        rcfg = RConfig(hidden=(32, 8, 8, 32), impl="mixed",
                       weight_dtypes=("int8", "fp32", "fp32", "int8"))
        assert r_resolve_impl(rcfg, "fused_step")[1:] == (eff, reason)

    def test_autoencoder_weight_dtypes_validated(self):
        with pytest.raises(ValueError, match="one entry per hidden layer"):
            AutoencoderConfig(hidden=(9, 9), weight_dtypes=("int8",))
        cfg = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, weight_dtype="bf16",
                                weight_dtypes=(None, "int8"))
        assert [c.weight_dtype for c in cfg.layer_cfgs()] == ["bf16", "int8"]


# ---------------------------------------------------------------------------
# (b) the port against the reference
# ---------------------------------------------------------------------------

REQUESTS = [
    dict(),
    dict(split=0),
    dict(split=1),
    dict(split=2),
    dict(split=3, act_bits=16),
    dict(split=4),
    dict(weight_dtype="int8"),
    dict(weight_dtype=("int8", "bf16", "bf16", "fp32")),
    dict(weight_dtype=("int8", "int8", "fp32", "fp32"), chunk_len=(4, 4, 8, 8)),
    dict(split=2, chunk_len=8, block_b=2, fuse_gates=False),
]


def _plan_view(plan):
    """What the two packages must agree on for one plan."""
    return {
        "segments": [([(c.in_dim, c.hidden, c.weight_dtype) for c in s.cfgs], s.weight_dtype,
                      s.chunk_len, s.block_b, s.fuse_gates, s.act_bits) for s in plan.segments],
        "weight_dtype": plan.weight_dtype, "split": plan.split, "chunk_len": plan.chunk_len,
        "layers": plan.layer_assignment(), "provenance": plan.knob_provenance(),
    }


@pytest.mark.parametrize("kw", REQUESTS, ids=[str(i) for i in range(len(REQUESTS))])
def test_plans_equal_the_reference(stack, kw):
    _, _, r_cfgs, t_cfgs, _ = stack
    want = _plan_view(rex.plan_stack(r_cfgs, impl="mixed", **kw))
    assert _plan_view(tex.plan_stack(t_cfgs, impl="mixed", **kw)) == want


@pytest.fixture
def both_caches():
    """An empty in-memory tuned store installed in each package."""
    r, t = rcache.TunedPlanCache(), tcache.TunedPlanCache()
    old = rcache.set_cache(r), tcache.set_cache(t)
    rex.clear_plan_cache()
    tex.clear_plan_cache()
    try:
        yield r, t
    finally:
        rcache.set_cache(old[0])
        tcache.set_cache(old[1])
        rex.clear_plan_cache()
        tex.clear_plan_cache()


@pytest.mark.parametrize("knobs,kw", [
    ({"split": 3, "chunk_len": 4}, {}),
    ({"split": 3, "chunk_len": 4}, {"split": 1}),
    ({"block_b": 2, "fuse_gates": False}, {"chunk_len": 16}),
])
def test_tuned_plans_equal_the_reference(stack, both_caches, knobs, kw):
    _, _, r_cfgs, t_cfgs, _ = stack
    dims = tuple(GW_DIMS)
    for cache, mod, cfgs in ((both_caches[0], rcache, r_cfgs), (both_caches[1], tcache, t_cfgs)):
        cache.put(dims, "mixed", mod.canonical_weight_dtype(cfgs, None), knobs)
    want = _plan_view(rex.plan_stack(r_cfgs, impl="mixed", tune="cached", **kw))
    got = _plan_view(tex.plan_stack(t_cfgs, impl="mixed", tune="cached", **kw))
    assert got == want
    assert any(src == "tuned" for _, src in got["provenance"].values())


def test_int8_codes_and_scales_equal_the_reference(stack):
    r_params, t_params, r_cfgs, t_cfgs, _ = stack
    r_ex = rex.plan_stack(r_cfgs, impl="mixed", split=3).bind(r_params)
    t_ex = tex.plan_stack(t_cfgs, impl="mixed", split=3).bind(t_params)
    assert t_ex.packed_bytes == r_ex.packed_bytes
    for r_pk, t_pk in zip(r_ex.packed, t_ex.packed):
        assert t_pk.weight_dtype == r_pk.weight_dtype
        assert sorted(t_pk.stacked) == sorted(r_pk.stacked)
        for key, arr in r_pk.stacked.items():
            np.testing.assert_array_equal(t_pk.stacked[key].numpy(), np.asarray(arr))
    assert "scales" in t_ex.packed[0].stacked


@pytest.mark.parametrize("kw", [dict(split=2), dict(weight_dtype=WDS), dict(split=1, act_bits=16)],
                         ids=["split2", "three-storages", "act_bits"])
def test_outputs_match_the_reference(stack, kw):
    r_params, t_params, r_cfgs, t_cfgs, x = stack
    r_ex = rex.plan_stack(r_cfgs, impl="mixed", **kw).bind(r_params)
    t_ex = tex.plan_stack(t_cfgs, impl="mixed", **kw).bind(t_params)
    r_h, r_f = r_ex(jax.numpy.asarray(x))
    t_h, t_f = t_ex(torch.from_numpy(x))
    np.testing.assert_allclose(t_h.float().numpy(), np.asarray(r_h, np.float32), **TOL)
    for (th, tc), (rh, rc) in zip(t_f, r_f):
        np.testing.assert_allclose(th.float().numpy(), np.asarray(rh, np.float32), **TOL)
        np.testing.assert_allclose(tc.float().numpy(), np.asarray(rc, np.float32), **TOL)
    r_state, t_state = r_ex.zero_state(3), t_ex.zero_state(3)
    for lo, hi in ((0, 3), (3, 8)):
        r_state = r_ex.step(jax.numpy.asarray(x[:, lo:hi]), r_state)
        t_state = t_ex.step(torch.from_numpy(x[:, lo:hi]), t_state)
    np.testing.assert_allclose(t_ex.last_hidden(t_state).float().numpy(),
                               np.asarray(r_ex.last_hidden(r_state), np.float32), **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

T = 12
ENGINE_WDS = ("int8", "fp32", "fp32", "int8")


@pytest.fixture(scope="module")
def engines_setup():
    r_cfg = RConfig(hidden=(32, 8, 8, 32), latent_boundary=2, timesteps=T, impl="mixed",
                    weight_dtypes=ENGINE_WDS)
    t_cfg = AutoencoderConfig(hidden=(32, 8, 8, 32), latent_boundary=2, timesteps=T,
                              impl="mixed", weight_dtypes=ENGINE_WDS)
    r_params = r_init(jax.random.PRNGKey(5), r_cfg)
    x = np.random.RandomState(6).randn(3, 3 * T, 1).astype(np.float32)
    return r_params, _to_torch(r_params), r_cfg, t_cfg, x


def _ref(setup, **kw):
    r_params, _, r_cfg, _, _ = setup
    cfg = kw.pop("cfg", r_cfg)
    return reng.StreamingAnomalyEngine(r_params, cfg, batch=kw.pop("batch", 1), window=T,
                                       impl="mixed", **kw)


def _port(setup, **kw):
    _, t_params, _, t_cfg, _ = setup
    cfg = kw.pop("cfg", t_cfg)
    return teng.StreamingAnomalyEngine(t_params, cfg, batch=kw.pop("batch", 1), window=T,
                                       impl="mixed", device="cpu", **kw)


class TestMixedEngine:
    def test_fingerprint_reads_like_the_reference(self, engines_setup):
        fp = _port(engines_setup).fingerprint()
        assert fp["weight_dtype"] == "int8+fp32" and "act_bits" not in fp
        assert fp == _ref(engines_setup).fingerprint()
        cfg16 = dataclasses.replace(engines_setup[3], act_bits=16)
        r16 = dataclasses.replace(engines_setup[2], act_bits=16)
        assert _port(engines_setup, cfg=cfg16).fingerprint() == \
            _ref(engines_setup, cfg=r16).fingerprint()
        assert _port(engines_setup, cfg=cfg16).fingerprint()["act_bits"] == 16

    def test_scores_match_the_reference_engines(self, engines_setup):
        r_params, t_params, r_cfg, t_cfg, x = engines_setup
        w = x[:, :T]
        got = teng.AnomalyStreamEngine(t_params, t_cfg, impl="mixed", device="cpu").score(w)
        want = reng.AnomalyStreamEngine(r_params, r_cfg, impl="mixed").score(w)
        np.testing.assert_allclose(got, want, **TOL)
        streamed = {}
        for name, eng in (("port", _port(engines_setup, batch=3)),
                          ("ref", _ref(engines_setup, batch=3))):
            streamed[name] = [s for lo, hi in ((0, 5), (5, T)) for s in eng.push(w[:, lo:hi])]
        np.testing.assert_allclose(streamed["port"][0], np.asarray(streamed["ref"][0]), **TOL)

    def test_chunked_push_matches_one_shot(self, engines_setup):
        x = engines_setup[4]
        (one,) = _port(engines_setup, batch=3).push(x[:, :T])
        eng = _port(engines_setup, batch=3)
        chunked = [s for lo, hi in ((0, 4), (4, 9), (9, T)) for s in eng.push(x[:, lo:hi])]
        np.testing.assert_allclose(one, chunked[0], **STREAM_TOL)
        np.testing.assert_allclose(eng.score(x[:, :T]), one, **STREAM_TOL)

    def test_push_many_equals_sequential_pushes(self, engines_setup):
        x = engines_setup[4]
        pool = _port(engines_setup)
        pool.push_many(["a"], x[:1, :5])  # ragged fill levels
        got = {sid: [] for sid in "abc"}
        starts = {"a": 5, "b": 0, "c": 0}
        for a, b in ((0, 7), (7, 2 * T)):
            res = pool.push_many(list("abc"), np.stack([x[i, s + a : s + b] for i, s in
                                                        enumerate(starts.values())]))
            for sid in got:
                got[sid] += res[sid]
        seq = _port(engines_setup)
        for i, (sid, s) in enumerate(starts.items()):
            seq.reset()
            cuts = ([0] if s else []) + [s, s + 7, s + 2 * T]
            want = [sc for a, b in zip(cuts, cuts[1:]) for sc in seq.push(x[i : i + 1, a:b])]
            assert len(got[sid]) == len(want) >= 1
            for g, w in zip(got[sid], want):
                np.testing.assert_array_equal(g, w)

    def test_snapshot_roundtrip_bit_equal(self, engines_setup, tmp_path):
        x = engines_setup[4]
        path = str(tmp_path / "mixed.npz")
        a = _port(engines_setup, batch=3)
        a.push(x[:, :5])  # mid-window through two segments
        a.save_snapshot(path)
        b = _port(engines_setup, batch=3)
        b.restore(path)
        assert b.filled == 5
        np.testing.assert_array_equal(a.push(x[:, 5:T])[0], b.push(x[:, 5:T])[0])
        pa = _port(engines_setup)
        pa.push_many(["s", "t"], x[:2, :7])
        pb = _port(engines_setup)
        pb.restore(pa.snapshot())
        assert pb.stream_ids == ("s", "t")
        ra, rb = pa.push_many(["s", "t"], x[:2, 7:T]), pb.push_many(["s", "t"], x[:2, 7:T])
        for sid in ("s", "t"):
            np.testing.assert_array_equal(ra[sid][0], rb[sid][0])

    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_snapshots_cross_the_packages(self, engines_setup, tmp_path, direction):
        x = engines_setup[4]
        path = str(tmp_path / "snap.npz")
        make = {"ref": lambda: _ref(engines_setup), "port": lambda: _port(engines_setup)}
        src_name, dst_name = direction.split("_to_")
        src = make[src_name]()
        src.push_many(["a", "b"], x[:2, :5])
        src.push_many(["a", "b", "c"], x[:, 5:9])
        src.save_snapshot(path)
        dst = make[dst_name]()
        dst.restore(path)
        assert set(dst.stream_ids) == {"a", "b", "c"}
        got = dst.push_many(["a", "b", "c"], x[:, 9:T + 4])
        want = src.push_many(["a", "b", "c"], x[:, 9:T + 4])
        for sid in ("a", "b"):
            np.testing.assert_allclose(np.asarray(got[sid][0]), np.asarray(want[sid][0]), **TOL)

    def test_fingerprint_refuses_another_split(self, engines_setup, tmp_path):
        p_path, r_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
        _port(engines_setup).save_snapshot(p_path)
        _ref(engines_setup).save_snapshot(r_path)
        other = ("fp32", "fp32", "fp32", "int8")
        t_other = dataclasses.replace(engines_setup[3], weight_dtypes=other)
        r_other = dataclasses.replace(engines_setup[2], weight_dtypes=other)
        with pytest.raises(thealth.SnapshotMismatchError, match="weight_dtype"):
            _port(engines_setup, cfg=t_other).restore(r_path)
        with pytest.raises(rhealth.SnapshotMismatchError, match="weight_dtype"):
            _ref(engines_setup, cfg=r_other).restore(p_path)
        with pytest.raises(thealth.SnapshotMismatchError, match="act_bits"):
            _port(engines_setup, cfg=dataclasses.replace(engines_setup[3], act_bits=16)) \
                .restore(p_path)

    def test_tune_balanced_engine(self, engines_setup):
        t_params = engines_setup[1]
        cfg = AutoencoderConfig(hidden=(32, 8, 8, 32), timesteps=T, impl="mixed")
        eng = teng.StreamingAnomalyEngine(t_params, cfg, window=T, impl="mixed",
                                          tune="balanced", device="cpu")
        prov = eng._exec_enc.plan.knob_provenance()
        assert prov["weight_dtype"][1] == "balanced" and eng._exec_enc.plan.split is not None
        batch = teng.AnomalyStreamEngine(t_params, cfg, impl="mixed", tune="balanced",
                                         device="cpu")
        assert batch._execs()[0].plan == eng._exec_enc.plan


def test_pack_of_each_segment_equals_the_reference_pack(stack):
    """``pack_stack`` of one segment is the reference's element for element
    at every storage (the mixed bind packs each segment this way)."""
    r_params, t_params, r_cfgs, t_cfgs, _ = stack
    for wd in ("fp32", "bf16", "int8"):
        r_pk = rops.pack_stack(r_params[1:3], r_cfgs[1:3], weight_dtype=wd)
        t_pk = tops.pack_stack(t_params[1:3], t_cfgs[1:3], weight_dtype=wd)
        for key, arr in r_pk.stacked.items():
            got, want = t_pk.stacked[key], np.asarray(arr)
            if got.dtype == torch.bfloat16:  # numpy has no bf16: compare widened
                got, want = got.float(), want.astype(np.float32)
            np.testing.assert_array_equal(got.numpy(), want)
