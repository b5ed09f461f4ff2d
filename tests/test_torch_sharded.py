"""Sharded placement in the port: ``fused_stack_sharded`` over a tuple of
stage devices, held against the port's local ``fused_stack`` and the
reference.

The reference's own sharded tests run on virtual XLA CPU devices in a
subprocess (``tests/test_executor.py``); its contract is that the sharded
wavefront equals the local fused stack bit for bit, because it only moves
where each (layer, chunk) cell runs.  Here the stages are ``("cpu",) * S``:

* ``fused_stack_sharded`` at ``gw_nominal``'s 4-layer stack (S in {1, 2,
  4}) and at each 2-layer segment (S in {1, 2}), fp32 and int8 storage,
  zero and non-zero initial state, several ``n_chunks``: ``torch.equal``
  to local ``fused_stack`` (outputs and finals), through the executor and
  through ``wavefront_shard_map_fused`` itself; the streaming ``step``
  surface likewise.  With bf16 compute a stage boundary's input product is
  rounded to bf16 outside the kernel (``project_layer0``) where the local
  kernel's inner layer keeps it in fp32 (the reference rounds it the same
  way and never tests bf16); the recurrence carries that one rounding on
  through the window, so bf16 is held to K1's bf16 tolerance (the
  reference's, rtol 2e-2 / atol 1e-2, as in ``test_torch_kernels.py``).
* The reference's single-stage inline test, across packages: the
  reference's sharded plan (one device) within 1e-5 of the port's, and the
  port's equal to its local plan.
* Plan legality against the reference (each request refused by both, or
  planned by both with the same backend and knobs), and
  ``test_n_chunks_must_divide_time``.
* Both engines with ``placement="sharded"``: the golden fixture's scores
  within 1e-5, equal to the local engines' bit for bit, ``push_many``
  equal to sequential pushes, snapshots crossing placements both ways.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import executor as rex  # noqa: E402
from repro.core.lstm import LstmConfig as RLstmConfig  # noqa: E402
from repro.core.lstm import init_lstm as r_init_lstm  # noqa: E402
from repro_torch.configs.gw import GW_MODELS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core.lstm import LstmConfig  # noqa: E402
from repro_torch.core.pipeline import StagedStack, wavefront_shard_map_fused  # noqa: E402
from repro_torch.kernels.lstm_stack.ops import lstm_stack_op  # noqa: E402
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine  # noqa: E402

FIXTURE = Path(__file__).parent / "data" / "torch_port_gw_nominal.npz"
GW_DIMS = [(1, 32), (32, 8), (8, 8), (8, 32)]
SEGMENTS = {"stack": GW_DIMS, "enc": GW_DIMS[:2], "dec": GW_DIMS[2:]}
BF16_TOL = dict(rtol=2e-2, atol=1e-2)  # K1's bf16 tolerance (test_torch_kernels.py)
TOL = dict(rtol=1e-5, atol=1e-5)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _reference_stack(dims, seed=0):
    r_cfgs = [RLstmConfig(in_dim=a, hidden=b) for a, b in dims]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dims))
    return [r_init_lstm(k, c) for k, c in zip(keys, r_cfgs)], r_cfgs


@pytest.fixture(scope="module")
def gw_params():
    r_params, _ = _reference_stack(GW_DIMS)
    return [_to_torch(p) for p in r_params]


def _cfgs(dims, dtype=torch.float32):
    return [LstmConfig(in_dim=a, hidden=b, dtype=dtype) for a, b in dims]


def _segment(gw_params, name):
    first = {"stack": 0, "enc": 0, "dec": 2}[name]
    dims = SEGMENTS[name]
    return gw_params[first : first + len(dims)], dims


def _state(dims, batch, seed):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy((rng.randn(batch, b) * 0.3).astype(np.float32)),
             torch.from_numpy((rng.randn(batch, b) * 0.3).astype(np.float32)))
            for _, b in dims]


def _assert_equal_runs(got, want, exact=True):
    (h_g, f_g), (h_w, f_w) = got, want
    pairs = [(h_g, h_w)] + [(a, b) for fg, fw in zip(f_g, f_w) for a, b in zip(fg, fw)]
    for a, b in pairs:
        if exact:
            assert torch.equal(a, b), (a.float() - b.float()).abs().max()
        else:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **BF16_TOL)


CASES = [(seg, s) for seg in ("stack", "enc", "dec") for s in (1, 2, 4)
         if len(SEGMENTS[seg]) % s == 0]


@pytest.mark.parametrize("seg,n_stages", CASES, ids=[f"{g}-S{s}" for g, s in CASES])
@pytest.mark.parametrize("wd", ["fp32", "int8"])
def test_sharded_equals_local_bitwise(gw_params, seg, n_stages, wd):
    params, dims = _segment(gw_params, seg)
    cfgs = _cfgs(dims)
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 20, dims[0][0]).astype(np.float32))
    local = tex.plan_stack(cfgs, impl="fused_stack", weight_dtype=wd).bind(params)
    init = _state(dims, 3, 2)
    want_zero, want_init = local(x), local(x, init)
    for n_chunks in (None, 1, 2, 4, 5, 20):
        ex = tex.plan_stack(cfgs, impl="fused_stack", weight_dtype=wd, placement="sharded",
                            mesh=("cpu",) * n_stages, n_chunks=n_chunks).bind(params)
        assert ex.plan.impl == "fused_stack_sharded" and len(ex.mesh) == n_stages
        _assert_equal_runs(ex(x), want_zero)
        _assert_equal_runs(ex(x, init), want_init)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_sharded_bf16_within_the_k1_tolerance(gw_params, n_stages):
    """bf16 compute: a stage boundary rounds the next layer's input product
    to bf16 (``project_layer0``), the local kernel's inner layer does not,
    and the recurrence carries that rounding on: K1's bf16 tolerance."""
    cfgs = _cfgs(GW_DIMS, torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 20, 1).astype(np.float32))
    local = tex.plan_stack(cfgs, impl="fused_stack").bind(gw_params)
    ex = tex.plan_stack(cfgs, impl="fused_stack", placement="sharded",
                        mesh=("cpu",) * n_stages).bind(gw_params)
    _assert_equal_runs(ex(x), local(x), exact=False)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_shard_map_fused_equals_one_k1_call(gw_params, n_stages):
    """The schedule function itself on a packed state, against one
    ``lstm_stack_op`` over the whole window: the last layer's sequence and
    every layer's (h, c)."""
    ex = tex.plan_stack(_cfgs(GW_DIMS), impl="fused_stack", weight_dtype="int8").bind(gw_params)
    packed = ex.packed
    x = packed.pad_input(torch.from_numpy(
        np.random.RandomState(4).randn(2, 12, 1).astype(np.float32)))
    h0, c0 = packed.pack_state(_state(GW_DIMS, 2, 5))
    want = lstm_stack_op(x, packed.stacked, h0, c0, acts=packed.acts, weight_dtype="int8")
    mesh = ("cpu",) * n_stages
    staged = StagedStack.place(packed, mesh)
    assert len(staged.stages) == n_stages and staged.streams == (None,) * n_stages
    for n_chunks in (1, 3, 12):
        got = wavefront_shard_map_fused(packed, staged, x, h0, c0, n_chunks)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not divide"):
        wavefront_shard_map_fused(packed, staged, x, h0, c0, 5)


def test_sub_stacks_are_views_of_the_one_pack(gw_params):
    """Weights are packed once, at bind; a stage on the pack's own device
    holds views of it, and the int8 scales split with the weights."""
    ex = tex.plan_stack(_cfgs(GW_DIMS), impl="fused_stack_sharded", weight_dtype="int8",
                        mesh=("cpu", "cpu")).bind(gw_params)
    stages = ex.staged.stages
    for s, stage in enumerate(stages):
        for key, value in stage.items():
            assert value.shape[0] == 2
            assert value.data_ptr() == ex.packed.stacked[key][2 * s].data_ptr()
    assert set(stages[0]) == {"w_x", "w_h", "b", "scales"}
    assert ex.update_params(gw_params).staged is not ex.staged


@pytest.mark.parametrize("t_len", [1, 5, 20])
def test_sharded_step_surface_equals_local(gw_params, t_len):
    """The streaming surface on packed state: chunks of any length, state
    carried across calls, the sharded and local states bit-equal."""
    cfgs = _cfgs(GW_DIMS)
    local = tex.plan_stack(cfgs, impl="fused_step").bind(gw_params)
    ex = tex.plan_stack(cfgs, impl="fused_step", placement="sharded",
                        mesh=("cpu",) * 2).bind(gw_params)
    assert ex.plan.impl == "fused_stack_sharded" and ex.plan.chunk_len is None
    x = torch.from_numpy(np.random.RandomState(t_len).randn(2, t_len, 1).astype(np.float32))
    # the local plan routes short chunks to the step kernel, whose input
    # product is in-kernel: hold the sharded surface to the local wavefront
    wave = tex.plan_stack(cfgs, impl="fused_stack").bind(gw_params)
    s_sh, s_wave = ex.zero_state(2), wave.zero_state(2)
    for _ in range(2):
        s_sh, s_wave = ex.step(x, s_sh), wave.step(x, s_wave)
    assert all(torch.equal(a, b) for a, b in zip(s_sh, s_wave))
    assert torch.equal(ex.last_hidden(s_sh), wave.last_hidden(s_wave))
    hs_sh, _ = ex.step_with_output(x, s_sh)
    hs_wave, _ = wave.step_with_output(x, s_wave)
    assert torch.equal(hs_sh, hs_wave)
    np.testing.assert_allclose(local.last_hidden(local.step(x, local.zero_state(2))),
                               ex.last_hidden(ex.step(x, ex.zero_state(2))), **TOL)


def test_single_stage_sharded_matches_reference_inline():
    """The reference's ``test_single_stage_sharded_matches_local_inline``
    (its gw_stack, one stage), held across packages."""
    dims = [(1, 32), (32, 8), (8, 8)]
    r_params, r_cfgs = _reference_stack(dims)
    xs = np.random.RandomState(1).randn(3, 12, 1).astype(np.float32)
    r_sharded = rex.plan_stack(r_cfgs, impl="fused_stack", placement="sharded").bind(r_params)
    want = np.asarray(r_sharded(jax.numpy.asarray(xs), return_state=False))
    params = [_to_torch(p) for p in r_params]
    local = tex.plan_stack(_cfgs(dims), impl="fused_stack").bind(params)
    sharded = tex.plan_stack(_cfgs(dims), impl="fused_stack", placement="sharded").bind(params)
    assert sharded.mesh == (torch.device("cpu"),)
    got = sharded(torch.from_numpy(xs), return_state=False)
    assert torch.equal(got, local(torch.from_numpy(xs), return_state=False))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_n_chunks_must_divide_time(gw_params):
    ex = tex.plan_stack(_cfgs(GW_DIMS), impl="fused_stack", placement="sharded",
                        mesh=("cpu",) * 2, n_chunks=5).bind(gw_params)
    with pytest.raises(ValueError, match="n_chunks"):
        ex(torch.zeros(3, 12, 1))
    # auto: one chunk per stage where the stages divide T, else one chunk
    auto = tex.plan_stack(_cfgs(GW_DIMS), impl="fused_stack_sharded",
                          mesh=("cpu",) * 4).bind(gw_params)
    assert tex._resolve_n_chunks(auto, 100) == 4 and tex._resolve_n_chunks(auto, 1) == 1
    assert tex._resolve_n_chunks(auto, 6) == 1


LEGALITY = [
    dict(impl="split", placement="sharded"),
    dict(impl="kernel", placement="sharded"),
    dict(impl="fused_stack", placement="orbital"),
    dict(impl="naive", n_chunks=2),
    dict(impl="fused_step", n_chunks=2),
    dict(impl="fused_stack_sharded", act_bits=16),
    dict(impl="fused_step", placement="sharded", act_bits=16),
    dict(impl="mixed", placement="sharded"),
    dict(impl="mixed", n_chunks=2),
    dict(impl="wavefront", weight_dtype="int8"),
    dict(impl="wavefront", act_bits=16),
    dict(impl="wavefront", chunk_len=4),
    dict(impl="fused_stack_sharded", chunk_len=4),
    dict(impl="fused_stack_sharded", fuse_gates=True),
    dict(impl="fused_stack_sharded", n_chunks=4),
    dict(impl="fused_step", placement="sharded", chunk_len=4, fuse_gates=True, block_b=2,
         n_chunks=2),
    dict(impl="fused_stack", placement="sharded", weight_dtype="int8"),
    dict(impl="wavefront", n_chunks=5),
]


@pytest.mark.parametrize("kw", LEGALITY, ids=[",".join(f"{k}={v}" for k, v in kw.items())
                                              for kw in LEGALITY])
def test_legality_follows_the_reference(kw):
    """Each request is refused by both packages, or planned by both with
    the same backend, placement, storage and knobs."""
    dims = [(1, 4), (4, 4)]
    r_cfgs = [RLstmConfig(in_dim=a, hidden=b) for a, b in dims]
    try:
        want = rex.plan_stack(r_cfgs, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            tex.plan_stack(_cfgs(dims), **kw)
        return
    got = tex.plan_stack(_cfgs(dims), **kw)
    for field in ("impl", "placement", "weight_dtype", "n_chunks", "chunk_len", "block_b",
                  "fuse_gates", "act_bits"):
        assert getattr(got, field) == getattr(want, field), field
    assert dict(got.knob_sources) == dict(want.knob_sources)


@pytest.mark.parametrize("mesh, match", [
    ((), "at least one"),
    (("cpu", "meta"), "neither"),
    (("cpu", "cuda:0"), "mixes"),
    (("cuda:0", "cpu"), "mixes"),
])
def test_mesh_legality(mesh, match):
    """A stage mesh is a non-empty tuple of devices of one kind."""
    with pytest.raises(ValueError, match=match):
        tex.plan_stack(_cfgs([(1, 4), (4, 4)]), impl="fused_stack_sharded", mesh=mesh)


def test_default_stage_mesh_starts_at_the_params_card(monkeypatch):
    """The default mesh counts every card, stage 0 on the params' own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert tex._default_stage_mesh(4, torch.device("cuda", 2)) == tuple(cuda[2:] + cuda[:2])
    assert tex._default_stage_mesh(2, torch.device("cuda", 3)) == (cuda[3], cuda[0])
    assert tex._default_stage_mesh(3, torch.device("cuda", 1)) == (cuda[1], cuda[2], cuda[3])
    assert tex._default_stage_mesh(4, torch.device("cpu")) == (torch.device("cpu"),)


def test_plan_surfaces():
    cfgs = _cfgs([(1, 4), (4, 4)])
    plan = tex.plan_stack(cfgs, impl="fused_stack_sharded", mesh=["cpu", "cpu"])
    assert plan is tex.plan_stack(cfgs, impl="fused_stack_sharded", mesh=("cpu", "cpu"))
    assert plan == tex.plan_stack(cfgs, impl="fused_stack", placement="sharded",
                                  mesh=(torch.device("cpu"),) * 2)
    assert plan.mesh == (torch.device("cpu"),) * 2
    assert "placement=sharded" in plan.describe() and "mesh=cpu,cpu" in plan.describe()
    assert plan.knob_provenance() == {"n_chunks": (None, "default")}
    default = tex.plan_stack(cfgs, impl="fused_stack_sharded")
    assert default.mesh is None and "mesh=default" in default.describe()
    assert tex.plan_stack(cfgs, impl="fused_stack").placement == "local"
    from repro_torch.core.lstm import init_lstm
    from repro_torch.kernels.lstm_stack.ops import pack_stack

    params = [init_lstm(c, torch.Generator().manual_seed(i), "cpu") for i, c in enumerate(cfgs)]
    supplied = pack_stack(params, cfgs)
    ex = plan.bind(params, packed=supplied)
    assert ex.packed is supplied
    assert ex.staged.stages[1]["w_h"].data_ptr() == supplied.stacked["w_h"][1].data_ptr()
    with pytest.raises(ValueError, match="step_graph"):
        plan.bind(params).step_graph(1)


def test_wavefront_backend_refuses_state():
    """The reference's test: ``wavefront`` runs stateless only."""
    from repro_torch.core.lstm import init_lstm

    cfgs = _cfgs([(1, 8), (8, 8)])
    params = [init_lstm(c, torch.Generator().manual_seed(5), "cpu") for c in cfgs]
    ex = tex.plan_stack(cfgs, impl="wavefront", n_chunks=2).bind(params)
    xs = torch.randn(3, 12, 1, generator=torch.Generator().manual_seed(1))
    assert ex(xs, return_state=False).shape == (3, 12, 8)
    with pytest.raises(ValueError, match="state"):
        ex(xs)
    for call in (lambda: ex.zero_state(3), lambda: ex.step(xs, None),
                 lambda: ex.last_hidden(None), lambda: ex(xs, [(None, None)] * 2)):
        with pytest.raises(ValueError, match="state"):
            call()


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as data:
        tree: dict = {}
        for key in data.files:
            if key.startswith("params/"):
                _, layer, name = key.split("/")
                tree.setdefault(layer, {})[name] = data[key]
        return {k: data[k] for k in data.files}, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("wd", ["fp32", "int8"])
def test_engines_score_the_golden_fixture(golden, wd):
    data, params = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
    x = data["windows"][::4]  # 4 background windows and 1 chirp
    batch = AnomalyStreamEngine(params, cfg, device="cpu", placement="sharded",
                                mesh=("cpu", "cpu"))
    ex_enc, _ = batch._execs()
    assert ex_enc.plan.impl == "fused_stack_sharded" and len(ex_enc.mesh) == 2
    got = batch.score(x)
    np.testing.assert_allclose(got, data[f"scores/{wd}"][::4], **TOL)
    local = AnomalyStreamEngine(params, cfg, device="cpu").score(x)
    np.testing.assert_array_equal(got, local)
    lock = StreamingAnomalyEngine(params, cfg, batch=len(x), device="cpu",
                                  placement="sharded", mesh=("cpu", "cpu"))
    streamed = [s for pos in range(0, 100, 25) for s in lock.push(x[:, pos : pos + 25])]
    np.testing.assert_allclose(streamed[0], data[f"streamed/{wd}"][::4], **TOL)


def _sharded(params, cfg, **kw):
    return StreamingAnomalyEngine(params, cfg, device="cpu", placement="sharded",
                                  mesh=("cpu", "cpu"), **kw)


def test_streaming_engine_push_many_equals_sequential(golden):
    data, params = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], timesteps=20)
    x = np.random.RandomState(6).randn(3, 45, 1).astype(np.float32)
    pool = _sharded(params, cfg)
    assert not pool._graph_steps and not pool._graph_finish
    assert pool._exec_enc.plan.impl == pool._exec_dec.plan.impl == "fused_stack_sharded"
    pool.push_many(["a"], x[:1, :7])
    got = {sid: [] for sid in "abc"}
    for a, b in ((0, 1), (1, 13), (13, 38)):
        starts = [7, 0, 0]
        res = pool.push_many(list("abc"), np.stack([x[i, s + a : s + b]
                                                     for i, s in enumerate(starts)]))
        for sid in "abc":
            got[sid] += res[sid]
    seq = _sharded(params, cfg)
    for i, sid in enumerate("abc"):
        seq.reset()
        cuts = ([0, 7] if i == 0 else [0]) + [(7 if i == 0 else 0) + c for c in (1, 13, 38)]
        want = [s for a, b in zip(cuts, cuts[1:]) for s in seq.push(x[i : i + 1, a:b])]
        assert len(got[sid]) == len(want) >= 1
        for g, w in zip(got[sid], want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("direction", ["sharded->local", "local->sharded"])
def test_snapshot_crosses_placements(golden, direction):
    data, params = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], timesteps=20)
    x = data["windows"][:2, :20]

    def make(placement):
        if placement == "sharded":
            return _sharded(params, cfg)
        return StreamingAnomalyEngine(params, cfg, device="cpu", impl="fused_stack")

    a, b = direction.split("->")
    src, dst = make(a), make(b)
    assert src.fingerprint() == dst.fingerprint()
    src.push(x[:1, :7])
    src.push_many(["p", "q"], x[:, :11])
    dst.restore(src.snapshot())
    np.testing.assert_array_equal(dst.push(x[:1, 7:])[0], src.push(x[:1, 7:])[0])
    got, want = dst.push_many(["p", "q"], x[:, 11:]), src.push_many(["p", "q"], x[:, 11:])
    for sid in ("p", "q"):
        np.testing.assert_array_equal(got[sid][0], want[sid][0])


def test_segment_executors_take_placement(golden):
    _, params = golden
    cfg = GW_MODELS["gw_nominal"]
    enc, dec = tae.segment_executors(params, cfg, impl="fused_step", placement="sharded",
                                     mesh=("cpu", "cpu"))
    assert enc.plan.impl == dec.plan.impl == "fused_stack_sharded"
    assert enc.mesh == dec.mesh == (torch.device("cpu"),) * 2
    assert enc.plan.hidden == (32, 8) and dec.plan.hidden == (8, 32)
    with pytest.raises(ValueError, match="placement='sharded'"):
        tae.segment_executors(params, cfg, mesh=("cpu",))


def test_tuned_n_chunks_round_trips_in_the_reference_format(tmp_path):
    """A tuned ``n_chunks`` written by either package's cache loads in the
    other and, under this process's fingerprint, reaches the port's sharded
    and wavefront plans as a tuned knob."""
    from repro.autotune import cache as rcache
    from repro_torch.autotune import cache as tcache

    dims = [(1, 4), (4, 4)]
    r = rcache.TunedPlanCache()
    r.put(dims, "fused_stack_sharded", "fp32", {"n_chunks": 4}, meta={"us": 1.0})
    r.save(str(tmp_path / "ref.json"))
    loaded = tcache.TunedPlanCache.load(str(tmp_path / "ref.json"))
    assert loaded.entries == r.entries
    mine = tcache.TunedPlanCache()
    for impl in ("fused_stack_sharded", "wavefront"):
        mine.put(dims, impl, "fp32", {"n_chunks": 2})
    mine.save(str(tmp_path / "port.json"))
    assert rcache.TunedPlanCache.load(str(tmp_path / "port.json")).entries == mine.entries
    old = tcache.set_cache(tcache.TunedPlanCache.load(str(tmp_path / "port.json")))
    try:
        for impl in ("fused_stack_sharded", "wavefront"):
            plan = tex.plan_stack(_cfgs(dims), impl=impl, tune="cached")
            assert plan.n_chunks == 2 and plan.knob_provenance()["n_chunks"] == (2, "tuned")
        explicit = tex.plan_stack(_cfgs(dims), impl="wavefront", tune="cached", n_chunks=4)
        assert explicit.knob_provenance()["n_chunks"] == (4, "explicit")
    finally:
        tcache.set_cache(old)


def test_engines_validate_the_sharded_plan_at_construction(golden):
    """The reference's ``test_oneshot_engine_validates_plan_at_init``:
    PAPER_HW declines the fused upgrade, so the engine resolves ``split``,
    which cannot take sharded placement; both engines raise when made."""
    from repro_torch.core.quant import PAPER_HW

    _, params = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], acts=PAPER_HW)
    with pytest.raises(ValueError, match="sharded"):
        AnomalyStreamEngine(params, cfg, device="cpu", placement="sharded")
    with pytest.raises(ValueError, match="sharded"):
        StreamingAnomalyEngine(params, cfg, device="cpu", placement="sharded")
