"""The port's autotuner: knob spaces, the tuned-plan cache, cached planning,
the sweep harness, the cost model and the tune CLI, on the CPU.

The contracts (the reference's ``tests/test_autotune.py``, without its HLO
classes: the port counts costs from its kernels' shapes):

* every point the space generator proposes is legal for its backend, the
  all-default point comes first, and the axes follow the port's kernels;
* the cache keeps the reference's file format: a file written by either
  package loads in the other, and each package's device fingerprint leaves
  the other's entries inert;
* ``plan_stack(tune="cached")`` resolves tuned knobs with provenance,
  explicit arguments beat tuned values, an empty cache gives the default
  plan, and an illegal tuned knob raises at plan time;
* a tuned fp32 plan computes the default plan's bits;
* ``fit_roofline`` recovers a synthetic law, ``predict_pack_bytes`` equals
  the port's pack exactly, a smoke sweep round-trips through JSONL, and
  ``python -m repro_torch.launch.tune --device cpu`` writes a cache that
  ``plan_stack(tune="cached")`` reads back.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.autotune import cache as tcache
from repro_torch.autotune.cache import (
    CACHE_VERSION,
    KNOB_NAMES,
    TunedPlanCache,
    canonical_weight_dtype,
    device_fingerprint,
    entry_key,
    lookup_tuned,
    set_cache,
)
from repro_torch.autotune.model import (
    H100_SXM,
    attach_costs,
    config_costs,
    fit_roofline,
    predict_pack_bytes,
    predict_segment_us,
    roofline_terms_from_counts,
    segment_costs,
    stack_kernel_costs,
)
from repro_torch.autotune.space import DEFAULT_POINT, KnobPoint, check_legal, knob_space
from repro_torch.autotune.sweep import (
    best_record,
    case_from_record,
    default_record,
    read_jsonl,
    run_sweep,
    smoke_cases,
    sweep_case,
    write_jsonl,
)
from repro_torch.core.backends import available_backends, get_backend
from repro_torch.core.executor import clear_plan_cache, plan_stack
from repro_torch.core.lstm import LstmConfig, init_lstm
from repro_torch.core.stage_balance import choose_mixed_split
from repro_torch.kernels.lstm_stack.lstm_stack import MAX_SMEM_BYTES, smem_bytes

SMALL_DIMS = ((1, 9), (9, 9))
GW_DIMS = ((1, 32), (32, 8), (8, 8), (8, 32))


def _stack(dims, seed=0, **cfg_kw):
    cfgs = [LstmConfig(in_dim=a, hidden=b, **cfg_kw) for a, b in dims]
    gen = torch.Generator().manual_seed(seed)
    return [init_lstm(c, gen, torch.device("cpu")) for c in cfgs], cfgs


@pytest.fixture
def injected_cache():
    """An empty in-memory cache installed as the process default; the
    previous one is restored afterwards."""
    cache = TunedPlanCache()
    old = set_cache(cache)
    clear_plan_cache()
    try:
        yield cache
    finally:
        set_cache(old)
        clear_plan_cache()


# ---------------------------------------------------------------------------
# (d) knob space
# ---------------------------------------------------------------------------

class TestKnobSpace:
    @pytest.mark.parametrize("dims", [SMALL_DIMS, GW_DIMS, ((1, 32), (32, 32))])
    def test_every_point_legal_default_first(self, dims):
        cfgs = _stack(dims)[1]
        for impl in available_backends():
            points = knob_space(cfgs, impl, batch=8)
            assert points[0].is_default, impl
            assert len(set(points)) == len(points)
            for point in points:
                check_legal(cfgs, impl, point)
            if not get_backend(impl).knobs:
                assert points == [DEFAULT_POINT]

    def test_axes_follow_the_port_kernels(self):
        cfgs = _stack(GW_DIMS)[1]
        points = knob_space(cfgs, "mixed", batch=8)
        assert {p.split for p in points} == {None, 0, 1, 2, 3, 4}
        assert {p.chunk_len for p in points} == {None, 4, 8, 16, 32, 64}
        assert {p.block_b for p in points} == {None, 2, 4, 8}
        assert not any(p.fuse_gates is True for p in points)
        assert {p.block_b for p in knob_space(cfgs, "fused_stack", batch=3)} == {None, 2}
        # a block whose CTA does not fit the kernels' shared memory is never proposed
        wide = _stack([(48, 48)] * 2)[1]  # 147 KB of fp32 weights in shared memory
        blocks = {p.block_b for p in knob_space(wide, "fused_stack", batch=64)} - {None}
        assert blocks == {2, 4, 8, 16}
        assert smem_bytes(2, 48, 16, 4, False) <= MAX_SMEM_BYTES < smem_bytes(2, 48, 32, 4, False)

    def test_int8_and_explicit_dtypes(self):
        cfgs = _stack(SMALL_DIMS)[1]
        int8 = knob_space(cfgs, "fused_step", weight_dtype="int8", batch=8)
        assert int8 and all(p.fuse_gates is not True for p in int8)
        for point in int8:
            check_legal(cfgs, "fused_step", point, weight_dtype="int8")
        assert any(p.fuse_gates for p in knob_space(cfgs, "fused_step", batch=8))
        pinned = knob_space(_stack(GW_DIMS)[1], "mixed", weight_dtype="int8", batch=4)
        assert {p.split for p in pinned} == {None}

    @pytest.mark.parametrize("impl", ["wavefront", "fused_stack_sharded"])
    def test_n_chunks_axis_only_proposes_divisors(self, impl):
        """The reference's axis: 2 and 4 where they divide the window (1 is
        the default's single chunk), nothing without a window length."""
        cfgs = _stack(SMALL_DIMS)[1]
        assert {p.n_chunks for p in knob_space(cfgs, impl, batch=8, t_len=50)} == {None, 2}
        assert {p.n_chunks for p in knob_space(cfgs, impl, batch=8, t_len=8)} == {None, 2, 4}
        assert knob_space(cfgs, impl, batch=8) == [DEFAULT_POINT]
        for point in knob_space(cfgs, impl, batch=8, t_len=8):
            check_legal(cfgs, impl, point)

    def test_max_points_thins_but_keeps_default(self):
        cfgs = _stack(SMALL_DIMS)[1]
        full = knob_space(cfgs, "fused_step", batch=8)
        thin = knob_space(cfgs, "fused_step", batch=8, max_points=4)
        assert len(full) > 4 >= len(thin) and thin[0].is_default and set(thin) <= set(full)

    def test_knob_point_overrides_and_describe(self):
        p = KnobPoint(chunk_len=8, fuse_gates=False)
        assert p.overrides() == {"chunk_len": 8, "fuse_gates": False}
        assert p.describe() == "chunk_len=8,fuse_gates=False"
        assert DEFAULT_POINT.describe() == "default" and DEFAULT_POINT.is_default


# ---------------------------------------------------------------------------
# (d) the tuned-plan cache
# ---------------------------------------------------------------------------

class TestTunedPlanCache:
    def test_roundtrip_through_disk(self, tmp_path):
        path = str(tmp_path / "tuned.json")
        cache = TunedPlanCache()
        cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16, "block_b": None},
                  meta={"ratio": 1.2})
        cache.save(path)
        loaded = TunedPlanCache.load(path)
        assert loaded.lookup(SMALL_DIMS, "fused_step", "fp32") == {"chunk_len": 16}
        assert loaded.entry_meta(SMALL_DIMS, "fused_step", "fp32") == {"ratio": 1.2}

    def test_version_mismatch_and_corrupt_files(self, tmp_path):
        path = tmp_path / "tuned.json"
        cache = TunedPlanCache()
        cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16})
        cache.save(str(path))
        payload = json.loads(path.read_text())
        payload["version"] = CACHE_VERSION + 1
        path.write_text(json.dumps(payload))
        assert len(TunedPlanCache.load(str(path))) == 0
        assert len(TunedPlanCache.load(str(tmp_path / "nope.json"))) == 0
        path.write_text("{ not json")
        assert len(TunedPlanCache.load(str(path))) == 0

    def test_unknown_knobs_and_unreachable_entries(self, tmp_path):
        cache = TunedPlanCache()
        with pytest.raises(ValueError, match="unknown tuned knob"):
            cache.put(SMALL_DIMS, "fused_step", "fp32", {"warp_size": 32})
        fp = "torch-cpu:cpu:1"
        good = entry_key(GW_DIMS, "mixed", "int8+int8+fp32+fp32", fp)
        path = str(tmp_path / "tuned.json")
        TunedPlanCache({
            entry_key(GW_DIMS, "mixed", "int8+fp32", fp): {"knobs": {"chunk_len": 4}},
            entry_key(GW_DIMS, "mixed", "fp32", fp): {"knobs": {"split": 9}},
            "future|wd=fp32|1x9|" + fp: {"knobs": {"warp_size": 32}},
            good: {"knobs": {"chunk_len": 4}, "meta": {}},
        }).save(path)
        assert set(TunedPlanCache.load(path).entries) == {good}

    def test_fingerprint_names_the_device_and_never_the_reference(self):
        fp = device_fingerprint()
        if torch.cuda.is_available():
            assert fp.startswith("torch-cuda:") and fp.endswith(f":{torch.cuda.device_count()}")
        else:
            assert fp == "torch-cpu:cpu:1"
        cache = TunedPlanCache()
        for other in ("cpu:cpu:1", "gpu:NVIDIA_H100_80GB_HBM3:1", "torch-cuda:NVIDIA_H100:1"):
            cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16}, fingerprint=other)
        assert cache.lookup(SMALL_DIMS, "fused_step", "fp32") is None  # inert here
        assert cache.lookup(SMALL_DIMS, "fused_step", "fp32",
                            fingerprint="cpu:cpu:1") == {"chunk_len": 16}

    def test_files_cross_the_packages(self, tmp_path):
        """A file written by either package loads in the other; each one's
        entries are inert under the other's fingerprint."""
        rcache = pytest.importorskip("repro.autotune.cache")
        r_path, t_path = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
        r = rcache.TunedPlanCache()
        r.put(GW_DIMS, "mixed", "fp32", {"split": 2, "chunk_len": 8}, meta={"us": 1.0})
        r.save(r_path)
        t = TunedPlanCache()
        t.put(GW_DIMS, "mixed", "fp32", {"split": 1, "block_b": 2}, meta={"us": 2.0})
        t.save(t_path)
        assert rcache.CACHE_VERSION == CACHE_VERSION and rcache.KNOB_NAMES == KNOB_NAMES
        in_port, in_ref = TunedPlanCache.load(r_path), rcache.TunedPlanCache.load(t_path)
        assert in_port.entries == r.entries and in_ref.entries == t.entries
        assert in_port.lookup(GW_DIMS, "mixed", "fp32") is None
        assert in_ref.lookup(GW_DIMS, "mixed", "fp32") is None
        assert rcache.device_fingerprint() != device_fingerprint()
        assert in_port.lookup(GW_DIMS, "mixed", "fp32",
                              fingerprint=rcache.device_fingerprint()) == {"split": 2,
                                                                           "chunk_len": 8}

    def test_weight_dtype_keying(self, injected_cache):
        cfgs = _stack(SMALL_DIMS)[1]
        assert canonical_weight_dtype(cfgs, None) == "fp32"
        assert canonical_weight_dtype(cfgs, ("int8", None)) == "int8+fp32"
        injected_cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16})
        assert lookup_tuned(cfgs, "fused_step") == {"chunk_len": 16}
        assert lookup_tuned(cfgs, "fused_step", "fp32") == {"chunk_len": 16}
        injected_cache.put(SMALL_DIMS, "fused_stack", "int8", {"block_b": 8})
        assert lookup_tuned(cfgs, "fused_stack", "int8") == {"block_b": 8}
        assert lookup_tuned(_stack(SMALL_DIMS, weight_dtype="int8")[1], "fused_stack") == \
            {"block_b": 8}
        assert lookup_tuned(cfgs, "fused_stack") is None

    def test_knob_names_match_the_planner(self):
        from repro_torch.core.executor import _TUNABLE_KNOBS

        assert tuple(KNOB_NAMES) == tuple(_TUNABLE_KNOBS)


# ---------------------------------------------------------------------------
# (d) cached planning
# ---------------------------------------------------------------------------

class TestCachedPlanning:
    def test_tuned_knobs_resolve_with_provenance(self, injected_cache):
        cfgs = _stack(SMALL_DIMS)[1]
        injected_cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16, "fuse_gates": False})
        plan = plan_stack(cfgs, impl="fused_step", tune="cached")
        prov = plan.knob_provenance()
        assert prov["chunk_len"] == (16, "tuned") and prov["fuse_gates"] == (False, "tuned")
        assert prov["block_b"] == (None, "default")

    def test_explicit_knob_beats_tuned(self, injected_cache):
        cfgs = _stack(SMALL_DIMS)[1]
        injected_cache.put(SMALL_DIMS, "fused_step", "fp32", {"chunk_len": 16, "fuse_gates": False})
        prov = plan_stack(cfgs, impl="fused_step", chunk_len=8, tune="cached").knob_provenance()
        assert prov["chunk_len"] == (8, "explicit") and prov["fuse_gates"] == (False, "tuned")

    def test_mixed_split_tuned_and_explicit(self, injected_cache):
        cfgs = _stack(GW_DIMS)[1]
        injected_cache.put(GW_DIMS, "mixed", canonical_weight_dtype(cfgs, None),
                           {"split": 3, "chunk_len": 4})
        plan = plan_stack(cfgs, impl="mixed", tune="cached")
        assert plan.weight_dtype == ("int8",) * 3 + ("fp32",) and plan.chunk_len == 4
        prov = plan.knob_provenance()
        assert prov["split"][1] == prov["weight_dtype"][1] == prov["chunk_len"][1] == "tuned"
        exp = plan_stack(cfgs, impl="mixed", tune="cached", split=1)
        assert exp.weight_dtype == ("int8",) + ("fp32",) * 3
        assert exp.knob_provenance()["split"] == (1, "explicit")

    def test_miss_resolves_the_defaults(self, injected_cache):
        cfgs = _stack(SMALL_DIMS)[1]
        cached = plan_stack(cfgs, impl="fused_step", tune="cached")
        assert cached == plan_stack(cfgs, impl="fused_step")
        assert all(src == "default" for _, src in cached.knob_provenance().values())

    @pytest.mark.parametrize("knobs,match", [
        ({"fuse_gates": True}, "int8"),
        ({"chunk_len": 300}, "ceiling"),
        ({"block_b": 0}, "block_b must be"),
        ({"n_chunks": 2}, "n_chunks"),
    ])
    def test_illegal_tuned_knob_raises(self, injected_cache, knobs, match):
        cfgs = _stack(SMALL_DIMS, weight_dtype="int8")[1]
        injected_cache.put(SMALL_DIMS, "fused_step", "int8", knobs)
        with pytest.raises(ValueError, match=match):
            plan_stack(cfgs, impl="fused_step", tune="cached")

    @pytest.mark.parametrize("impl,knobs,batch,t_len", [
        ("fused_stack", {"block_b": 4}, 16, 12),
        ("fused_step", {"chunk_len": 4, "fuse_gates": False, "block_b": 2}, 8, 8),
        ("mixed", {"split": 1, "chunk_len": 4, "block_b": 2}, 8, 8),
    ])
    def test_tuned_fp32_plan_is_bit_equal(self, injected_cache, impl, knobs, batch, t_len):
        """Knobs choose how the kernels run, not what they compute: rows
        per CTA and the step/wavefront routing give the same bits."""
        params, cfgs = _stack(SMALL_DIMS, seed=3)
        xs = torch.randn(batch, t_len, 1, generator=torch.Generator().manual_seed(4))
        if impl == "mixed":
            default = plan_stack(cfgs, impl=impl, split=1).bind(params)
        else:
            default = plan_stack(cfgs, impl=impl).bind(params)
        injected_cache.put(SMALL_DIMS, impl, canonical_weight_dtype(cfgs, None), knobs)
        tuned = plan_stack(cfgs, impl=impl, tune="cached")
        assert any(src == "tuned" for _, src in tuned.knob_provenance().values())
        tuned_ex = tuned.bind(params)
        assert torch.equal(tuned_ex(xs, return_state=False), default(xs, return_state=False))
        if get_backend(impl).chunked_step:
            s0 = default.step(xs[:, :3], default.zero_state(batch))
            s1 = tuned_ex.step(xs[:, :3], tuned_ex.zero_state(batch))
            assert torch.equal(default.last_hidden(s0), tuned_ex.last_hidden(s1))


# ---------------------------------------------------------------------------
# (f) sweep harness, cost model, the CLI
# ---------------------------------------------------------------------------

class TestSweepHarness:
    def test_smoke_sweep_and_jsonl_roundtrip(self, tmp_path):
        case = sweep_case(SMALL_DIMS, "fused_step", batch=4, t_len=4)
        records = run_sweep(case, k=1, reps=1, max_points=3, device="cpu")
        assert 1 < len(records) <= 3 and records[0]["knobs"] == {}
        assert default_record(records) is records[0]
        assert best_record(records)["us"] <= records[0]["us"]
        assert all(r["us"] > 0 and r["device"] == "cpu" for r in records)
        path = str(tmp_path / "sweep.jsonl")
        write_jsonl(records, path)
        assert read_jsonl(path) == records
        assert case_from_record(records[-1]) == case

    def test_mixed_sweep_on_the_cpu(self):
        case = sweep_case(GW_DIMS[:2], "mixed", batch=4, t_len=4)
        records = run_sweep(case, k=1, reps=1, max_points=4, device="cpu")
        assert records[0]["point"] == "default" and len(records) == 4

    def test_record_selection(self):
        with pytest.raises(ValueError, match="default"):
            default_record([{"knobs": {"chunk_len": 4}, "us": 1.0}])
        records = [{"knobs": {"chunk_len": 4}, "us": 1.0}, {"knobs": {}, "us": 1.0}]
        assert best_record(records) is records[1]

    def test_unknown_impl_fails_before_timing(self):
        with pytest.raises(ValueError, match="warp_drive"):
            run_sweep(sweep_case(SMALL_DIMS, "warp_drive"), k=1, reps=1, device="cpu")

    def test_smoke_cases_legal_and_tagged(self):
        tags = set()
        for case in smoke_cases():
            tags.add(case.tag)
            for point in knob_space(case.cfgs(), case.impl, weight_dtype=case.weight_dtype,
                                    batch=case.batch, max_points=3):
                check_legal(case.cfgs(), case.impl, point, weight_dtype=case.weight_dtype)
        assert len(tags) == len(smoke_cases())


class TestCostModel:
    def test_fit_recovers_synthetic_law(self):
        c0, spf, spb = 5e-6, 2e-11, 1e-9
        records = [
            {"case": f"syn{i}", "point": "default", "knobs": {},
             "us": (c0 + spf * f + spb * b) * 1e6, "costs": {"flops": f, "bytes": b}}
            for i, (f, b) in enumerate([(1e6, 1e4), (1e7, 1e5), (5e7, 2e6), (2e8, 1e7),
                                        (1e6, 5e6)])
        ]
        fit = fit_roofline(records)
        assert fit.n_records == 5 and fit.max_rel_err < 1e-6
        np.testing.assert_allclose([fit.c0, fit.sec_per_flop, fit.sec_per_byte],
                                   [c0, spf, spb], rtol=1e-6)
        np.testing.assert_allclose(fit.predict_us(1e7, 1e5), (c0 + spf * 1e7 + spb * 1e5) * 1e6,
                                   rtol=1e-6)
        assert "GFLOP/s" in fit.describe()

    def test_fit_never_negative_and_needs_costs(self):
        records = [{"case": f"n{i}", "point": "default", "knobs": {}, "us": 10.0 + 2e-5 * f,
                    "costs": {"flops": f, "bytes": b}}
                   for i, (f, b) in enumerate([(1e6, 9e6), (2e6, 5e6), (4e6, 2e6), (8e6, 1e5)])]
        fit = fit_roofline(records)
        assert min(fit.c0, fit.sec_per_flop, fit.sec_per_byte) >= 0
        with pytest.raises(ValueError, match="attach_costs"):
            fit_roofline([{"case": "x", "us": 1.0}])

    def test_roofline_terms_use_the_h100(self):
        assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.link_bw) == (67e12, 3.35e12, 25e9)
        for counts, bound in (((1e15, 1e3), "compute"), ((1e6, 1e12), "hbm"),
                              ((1e6, 1e3, 1e12), "link")):
            terms = roofline_terms_from_counts(*counts)
            assert terms["bound"] == bound
            assert terms["t_bound_us"] == max(terms["t_compute_us"], terms["t_hbm_us"],
                                              terms["t_link_us"])
        assert roofline_terms_from_counts(67e12, 0)["t_compute_us"] == pytest.approx(1e6)

    def test_stack_kernel_costs_count_the_kernels_work(self):
        """K2 at L=2, W=32, B=1, T=1 fp32, by hand."""
        c = stack_kernel_costs(2, 32, 1, 1, step=True, weight_dtype="fp32")
        assert c["bytes"] == 32 * 4 + (2 * 2 * 32 * 128 * 4 + 2 * 128 * 4) + 2 * 2 * 32 * 8 + 32 * 4
        assert c["flops"] == 2 * (32 * 128 * 4) + 2 * (4 * 128 + 10 * 32)
        k1 = stack_kernel_costs(2, 32, 1, 1, step=False, weight_dtype="int8")
        assert k1["flops"] == 2 * (32 * 128 * 3) + 2 * (4 * 128 + 10 * 32)
        assert k1["bytes"] == 128 * 4 + (2 * 2 * 32 * 128 + 2 * 128 * 4 + 2 * 2 * 4 * 4) \
            + 2 * 2 * 32 * 8 + 32 * 4

    def test_config_costs_route_like_the_plan(self):
        cfgs = _stack(GW_DIMS)[1]
        mixed = config_costs(cfgs, "mixed", batch=8, t_len=8, knobs={"split": 2})
        parts = [segment_costs(cfgs[:2], "int8"), segment_costs(cfgs[2:], "fp32")]
        assert mixed == {k: parts[0][k] + parts[1][k] for k in mixed}
        step = config_costs(cfgs[:2], "fused_step", batch=8, t_len=8)
        wave = config_costs(cfgs[:2], "fused_step", batch=8, t_len=8, knobs={"chunk_len": 4})
        assert step == stack_kernel_costs(2, 32, 8, 8, step=True)
        assert wave == stack_kernel_costs(2, 32, 8, 8, step=False)
        assert config_costs(cfgs[:2], "fused_stack", batch=8, t_len=8) == wave
        with pytest.raises(ValueError, match="fused stack kernels"):
            config_costs(cfgs[:2], "kernel")

    def test_balanced_split_reads_the_kernel_counts(self):
        cfgs = _stack(GW_DIMS)[1]

        def floors(seg, wd):
            return predict_segment_us(segment_costs(seg, wd, batch=8, t_len=8))

        assert choose_mixed_split(cfgs) == choose_mixed_split(cfgs, cost_fn=floors)
        plan = plan_stack(cfgs, impl="mixed", tune="balanced")
        assert plan.weight_dtype == choose_mixed_split(cfgs).dtypes
        assert plan.knob_provenance()["weight_dtype"][1] == "balanced"

    def test_attach_costs_on_sweep_records(self):
        records = run_sweep(sweep_case(SMALL_DIMS, "fused_step", batch=4, t_len=4), k=1, reps=1,
                            max_points=2, device="cpu")
        with_costs = attach_costs(records)
        assert all(r["costs"]["flops"] > 0 and r["costs"]["bytes"] > 0 for r in with_costs)
        assert fit_roofline(with_costs).n_records == len(records)

    @pytest.mark.parametrize("dims", [((1, 32), (32, 8)), SMALL_DIMS, ((8, 8),)])
    def test_predict_pack_bytes_matches_the_pack_exactly(self, dims):
        from repro_torch.kernels.lstm_stack.ops import pack_stack

        params, cfgs = _stack(dims, seed=6)
        for wd in ("fp32", "bf16", "int8"):
            assert predict_pack_bytes(cfgs, weight_dtype=wd) == \
                pack_stack(params, cfgs, weight_dtype=wd).packed_bytes


def test_tune_cli_smoke_writes_a_cache_plan_stack_reads(tmp_path, injected_cache, capsys):
    from repro_torch.launch.tune import main, parse_dims

    cache_path, jsonl = str(tmp_path / "tuned.json"), str(tmp_path / "sweep.jsonl")
    out = main(["--smoke", "--device", "cpu", "--k", "1", "--reps", "1", "--max-points", "3",
                "--jsonl", jsonl, "--cache", cache_path, "--balanced"])
    text = capsys.readouterr().out
    assert "roofline fit" in text and "chosen split=" in text
    assert len(read_jsonl(jsonl)) == len(out["records"]) == 3 * len(smoke_cases())
    stored = TunedPlanCache.load(cache_path)
    assert out["cache"] == cache_path
    set_cache(stored)
    for tag, best, default, ratio in out["winners"]:
        assert ratio >= 1.0
        case = next(c for c in smoke_cases() if c.tag == tag)
        plan = plan_stack(case.cfgs(), impl=case.impl, weight_dtype=case.weight_dtype,
                          tune="cached")
        tuned = {k for k, (_, src) in plan.knob_provenance().items() if src == "tuned"}
        assert tuned == (set(best["knobs"]) | ({"weight_dtype"} if "split" in best["knobs"]
                                              else set()))
    with pytest.raises(ValueError, match="bad --dims"):
        parse_dims("1x32,32")
    with pytest.raises(SystemExit):
        main(["--smoke", "--dims", "1x9", "--device", "cpu"])


def test_default_cache_path_is_ignored_by_git():
    assert tcache.DEFAULT_CACHE_PATH.replace("\\", "/").startswith("runs/")
