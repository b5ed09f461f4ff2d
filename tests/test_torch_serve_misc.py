"""The port's numpy leaves and its CLI, against the reference.

``serve/latency.py`` and ``data/gw.py`` are copies of the reference's
numpy modules: the same gap and latency sequences give the same
estimates and percentiles, exactly, and a seed gives equal arrays.  The
CLI's anomaly mode runs on the CPU at ``gw_small`` through every serving
loop (batch, ``--streams``, ``--server``, checkpoint and restore).
"""

import numpy as np
import pytest

from repro_torch.data import gw as tgw
from repro_torch.launch import serve as tcli
from repro_torch.serve import latency as tlat


def _reference(name):
    pytest.importorskip("jax")
    import importlib

    return importlib.import_module(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_reference(seed):
    rlat = _reference("repro.serve.latency")
    rng = np.random.RandomState(seed)
    samples = np.concatenate([rng.lognormal(5, 1.5, 500), [0.0, 0.5, 1.0, 2.0**27]])
    mine, ref = tlat.LatencyHistogram(), rlat.LatencyHistogram()
    mine.record_many(samples)
    ref.record_many(samples)
    assert mine.summary("x") == ref.summary("x")
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert mine.percentile(q) == ref.percentile(q)
    other_m, other_r = tlat.LatencyHistogram(), rlat.LatencyHistogram()
    other_m.record_many(samples[:50] * 3)
    other_r.record_many(samples[:50] * 3)
    assert mine.merge(other_m).summary() == ref.merge(other_r).summary()


@pytest.mark.parametrize("trace", ["steady", "poisson", "bursty", "idle"])
def test_arrival_estimator_matches_reference(trace):
    rlat = _reference("repro.serve.latency")
    rng = np.random.RandomState(4)
    gaps = {"steady": [100e-6] * 50, "poisson": list(rng.exponential(200e-6, 500)),
            "bursty": [500e-6] * 10 + [10e-6] * 10 + [0.0] * 3,
            "idle": [100e-6] * 5 + [10.0] + [20e-6] * 5 + [100.0, 50e-6]}[trace]
    for alpha, idle in ((0.25, 50.0), (1.0, 2.0), (0.05, 10.0)):
        mine = tlat.ArrivalRateEstimator(alpha=alpha, idle_reset_factor=idle)
        ref = rlat.ArrivalRateEstimator(alpha=alpha, idle_reset_factor=idle)
        t = 0.0
        for g in gaps:
            t += g
            mine.observe(t)
            ref.observe(t)
            assert (mine.gap_us, mine.rate_hz, mine.observed) == (
                ref.gap_us, ref.rate_hz, ref.observed)


def test_latency_validation():
    with pytest.raises(ValueError, match="percentile"):
        tlat.LatencyHistogram().percentile(101)
    for kw in (dict(alpha=0.0), dict(alpha=1.5), dict(idle_reset_factor=1.0)):
        with pytest.raises(ValueError):
            tlat.ArrivalRateEstimator(**kw)
    assert tlat.LatencyHistogram().summary("x")["x.p50_us"] == 0.0


@pytest.mark.parametrize("seed,timesteps", [(0, 100), (3, 12)])
def test_gw_data_equals_reference(seed, timesteps):
    rgw = _reference("repro.data.gw")
    mine = tgw.GwDataset(tgw.GwDataConfig(seed=seed, timesteps=timesteps))
    ref = rgw.GwDataset(rgw.GwDataConfig(seed=seed, timesteps=timesteps))
    for draw in ("background", "events", "background"):
        a, b = getattr(mine, draw)(3), getattr(ref, draw)(3)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    f = np.linspace(0, 1024, 33)
    np.testing.assert_array_equal(tgw.analytic_psd(f), rgw.analytic_psd(f))
    np.testing.assert_array_equal(tgw.inspiral_chirp(2048, 2048.0),
                                  rgw.inspiral_chirp(2048, 2048.0))
    np.testing.assert_array_equal(
        tgw.colored_noise(np.random.default_rng(5), 256, 2048.0),
        rgw.colored_noise(np.random.default_rng(5), 256, 2048.0))


BASE = ["--mode", "anomaly", "--device", "cpu", "--gw-model", "gw_small", "--windows", "2"]


def test_cli_batch_and_streams(capsys):
    out = tcli.main(BASE + ["--chunk", "25"])
    assert out["latency"]["latency.count"] >= 1
    out = tcli.main(BASE + ["--chunk", "50", "--streams", "4"])
    assert "coalesced streams" in capsys.readouterr().out


def test_cli_server_checkpoint_and_restore(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    out = tcli.main(BASE + ["--chunk", "25", "--streams", "4", "--server",
                            "--checkpoint", path, "--sanitize", "reject"])
    assert out["stats"]["processed"] == 32 and out["stats"]["windows_scored"] == 8
    assert out["stats"]["checkpoints"] >= 1
    assert sum(len(v) for v in out["scores"].values()) == 8
    out = tcli.main(BASE + ["--chunk", "25", "--streams", "4", "--server", "--adaptive",
                            "--restore", path])
    text = capsys.readouterr().out
    assert "restored engine" in text and "4 stream(s) resident" in text
    assert out["stats"]["processed"] == 32


def test_cli_plan_only(capsys):
    plans = tcli.main(BASE + ["--plan-only", "--weight-dtype", "int8"])
    assert "weight_dtype=int8" in plans["encoder"]


@pytest.mark.parametrize("arch,n_front,rows_front", [
    ("seamless-m4t-large-v2", 6, 0),   # 6 encoder frames beside the 6-token prompts
    ("llava-next-34b", 8, 8),          # 8 patches (reduced) in front of each prompt
])
def test_cli_refuses_later_slices(arch, n_front, rows_front, monkeypatch, capsys):
    """No LM family is refused any more (the test keeps the name of the
    refusal it replaced): ``--mode lm`` serves the frontend-fed ones, with their embeddings drawn from a seed.  The
    engine's position after prefill counts a VLM's patches, not an
    encoder's frames, and agrees with the cache's own."""
    from repro_torch.serve.engine import LmEngine

    positions, frontends = [], []
    set_position, prefill = LmEngine._set_position, LmEngine.prefill

    def recording_position(self, cache, pos):
        positions.append((pos, int(cache["pos"])))
        return set_position(self, cache, pos)

    def recording_prefill(self, tokens, frontend_embeds=None):
        frontends.append(tuple(frontend_embeds.shape))
        return prefill(self, tokens, frontend_embeds)

    monkeypatch.setattr(LmEngine, "_set_position", recording_position)
    monkeypatch.setattr(LmEngine, "prefill", recording_prefill)
    out = tcli.main(["--mode", "lm", "--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "6", "--new-tokens", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["launches"] == {"decode_attn": 0, "ssd_scan": 0}
    assert f"{arch}: generated (2, 4)" in capsys.readouterr().out
    assert frontends == [(2, n_front, 64)]
    assert positions == [(rows_front + 6 + i, rows_front + 6 + i) for i in range(4)]


@pytest.mark.parametrize("flags", [
    ["--weight-dtypes", "int8,fp32"],
    ["--weight-dtypes", "int8,fp32", "--plan-only"],
    ["--tune", "balanced", "--plan-only"],
])
def test_cli_sharded_refuses_the_mixed_backend(flags):
    """Per-layer storage runs on ``mixed``, which chains local segments:
    the reference refuses it under sharded placement, and so does the port."""
    with pytest.raises(ValueError, match="single-host"):
        tcli.main(BASE + ["--placement", "sharded"] + flags)


def test_cli_placement_sharded_serves(capsys):
    """``--placement sharded`` on the CPU: the default stage mesh is one CPU
    stage; the plan and ``--server`` (whose engine ``--streams`` feeds)
    serve through ``fused_stack_sharded``, as the reference's CLI does."""
    plans = tcli.main(BASE + ["--placement", "sharded", "--plan-only", "--weight-dtype",
                              "int8"])
    text = capsys.readouterr().out
    for seg in ("encoder", "decoder"):
        assert "impl=fused_stack_sharded placement=sharded" in plans[seg]
        assert "weight_dtype=int8" in plans[seg]
    assert "stages=cpu" in text and "n_chunks     = auto" in text
    out = tcli.main(BASE + ["--placement", "sharded", "--chunk", "25", "--streams", "4",
                            "--server"])
    assert "placement=sharded" in capsys.readouterr().out
    assert out["stats"]["processed"] == 32 and out["stats"]["windows_scored"] == 8


def test_cli_placement_sharded_tune_cached(capsys):
    """A tuned ``n_chunks`` reaches the sharded plan; the step kernel's
    tuned knobs are dropped with the step kernel, as in the reference."""
    from repro_torch.autotune import cache as tcache

    store = tcache.TunedPlanCache()
    store.put([(1, 9)], "fused_step", "fp32", {"chunk_len": 8, "n_chunks": 4})
    old = tcache.set_cache(store)
    try:
        plans = tcli.main(BASE + ["--placement", "sharded", "--plan-only", "--tune", "cached"])
        text = capsys.readouterr().out
    finally:
        tcache.set_cache(old)
    assert "n_chunks=4" in plans["encoder"] and "n_chunks     = 4      [tuned]" in text
    assert "chunk_len" not in plans["encoder"] and "n_chunks" not in plans["decoder"]


def test_cli_weight_dtypes_route_the_mixed_backend(capsys):
    """``--weight-dtypes`` pins per-layer storage: both segments plan
    ``mixed``; ``--plan-only`` prints each knob's provenance and the layer
    assignment; the engine serves through the chained segments."""
    plans = tcli.main(BASE + ["--plan-only", "--gw-model", "gw_nominal",
                              "--weight-dtypes", "int8,fp32,fp32,int8"])
    text = capsys.readouterr().out
    assert "impl=mixed" in plans["encoder"] and "weight_dtype=int8+fp32" in plans["encoder"]
    assert "weight_dtype=fp32+int8" in plans["decoder"]
    # the storage comes from the config's layers, as the reference reports it
    assert "layer 1 (hidden=8  ) -> fp32  stage=1 chunk_len=32 [default]" in text
    out = tcli.main(BASE + ["--chunk", "25", "--streams", "2", "--gw-model", "gw_nominal",
                            "--weight-dtypes", "int8,fp32,fp32,int8"])
    assert "impl=mixed" in capsys.readouterr().out and out["latency"]["latency.count"] >= 1


def test_cli_tune_balanced_and_cached(tmp_path, capsys, monkeypatch):
    from repro_torch.autotune import cache as tcache

    plans = tcli.main(BASE + ["--plan-only", "--gw-model", "gw_nominal", "--tune", "balanced"])
    text = capsys.readouterr().out
    assert "impl=mixed" in plans["encoder"] and "[balanced]" in text
    store = tcache.TunedPlanCache()
    store.put([(1, 9)], "fused_step", "fp32", {"chunk_len": 8})
    old = tcache.set_cache(store)
    try:
        plans = tcli.main(BASE + ["--plan-only", "--tune", "cached"])
        text = capsys.readouterr().out
        assert "chunk_len=8" in plans["encoder"] and "chunk_len    = 8      [tuned]" in text
        assert "chunk_len=32" in plans["decoder"]  # no entry for (9x9): the default
        out = tcli.main(BASE + ["--chunk", "25", "--tune", "cached"])
        assert "tune=cached" in capsys.readouterr().out and out["latency"]["latency.count"] >= 1
    finally:
        tcache.set_cache(old)
