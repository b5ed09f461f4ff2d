"""Golden fixture of the serving path: the reference's ``kernel``-backend
scores and one fake-clock server script, for checking the port without JAX
(``chip_smoke.py`` reads it on the GPU machine).

``tests/data/torch_port_gw_server.npz`` holds, on the params and windows
of ``torch_port_gw_nominal.npz`` (``gw_nominal``):

* ``scores/kernel``: the reference ``AnomalyStreamEngine(impl="kernel")``
  scores of the 20 windows, and ``streamed/kernel``: its
  ``StreamingAnomalyEngine(impl="kernel")`` scores pushed in chunks of 25;
* ``server/*``: one fake-clock ``StreamServer`` script (6 streams, chunks
  of 25, the adaptive policy, a close and a rejoin) as an op table, its
  inputs, the reference's tick results, per-stream scores and
  ``ServerStats.summary()``.

The first test regenerates it from the JAX package and requires equality,
so the file cannot go stale; regenerate with

    PYTHONPATH=src python tests/test_torch_golden_server.py
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.gw import GW_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.serve import server as tsrv
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

DATA = Path(__file__).parent / "data"
FIXTURE = DATA / "torch_port_gw_server.npz"
BASE = DATA / "torch_port_gw_nominal.npz"
CHUNK = 25
#: op kinds of the script table: (kind, stream, a, b)
SUBMIT, ADVANCE, TICK, DRAIN, CLOSE = range(5)


def make_script(seed: int = 0, n_streams: int = 6, windows: int = 2, T: int = 100):
    """The server script: an (N, 4) int64 op table and the streams' data.

    SUBMIT (s, a, b) submits data[s, a:b]; ADVANCE (_, us) moves the fake
    clock; TICK (_, force) runs one decision; DRAIN; CLOSE (s).  Stream 2
    closes after its first window and rejoins with fresh samples.
    """
    rng = np.random.RandomState(seed)
    data = rng.randn(n_streams + 1, windows * T, 1).astype(np.float32)
    pos = [0] * n_streams
    ops = []
    rejoined = False
    while any(p < windows * T for p in pos):
        s = int(rng.randint(n_streams))
        if pos[s] >= windows * T:
            continue
        ops.append((SUBMIT, s, pos[s], pos[s] + CHUNK))
        pos[s] += CHUNK
        ops.append((ADVANCE, 0, int(rng.randint(0, 400)), 0))
        if rng.rand() < 0.6:
            ops.append((TICK, 0, int(rng.rand() < 0.2), 0))
        if s == 2 and pos[s] == T and not rejoined:
            ops += [(DRAIN, 0, 0, 0), (CLOSE, 2, 0, 0)]
            # the rejoin replays stream n_streams' samples under id 2
            ops += [(SUBMIT, n_streams, a, a + CHUNK) for a in range(0, T, CHUNK)]
            rejoined = True
    ops.append((DRAIN, 0, 0, 0))
    return np.asarray(ops, dtype=np.int64), data


def server_config(mod):
    """The script's server settings, for the reference's module or ours."""
    return mod.ServerConfig(max_coalesce=8, adaptive=mod.AdaptiveConfig(
        max_deadline_us=600.0))


def replay(server, clock, ops, data):
    """Play the op table on ``server`` driven by the fake ``clock``;
    returns the tick/drain/close results in order."""
    results = []
    for kind, s, a, b in ops.tolist():
        if kind == SUBMIT:
            sid = "s2" if s == data.shape[0] - 1 else f"s{s}"
            server.submit(sid, data[s, a:b])
        elif kind == ADVANCE:
            clock.t += a * 1e-6
        elif kind == TICK:
            results.append(server.tick(force=bool(a)))
        elif kind == DRAIN:
            results.append(server.drain())
        else:
            results.append(server.close_stream(f"s{s}"))
    return np.asarray(results, dtype=np.int64)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def load_params(data) -> dict:
    tree: dict = {}
    for key in data.files:
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = data[key]
    return tree


def make_fixture() -> dict:
    """Every array of the fixture, computed by the JAX reference."""
    import jax.numpy as jnp

    from repro.configs.gw import GW_MODELS as R_MODELS
    from repro.serve import engine as reng
    from repro.serve import server as rsrv

    with np.load(BASE) as base:
        tree, windows = load_params(base), base["windows"]
    params = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in tree.items()}
    cfg = R_MODELS["gw_nominal"]
    out = {"scores/kernel": reng.AnomalyStreamEngine(params, cfg, impl="kernel").score(windows)}
    eng = reng.StreamingAnomalyEngine(params, cfg, batch=len(windows), impl="kernel")
    streamed = []
    for pos in range(0, cfg.timesteps, CHUNK):
        streamed += eng.push(windows[:, pos : pos + CHUNK])
    (out["streamed/kernel"],) = streamed
    ops, data = make_script(T=cfg.timesteps)
    clock = FakeClock()
    srv = rsrv.StreamServer(reng.StreamingAnomalyEngine(params, cfg, batch=1),
                            server_config(rsrv), clock=clock)
    out["server/ops"], out["server/data"] = ops, data
    out["server/results"] = replay(srv, clock, ops, data)
    for sid, scores in srv.pop_scores().items():
        out[f"server/scores/{sid}"] = np.concatenate([np.asarray(s) for s in scores])
    out["server/summary"] = np.frombuffer(
        json.dumps(srv.stats.summary(), sort_keys=True).encode(), dtype=np.uint8)
    return out


def test_fixture_equals_regenerated_reference():
    pytest.importorskip("jax")
    fresh = make_fixture()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for key, value in fresh.items():
            if key.startswith(("scores/", "streamed/", "server/scores/")):
                # compiled XLA code may differ in the last bit across CPUs
                np.testing.assert_allclose(stored[key], value, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(stored[key], value)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as data:
        fx = {k: data[k] for k in data.files}
    with np.load(BASE) as base:
        tree, windows = load_params(base), base["windows"]
    return fx, params_from_numpy(tree, "cpu"), windows


def test_port_cpu_kernel_scores_match_fixture(golden):
    fx, params, windows = golden
    cfg = GW_MODELS["gw_nominal"]
    got = AnomalyStreamEngine(params, cfg, impl="kernel", device="cpu").score(windows)
    np.testing.assert_allclose(got, fx["scores/kernel"], rtol=1e-5, atol=1e-5)
    eng = StreamingAnomalyEngine(params, cfg, batch=len(windows), impl="kernel",
                                 device="cpu")
    streamed = [s for pos in range(0, cfg.timesteps, CHUNK)
                for s in eng.push(windows[:, pos : pos + CHUNK])]
    np.testing.assert_allclose(streamed[0], fx["streamed/kernel"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["fused_step", "kernel"])
def test_port_cpu_server_script_matches_fixture(golden, impl):
    """The same decisions and counters as the reference, scores at 1e-5."""
    fx, params, _ = golden
    eng = StreamingAnomalyEngine(params, GW_MODELS["gw_nominal"], impl=impl, device="cpu")
    clock = FakeClock()
    srv = tsrv.StreamServer(eng, server_config(tsrv), clock=clock)
    np.testing.assert_array_equal(replay(srv, clock, fx["server/ops"], fx["server/data"]),
                                  fx["server/results"])
    # through JSON, as stored: the batch-fill keys become strings
    assert json.loads(json.dumps(srv.stats.summary())) == json.loads(bytes(fx["server/summary"]))
    scores = srv.pop_scores()
    want = {k.split("/")[-1]: v for k, v in fx.items() if k.startswith("server/scores/")}
    assert sorted(scores) == sorted(want)
    for sid, w in want.items():
        np.testing.assert_allclose(np.concatenate(scores[sid]), w, rtol=1e-5, atol=1e-5)


def test_script_covers_the_policy(golden):
    """Every op kind, several flush reasons and batch widths."""
    fx = golden[0]
    assert {SUBMIT, ADVANCE, TICK, DRAIN, CLOSE} <= set(fx["server/ops"][:, 0].tolist())
    summary = json.loads(bytes(fx["server/summary"]))
    assert summary["cancelled"] == 0 and summary["windows_scored"] == 13
    assert len(summary["batch_fill"]) >= 3
    assert sum(summary[k] for k in ("full_flushes", "deadline_flushes",
                                    "fastpath_flushes", "drain_flushes")) == summary["ticks"]


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
