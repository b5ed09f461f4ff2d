"""The port's StreamServer takes the reference's scheduling decisions.

The same fake-clock scripts of submits, clock advances, ticks, drains and
closes drive the reference ``repro.serve.server.StreamServer`` (over the
reference engine) and the port's (over the port's CPU engine with the
reference's weights).  Per script, both must return the same tick
results, gather the same batches (stream ids and padded widths, in
order), count the same ``ServerStats.summary()`` and raise the same
errors; the scores agree within 1e-5 (the two packages round the
transcendentals differently).

Model: the reference server tests' size, hidden (9, 9), boundary 1, T=12.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.autoencoder import AutoencoderConfig as RConfig  # noqa: E402
from repro.core.autoencoder import init_autoencoder as r_init  # noqa: E402
from repro.serve import engine as reng  # noqa: E402
from repro.serve import server as rsrv  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.autoencoder import AutoencoderConfig  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402

T = 12
_R_CFG = RConfig(hidden=(9, 9), latent_boundary=1, timesteps=T)
_T_CFG = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, timesteps=T)
_R_PARAMS = r_init(jax.random.PRNGKey(7), _R_CFG)
_T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, _R_PARAMS), "cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class Recorder:
    """Delegating engine that logs every ``push_many`` batch: the real
    stream ids in order and the padded width."""

    def __init__(self, engine):
        self._engine = engine
        self.batches = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def push_many(self, ids, chunks):
        self.batches.append(([i for i in ids if isinstance(i, str)], len(ids),
                             int(chunks.shape[1])))
        return self._engine.push_many(ids, chunks)


def _build(pkg, server_kw, engine_kw=None):
    engine_kw = engine_kw or {}
    clock = FakeClock()
    if pkg == "ref":
        eng = Recorder(reng.StreamingAnomalyEngine(_R_PARAMS, _R_CFG, batch=1, **engine_kw))
        srv = rsrv.StreamServer(eng, rsrv.ServerConfig(**_cfg_kw(rsrv, server_kw)),
                                clock=clock)
    else:
        eng = Recorder(teng.StreamingAnomalyEngine(_T_PARAMS, _T_CFG, batch=1,
                                                   device="cpu", **engine_kw))
        srv = tsrv.StreamServer(eng, tsrv.ServerConfig(**_cfg_kw(tsrv, server_kw)),
                                clock=clock)
    return srv, eng, clock


def _cfg_kw(mod, kw):
    kw = dict(kw)
    if isinstance(kw.get("adaptive"), dict):
        kw["adaptive"] = mod.AdaptiveConfig(**kw["adaptive"])
    return kw


def run_script(pkg, script, data, server_kw, engine_kw=None):
    """Play ``script`` on a fresh server of package ``pkg``; returns the
    decision trace, the batches, the stats summary and the scores."""
    srv, eng, clock = _build(pkg, server_kw, engine_kw)
    trace = []
    for op in script:
        kind = op[0]
        if kind == "submit":
            _, sid, a, b = op
            try:
                srv.submit(sid, data[sid][a:b])
                trace.append(("submit", sid, "ok"))
            except Exception as e:  # noqa: BLE001  (compared across packages)
                trace.append(("submit", sid, type(e).__name__))
        elif kind == "advance":
            clock.t += op[1] * 1e-6
        elif kind == "set":
            clock.t = op[1] * 1e-6
        elif kind == "tick":
            trace.append(("tick", srv.tick(force=op[1])))
        elif kind == "drain":
            trace.append(("drain", srv.drain()))
        elif kind == "close":
            trace.append(("close", srv.close_stream(op[1])))
        elif kind == "width":
            trace.append(("width", srv.effective_coalesce))
        trace.append(("pending", srv.pending))
    return trace, eng.batches, srv.stats.summary(), srv.pop_scores()


def assert_same(script, data, server_kw, engine_kw=None):
    r = run_script("ref", script, data, server_kw, engine_kw)
    t = run_script("port", script, data, server_kw, engine_kw)
    assert t[0] == r[0], "decision trace differs"
    assert t[1] == r[1], "batches differ"
    assert t[2] == r[2], "stats differ"
    assert set(t[3]) == set(r[3])
    for sid in r[3]:
        assert len(t[3][sid]) == len(r[3][sid]), sid
        for a, b in zip(t[3][sid], r[3][sid]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    return t


def _data(seed, ids, n=2 * T):
    rng = np.random.RandomState(seed)
    return {sid: rng.randn(n, 1).astype(np.float32) for sid in ids}


def test_fixed_deadline_waits_then_flushes():
    data = _data(1, "abc")
    script = [("submit", "c", 0, 4), ("drain",), ("submit", "a", 0, 4),
              ("submit", "b", 0, 4), ("tick", False), ("advance", 199.0),
              ("tick", False), ("advance", 2.0), ("tick", False)]
    t = assert_same(script, data, dict(deadline_us=200.0))
    assert t[2]["deadline_flushes"] == 1 and t[2]["batch_fill"] == {1: 1, 2: 1}


def test_fast_path_and_per_bucket_fifo():
    data = _data(2, "ab")
    script = [("submit", "a", 0, 5), ("advance", 10.0), ("submit", "b", 0, 6),
              ("tick", False), ("tick", False), ("advance", 5.0),
              ("submit", "a", 5, T), ("advance", 5.0), ("submit", "b", 6, T),
              ("tick", False), ("tick", False), ("tick", False), ("drain",),
              ("submit", "a", T, T + 1), ("tick", False)]
    t = assert_same(script, data, dict(deadline_us=1e9))
    assert t[2]["fastpath_flushes"] == 3


def test_two_bucket_starvation():
    ids = ["j", "b", "a0", "d0", "a1", "d1", "a2"]
    data = _data(3, ids)
    script = [("submit", "j", 0, 2), ("drain",), ("submit", "b", 0, 6)]
    for i, t_now in enumerate((50.0, 130.0)):
        script += [("set", t_now), ("submit", f"a{i}", 0, 5), ("submit", f"d{i}", 0, 5),
                   ("tick", False)]
    script += [("set", 205.0), ("submit", "a2", 0, 5), ("tick", False), ("drain",)]
    t = assert_same(script, data, dict(max_coalesce=2, deadline_us=200.0))
    assert t[2]["full_flushes"] == 2 and t[2]["deadline_flushes"] == 1


def test_adaptive_deadline_follows_arrival_rate():
    ids = [f"silent{i}" for i in range(6)] + ["a", "b", "c"]
    data = _data(4, ids)
    script = []
    for i in range(6):
        script += [("submit", f"silent{i}", 0, 2), ("drain",)]
    script += [("submit", "a", 0, 4), ("advance", 100.0), ("submit", "b", 0, 4),
               ("tick", False), ("advance", 499.0), ("tick", False), ("advance", 2.0),
               ("tick", False), ("submit", "c", 0, 4), ("tick", False),
               ("advance", 400.0), ("submit", "a", 4, 8), ("tick", False),
               ("advance", 600.0), ("tick", False), ("width",), ("drain",)]
    adaptive = dict(max_deadline_us=100_000.0, fill_headroom=1.0, ewma_alpha=1.0)
    assert_same(script, data, dict(max_coalesce=8, adaptive=adaptive))


def test_adaptive_unfillable_and_cold_bucket():
    ids = [f"silent{i}" for i in range(6)] + ["a", "b", "c"]
    data = _data(5, ids)
    script = []
    for i in range(6):
        script += [("submit", f"silent{i}", 0, 2), ("drain",)]
    script += [("submit", "a", 0, 4), ("advance", 400.0), ("submit", "b", 0, 4),
               ("tick", False), ("submit", "c", 0, 3), ("tick", False),
               ("advance", 499.0), ("tick", False), ("advance", 2.0), ("tick", False),
               ("drain",)]
    adaptive = dict(max_deadline_us=500.0, fill_headroom=1.0, ewma_alpha=1.0)
    assert_same(script, data, dict(max_coalesce=8, adaptive=adaptive))


def test_width_narrows_and_rewidens():
    """Arrivals that land during a tick grow the queue: the adaptive width
    halves, then widens back on full batches with backlog."""
    n = 16
    first = [f"s{i}" for i in range(n)]
    late = [f"t{i}" for i in range(2 * n)]
    data = _data(6, first + late)
    out = {}
    for pkg in ("ref", "port"):
        srv, eng, _ = _build(pkg, dict(max_coalesce=n, adaptive=dict(min_coalesce=8)))
        for sid in first:
            srv.submit(sid, data[sid][:2])
        orig, fired = eng.push_many, []

        def push_and_arrive(ids, chunks, srv=srv, orig=orig, fired=fired):
            res = orig(ids, chunks)
            if not fired:
                fired.append(1)
                for sid in late:
                    srv.submit(sid, data[sid][:2])
            return res

        eng.push_many = push_and_arrive
        widths = [(srv.tick(force=True), srv.effective_coalesce)]
        widths.append((srv.tick(force=True), srv.effective_coalesce))
        widths.append((srv.drain(), srv.effective_coalesce))
        out[pkg] = (widths, eng.batches, srv.stats.summary())
    assert out["port"] == out["ref"]
    assert out["port"][0][:2] == [(16, 8), (8, 16)]


@pytest.mark.parametrize("policy", ["drop_oldest", "error", "block"])
def test_overflow_policies(policy):
    data = _data(7, "abcd", n=T)
    script = [("submit", "a", 0, T), ("submit", "b", 0, T), ("submit", "c", 0, T),
              ("submit", "d", 0, 3), ("drain",)]
    t = assert_same(script, data, dict(queue_capacity=2, overflow=policy, deadline_us=1e9))
    want = {"drop_oldest": "ok", "error": "QueueFullError", "block": "RuntimeError"}[policy]
    assert t[0][4] == ("submit", "c", want)


def test_join_close_rejoin_and_ragged_buckets():
    data = _data(8, ["a", "b", "c"], n=3 * T)
    script = [("submit", "a", 0, 5), ("submit", "b", 0, 6), ("submit", "a", 5, 8),
              ("tick", True), ("tick", True), ("submit", "c", 0, 5), ("drain",),
              ("submit", "a", 8, T), ("submit", "a", T, T + 3), ("close", "a"),
              ("submit", "b", 6, T), ("submit", "c", 5, T), ("tick", False),
              ("submit", "a", 0, T), ("advance", 300.0), ("tick", False), ("drain",),
              ("submit", "b", T, 2 * T), ("submit", "c", T, 2 * T), ("drain",)]
    t = assert_same(script, data, dict(deadline_us=200.0))
    assert t[2]["cancelled"] == 2


def test_random_script_on_both_engines():
    """A seeded random interleaving, on both port engines (fused_step and
    kernel) against the reference's default engine."""
    rng = np.random.RandomState(9)
    ids = [f"s{i}" for i in range(5)]
    data = _data(10, ids, n=2 * T)
    pos = {sid: 0 for sid in ids}
    script = []
    while any(p < 2 * T for p in pos.values()):
        sid = ids[rng.randint(len(ids))]
        if pos[sid] >= 2 * T:
            continue
        n = min(int(rng.choice([3, 4, 6])), 2 * T - pos[sid])
        script.append(("submit", sid, pos[sid], pos[sid] + n))
        pos[sid] += n
        script.append(("advance", float(rng.randint(0, 300))))
        if rng.rand() < 0.5:
            script.append(("tick", bool(rng.rand() < 0.3)))
    script.append(("drain",))
    ref = run_script("ref", script, data, dict(deadline_us=250.0))
    for impl in ("fused_step", "kernel"):
        got = run_script("port", script, data, dict(deadline_us=250.0), dict(impl=impl))
        assert got[:3] == ref[:3], impl
        for sid in ref[3]:
            np.testing.assert_allclose(np.concatenate(got[3][sid]),
                                       np.concatenate(ref[3][sid]), rtol=1e-5, atol=1e-5)
