"""Fault injection against the port's serving stack: faults stay local.

The contracts of the reference's chaos suite (``tests/test_chaos.py``) on
the port's engine, with the same injectors (``tests/chaos.py``, numpy
only and engine-agnostic).  Under NaN/Inf/saturated chunks, engine-step
exceptions, poisoned resident state, clock skew, mid-batch closes and a
mid-run snapshot/restore, every unaffected stream scores bit-equal to a
fault-free sequential replay, and the affected streams degrade exactly as
their policy says.  Every wait has a timeout.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from chaos import (
    BlockingEngine,
    CloseRaceEngine,
    FaultyEngine,
    SkewClock,
    corrupt,
    glitch_plan,
)
from repro_torch.core.autoencoder import AutoencoderConfig, init_autoencoder
from repro_torch.serve.engine import StreamingAnomalyEngine
from repro_torch.serve.health import ChunkRejectedError, HealthConfig, SnapshotMismatchError
from repro_torch.serve.server import QueueFullError, ServerConfig, StreamServer

_CFG = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, timesteps=12)
_PARAMS = init_autoencoder(_CFG, seed=7, device="cpu")
_DIM = _CFG.input_dim


def _engine(impl="fused_step", **kw):
    return StreamingAnomalyEngine(_PARAMS, _CFG, batch=1, impl=impl, device="cpu", **kw)


def _server(engine=None, *, health=True, on_score=None, clock=None, **cfg_kw):
    kw = {}
    if on_score is not None:
        kw["on_score"] = on_score
    if clock is not None:
        kw["clock"] = clock
    return StreamServer(engine if engine is not None else _engine(),
                        ServerConfig(health=health, **cfg_kw), **kw)


def _chunks(seed, n, t=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, _DIM)).astype(np.float32) for _ in range(n)]


def _replay(chunk_lists: dict, impl="fused_step") -> dict:
    seq = _engine(impl)
    out = {}
    for sid, chunks in chunk_lists.items():
        seq.reset()
        scores = []
        for c in chunks:
            scores += seq.push(c[None])
        out[sid] = scores
    return out


def _assert_scores_equal(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got, key=str), sorted(want, key=str))
    for sid in want:
        assert len(got[sid]) == len(want[sid]), sid
        for g, w in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class TestGlitchQuarantine:
    def test_hold_glitched_streams_score_their_clean_chunks(self):
        streams = [f"s{i}" for i in range(4)]
        chunks = {sid: _chunks(i, 10) for i, sid in enumerate(streams)}
        bad = {(s, c) for (s, c) in glitch_plan(n_streams=4, n_chunks=10) if s in (1, 3)}
        srv = _server(health=HealthConfig(sanitize="hold"))
        for c in range(10):
            for s, sid in enumerate(streams):
                srv.submit(sid, corrupt((6, _DIM), "nan") if (s, c) in bad
                           else chunks[sid][c])
            srv.drain()
        clean = {sid: [c for j, c in enumerate(chs) if (i, j) not in bad]
                 for i, (sid, chs) in enumerate(chunks.items())}
        _assert_scores_equal(srv.pop_scores(), _replay(clean))
        assert srv.stats.held == len(bad) and srv.pop_errors() == {}

    def test_reject_raises_and_stream_survives(self):
        srv = _server(health=HealthConfig(sanitize="reject"))
        chunks = _chunks(1, 4)
        srv.submit("a", chunks[0])
        with pytest.raises(ChunkRejectedError, match="stream 'a'.*NaN"):
            srv.submit("a", corrupt((6, _DIM), "nan"))
        with pytest.raises(ChunkRejectedError, match="Inf"):
            srv.submit("a", corrupt((6, _DIM), "inf"))
        for c in chunks[1:]:
            srv.submit("a", c)
        srv.drain()
        _assert_scores_equal(srv.pop_scores(), _replay({"a": chunks}))
        assert srv.stats.rejected == 2

    def test_saturation_limit_screens_amplitude(self):
        srv = _server(health=HealthConfig(sanitize="reject", saturation_limit=100.0))
        with pytest.raises(ChunkRejectedError, match="saturated"):
            srv.submit("a", corrupt((6, _DIM), "saturated", value=1e6))
        srv.submit("a", np.full((6, _DIM), 99.0, np.float32))
        assert srv.pending == 1

    def test_reset_policy_fresh_lineage_with_holddown(self):
        a_chunks, b_chunks = _chunks(10, 10), _chunks(11, 10)
        srv = _server(health=HealthConfig(sanitize="reset", holddown_windows=1))
        glitch_at = 3
        for c in range(10):
            srv.submit("a", a_chunks[c])
            srv.submit("b", corrupt((6, _DIM), "inf") if c == glitch_at else b_chunks[c])
            srv.drain()
        pre = _replay({"b": b_chunks[:2]})["b"]
        post = _replay({"b": b_chunks[glitch_at + 1 :]})["b"]
        _assert_scores_equal(srv.pop_scores(),
                             {"a": _replay({"a": a_chunks})["a"], "b": pre + post[1:]})
        assert srv.stats.sanitize_resets == 1 and srv.stats.holddown_suppressed == 1

    def test_queue_full_semantics_unchanged_by_health(self):
        srv = _server(health=True, queue_capacity=2, overflow="error")
        srv.submit("a", _chunks(0, 1)[0])
        srv.submit("b", _chunks(1, 1)[0])
        with pytest.raises(QueueFullError):
            srv.submit("c", _chunks(2, 1)[0])


@pytest.mark.parametrize("impl", ["fused_step", "kernel"])
class TestEngineFaults:
    def test_engine_exception_isolated_to_its_batch(self, impl):
        eng = FaultyEngine(_engine(impl), fail_calls={0})
        srv = _server(eng, health=HealthConfig(holddown_windows=0))
        a_chunks, b_chunks = _chunks(20, 4, t=12), _chunks(21, 2, t=6)
        srv.submit("a", a_chunks[0])
        assert srv.tick(force=True) == 1
        errs = srv.pop_errors()
        assert list(errs) == ["a"] and "engine step failed" in errs["a"][0]
        assert srv.stats.engine_errors == 1 and srv.pop_scores() == {}
        for c in b_chunks:
            srv.submit("b", c)
        for c in a_chunks[1:]:
            srv.submit("a", c)
        srv.drain()
        _assert_scores_equal(srv.pop_scores(),
                             _replay({"a": a_chunks[1:], "b": b_chunks}, impl))
        assert srv.pop_errors() == {}

    def test_watchdog_resets_poisoned_state(self, impl):
        eng = _engine(impl)
        srv = _server(eng, health=HealthConfig(holddown_windows=0))
        a0, b0 = _chunks(30, 1)[0], _chunks(31, 1)[0]
        ap, bp = _chunks(32, 1, t=2)[0], _chunks(33, 1, t=2)[0]
        b1 = _chunks(34, 1, t=4)[0]
        srv.submit("a", a0)
        srv.submit("b", b0)
        srv.drain()
        slot = eng._streams["a"]
        if impl == "kernel":  # layers layout: [(h, c)] per layer
            slot.state = [tuple(t * float("nan") for t in layer) for layer in slot.state]
        else:  # packed layout: (h, c)
            slot.state = tuple(t * float("nan") for t in slot.state)
        srv.submit("a", ap)
        srv.submit("b", bp)
        srv.drain()  # 6+2 samples: no window boundary, the poison persists
        assert srv.stats.watchdog_resets == 1
        errs = srv.pop_errors()
        assert list(errs) == ["a"] and "watchdog" in errs["a"][0]
        assert "a" not in eng.stream_ids
        a_fresh = _chunks(35, 2)
        for c in a_fresh:
            srv.submit("a", c)
        srv.submit("b", b1)
        srv.drain()
        _assert_scores_equal(srv.pop_scores(),
                             _replay({"a": a_fresh, "b": [b0, bp, b1]}, impl))

    def test_state_absmax_reads_inf_and_zero(self, impl):
        eng = _engine(impl)
        eng.push_many(["a", "b"], np.zeros((2, 3, _DIM), np.float32))
        slot = eng._streams["b"]
        if impl == "kernel":
            slot.state = [(layer[0], layer[1] + float("inf")) for layer in slot.state]
        else:
            slot.state = (slot.state[0], slot.state[1] + float("inf"))
        vals = eng.state_absmax(["a", "b", "missing"])
        assert vals[0] <= 1.0 and np.isinf(vals[1]) and vals[2] == 0.0


def test_watchdog_off_lets_scores_flow():
    srv = _server(_engine(), health=HealthConfig(watchdog=False))
    srv.submit("a", _chunks(32, 1)[0])
    srv.drain()
    assert srv.stats.watchdog_resets == 0


class TestSnapshotRestore:
    @pytest.mark.parametrize("impl", ["fused_step", "kernel"])
    def test_midrun_checkpoint_restart_bitequal(self, tmp_path, impl):
        path = str(tmp_path / "ck.npz")
        streams = ["s0", "s1", "s2"]
        chunks = {sid: _chunks(40 + i, 7) for i, sid in enumerate(streams)}
        srv = _server(_engine(impl), health=True)
        for c in range(3):
            for sid in streams:
                srv.submit(sid, chunks[sid][c])
            srv.drain()
        mid = srv.pop_scores()
        srv.checkpoint(path)
        assert srv.stats.checkpoints == 1
        restarted = StreamServer.restart_from(path, _engine(impl), ServerConfig(health=True))
        for c in range(3, 7):
            for sid in streams:
                srv.submit(sid, np.array(chunks[sid][c]))
                restarted.submit(sid, np.array(chunks[sid][c]))
            srv.drain()
            restarted.drain()
        tail = srv.pop_scores()
        _assert_scores_equal(restarted.pop_scores(), tail)
        merged = {sid: mid.get(sid, []) + tail.get(sid, []) for sid in streams}
        _assert_scores_equal(merged, _replay(chunks, impl))

    @pytest.mark.parametrize("impl", ["fused_step", "kernel"])
    def test_bf16_state_roundtrip_bitequal(self, tmp_path, impl):
        """bf16 h leaves go to disk as 2-byte items and come back exact."""
        cfg = dataclasses.replace(_CFG, dtype=torch.bfloat16)
        path = str(tmp_path / "bf16.npz")
        x = np.random.RandomState(1).randn(2, 20, 1).astype(np.float32)
        params = init_autoencoder(cfg, seed=7, device="cpu")
        src = StreamingAnomalyEngine(params, cfg, impl=impl, device="cpu")
        src.push_many(["a", "b"], x[:, :7])
        src.save_snapshot(path)
        dst = StreamingAnomalyEngine(params, cfg, impl=impl, device="cpu")
        dst.restore(path)
        assert dst.fingerprint()["dtype"] == "bfloat16"
        want, got = src.push_many(["a", "b"], x[:, 7:]), dst.push_many(["a", "b"], x[:, 7:])
        _assert_scores_equal(got, want)

    def test_restore_carries_threshold_and_lockstep_state(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        eng = _engine()
        eng.threshold = 0.125
        x = np.random.RandomState(0).randn(1, 12, 1).astype(np.float32)
        eng.push(x[:, :5])
        eng.save_snapshot(path)
        eng2 = _engine()
        eng2.restore(path)
        assert eng2.threshold == 0.125 and eng2.filled == 5
        np.testing.assert_array_equal(eng2.push(x[:, 5:])[0], eng.push(x[:, 5:])[0])

    def test_fingerprint_mismatch_refused(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        _engine().save_snapshot(path)
        other_cfg = AutoencoderConfig(hidden=(6, 6), latent_boundary=1, timesteps=12)
        other = StreamingAnomalyEngine(init_autoencoder(other_cfg, seed=1, device="cpu"),
                                       other_cfg, batch=1, device="cpu")
        with pytest.raises(SnapshotMismatchError, match="hidden"):
            other.restore(path)
        with pytest.raises(SnapshotMismatchError, match="state_layout"):
            _engine("kernel").restore(path)

    def test_version_gate(self):
        snap = _engine().snapshot()
        snap["version"] = 999
        with pytest.raises(SnapshotMismatchError, match="version"):
            _engine().restore(snap)

    def test_unserializable_stream_id_fails_at_snapshot(self, tmp_path):
        eng = _engine()
        eng.push_many([("tuple", "id")], np.zeros((1, 2, _DIM), np.float32))
        with pytest.raises(ValueError, match="not snapshot-serializable"):
            eng.save_snapshot(str(tmp_path / "ck.npz"))


class _FireCrash:
    """Make the scheduler loop itself crash on its first scripted calls."""

    def __init__(self, server, crashes=1):
        self._orig = server._fire
        self.remaining = crashes

    def __call__(self, batch, reason):
        if self.remaining > 0:
            self.remaining -= 1
            raise RuntimeError("injected scheduler crash")
        return self._orig(batch, reason)


class TestSupervision:
    _HEALTH = dict(supervise=False, restart_backoff_s=0.001, max_backoff_s=0.002,
                   heartbeat_timeout_s=5.0)

    def test_supervised_restart_and_budget(self):
        srv = _server(health=HealthConfig(max_restarts=2, **self._HEALTH))
        srv._fire = _FireCrash(srv, crashes=3)
        srv.start()
        try:
            for expected in (1, 2):
                srv.submit("a", _chunks(52, 1)[0])
                _wait_until(lambda: not srv._thread.is_alive(), msg="crash")
                assert not srv.healthy()
                assert srv._supervise_once() is True
                assert srv.stats.scheduler_restarts == expected and srv.healthy()
            srv.submit("a", _chunks(53, 1)[0])
            _wait_until(lambda: not srv._thread.is_alive(), msg="crash")
            assert srv._supervise_once() is False  # budget exhausted
            assert srv.stats.scheduler_restarts == 2
        finally:
            srv.stop(deadline_s=30.0)

    def test_supervisor_thread_end_to_end(self):
        health = HealthConfig(supervise=True, supervise_interval_s=0.005,
                              restart_backoff_s=0.001, max_backoff_s=0.002)
        srv = _server(health=health)
        srv._fire = _FireCrash(srv, crashes=1)
        srv.start()
        try:
            srv.submit("a", _chunks(54, 1)[0])
            _wait_until(lambda: srv.stats.scheduler_restarts >= 1, msg="supervisor restart")
            for c in _chunks(55, 2):
                srv.submit("a", c)
            _wait_until(lambda: srv.pop_scores().get("a"), msg="post-restart score")
        finally:
            assert srv.stop(deadline_s=30.0)

    def test_stop_deadline_survives_wedged_engine(self):
        eng = BlockingEngine(_engine(), block_calls={0})
        srv = _server(eng, health=HealthConfig(supervise=False, heartbeat_timeout_s=0.05))
        srv.start()
        try:
            srv.submit("a", _chunks(56, 1)[0])
            assert eng.entered.wait(30.0)
            srv.submit("b", _chunks(57, 1)[0])
            _wait_until(lambda: not srv.healthy(), msg="stale heartbeat")
            t0 = time.monotonic()
            assert srv.stop(drain=True, deadline_s=0.2) is False
            assert time.monotonic() - t0 < 5.0
            assert srv.pending == 0 and srv.stats.cancelled >= 1
        finally:
            eng.release.set()

    def test_clock_skew_does_not_break_determinism(self):
        clk = SkewClock()
        srv = _server(health=True, clock=clk, deadline_us=200.0)
        chunks = {sid: _chunks(60 + i, 6) for i, sid in enumerate("ab")}
        jumps = [3600.0, -7200.0, 0.25, -0.001, 1e6]
        for c in range(6):
            for sid in "ab":
                srv.submit(sid, chunks[sid][c])
            clk.jump_s(jumps[c % len(jumps)])
            srv.tick()
            clk.advance_us(300.0)
            srv.tick()
        srv.drain()
        _assert_scores_equal(srv.pop_scores(), _replay(chunks))


def test_close_mid_batch_suppresses_scores_and_slot():
    eng = CloseRaceEngine(_engine(), race_call=1)
    srv = _server(eng, health=True)
    eng.attach(srv, "a")
    a, b = _chunks(70, 2), _chunks(71, 2)
    srv.submit("a", a[0])
    srv.submit("b", b[0])
    srv.drain()
    srv.submit("a", a[1])
    srv.submit("b", b[1])
    srv.drain()  # the race: close("a") lands while its batch is in flight
    eng.closer.join(30.0)
    assert not eng.closer.is_alive() and eng.closed_dropped == 0
    assert "a" not in eng.stream_ids
    _assert_scores_equal(srv.pop_scores(), _replay({"b": b}))
    fresh = _chunks(72, 2)
    for c in fresh:
        srv.submit("a", c)
    srv.drain()
    _assert_scores_equal(srv.pop_scores(), _replay({"a": fresh}))


def test_throwing_on_score_threaded_does_not_kill_scheduler():
    calls = []

    def bad_cb(sid, score):
        calls.append((sid, np.asarray(score)))
        raise ValueError("user callback bug")

    srv = _server(on_score=bad_cb, health=True)
    chunks = _chunks(80, 4)
    srv.start()
    try:
        for c in chunks:
            srv.submit("a", c)
        _wait_until(lambda: len(calls) >= 2, msg="callback deliveries")
    finally:
        assert srv.stop(deadline_s=30.0)
    assert srv.stats.callback_errors == len(calls) == 2 and srv._thread is None
    for (sid, got), w in zip(calls, _replay({"a": chunks})["a"]):
        assert sid == "a"
        np.testing.assert_array_equal(got, np.asarray(w))
