"""The port's StreamServer on its own: policy, backpressure, lifecycle,
threads, and the determinism contract, bitwise.

The contract: the scheduler only (a) keeps per-stream FIFO order and (b)
batches distinct streams of one chunk length into one ``push_many`` call,
so any arrival order and batch-fill sequence scores bit-equal to
per-stream sequential replays through ``engine.push``.  It holds on both
engines the server runs on the card: ``fused_step`` (step and wavefront
kernels) and ``kernel`` (the per-layer scan kernel); here their plain
versions run on the CPU.

Every thread join and wait has a timeout, so a hang fails a test.
"""

import threading
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline container: fixed-example stand-ins
    from _hypothesis_compat import given, settings, st

from repro_torch.core.autoencoder import AutoencoderConfig, init_autoencoder
from repro_torch.serve.engine import POOL_STEP, StreamingAnomalyEngine
from repro_torch.serve.server import (
    AdaptiveConfig,
    QueueFullError,
    ServerConfig,
    StreamServer,
    _pad_width,
)

_CFG = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, timesteps=12)
_PARAMS = init_autoencoder(_CFG, seed=7, device="cpu")
IMPLS = ["fused_step", "kernel"]


def _engine(impl="fused_step", **kw):
    return StreamingAnomalyEngine(_PARAMS, _CFG, batch=1, impl=impl, device="cpu", **kw)


def _sequential_scores(chunk_lists: dict, impl="fused_step") -> dict:
    """Ground truth: each stream replayed solo through engine.push."""
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
    assert set(got) == set(want), (sorted(got), sorted(want))
    for sid in want:
        assert len(got[sid]) == len(want[sid]), sid
        for g, w in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _join(thread, timeout=60.0):
    thread.join(timeout)
    assert not thread.is_alive(), "thread did not finish in time"


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_us(self, us: float):
        self.t += us * 1e-6


class TestServerConfig:
    def test_pad_width_ladder_is_bounded(self):
        assert [_pad_width(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
        assert _pad_width(POOL_STEP + 1) == 2 * POOL_STEP
        for n in range(1, 65):
            assert n <= _pad_width(n) < n + POOL_STEP

    def test_defaults_keep_the_reference_widths(self):
        assert POOL_STEP == 8
        assert ServerConfig().max_coalesce == 8 and AdaptiveConfig().min_coalesce == 8
        assert ServerConfig(max_coalesce=1).max_coalesce == 1

    @pytest.mark.parametrize("kw", [dict(max_coalesce=0), dict(deadline_us=0),
                                    dict(queue_capacity=0), dict(overflow="spill"),
                                    dict(adaptive="yes"), dict(health="yes")])
    def test_invalid_config_raises(self, kw):
        with pytest.raises(ValueError):
            ServerConfig(**kw)

    @pytest.mark.parametrize("kw", [dict(max_deadline_us=0), dict(min_deadline_us=1000.0),
                                    dict(ewma_alpha=0.0), dict(idle_reset_factor=1.0),
                                    dict(fill_headroom=0.0), dict(min_coalesce=0)])
    def test_invalid_adaptive_config_raises(self, kw):
        with pytest.raises(ValueError):
            AdaptiveConfig(**kw)

    def test_engine_must_be_batch_one(self):
        with pytest.raises(ValueError, match="batch=1"):
            StreamServer(StreamingAnomalyEngine(_PARAMS, _CFG, batch=2, device="cpu"))


@pytest.mark.parametrize("impl", IMPLS)
class TestManualScheduling:
    def test_drain_bit_equal_sequential_ragged(self, impl):
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=1e9))
        T = eng.window
        x = np.random.RandomState(3).randn(3, 2 * T, 1).astype(np.float32)
        bounds = (0, 5, 11, 16, 2 * T)
        chunk_lists = {f"s{i}": [x[i, a:b] for a, b in zip(bounds, bounds[1:])]
                       for i in range(3)}
        for j in range(len(bounds) - 1):
            for sid in chunk_lists:
                srv.submit(sid, chunk_lists[sid][j])
        srv.drain()
        _assert_scores_equal(srv.pop_scores(), _sequential_scores(chunk_lists, impl))
        assert srv.stats.processed == srv.stats.submitted == 12
        assert srv.stats.windows_scored == 6

    def test_close_stream_discards_pending_and_slot(self, impl):
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=1e9))
        T = eng.window
        x = np.random.RandomState(6).randn(1, T, 1).astype(np.float32)
        srv.submit("a", x[0, :5])
        srv.drain()
        srv.submit("a", x[0, 5:8])
        srv.submit("a", x[0, 8:])
        assert srv.close_stream("a") == 2
        assert srv.pending == 0 and eng.stream_ids == ()
        srv.submit("a", x[0, :T])
        srv.drain()
        _assert_scores_equal(srv.pop_scores(), _sequential_scores({"a": [x[0, :T]]}, impl))

    def test_pad_streams_never_leak(self, impl):
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=1e9, pad_to_sublanes=True))
        srv.submit("a", np.zeros((3, 1), np.float32))
        srv.submit("b", np.zeros((3, 1), np.float32))
        srv.submit("c", np.zeros((3, 1), np.float32))
        srv.drain()
        assert eng.stream_ids == ("a", "b", "c")

    def test_adaptive_schedule_bit_equal_sequential(self, impl):
        clock = FakeClock()
        srv = StreamServer(_engine(impl), ServerConfig(adaptive=True), clock=clock)
        T = srv.engine.window
        x = np.random.RandomState(21).randn(5, 2 * T, 1).astype(np.float32)
        bounds = (0, 5, 11, 16, 2 * T)
        chunk_lists = {f"s{i}": [x[i, a:b] for a, b in zip(bounds, bounds[1:])]
                       for i in range(5)}
        rng = np.random.RandomState(22)
        for j in range(len(bounds) - 1):
            for sid in chunk_lists:
                srv.submit(sid, chunk_lists[sid][j])
                clock.advance_us(float(rng.randint(0, 300)))
                srv.tick()
        srv.drain()
        srv.close_stream("s2")
        rejoin = rng.randn(T, 1).astype(np.float32)
        srv.submit("s2", rejoin[: T // 2])
        srv.submit("s2", rejoin[T // 2 :])
        srv.drain()
        want = _sequential_scores(chunk_lists, impl)
        want["s2"] = want["s2"] + _sequential_scores(
            {"s2": [rejoin[: T // 2], rejoin[T // 2 :]]}, impl)["s2"]
        _assert_scores_equal(srv.pop_scores(), want)
        assert srv.stats.processed == srv.stats.submitted


class TestSubmitAndCallbacks:
    def test_submit_errors_name_the_stream_and_shape(self):
        srv = StreamServer(_engine())
        with pytest.raises(ValueError, match=r"stream 'det-7'.*\(3, 9\)"):
            srv.submit("det-7", np.zeros((3, 9), np.float32))
        with pytest.raises(ValueError, match=r"stream 'det-7'.*complex64"):
            srv.submit("det-7", np.zeros((4, 1), np.complex64))
        with pytest.raises(ValueError, match="chunk must be"):
            srv.submit("a", np.zeros((0, 1), np.float32))
        srv.submit("det-7", np.zeros((4, 1), np.int32))
        srv.submit("a", np.zeros((1, 4, 1), np.float32))  # push shape ok
        assert srv.pending == 2

    def test_throwing_callback_counted_not_fatal(self):
        calls = []

        def cb(sid, score):
            calls.append(sid)
            raise RuntimeError("user bug")

        eng = _engine()
        srv = StreamServer(eng, on_score=cb)
        T = eng.window
        x = np.random.RandomState(3).randn(1, 2 * T, 1).astype(np.float32)
        for half in (x[0, :T], x[0, T:]):
            srv.submit("a", half)
            srv.drain()
        assert calls == ["a", "a"] and srv.stats.callback_errors == 2
        assert srv.stats.windows_scored == 2

    def test_latency_histogram_records_per_chunk(self):
        clock = FakeClock()
        srv = StreamServer(_engine(), ServerConfig(deadline_us=50.0), clock=clock)
        srv.submit("a", np.zeros((2, 1), np.float32))
        clock.advance_us(100.0)
        srv.submit("b", np.zeros((2, 1), np.float32))
        srv.tick()
        assert srv.stats.latency.count == 2 and srv.stats.latency.max_us >= 99.0


class TestOverflow:
    def _small(self, policy):
        return StreamServer(_engine(), ServerConfig(queue_capacity=2, overflow=policy,
                                                    deadline_us=1e9))

    def test_drop_oldest_sheds_stalest(self):
        srv = self._small("drop_oldest")
        x = np.random.RandomState(8).randn(3, 12, 1).astype(np.float32)
        for sid, chunk in zip("abc", x):
            srv.submit(sid, chunk)
        assert srv.stats.drops == 1
        srv.drain()
        _assert_scores_equal(srv.pop_scores(),
                             _sequential_scores({"b": [x[1]], "c": [x[2]]}))

    def test_error_raises_queue_full(self):
        srv = self._small("error")
        srv.submit("a", np.zeros((1, 1), np.float32))
        srv.submit("b", np.zeros((1, 1), np.float32))
        with pytest.raises(QueueFullError):
            srv.submit("c", np.zeros((1, 1), np.float32))

    def test_block_without_scheduler_raises(self):
        srv = self._small("block")
        srv.submit("a", np.zeros((1, 1), np.float32))
        srv.submit("b", np.zeros((1, 1), np.float32))
        with pytest.raises(RuntimeError, match="no scheduler thread"):
            srv.submit("c", np.zeros((1, 1), np.float32))

    def test_block_unblocks_when_scheduler_drains(self):
        srv = self._small("block")
        srv.config.deadline_us = 100.0
        srv.start()
        try:
            for i in range(6):  # 3x capacity: must block and recover
                srv.submit(f"s{i}", np.zeros((2, 1), np.float32))
        finally:
            assert srv.stop(drain=True, deadline_s=60.0)
        assert srv.stats.processed == 6 and srv.stats.drops == 0


@pytest.mark.parametrize("impl", IMPLS)
class TestThreaded:
    def test_concurrent_producers_bit_equal(self, impl):
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=500.0))
        T = eng.window
        x = np.random.RandomState(9).randn(6, 2 * T, 1).astype(np.float32)
        bounds = (0, 4, 9, 12, 2 * T)
        chunk_lists = {f"s{i}": [x[i, a:b] for a, b in zip(bounds, bounds[1:])]
                       for i in range(6)}

        def produce(ids):
            for j in range(len(bounds) - 1):
                for sid in ids:
                    srv.submit(sid, chunk_lists[sid][j])

        srv.start()
        producers = [threading.Thread(target=produce, args=(ids,))
                     for ids in (["s0", "s1", "s2"], ["s3", "s4", "s5"])]
        for p in producers:
            p.start()
        for p in producers:
            _join(p)
        assert srv.stop(drain=True, deadline_s=60.0)
        assert srv.pending == 0
        assert srv.stats.processed == srv.stats.submitted == 24
        _assert_scores_equal(srv.pop_scores(), _sequential_scores(chunk_lists, impl))

    def test_stop_without_drain_and_restart(self, impl):
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=1e9))
        srv.start()
        srv.submit("a", np.zeros((2, 1), np.float32))
        srv.stop(drain=False, deadline_s=60.0)
        assert srv.pending == 0 and srv.stats.cancelled + srv.stats.processed >= 1
        T = eng.window
        x = np.random.RandomState(11).randn(1, T, 1).astype(np.float32)
        srv.close_stream("a")
        srv.config.deadline_us = 100.0
        for half in (x[0, : T // 2], x[0, T // 2 :]):
            srv.start()
            srv.submit("a", half)
            assert srv.stop(drain=True, deadline_s=60.0)
        _assert_scores_equal(srv.pop_scores(), _sequential_scores(
            {"a": [x[0, : T // 2], x[0, T // 2 :]]}, impl))

    def test_on_score_callback_delivery(self, impl):
        eng = _engine(impl)
        seen = []
        srv = StreamServer(eng, ServerConfig(deadline_us=100.0),
                           on_score=lambda sid, s: seen.append((sid, float(s[0]))))
        x = np.random.RandomState(10).randn(eng.window, 1).astype(np.float32)
        srv.start()
        srv.submit("a", x)
        assert srv.stop(drain=True, deadline_s=60.0)
        assert len(seen) == 1 and seen[0][0] == "a"
        assert srv.pop_scores() == {}


class TestSchedulerDeterminism:
    """Any arrival order and batch-fill sequence scores bit-equal to
    sequential per-stream pushes, with a mid-run drop and rejoin."""

    _SPLITS = [3, 4, 6, 12]

    @pytest.mark.parametrize("impl", IMPLS)
    @settings(max_examples=4, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=10_000))
    def test_random_schedule_bit_equal(self, impl, seed):
        rng = np.random.RandomState(seed)
        eng = _engine(impl)
        srv = StreamServer(eng, ServerConfig(deadline_us=1e9))
        T = eng.window
        n_streams = int(rng.randint(2, 5))
        data = rng.randn(n_streams, 2 * T, 1).astype(np.float32)
        chunk_lists, pending = {}, {}
        for i in range(n_streams):
            chunks, pos = [], 0
            while pos < 2 * T:
                t = min(int(rng.choice(self._SPLITS)), 2 * T - pos)
                chunks.append(data[i, pos : pos + t])
                pos += t
            chunk_lists[f"s{i}"] = chunks
            pending[f"s{i}"] = list(chunks)
        while any(pending.values()):
            ready = [sid for sid, q in pending.items() if q]
            sid = ready[int(rng.randint(len(ready)))]
            srv.submit(sid, pending[sid].pop(0))
            if rng.rand() < 0.35:
                srv.tick(force=bool(rng.rand() < 0.5))
        srv.drain()
        srv.close_stream("s0")
        rejoin = rng.randn(T, 1).astype(np.float32)
        cut = int(rng.choice([s for s in self._SPLITS if s < T]))
        srv.submit("s0", rejoin[:cut])
        srv.submit("s0", rejoin[cut:])
        srv.drain()
        got = srv.pop_scores()
        want = _sequential_scores(chunk_lists, impl)
        want["s0"] = want["s0"] + _sequential_scores(
            {"s0": [rejoin[:cut], rejoin[cut:]]}, impl)["s0"]
        _assert_scores_equal(got, want)
        assert srv.stats.processed == srv.stats.submitted and srv.stats.drops == 0


def test_heartbeat_and_healthy_in_manual_mode():
    clock = FakeClock()
    srv = StreamServer(_engine(), ServerConfig(health=True), clock=clock)
    assert srv.healthy() and srv.heartbeat_age_s() is None
    srv.tick()
    clock.advance_us(2e6)
    assert srv.heartbeat_age_s() == pytest.approx(2.0)
    srv.start()
    try:
        deadline = time.monotonic() + 30.0
        while srv.heartbeat_age_s() != 0.0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.healthy()
    finally:
        assert srv.stop(deadline_s=30.0)
