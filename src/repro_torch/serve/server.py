"""Continuous-batching stream server: the policy layer over ``push_many``.

``StreamingAnomalyEngine.push_many`` is the *mechanism*: N independent
B=1 streams advanced by one gathered B=N step call, bit-equal to
sequential pushes.  It only coalesces what one caller hands over in a
single synchronous call.  Production is the other shape: thousands of
detector streams arriving *asynchronously*, each with a fixed per-chunk
latency budget (the paper's premise).  This module adds the policy layer,
the continuous-batching loop LLM serving uses:

* **arrival queue**: producers call ``submit(stream_id, chunk)`` from any
  thread; it is non-blocking (bounded, with an explicit overflow policy)
  and never touches the engine;
* **deadline scheduler**: a single scheduler thread gathers whatever is
  pending into one ``push_many`` call per tick.  It waits to *fill* a
  batch (up to ``max_coalesce`` streams) but flushes early the moment the
  oldest pending chunk's age reaches its deadline.  The deadline is
  tracked **per chunk-length bucket** (a bucket stuck behind a busy head
  bucket can never overstay), and two degenerate cases flush
  *immediately*: when every currently joined stream already has a
  pending chunk (waiting cannot improve fill), and when a batch is full;
* **adaptive policy** (``ServerConfig.adaptive``): instead of a fixed
  ``deadline_us``, the scheduler estimates each bucket's arrival rate
  with an EWMA over inter-arrival gaps (``serve/latency.py``) and picks
  the deadline that fills the batch with high probability under that
  rate, capped by ``max_deadline_us``; when even the cap cannot fill it,
  it flushes at once.  The effective coalescing width widens toward
  ``max_coalesce`` while full batches keep arriving and narrows when the
  queue depth says the engine is the bottleneck;
* **padded batch widths**: partial batches are padded up a bounded width
  ladder ({1, 2, 4} then multiples of ``POOL_STEP``) with inert
  zero-chunk pad streams, so every fill level runs one of a bounded set
  of batch widths (the widths a captured launch sequence per width would
  cover), while a lone stream runs width 1;
* **dynamic lifecycle**: streams join on first submit and leave via
  ``close_stream``; join/leave is host-side bookkeeping only;
* **metrics**: per-chunk enqueue->score latency lands in a
  ``LatencyHistogram``, plus tick counts, the batch-fill distribution,
  deadline/full/fast-path flush counts, and drops.

Determinism contract: the scheduler only ever (a) preserves per-stream
chunk FIFO order and (b) coalesces *distinct* streams of one chunk length
into a single ``push_many`` call.  ``push_many`` is bit-equal to
sequential single-stream pushes for both, so **any** arrival order and
batch-fill sequence scores bit-equal to per-stream sequential replays.

The scheduling decisions are the reference's (``repro.serve.server``),
line for line: given the same submits and the same clock, both servers
take the same ticks, batches and flush reasons and count the same stats.

Two drive modes share all scheduling logic:

* threaded (production): ``server.start()`` (or ``with server:``) runs the
  loop on a daemon thread;
* manual (tests): leave it unstarted and call ``tick()`` / ``drain()``,
  fully deterministic and fake-clock friendly.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .engine import POOL_STEP, _pad_width
from .health import ChunkRejectedError, HealthConfig, screen_chunk
from .latency import ArrivalRateEstimator, LatencyHistogram

__all__ = [
    "AdaptiveConfig",
    "ChunkRejectedError",
    "HealthConfig",
    "QueueFullError",
    "ServerConfig",
    "ServerStats",
    "StreamServer",
]

logger = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` under ``overflow="error"`` on a full queue."""


@dataclass
class AdaptiveConfig:
    """Self-tuning scheduler knobs (``ServerConfig.adaptive``).

    ``max_deadline_us`` — hard cap on the chosen coalescing deadline: no
    pending chunk ever waits longer than this for its batch to fill (the
    paper's fixed per-sample budget survives as the *bound* the adaptive
    policy works under).
    ``min_deadline_us`` — floor on the chosen deadline; also the wait
    applied when the estimator says the batch cannot fill within
    ``max_deadline_us`` (0 = flush immediately — waiting buys nothing).
    ``ewma_alpha`` / ``idle_reset_factor`` — per-bucket inter-arrival
    EWMA weight and idle-boundary threshold (``ArrivalRateEstimator``).
    ``fill_headroom`` — safety factor on the predicted time-to-fill
    (arrival gaps are noisy; >1 waits a little longer than the point
    estimate before giving up on the batch filling).
    ``min_coalesce`` — narrowest effective width the engine-bottleneck
    shrink may reach (one ``POOL_STEP`` by default: below that, batching
    stops paying at all).
    """

    max_deadline_us: float = 500.0
    min_deadline_us: float = 0.0
    ewma_alpha: float = 0.25
    idle_reset_factor: float = 50.0
    fill_headroom: float = 1.5
    min_coalesce: int = POOL_STEP

    def __post_init__(self):
        if self.max_deadline_us <= 0:
            raise ValueError(
                f"max_deadline_us must be > 0, got {self.max_deadline_us}"
            )
        if not 0.0 <= self.min_deadline_us <= self.max_deadline_us:
            raise ValueError(
                "min_deadline_us must be in [0, max_deadline_us], got "
                f"{self.min_deadline_us}"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}"
            )
        if self.idle_reset_factor <= 1.0:
            raise ValueError(
                f"idle_reset_factor must be > 1, got {self.idle_reset_factor}"
            )
        if self.fill_headroom <= 0:
            raise ValueError(
                f"fill_headroom must be > 0, got {self.fill_headroom}"
            )
        if self.min_coalesce < 1:
            raise ValueError(
                f"min_coalesce must be >= 1, got {self.min_coalesce}"
            )


@dataclass
class ServerConfig:
    """Scheduler policy knobs (everything model-side lives in the plan).

    ``max_coalesce`` — most *distinct streams* gathered into one step
    call, honored exactly as requested (``max_coalesce=1`` really means
    no coalescing).  Batch widths are a separate concern: partial
    batches are padded up the bounded ``_pad_width`` ladder, so the
    requested gather cap never changes which batch widths run, only how
    many streams ride each one.
    ``deadline_us`` — the *fixed-policy* coalescing budget: a pending
    chunk never waits longer than this for the batch to fill (the
    paper's fixed per-sample budget, 50-500us on real hardware; host
    clock granularity applies).  Ignored when ``adaptive`` is set.
    ``adaptive`` — an ``AdaptiveConfig`` (or ``True`` for defaults):
    choose the deadline per chunk-length bucket from the observed
    arrival rate instead, capped by ``adaptive.max_deadline_us``, and
    let the effective width self-tune between ticks.
    ``queue_capacity`` / ``overflow`` — backpressure: "block" makes
    ``submit`` wait for space (producers throttle), "drop_oldest" sheds
    the stalest pending chunk (freshness wins; counted in stats),
    "error" raises ``QueueFullError`` (caller-managed).
    ``pad_to_sublanes`` — pad partial batches up the width ladder with
    inert pad streams: a bounded set of batch widths across fill levels
    (the name is the reference's).
    ``health`` — a ``HealthConfig`` (or ``True`` for defaults): input
    sanitization + stream quarantine, the post-step state watchdog,
    scheduler supervision, the ``stop(drain=True)`` deadline, and
    periodic checkpointing.  ``None`` (default) disables the quarantine/
    watchdog/supervision machinery, but per-batch fault isolation —
    engine-step exceptions and raising ``on_score`` callbacks never kill
    the scheduler thread — is always on.
    """

    max_coalesce: int = POOL_STEP
    deadline_us: float = 200.0
    queue_capacity: int = 4096
    overflow: str = "block"
    pad_to_sublanes: bool = True
    adaptive: AdaptiveConfig | bool | None = None
    health: HealthConfig | bool | None = None

    def __post_init__(self):
        if self.max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {self.max_coalesce}")
        if self.deadline_us <= 0:
            raise ValueError(f"deadline_us must be > 0, got {self.deadline_us}")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}"
            )
        if self.overflow not in ("block", "drop_oldest", "error"):
            raise ValueError(
                "overflow must be one of 'block' | 'drop_oldest' | 'error', "
                f"got {self.overflow!r}"
            )
        if self.adaptive is True:
            self.adaptive = AdaptiveConfig()
        elif self.adaptive is False:
            self.adaptive = None
        elif self.adaptive is not None and not isinstance(
            self.adaptive, AdaptiveConfig
        ):
            raise ValueError(
                "adaptive must be an AdaptiveConfig, True, or None, got "
                f"{self.adaptive!r}"
            )
        if self.health is True:
            self.health = HealthConfig()
        elif self.health is False:
            self.health = None
        elif self.health is not None and not isinstance(
            self.health, HealthConfig
        ):
            raise ValueError(
                "health must be a HealthConfig, True, or None, got "
                f"{self.health!r}"
            )


@dataclass
class ServerStats:
    """Scheduler instrumentation; read a consistent copy via ``summary``."""

    submitted: int = 0
    processed: int = 0
    drops: int = 0        # shed by drop_oldest backpressure
    cancelled: int = 0    # pending chunks discarded by close_stream
    ticks: int = 0
    full_flushes: int = 0      # batch reached the effective width
    deadline_flushes: int = 0  # oldest chunk in its bucket hit the deadline
    fastpath_flushes: int = 0  # every joined stream pending: waiting is moot
    drain_flushes: int = 0     # forced (drain / shutdown)
    windows_scored: int = 0
    # fault-tolerance counters (serve/health.py)
    rejected: int = 0            # chunks refused by sanitize="reject"
    held: int = 0                # chunks skipped by sanitize="hold"
    sanitize_resets: int = 0     # streams reset by sanitize="reset"
    watchdog_resets: int = 0     # streams reset by the post-step watchdog
    holddown_suppressed: int = 0  # scores withheld during a reset hold-down
    callback_errors: int = 0     # on_score raised (logged, never fatal)
    engine_errors: int = 0       # engine-step batches that raised
    scheduler_restarts: int = 0  # supervised scheduler-thread restarts
    checkpoints: int = 0         # periodic engine snapshots written
    batch_fill: Counter = field(default_factory=Counter)
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)

    def summary(self) -> dict:
        out = {
            "submitted": self.submitted,
            "processed": self.processed,
            "drops": self.drops,
            "cancelled": self.cancelled,
            "ticks": self.ticks,
            "full_flushes": self.full_flushes,
            "deadline_flushes": self.deadline_flushes,
            "fastpath_flushes": self.fastpath_flushes,
            "drain_flushes": self.drain_flushes,
            "windows_scored": self.windows_scored,
            "rejected": self.rejected,
            "held": self.held,
            "sanitize_resets": self.sanitize_resets,
            "watchdog_resets": self.watchdog_resets,
            "holddown_suppressed": self.holddown_suppressed,
            "callback_errors": self.callback_errors,
            "engine_errors": self.engine_errors,
            "scheduler_restarts": self.scheduler_restarts,
            "checkpoints": self.checkpoints,
            "batch_fill": dict(sorted(self.batch_fill.items())),
        }
        out.update(self.latency.summary("latency"))
        return out


@dataclass
class _Pending:
    stream_id: object
    chunk: np.ndarray  # (t, input_dim), owned copy
    t_enqueue: float


class StreamServer:
    """Deadline-coalescing continuous-batching front end for a
    ``StreamingAnomalyEngine`` (must be constructed with ``batch=1`` —
    the ``push_many`` pool shape).

    Scores are delivered per completed window, either through the
    ``on_score(stream_id, score)`` callback (invoked on the scheduler
    thread — keep it cheap) or, when no callback is given, accumulated
    for ``pop_scores()``.

    ``clock`` is injectable (seconds, monotonic) so deadline behaviour is
    testable without sleeping.
    """

    def __init__(
        self,
        engine,
        config: ServerConfig | None = None,
        *,
        on_score: Callable[[object, np.ndarray], None] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if getattr(engine, "batch", None) != 1:
            raise ValueError(
                "StreamServer coalesces independent B=1 streams; construct "
                "the engine with batch=1 "
                f"(got batch={getattr(engine, 'batch', None)})"
            )
        self.engine = engine
        self.config = config or ServerConfig()
        self.stats = ServerStats()
        self._on_score = on_score
        self._clock = clock
        self._input_dim = engine.cfg.input_dim

        self._health: HealthConfig | None = self.config.health

        self._cond = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._stopping = False
        self._drain_on_stop = True
        self._thread: threading.Thread | None = None
        # fault-tolerance state: streams of the batch currently inside the
        # engine (and the subset closed/reset while it was in flight, whose
        # slots must be re-dropped and scores suppressed), per-stream score
        # hold-down counters after a quarantine/watchdog reset, per-stream
        # error marks (pop_errors), and the scheduler heartbeat/supervisor
        self._inflight: set = set()
        self._closed_inflight: set = set()
        self._holddown: dict = {}
        self._errors: dict = {}
        self._heartbeat: float | None = None
        self._restarts = 0
        self._sup_thread: threading.Thread | None = None
        self._sup_stop = threading.Event()
        self._last_checkpoint: float | None = None
        # adaptive scheduler state: effective gather width (narrowed /
        # widened between ticks), per-bucket arrival estimators, and the
        # queue depth at the end of the previous tick (the engine-
        # bottleneck signal: depth growing across ticks means arrivals
        # outpace service)
        self._width = self.config.max_coalesce
        self._est: dict[int, ArrivalRateEstimator] = {}
        self._last_depth = 0
        # the engine is single-caller by design: one lock serializes the
        # scheduler's push_many against close_stream/drain from other threads
        self._engine_lock = threading.Lock()
        self._results_lock = threading.Lock()
        self._results: dict = {}
        # identity-only pad stream ids: can never collide with user ids
        self._pad_ids = [object() for _ in range(POOL_STEP - 1)]

    # -- producer side -------------------------------------------------------

    def submit(self, stream_id, chunk: np.ndarray) -> None:
        """Enqueue one chunk for ``stream_id`` (thread-safe).

        ``chunk``: (t, input_dim) with t >= 1 — or (1, t, input_dim), the
        engine's push shape, squeezed for convenience.  Shape, length and
        dtype are validated *here*, naming the stream — a bad chunk fails
        in the producer's own call, not as an opaque error from
        inside a coalesced batch on the scheduler thread.  The chunk is
        copied (producers may reuse their buffers).  When
        ``config.health`` enables sanitization, the chunk is screened for
        NaN/Inf/saturation before it can enter a batch and the configured
        quarantine policy (reject/hold/reset) is applied.  Never calls
        into the engine step; backpressure follows ``config.overflow``
        (``QueueFullError`` semantics unchanged by any health policy).
        """
        chunk = np.asarray(chunk)
        if chunk.ndim == 3 and chunk.shape[0] == 1:
            chunk = chunk[0]
        # dtype.kind beats two np.issubdtype calls on the per-chunk path
        # (f=float, i/u=int; bool/complex/str/object all screen out)
        if chunk.dtype.kind not in "fiu":
            raise ValueError(
                f"stream {stream_id!r}: chunk must be real-valued numeric, "
                f"got dtype {chunk.dtype} (shape {chunk.shape})"
            )
        if chunk.ndim != 2 or chunk.shape[0] < 1 or chunk.shape[1] != self._input_dim:
            raise ValueError(
                f"stream {stream_id!r}: chunk must be "
                f"(t, {self._input_dim}) with t >= 1, "
                f"got {np.asarray(chunk).shape}"
            )
        health = self._health
        if health is not None and health.sanitize != "off":
            reason = screen_chunk(chunk, health.saturation_limit)
            if reason is not None:
                self._quarantine(stream_id, reason)
                return
        item = _Pending(stream_id, np.array(chunk), self._clock())
        with self._cond:
            while len(self._queue) >= self.config.queue_capacity:
                if self.config.overflow == "error":
                    raise QueueFullError(
                        f"arrival queue full ({self.config.queue_capacity} "
                        "chunks pending)"
                    )
                if self.config.overflow == "drop_oldest":
                    self._queue.popleft()
                    self.stats.drops += 1
                    continue
                # block: wait for the scheduler to make space
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError(
                        "submit would block on a full queue but no scheduler "
                        "thread is running — start() the server, drain(), or "
                        "pick a non-blocking overflow policy"
                    )
                self._cond.wait()
            self._queue.append(item)
            self.stats.submitted += 1
            est = self._est.get(chunk.shape[0])
            if est is None:
                ad = self.config.adaptive
                est = self._est[chunk.shape[0]] = ArrivalRateEstimator(
                    alpha=ad.ewma_alpha if ad else 0.25,
                    idle_reset_factor=(
                        ad.idle_reset_factor if ad else 50.0
                    ),
                )
            est.observe(item.t_enqueue)
            self._cond.notify_all()

    def _quarantine(self, stream_id, reason: str) -> None:
        """Apply the configured sanitize policy to one screened-out chunk
        (the chunk itself is never enqueued)."""
        policy = self._health.sanitize
        if policy == "reject":
            with self._cond:
                self.stats.rejected += 1
            raise ChunkRejectedError(
                f"stream {stream_id!r}: chunk rejected — {reason}"
            )
        if policy == "hold":
            # skip the chunk, keep the stream's resident state frozen: the
            # stream's scores stay equal to a replay of its clean chunks
            with self._cond:
                self.stats.held += 1
            logger.warning(
                "stream %r: bad chunk held back (%s); resident state kept",
                stream_id, reason,
            )
            return
        # "reset": the glitch invalidates the stream's window in progress —
        # discard its pending chunks, zero its engine state, and hold down
        # the next holddown_windows scores while the state re-warms
        with self._cond:
            kept = deque(p for p in self._queue if p.stream_id != stream_id)
            self.stats.cancelled += len(self._queue) - len(kept)
            self._queue = kept
            self.stats.sanitize_resets += 1
            if self._health.holddown_windows:
                self._holddown[stream_id] = self._health.holddown_windows
            if stream_id in self._inflight:
                self._closed_inflight.add(stream_id)
            self._cond.notify_all()
        with self._engine_lock:
            self.engine.drop_stream(stream_id)
        logger.warning(
            "stream %r: bad chunk triggered state reset (%s); next %d "
            "window score(s) held down", stream_id, reason,
            self._health.holddown_windows,
        )

    def close_stream(self, stream_id) -> int:
        """Leave: discard the stream's pending chunks (returned as a
        count), release its engine slot and partial window.

        Safe against an in-flight batch: if the scheduler already
        gathered one of this stream's chunks, the slot ``push_many``
        re-creates is re-dropped when the batch completes and the
        stream's scores from that batch are not delivered — a drop can
        never leak stale ``(h, c)`` into a later rejoin.
        """
        with self._cond:
            kept = deque(p for p in self._queue if p.stream_id != stream_id)
            dropped = len(self._queue) - len(kept)
            self._queue = kept
            self.stats.cancelled += dropped
            self._holddown.pop(stream_id, None)
            if stream_id in self._inflight:
                self._closed_inflight.add(stream_id)
            self._cond.notify_all()
        with self._engine_lock:
            self.engine.drop_stream(stream_id)
        return dropped

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    def pop_scores(self) -> dict:
        """Scores accumulated since the last call (no ``on_score`` only):
        ``{stream_id: [(1,) score, ...]}`` in completion order."""
        with self._results_lock:
            out, self._results = self._results, {}
        return out

    def pop_errors(self) -> dict:
        """Per-stream error marks accumulated since the last call:
        ``{stream_id: [reason, ...]}``.  A stream lands here when its
        batch's engine step raised (the whole batch is error-marked and
        reset, not the whole server) or the post-step watchdog reset it;
        its queued chunks keep flowing — the mark is the signal that a
        window boundary was lost."""
        with self._results_lock:
            out, self._errors = self._errors, {}
        return out

    def _mark_errors(self, stream_ids, reason: str) -> None:
        with self._results_lock:
            for sid in stream_ids:
                self._errors.setdefault(sid, []).append(reason)

    # -- scheduler core (shared by thread and manual modes) ------------------

    @property
    def effective_coalesce(self) -> int:
        """The current gather width (== ``config.max_coalesce`` under the
        fixed policy; self-tuned between ticks under adaptive)."""
        return self._width

    def arrival_gap_us(self, chunk_len: int) -> float | None:
        """Estimated inter-arrival gap for one chunk-length bucket
        (``None`` until the bucket's EWMA has two in-burst samples)."""
        with self._cond:
            est = self._est.get(chunk_len)
            return est.gap_us if est is not None else None

    def _bucket_stats_locked(self) -> dict[int, tuple[int, float]]:
        """Per chunk-length bucket, over *stream heads* (call with
        ``_cond`` held): ``{chunk_len: (gatherable_fill, oldest_enqueue)}``.

        Only the head of each stream's FIFO is gatherable this tick, so
        fill counts distinct streams whose head chunk is in the bucket
        (a raw ``len(queue)`` overcounts one stream's backlog), and the
        deadline clock per bucket starts at its oldest gatherable head —
        a bucket parked behind a repeatedly-flushing head bucket keeps
        its own age and can never overstay unobserved.
        """
        heads: dict = {}
        for item in self._queue:
            heads.setdefault(item.stream_id, item)
        stats: dict[int, tuple[int, float]] = {}
        for item in heads.values():
            t = item.chunk.shape[0]
            fill, oldest = stats.get(t, (0, math.inf))
            stats[t] = (fill + 1, min(oldest, item.t_enqueue))
        return stats

    def _deadline_us_locked(self, t_bucket: int, fill: int,
                            n_joined: int) -> float:
        """The coalescing budget for one bucket right now.

        Fixed policy: the ``deadline_us`` constant.  Adaptive: predict
        the time for ``need`` more distinct streams to arrive from the
        bucket's EWMA inter-arrival gap; wait that long (within
        [min, max]_deadline_us) when the batch will plausibly fill, and
        only ``min_deadline_us`` when it cannot — waiting out a budget
        that cannot be filled is the pathology this policy removes.
        """
        ad = self.config.adaptive
        if ad is None:
            return self.config.deadline_us
        need = min(self._width, n_joined) - fill
        if need <= 0:
            return ad.min_deadline_us
        est = self._est.get(t_bucket)
        gap = est.gap_us if est is not None else None
        if gap is None:
            return ad.max_deadline_us  # cold bucket: conservative budget
        expected_fill_us = gap * need * ad.fill_headroom
        if expected_fill_us > ad.max_deadline_us:
            return ad.min_deadline_us
        return max(expected_fill_us, ad.min_deadline_us)

    def _decide_locked(self, now: float):
        """One scheduling decision (call with ``_cond`` held):
        ``(t_bucket, reason, None)`` to flush that bucket now, or
        ``(None, None, wait_us)`` to hold for up to ``wait_us``.

        Order: (1) the all-joined-pending fast path — when every stream
        the server knows about (resident in the engine or pending in the
        queue) already has a queued chunk, no amount of waiting can add
        a distinct stream to any batch, so flush the oldest bucket at
        once (this is the single-stream case in the extreme: one joined
        stream, one pending chunk, zero wait); (2) any bucket whose
        oldest gatherable chunk has outlived its deadline, oldest first;
        (3) any bucket already at the effective width; (4) wait for the
        tightest remaining budget.
        """
        if not self._queue:
            return None, None, None
        if len(self._queue) == 1:
            # lone-pending fast path: when the single queued chunk's stream
            # is the only stream the server knows about, no waiting can add
            # a distinct stream — skip the bucket-stats/set building that
            # otherwise dominates a lone stream's per-tick host cost
            item = self._queue[0]
            sid = item.stream_id
            if all(s == sid for s in self.engine.stream_ids):
                reason = "full" if self._width <= 1 else "fastpath"
                return item.chunk.shape[0], reason, None
        stats = self._bucket_stats_locked()
        pending_ids = {item.stream_id for item in self._queue}
        joined = set(self.engine.stream_ids) | pending_ids
        if all(sid in pending_ids for sid in joined):
            t = min(stats, key=lambda t: stats[t][1])
            reason = "full" if stats[t][0] >= self._width else "fastpath"
            return t, reason, None
        best_wait = math.inf
        exp_t, exp_oldest = None, math.inf
        full_t = None
        for t, (fill, oldest) in stats.items():
            if fill >= self._width:
                full_t = t if full_t is None else full_t
                continue
            deadline = self._deadline_us_locked(t, fill, len(joined))
            age_us = (now - oldest) * 1e6
            if age_us >= deadline:
                if oldest < exp_oldest:
                    exp_t, exp_oldest = t, oldest
            else:
                best_wait = min(best_wait, deadline - age_us)
        if exp_t is not None:
            return exp_t, "deadline", None
        if full_t is not None:
            return full_t, "full", None
        return None, None, best_wait

    def _gather_locked(self, t_bucket: int | None = None) -> list[_Pending]:
        """Pop the next coalescable batch (call with ``_cond`` held).

        ``t_bucket`` picks the chunk-length bucket (default: the head
        item's).  Walking head to tail, take at most one pending chunk
        per stream and only chunks of the bucket's length; once a stream
        has been taken *or skipped*, all its later chunks stay queued
        (per-stream FIFO order is what the bit-equality contract rides
        on).  Stops at the effective width.
        """
        if not self._queue:
            return []
        if t_bucket is None:
            t_bucket = self._queue[0].chunk.shape[0]
        batch: list[_Pending] = []
        leftovers: deque[_Pending] = deque()
        seen: set = set()
        for item in self._queue:
            sid = item.stream_id
            if (
                len(batch) < self._width
                and sid not in seen
                and item.chunk.shape[0] == t_bucket
            ):
                batch.append(item)
            else:
                leftovers.append(item)
            seen.add(sid)
        self._queue = leftovers
        return batch

    def _fire(self, batch: list[_Pending], reason: str) -> None:
        """One scheduler tick: gathered batch -> one ``push_many`` call.

        Fault isolation happens here, per batch: an engine-step exception
        error-marks and resets *this batch's* streams (the server keeps
        serving everyone else), the post-step watchdog auto-resets any
        stream whose resident state came out non-finite/exploded, streams
        closed while the batch was in flight get their recreated slots
        re-dropped and their scores suppressed, and a raising ``on_score``
        callback is counted + logged instead of killing the scheduler
        thread.
        """
        ids = [p.stream_id for p in batch]
        if len(batch) == 1:
            # lone-stream fast path: a view, not a copy — push_many copies
            # each piece before the slot keeps a reference
            chunks = batch[0].chunk[None]
        else:
            chunks = np.stack([p.chunk for p in batch])  # (N, t, input_dim)
        n_real = len(ids)
        n_pad = 0
        if self.config.pad_to_sublanes:
            n_pad = _pad_width(n_real) - n_real
        if n_pad:
            ids = ids + self._pad_ids[:n_pad]
            chunks = np.concatenate(
                [chunks, np.zeros((n_pad,) + chunks.shape[1:], chunks.dtype)]
            )
        health = self._health
        step_error: str | None = None
        bad_state: set = set()
        with self._engine_lock:
            try:
                res = self.engine.push_many(ids, chunks)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                # one bad batch must not take the server down: reset every
                # stream in it (their state may be absent or half-advanced)
                # and error-mark them; everyone else is untouched
                logger.exception(
                    "engine step failed for a batch of %d stream(s)", n_real
                )
                step_error = f"engine step failed: {type(e).__name__}: {e}"
                res = None
                for sid in ids:
                    self.engine.drop_stream(sid)
            else:
                for pid in self._pad_ids[:n_pad]:
                    # pad slots are throwaway: dropping re-zeroes on next
                    # use, so pad rows never accumulate fill across ticks
                    self.engine.drop_stream(pid)
                if health is not None and health.watchdog:
                    # post-step numeric watchdog: a stream whose (h, c)
                    # came out non-finite or exploded is already poisoned —
                    # every later score would be garbage.  Auto-reset it
                    # (fresh zero state next chunk) and suppress this
                    # tick's scores for it.
                    absmax = self.engine.state_absmax(
                        [p.stream_id for p in batch]
                    )
                    for p, m in zip(batch, absmax):
                        if not m <= health.state_limit:
                            bad_state.add(p.stream_id)
                            self.engine.drop_stream(p.stream_id)
            # the closed-in-flight set must be read (and the recreated
            # slots re-dropped) before the engine lock is released: a
            # close_stream that completed *before* push_many started
            # already dropped its slot once, and push_many just recreated
            # it — leaking stale (h, c) into any rejoin.  (Taking _cond
            # inside _engine_lock is safe: no code path holds _cond while
            # acquiring the engine lock.)
            with self._cond:
                closed = set(self._closed_inflight)
                self._inflight = set()
                self._closed_inflight = set()
            for sid in closed:
                self.engine.drop_stream(sid)
        done = self._clock()

        if step_error is not None:
            self._mark_errors([p.stream_id for p in batch], step_error)
            with self._cond:
                self.stats.ticks += 1
                self.stats.engine_errors += 1
                if health is not None and health.holddown_windows:
                    for p in batch:
                        self._holddown[p.stream_id] = health.holddown_windows
                self._cond.notify_all()  # wake blocked producers
            return
        if bad_state:
            self._mark_errors(
                sorted(bad_state, key=str),
                f"state watchdog reset (|h,c| exceeded "
                f"{health.state_limit:g} or went non-finite)",
            )

        n_windows = sum(len(res[p.stream_id]) for p in batch)
        with self._cond:
            st = self.stats
            st.ticks += 1
            st.processed += n_real
            st.windows_scored += n_windows
            st.batch_fill[n_real] += 1
            st.watchdog_resets += len(bad_state)
            if bad_state and health is not None and health.holddown_windows:
                for sid in bad_state:
                    self._holddown[sid] = health.holddown_windows
            if reason == "full" or n_real >= self._width:
                st.full_flushes += 1
            elif reason == "deadline":
                st.deadline_flushes += 1
            elif reason == "fastpath":
                st.fastpath_flushes += 1
            else:
                st.drain_flushes += 1
            for p in batch:
                st.latency.record((done - p.t_enqueue) * 1e6)
            ad = self.config.adaptive
            if ad is not None:
                # self-tune the effective width between ticks: a queue
                # depth that *grew* across a tick means the engine is the
                # bottleneck — halve the tick so no chunk queues behind
                # an oversized one (bounding the p99 tail); full batches
                # with remaining backlog mean arrivals are rich — widen
                # back toward the configured cap
                depth_now = len(self._queue)
                if depth_now > self._last_depth and self._width > max(
                    1, min(ad.min_coalesce, self.config.max_coalesce)
                ):
                    self._width = max(
                        1,
                        min(ad.min_coalesce, self.config.max_coalesce),
                        self._width // 2,
                    )
                elif (
                    n_real >= self._width
                    and depth_now >= self._width
                    and self._width < self.config.max_coalesce
                ):
                    self._width = min(
                        self.config.max_coalesce, self._width * 2
                    )
                self._last_depth = depth_now
            self._cond.notify_all()  # wake blocked producers

        for p in batch:
            sid = p.stream_id
            if sid in closed or sid in bad_state:
                # closed/reset while in flight, or poisoned: these scores
                # belong to a stream that no longer exists in that lineage
                continue
            scores = res[sid]
            if scores and sid in self._holddown:
                # post-reset hold-down: the state is still re-warming, so
                # the first window score(s) after a reset are withheld
                with self._cond:
                    hold = self._holddown.get(sid, 0)
                    drop = min(hold, len(scores))
                    if drop:
                        self.stats.holddown_suppressed += drop
                    if hold - drop > 0:
                        self._holddown[sid] = hold - drop
                    else:
                        self._holddown.pop(sid, None)
                scores = scores[drop:]
            if not scores:
                continue
            if self._on_score is not None:
                for s in scores:
                    try:
                        self._on_score(sid, s)
                    except Exception:  # noqa: BLE001 — isolation boundary
                        # a raising user callback must never kill the
                        # scheduler thread: counted + logged
                        logger.exception(
                            "on_score callback raised for stream %r", sid
                        )
                        with self._cond:
                            self.stats.callback_errors += 1
            else:
                with self._results_lock:
                    self._results.setdefault(sid, []).extend(scores)

    # -- manual drive (tests) -----------------------------------------------

    def tick(self, force: bool = False) -> int:
        """Run one scheduler decision synchronously; returns the number of
        chunks processed (0 = nothing ready).  ``force=False`` applies the
        real policy (flush on a full batch, an expired per-bucket
        deadline, or the all-joined-pending fast path); ``force=True``
        flushes whatever is pending (drain semantics)."""
        with self._cond:
            now = self._clock()
            self._heartbeat = now
            if not self._queue:
                return 0
            if force:
                t_bucket, reason = None, "drain"
            else:
                t_bucket, reason, _ = self._decide_locked(now)
                if t_bucket is None:
                    return 0
            batch = self._gather_locked(t_bucket)
            self._inflight = {p.stream_id for p in batch}
            self._closed_inflight = set()
        if not batch:
            return 0
        self._fire(batch, reason)
        return len(batch)

    def drain(self) -> int:
        """Process everything pending now (manual mode / after stop)."""
        total = 0
        while True:
            n = self.tick(force=True)
            if n == 0:
                return total
            total += n

    # -- health / checkpointing ----------------------------------------------

    def heartbeat_age_s(self) -> float | None:
        """Seconds since the scheduler last proved liveness (``None``
        before the first tick / in manual mode before any ``tick()``)."""
        with self._cond:
            hb = self._heartbeat
        return None if hb is None else max(0.0, self._clock() - hb)

    def healthy(self) -> bool:
        """Liveness check: the scheduler thread is running (or the server
        is in manual mode) and, when ``health.heartbeat_timeout_s`` is
        configured, its heartbeat is fresh.  A wedged engine call cannot
        be killed from Python — but it *can* be detected here (and
        ``stop``'s deadline keeps it from hanging shutdown)."""
        thread = self._thread
        if thread is None:
            return True  # manual / unstarted mode: nothing to supervise
        if not thread.is_alive():
            return False
        health = self._health
        if health is None:
            return True
        age = self.heartbeat_age_s()
        return age is None or age <= health.heartbeat_timeout_s

    def checkpoint(self, path: str | None = None) -> str:
        """Snapshot the engine (every stream's state, partial windows,
        threshold) to ``path`` — default ``health.checkpoint_path`` —
        atomically, and count it.  Chunks still waiting in the arrival
        queue are *not* part of the snapshot: a checkpoint captures the
        engine-resident lineage; un-gathered chunks belong to producers
        and must be re-submitted after ``restart_from``."""
        if path is None:
            health = self._health
            path = health.checkpoint_path if health is not None else None
        if path is None:
            raise ValueError(
                "no checkpoint path: pass one explicitly or set "
                "HealthConfig.checkpoint_path"
            )
        with self._engine_lock:
            self.engine.save_snapshot(path)
        with self._cond:
            self.stats.checkpoints += 1
        return path

    def _maybe_checkpoint(self) -> None:
        """Periodic checkpointing on the scheduler thread (both knobs must
        be set); a failing write is logged, never fatal."""
        health = self._health
        if (
            health is None
            or health.checkpoint_interval_s is None
            or health.checkpoint_path is None
        ):
            return
        now = self._clock()
        if (
            self._last_checkpoint is not None
            and now - self._last_checkpoint < health.checkpoint_interval_s
        ):
            return
        self._last_checkpoint = now
        try:
            self.checkpoint()
        except Exception:  # noqa: BLE001 — isolation boundary
            logger.exception("periodic checkpoint failed")

    @classmethod
    def restart_from(
        cls, path, engine, config: ServerConfig | None = None, **kw
    ) -> "StreamServer":
        """Resume serving from a checkpoint: restore ``engine`` from the
        snapshot at ``path`` (version + fingerprint gated) and wrap it in
        a fresh server.  Every stream in the snapshot resumes bit-equal
        to an uninterrupted run; the old server's arrival queue is not
        part of the snapshot (producers re-submit un-scored chunks)."""
        engine.restore(path)
        return cls(engine, config, **kw)

    # -- threaded drive ------------------------------------------------------

    def start(self) -> "StreamServer":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("scheduler thread already running")
        self._stopping = False
        self._restarts = 0
        self._sup_stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="stream-server", daemon=True
        )
        self._thread.start()
        health = self._health
        if health is not None and health.supervise:
            self._sup_thread = threading.Thread(
                target=self._supervise_loop,
                name="stream-server-supervisor",
                daemon=True,
            )
            self._sup_thread.start()
        return self

    def stop(self, drain: bool = True, deadline_s: float | None = None) -> bool:
        """Stop the scheduler thread; ``drain=True`` (default) processes
        every pending chunk first, ``False`` abandons the queue.

        ``deadline_s`` (default ``health.drain_deadline_s``; ``None``
        waits forever) bounds the wait: a wedged engine step cannot hang
        shutdown past it.  Returns True when the scheduler exited cleanly
        within the deadline; False when it was abandoned (the daemon
        thread is left behind — it cannot be killed — and the remaining
        queue is cancelled)."""
        if deadline_s is None and self._health is not None:
            deadline_s = self._health.drain_deadline_s
        self._sup_stop.set()
        with self._cond:
            self._stopping = True
            self._drain_on_stop = drain
            self._cond.notify_all()
        if self._sup_thread is not None:
            self._sup_thread.join()
            self._sup_thread = None
        clean = True
        if self._thread is not None:
            self._thread.join(deadline_s)
            if self._thread.is_alive():
                clean = False
                logger.error(
                    "scheduler thread did not exit within the %.3fs stop "
                    "deadline (wedged engine step?); abandoning it",
                    deadline_s,
                )
            else:
                self._thread = None
        if not drain or not clean:
            with self._cond:
                self.stats.cancelled += len(self._queue)
                self._queue.clear()
        return clean

    def __enter__(self) -> "StreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    def _run(self) -> None:
        """Thread target: ``_loop`` behind a crash boundary.  Per-batch
        faults are already isolated inside ``_fire``; anything that still
        escapes (a scheduler bug, not a stream's fault) is logged and
        ends the thread — the supervisor, when enabled, restarts it."""
        try:
            self._loop()
        except Exception:  # noqa: BLE001 — crash boundary
            logger.exception("scheduler thread crashed")

    def _supervise_loop(self) -> None:
        interval = self._health.supervise_interval_s
        while not self._sup_stop.wait(interval):
            self._supervise_once()

    def _supervise_once(self) -> bool:
        """One supervision pass (extracted so tests can drive it without
        the poll cadence): if the scheduler thread died, restart it after
        bounded exponential backoff — ``restart_backoff_s`` doubling per
        restart up to ``max_backoff_s``, at most ``max_restarts`` times.
        Returns True iff a restart was performed."""
        health = self._health
        with self._cond:
            if self._stopping:
                return False
            thread = self._thread
            if thread is None or thread.is_alive():
                return False
            if self._restarts >= health.max_restarts:
                return False
            self._restarts += 1
            n = self._restarts
            self.stats.scheduler_restarts += 1
        backoff = min(
            health.restart_backoff_s * (2 ** (n - 1)), health.max_backoff_s
        )
        if self._sup_stop.wait(backoff):
            return False  # stop() raced the backoff
        with self._cond:
            if self._stopping:
                return False
            logger.warning(
                "scheduler thread died; supervised restart %d/%d",
                n, health.max_restarts,
            )
            self._thread = threading.Thread(
                target=self._run, name="stream-server", daemon=True
            )
            self._thread.start()
        return True

    def _loop(self) -> None:
        # while idle with health configured, wake periodically so the
        # heartbeat stays fresh (an idle scheduler is healthy, not wedged)
        health = self._health
        idle_wait = (
            health.heartbeat_timeout_s / 4.0 if health is not None else None
        )
        while True:
            with self._cond:
                self._heartbeat = self._clock()
                while not self._queue and not self._stopping:
                    self._cond.wait(idle_wait)
                    self._heartbeat = self._clock()
                if self._stopping and not (self._drain_on_stop and self._queue):
                    return
                t_bucket, reason = None, "drain"
                if not self._stopping:
                    # apply the policy, sleeping only as long as the
                    # tightest remaining per-bucket budget (new submits
                    # notify and re-decide)
                    while not self._stopping and self._queue:
                        t_bucket, reason, wait_us = self._decide_locked(
                            self._clock()
                        )
                        if t_bucket is not None:
                            break
                        self._cond.wait(
                            wait_us * 1e-6
                            if wait_us is not None and math.isfinite(wait_us)
                            else idle_wait
                        )
                        self._heartbeat = self._clock()
                    if not self._queue:
                        continue
                    if t_bucket is None:  # stop raced the wait: drain
                        reason = "drain"
                batch = self._gather_locked(t_bucket)
                self._inflight = {p.stream_id for p in batch}
                self._closed_inflight = set()
            if batch:
                self._fire(batch, reason)
                self._maybe_checkpoint()
