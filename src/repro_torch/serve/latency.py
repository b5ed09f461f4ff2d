"""Fixed-bin microsecond latency histogram with percentile summaries.

Serving latency is a *distribution*, not a number: the paper's deployment
target is a fixed per-sample budget, and what decides whether a stream
server meets it is the tail (p99/max under load), not the mean.  Keeping
every raw sample alive to compute percentiles does not survive fleet
scale — a server scoring millions of chunks cannot append a float per
chunk — so latencies are recorded into a histogram with *geometrically
spaced* fixed bins: O(1) memory and O(1) record cost forever, with a
bounded relative quantile error (each bin spans a factor of
``2**(1/SUB_BINS)``, ~9% wide at the default 8 sub-bins per octave —
HDR-histogram-style resolution, plenty for p50/p99 serving rows).

One implementation serves every consumer: the ``StreamServer`` records
enqueue->score latency per chunk, and the ``launch/serve`` CLI summarizes
its per-window latencies through it.  Exact ``count/mean/min/max`` are
tracked on the side, so only interior percentiles are approximate.  This
is a copy of the reference's module (numpy only), kept equal to it: the
same gap sequences give the same estimates and percentiles.

This module also carries the server's other streaming statistic: the
``ArrivalRateEstimator``, an EWMA over inter-arrival gaps.  The
``StreamServer`` keeps one per chunk-length bucket (chunks are already
timestamped at ``submit``) and uses the estimated gap to *choose* its
coalescing deadline — the scheduling analogue of the paper's per-layer
reuse factors, matched to the work actually arriving instead of a global
constant.
"""

from __future__ import annotations

import math

import numpy as np

#: bins per octave (factor-of-2 span): relative quantile error <= 2**(1/8)-1
SUB_BINS = 8
#: smallest resolvable latency; everything below lands in bin 0
MIN_US = 1.0
#: largest distinct latency (~67 s); beyond this, one overflow bin
MAX_US = 2.0**26
#: total bin count (one per sub-octave step, plus under/overflow)
N_BINS = 26 * SUB_BINS + 2


def _bin_index(us: float) -> int:
    if us < MIN_US:
        return 0
    if us >= MAX_US:
        return N_BINS - 1
    return 1 + int(math.log2(us / MIN_US) * SUB_BINS)


def _bin_upper(idx: int) -> float:
    """Upper edge of bin ``idx`` — the value reported for a quantile that
    lands in it (conservative: never under-reports a latency)."""
    if idx <= 0:
        return MIN_US
    return MIN_US * 2.0 ** (idx / SUB_BINS)


class ArrivalRateEstimator:
    """EWMA over inter-arrival gaps (microseconds), idle-aware.

    Feed monotonic arrival timestamps (seconds, the ``StreamServer``
    clock) through ``observe``; read the smoothed gap via ``gap_us``.
    Three degenerate cases are first-class:

    * **first arrival** — primes the reference timestamp only; ``gap_us``
      stays ``None`` (there is no gap yet), so consumers never divide by
      zero on a cold bucket;
    * **simultaneous arrivals** — a zero gap is a legal observation (a
      burst submitted faster than the clock resolution); ``rate_hz``
      reports ``inf`` rather than dividing by it;
    * **silent-then-burst** — a gap longer than ``idle_reset_factor`` x
      the current estimate is an idle-period boundary, not a sample of
      the within-burst rate: the stale estimate is *discarded* (back to
      ``None``) and the next gap re-seeds it, so one long silence neither
      poisons the EWMA nor lingers after traffic resumes.

    >>> est = ArrivalRateEstimator(alpha=0.5)
    >>> est.observe(0.0); est.gap_us is None
    True
    >>> est.observe(100e-6); est.gap_us
    100.0
    """

    def __init__(self, alpha: float = 0.25, idle_reset_factor: float = 50.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if idle_reset_factor <= 1.0:
            raise ValueError(
                f"idle_reset_factor must be > 1, got {idle_reset_factor}"
            )
        self.alpha = alpha
        self.idle_reset_factor = idle_reset_factor
        self.observed = 0
        self._last_t: float | None = None
        self._gap_us: float | None = None

    def observe(self, t_s: float) -> None:
        """Record one arrival at monotonic time ``t_s`` (seconds)."""
        self.observed += 1
        if self._last_t is None:
            self._last_t = t_s
            return
        gap = max((t_s - self._last_t) * 1e6, 0.0)
        self._last_t = t_s
        if self._gap_us is None:
            self._gap_us = gap
        elif gap > self.idle_reset_factor * max(self._gap_us, 1.0):
            # idle boundary: silence says nothing about the burst rate
            self._gap_us = None
        elif self._gap_us > self.idle_reset_factor**2 * max(gap, 1.0):
            # the standing estimate was itself seeded across a silence
            # (e.g. the very first gap after server start): re-seed from
            # the in-burst gap instead of EWMA-decaying for many samples.
            # Squared factor: ordinary heavy-tailed arrival noise must
            # never trip this, only orders-of-magnitude idle artifacts.
            self._gap_us = gap
        else:
            self._gap_us += self.alpha * (gap - self._gap_us)

    @property
    def gap_us(self) -> float | None:
        """Smoothed inter-arrival gap; ``None`` until two arrivals have
        been seen in the current burst."""
        return self._gap_us

    @property
    def rate_hz(self) -> float | None:
        """Arrival rate implied by the gap (``None`` when unestimated)."""
        if self._gap_us is None:
            return None
        if self._gap_us == 0.0:
            return math.inf
        return 1e6 / self._gap_us

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self._gap_us is None:
            return f"ArrivalRateEstimator(n={self.observed}, unestimated)"
        return (
            f"ArrivalRateEstimator(n={self.observed}, "
            f"gap={self._gap_us:.1f}us)"
        )


class LatencyHistogram:
    """Streaming us-latency histogram: ``record`` samples, read percentiles.

    >>> h = LatencyHistogram()
    >>> for us in (120, 130, 5000): h.record(us)
    >>> h.count, h.max_us
    (3, 5000.0)
    >>> 100 < h.percentile(50) < 200
    True
    """

    def __init__(self):
        self._bins = np.zeros(N_BINS, dtype=np.int64)
        self.count = 0
        self.sum_us = 0.0
        self.min_us = math.inf
        self.max_us = 0.0

    def record(self, us: float) -> None:
        us = float(us)
        self._bins[_bin_index(us)] += 1
        self.count += 1
        self.sum_us += us
        self.min_us = min(self.min_us, us)
        self.max_us = max(self.max_us, us)

    def record_many(self, us_values) -> None:
        for us in np.asarray(us_values, dtype=np.float64).ravel():
            self.record(us)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` in (histograms from parallel servers add)."""
        self._bins += other._bins
        self.count += other.count
        self.sum_us += other.sum_us
        self.min_us = min(self.min_us, other.min_us)
        self.max_us = max(self.max_us, other.max_us)
        return self

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Latency at quantile ``q`` in [0, 100]; exact at the recorded
        extremes, within one bin (~9%) in the interior."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        if q == 0.0:
            return self.min_us
        rank = math.ceil(q / 100.0 * self.count)
        seen = 0
        for idx, n in enumerate(self._bins):
            seen += int(n)
            if seen >= rank:
                # the top bin holds the exact max; clamping every bin's
                # edge to it also keeps single-sample histograms exact
                return min(_bin_upper(idx), self.max_us)
        return self.max_us

    def summary(self, prefix: str = "") -> dict:
        """The serving row set: count/mean/p50/p90/p99/max (us)."""
        p = f"{prefix}." if prefix else ""
        return {
            f"{p}count": self.count,
            f"{p}mean_us": round(self.mean_us, 3),
            f"{p}p50_us": round(self.percentile(50), 3),
            f"{p}p90_us": round(self.percentile(90), 3),
            f"{p}p99_us": round(self.percentile(99), 3),
            f"{p}max_us": round(self.max_us, 3) if self.count else 0.0,
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if not self.count:
            return "LatencyHistogram(empty)"
        return (
            f"LatencyHistogram(n={self.count}, "
            f"p50={self.percentile(50):.0f}us, "
            f"p99={self.percentile(99):.0f}us, max={self.max_us:.0f}us)"
        )
