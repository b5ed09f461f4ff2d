"""GPU form of balanced-II: min-max pipeline-stage time under a device budget.

The paper balances per-layer initiation intervals by reallocating DSP
multipliers between layers (more parallelism = lower II).  Across GPUs the
resources are devices and the per-stage "II" is the roofline-modelled step
time

    T_stage(s, c) = max( flops_s / (c * PEAK_FLOPS),
                         bytes_s / (c * HBM_BW),
                         coll_bytes_s / (c * LINK_BW) )

so the same optimization becomes: (1) partition layers into contiguous stages
and (2) allocate devices per stage, minimizing ``max_s T_stage``.  Both
solvers are exact (DP + water-filling) and both are tested against brute
force.  The solvers and their semantics are the JAX package's
(``core/stage_balance.py``); only the constants below are the H100's.

``choose_mixed_split`` is the ``impl="mixed"`` plan balancer: it picks the
per-layer int8/fp32 storage split that equalizes the predicted cost of the
homogeneous segments, by default from the counts of the port's own kernels
(``autotune.model.segment_costs``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

# NVIDIA H100 SXM data sheet (dense rates, 700 W): bf16 tensor-core peak
# and HBM3 bandwidth; NVLink 4 gives 900 GB/s per GPU over 18 links, both
# directions, so 25 GB/s per link and direction.
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per device
HBM_BW = 3.35e12             # bytes/s per device
LINK_BW_PER_LINK = 25e9      # bytes/s per NVLink link and direction


@dataclass(frozen=True)
class StageCost:
    """Work of one pipeline stage (totals, before dividing across chips)."""

    flops: float
    bytes_hbm: float
    bytes_collective: float = 0.0

    def time_on(self, chips: int) -> float:
        """Roofline step time on ``chips`` chips (perfect intra-stage scaling)."""
        if chips < 1:
            return math.inf
        return max(
            self.flops / (chips * PEAK_FLOPS_BF16),
            self.bytes_hbm / (chips * HBM_BW),
            self.bytes_collective / (chips * LINK_BW_PER_LINK),
        )

    def __add__(self, other: "StageCost") -> "StageCost":
        return StageCost(
            self.flops + other.flops,
            self.bytes_hbm + other.bytes_hbm,
            self.bytes_collective + other.bytes_collective,
        )


ZERO_COST = StageCost(0.0, 0.0, 0.0)


def allocate_chips(stages: Sequence[StageCost], total_chips: int) -> list[int]:
    """Devices ("chips") per stage minimizing the max stage time (exact water-filling).

    Greedy is optimal here: stage time is non-increasing in chips, so giving
    the next chip to the current argmax stage can never hurt, and exchange
    arguments close the proof.  Every stage gets >= 1 chip.
    """
    n = len(stages)
    if total_chips < n:
        raise ValueError(f"need >= {n} chips for {n} stages, got {total_chips}")
    alloc = [1] * n
    for _ in range(total_chips - n):
        worst = max(range(n), key=lambda s: stages[s].time_on(alloc[s]))
        alloc[worst] += 1
    return alloc


def pipeline_ii(stages: Sequence[StageCost], alloc: Sequence[int]) -> float:
    """System II (seconds) of the pipeline = slowest stage (paper Eq. 2)."""
    return max(s.time_on(c) for s, c in zip(stages, alloc))


def partition_layers(
    layer_costs: Sequence[StageCost],
    n_stages: int,
    chips_per_stage: int = 1,
) -> list[tuple[int, int]]:
    """Contiguous layer->stage partition minimizing max stage time (exact DP).

    Classic linear-partition dynamic program over prefix sums; returns
    ``[(start, end), ...)`` half-open layer ranges per stage.
    """
    n = len(layer_costs)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages must be in [1, {n}], got {n_stages}")

    prefix = [ZERO_COST]
    for c in layer_costs:
        prefix.append(prefix[-1] + c)

    def cost(a: int, b: int) -> float:  # time of layers [a, b)
        seg = StageCost(
            prefix[b].flops - prefix[a].flops,
            prefix[b].bytes_hbm - prefix[a].bytes_hbm,
            prefix[b].bytes_collective - prefix[a].bytes_collective,
        )
        return seg.time_on(chips_per_stage)

    INF = math.inf
    # dp[k][i] = min over partitions of layers[:i] into k stages of max cost
    dp = [[INF] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for k in range(1, n_stages + 1):
        for i in range(k, n + 1):
            for j in range(k - 1, i):
                v = max(dp[k - 1][j], cost(j, i))
                if v < dp[k][i]:
                    dp[k][i] = v
                    cut[k][i] = j
    # reconstruct
    bounds, i = [], n
    for k in range(n_stages, 0, -1):
        j = cut[k][i]
        bounds.append((j, i))
        i = j
    return list(reversed(bounds))


@dataclass(frozen=True)
class PipelinePlan:
    """A solved pipeline: stage boundaries + chip allocation + achieved II."""

    stage_bounds: tuple[tuple[int, int], ...]
    chips: tuple[int, ...]
    ii_seconds: float
    stage_times: tuple[float, ...]

    @property
    def imbalance(self) -> float:
        """max/mean stage time — 1.0 is a perfectly balanced (seamless) pipeline."""
        return max(self.stage_times) / (sum(self.stage_times) / len(self.stage_times))


def plan_pipeline(
    layer_costs: Sequence[StageCost],
    n_stages: int,
    total_chips: int,
    balanced: bool = True,
) -> PipelinePlan:
    """End-to-end solve: partition layers, allocate chips, report the II.

    ``balanced=False`` reproduces the naive baseline the paper argues
    against: equal layer count per stage and equal chips per stage.
    """
    n = len(layer_costs)
    if balanced:
        bounds = partition_layers(layer_costs, n_stages)
    else:
        per = math.ceil(n / n_stages)
        bounds = [(i, min(i + per, n)) for i in range(0, n, per)]
        n_stages = len(bounds)

    stage_costs = []
    for a, b in bounds:
        acc = ZERO_COST
        for c in layer_costs[a:b]:
            acc = acc + c
        stage_costs.append(acc)

    if balanced:
        alloc = allocate_chips(stage_costs, total_chips)
    else:
        base = total_chips // n_stages
        alloc = [base] * n_stages
        alloc[-1] += total_chips - base * n_stages

    times = tuple(s.time_on(c) for s, c in zip(stage_costs, alloc))
    return PipelinePlan(
        stage_bounds=tuple(bounds),
        chips=tuple(alloc),
        ii_seconds=max(times),
        stage_times=times,
    )


# ---------------------------------------------------------------------------
# mixed-precision storage splits (the ``impl="mixed"`` plan balancer)
# ---------------------------------------------------------------------------

def candidate_splits(
    n_layers: int, dtypes: tuple[str, str] = ("int8", "fp32")
) -> tuple[tuple[str, ...], ...]:
    """All prefix assignments ``dtypes[0]^k + dtypes[1]^(n-k)``, k=0..n.

    The paper's heterogeneous-precision axis collapsed to one dimension:
    early layers (closest to the raw strain input, widest matmuls on the GW
    autoencoder) take the narrow storage, late layers keep full precision.
    Includes both homogeneous ends, so the balancer's choice can degrade
    gracefully to all-narrow or all-wide when the middle never wins.
    """
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    return tuple(
        (dtypes[0],) * k + (dtypes[1],) * (n_layers - k)
        for k in range(n_layers + 1)
    )


def segment_runs(dtypes: Sequence[str]) -> list[tuple[int, int]]:
    """Maximal equal-dtype runs of a per-layer assignment, as half-open
    ``[(start, end), ...]`` ranges — the segments a mixed plan executes."""
    bounds, start = [], 0
    for i in range(1, len(dtypes)):
        if dtypes[i] != dtypes[i - 1]:
            bounds.append((start, i))
            start = i
    bounds.append((start, len(dtypes)))
    return bounds


@dataclass(frozen=True)
class MixedSplitChoice:
    """The balancer's verdict: a per-layer dtype assignment + its scores."""

    dtypes: tuple[str, ...]
    #: prefix-split shorthand (count of leading narrow layers) when the
    #: assignment is a prefix split; None for arbitrary assignments
    split: int | None
    #: half-open layer ranges of the homogeneous segments
    segments: tuple[tuple[int, int], ...]
    #: predicted cost (us) per segment, in chain order
    segment_us: tuple[float, ...]
    max_us: float
    total_us: float
    #: (dtypes, max_us, total_us) per scored candidate — the audit trail
    #: ``launch/tune.py --balanced`` prints
    scored: tuple = ()


def _as_prefix_split(dtypes: Sequence[str]) -> int | None:
    runs = segment_runs(dtypes)
    if len(runs) == 1:
        return len(dtypes) if dtypes[0] == "int8" else 0
    if len(runs) == 2 and dtypes[0] == "int8" and dtypes[-1] == "fp32":
        return runs[0][1]
    return None


def choose_mixed_split(
    cfgs: Sequence,
    *,
    batch: int = 8,
    t_len: int = 8,
    candidates: Sequence[Sequence[str]] | None = None,
    cost_fn: Callable | None = None,
    fit=None,
) -> MixedSplitChoice:
    """Pick the per-layer storage split equalizing per-stage predicted cost.

    Scores each candidate assignment by segmenting it into maximal
    homogeneous runs and predicting each segment's serving-shaped step cost
    with the roofline model (``cost_fn(seg_cfgs, weight_dtype) -> us``;
    default: the step kernel's FLOP/byte counts via
    ``autotune.model.segment_costs`` fed through the fitted model when
    ``fit`` is given, else the H100's roofline floors).  The winner
    minimizes the max per-segment cost — the
    pipeline-II criterion of ``partition_layers``, applied to the storage
    axis — with total predicted cost then candidate order breaking ties,
    so the choice is deterministic.
    """
    cfgs = tuple(cfgs)
    if not cfgs:
        raise ValueError("choose_mixed_split needs at least one layer")
    if candidates is None:
        candidates = candidate_splits(len(cfgs))
    if cost_fn is None:
        def cost_fn(seg_cfgs, wd):  # noqa: F811 - documented default
            from repro_torch.autotune.model import predict_segment_us, segment_costs

            return predict_segment_us(
                segment_costs(seg_cfgs, wd, batch=batch, t_len=t_len),
                fit=fit,
            )

    best, scored = None, []
    for cand in candidates:
        cand = tuple(cand)
        if len(cand) != len(cfgs):
            raise ValueError(
                f"candidate {cand!r} has {len(cand)} entries for "
                f"{len(cfgs)} layers"
            )
        runs = segment_runs(cand)
        seg_us = tuple(
            float(cost_fn(cfgs[a:b], cand[a])) for a, b in runs
        )
        max_us, total_us = max(seg_us), sum(seg_us)
        scored.append((cand, max_us, total_us))
        key = (max_us, total_us)
        if best is None or key < best[0]:
            best = (key, cand, runs, seg_us)
    _, cand, runs, seg_us = best
    return MixedSplitChoice(
        dtypes=cand, split=_as_prefix_split(cand),
        segments=tuple(runs), segment_us=seg_us,
        max_us=max(seg_us), total_us=sum(seg_us),
        scored=tuple(scored),
    )


def lstm_layer_cost(
    lx: int, lh: int, batch: int, timesteps: int, bytes_per_el: int = 2
) -> StageCost:
    """Roofline work of one LSTM layer over a full sequence (both sub-layers)."""
    flops = 2.0 * 4 * (lx + lh) * lh * batch * timesteps + 10.0 * lh * batch * timesteps
    weight_bytes = 4 * (lx + lh) * lh * bytes_per_el
    act_bytes = (lx + lh) * batch * timesteps * bytes_per_el * 2
    return StageCost(flops=flops, bytes_hbm=weight_bytes + act_bytes)
