"""Analytic initiation-interval / resource model — paper Eqs. (1)-(7).

This module is the *faithful* reproduction of the paper's performance model for
multi-layer LSTM inference on FPGAs (Que et al., ASAP 2021):

    Eq. (1)  II_N     = ii_N * TS                      (with HLS `rewind`)
    Eq. (2)  II_sys   = max(II_0, ..., II_N)
    Eq. (3)  DSP_layer = 4*Lx*Lh/R_x + 4*Lh^2/R_h + 4*Lh
    Eq. (4)  sum(DSP_layer) <= DSP_total
    Eq. (5)  LT_mvm   = LT_mult + (R - 1) * II_mult,   II_mult = 1
    Eq. (6)  II_sublayer = LT_mvm_x = LT_mvm_h + LT_sigma + LT_tail
    Eq. (7)  R_x      = R_h + LT_sigma + LT_tail

Calibration against the paper's Table II (validated in tests/test_ii_model.py):

    Zynq 7045 @100 MHz : LT_mult = 1, LT_sigma = 3, LT_tail = 5
    U250      @300 MHz : LT_mult = 4, LT_sigma = 3, LT_tail = 5

With these constants the model reproduces ii_layer for Z1/Z2/Z3/U1/U2 exactly and
DSP usage for all six designs within <= 4 % (the residual is Vivado replacing
multipliers-by-simple-constant with adders, documented in the paper).

All quantities are clock cycles / DSP counts, pure Python (a copy of the JAX
package's ``core/ii_model.py``: FPGA models have no device constants) — this
layer is the design-space model the balancing solver (`balance.py`)
optimizes over, and the same min-max structure is re-targeted to GPU cost
terms in `stage_balance.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Sequence


@dataclass(frozen=True)
class HlsConstants:
    """Device/toolchain latency constants (cycles). See module docstring."""

    lt_mult: int = 1      # latency of one pipelined multiplier
    ii_mult: int = 1      # initiation interval of a multiplier (paper: 1)
    lt_sigma: int = 3     # sigmoid LUT latency      (paper Fig. 8 uses 3)
    lt_tail: int = 5      # element-wise tail latency (paper Fig. 8 uses 5)

    @property
    def sublayer_gap(self) -> int:
        """R_x - R_h for balanced sub-layers — Eq. (7)."""
        return self.lt_sigma + self.lt_tail


ZYNQ_7045 = HlsConstants(lt_mult=1)
U250 = HlsConstants(lt_mult=4)

#: Total DSP slices per device (paper Table II header row).
DSP_TOTAL = {"zynq7045": 900, "u250": 12288}


@dataclass(frozen=True)
class LstmLayerDims:
    """Dimensions of one LSTM layer: Lx inputs, Lh hidden units."""

    lx: int
    lh: int

    def __post_init__(self) -> None:
        if self.lx < 1 or self.lh < 1:
            raise ValueError(f"invalid LSTM dims {self}")


@dataclass(frozen=True)
class DenseLayerDims:
    """A (TimeDistributed) dense layer: n_in -> n_out multipliers."""

    n_in: int
    n_out: int = 1


@dataclass(frozen=True)
class ReuseFactors:
    """Per-layer reuse factors. R >= 1; R = 1 is fully unrolled."""

    r_x: int
    r_h: int
    r_t: int = 1  # tail reuse; paper fixes R_t = 1 (tail is cheap)

    def __post_init__(self) -> None:
        if min(self.r_x, self.r_h, self.r_t) < 1:
            raise ValueError(f"reuse factors must be >= 1, got {self}")


# ---------------------------------------------------------------------------
# Eq. (3): resource usage
# ---------------------------------------------------------------------------

def dsp_lstm_layer(dims: LstmLayerDims, rf: ReuseFactors) -> int:
    """DSP multipliers for one LSTM layer — Eq. (3).

    The tail term is ``4*Lh`` (not ``4*Lh/R_t``) because the paper keeps R_t=1
    and the cell state is 32-bit so ``f_t*c_{t-1}`` costs two DSPs per lane:
    4*Lh = 2*Lh (two 32-bit mults in the tail: f*c and o*tanh(c)... the paper
    counts 4*Lh total for the tail unit).
    """
    mvm_x = math.ceil(4 * dims.lx * dims.lh / rf.r_x)
    mvm_h = math.ceil(4 * dims.lh * dims.lh / rf.r_h)
    tail = math.ceil(4 * dims.lh / rf.r_t)
    return mvm_x + mvm_h + tail


def dsp_dense_layer(dims: DenseLayerDims, r: int = 1) -> int:
    """Multipliers for a TimeDistributed dense layer (n_in*n_out MACs)."""
    return math.ceil(dims.n_in * dims.n_out / r)


# ---------------------------------------------------------------------------
# Eq. (5)/(6): latency of the two sub-layers
# ---------------------------------------------------------------------------

def lt_mvm(r: int, c: HlsConstants) -> int:
    """Latency of one (serialized) MVM — Eq. (5)."""
    return c.lt_mult + (r - 1) * c.ii_mult


def ii_recurrent_sublayer(rf: ReuseFactors, c: HlsConstants) -> int:
    """Timestep-loop II of the recurrent sub-layer (mvm_h + sigma + tail).

    This is the loop-carried dependency path: h_{t-1} -> mvm_h -> gates ->
    tail -> h_t, so ii = LT_mvm_h + LT_sigma + LT_tail (paper Sec. III-C).
    """
    return lt_mvm(rf.r_h, c) + c.lt_sigma + c.lt_tail


def ii_mvmx_sublayer(rf: ReuseFactors, c: HlsConstants) -> int:
    """II of the non-recurrent mvm_x sub-layer (it pipelines at LT_mvm_x)."""
    return lt_mvm(rf.r_x, c)


def ii_layer(rf: ReuseFactors, c: HlsConstants) -> int:
    """Timestep-loop II of a full LSTM layer = max of its two sub-layers.

    With balanced sub-layers (Eq. 7) both terms are equal and the mvm_x
    hardware is exactly shadowed by the recurrent path.
    """
    return max(ii_recurrent_sublayer(rf, c), ii_mvmx_sublayer(rf, c))


def balanced_r_x(r_h: int, c: HlsConstants) -> int:
    """Eq. (7): the largest (cheapest) R_x that does not increase layer II."""
    return r_h + c.sublayer_gap


# ---------------------------------------------------------------------------
# Eq. (1)/(2): layer and system II; wavefront latency model (Fig. 7)
# ---------------------------------------------------------------------------

def layer_ii_cycles(rf: ReuseFactors, c: HlsConstants, timesteps: int) -> int:
    """Eq. (1): II_N = ii_N * TS (rewind eliminates the drain term)."""
    return ii_layer(rf, c) * timesteps


def system_ii_cycles(
    rfs: Sequence[ReuseFactors], c: HlsConstants, timesteps: int
) -> int:
    """Eq. (2): II_sys = max over layers."""
    return max(layer_ii_cycles(rf, c, timesteps) for rf in rfs)


@dataclass(frozen=True)
class Segment:
    """A run of cascaded LSTM layers with timestep overlap (paper Fig. 7).

    Within a segment, layer l+1 starts on h_t as soon as layer l emits it, so
    the segment finishes at ``II_first + sum(trailing ii of later layers)``
    (assuming non-increasing ii, which balanced designs guarantee).  Segment
    boundaries (e.g. the autoencoder's encoder->decoder latent bottleneck)
    are hard sync points: only the final hidden vector crosses, so the next
    segment cannot start until the previous one fully finishes.
    """

    reuse: tuple[ReuseFactors, ...]

    def latency_cycles(self, c: HlsConstants, timesteps: int) -> int:
        iis = [ii_layer(rf, c) for rf in self.reuse]
        lead = iis[0] * timesteps
        trail = sum(
            max(ii_l, 0) + c.lt_sigma + c.lt_tail  # pipeline fill of each layer
            for ii_l in iis[1:]
        )
        return lead + trail


def model_latency_cycles(
    segments: Sequence[Segment], c: HlsConstants, timesteps: int,
    dense_tail_cycles: int = 0,
) -> int:
    """End-to-end latency of a segmented (autoencoder-style) LSTM stack."""
    return sum(s.latency_cycles(c, timesteps) for s in segments) + dense_tail_cycles


def cycles_to_us(cycles: int, freq_mhz: float) -> float:
    return cycles / freq_mhz


# ---------------------------------------------------------------------------
# Whole-model description + evaluation (drives Table II / benchmarks)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LstmModelDims:
    """A multi-layer LSTM network + optional TimeDistributed dense head."""

    layers: tuple[LstmLayerDims, ...]
    dense: DenseLayerDims | None = None
    #: indices where a hard sync boundary sits *before* the layer (e.g. the
    #: decoder start in an autoencoder: only the last latent h crosses).
    segment_starts: tuple[int, ...] = (0,)

    @staticmethod
    def autoencoder(
        input_dim: int, hidden: Sequence[int], latent_boundary: int | None = None
    ) -> "LstmModelDims":
        """Build enc/dec stacked-LSTM dims, e.g. hidden=(32, 8, 8, 32).

        ``latent_boundary`` = index of the first decoder layer (default:
        len(hidden)//2).  The decoder's first layer consumes the latent.
        """
        if latent_boundary is None:
            latent_boundary = len(hidden) // 2
        dims, lx = [], input_dim
        for h in hidden:
            dims.append(LstmLayerDims(lx=lx, lh=h))
            lx = h
        return LstmModelDims(
            layers=tuple(dims),
            dense=DenseLayerDims(n_in=hidden[-1], n_out=input_dim),
            segment_starts=(0, latent_boundary),
        )


#: The two models evaluated in the paper (Sec. V-C); LIGO strain is 1-d input.
GW_SMALL = LstmModelDims.autoencoder(input_dim=1, hidden=(9, 9), latent_boundary=1)
GW_NOMINAL = LstmModelDims.autoencoder(input_dim=1, hidden=(32, 8, 8, 32))


@dataclass(frozen=True)
class DesignPoint:
    """A fully-specified design: per-layer reuse factors on a device."""

    model: LstmModelDims
    reuse: tuple[ReuseFactors, ...]
    constants: HlsConstants
    timesteps: int
    dense_reuse: int = 1

    def __post_init__(self) -> None:
        if len(self.reuse) != len(self.model.layers):
            raise ValueError("one ReuseFactors per LSTM layer required")

    # -- resources ----------------------------------------------------------
    def dsp_used(self) -> int:
        total = sum(
            dsp_lstm_layer(d, rf) for d, rf in zip(self.model.layers, self.reuse)
        )
        if self.model.dense is not None:
            total += dsp_dense_layer(self.model.dense, self.dense_reuse)
        return total

    def fits(self, dsp_total: int) -> bool:
        return self.dsp_used() <= dsp_total  # Eq. (4)

    # -- performance ---------------------------------------------------------
    def layer_iis(self) -> tuple[int, ...]:
        return tuple(ii_layer(rf, self.constants) for rf in self.reuse)

    def ii_sys_cycles(self) -> int:
        return system_ii_cycles(self.reuse, self.constants, self.timesteps)

    def latency_cycles(self) -> int:
        starts = list(self.model.segment_starts) + [len(self.model.layers)]
        segments = [
            Segment(tuple(self.reuse[a:b])) for a, b in zip(starts, starts[1:])
        ]
        dense_tail = 0
        if self.model.dense is not None:
            dense_tail = lt_mvm(self.dense_reuse, self.constants)
        return model_latency_cycles(
            segments, self.constants, self.timesteps, dense_tail
        )

    def latency_us(self, freq_mhz: float) -> float:
        return cycles_to_us(self.latency_cycles(), freq_mhz)

    def is_balanced(self) -> bool:
        """All layer IIs equal and every layer sub-layer-balanced (Eq. 6/7)."""
        iis = self.layer_iis()
        if len(set(iis)) != 1:
            return False
        return all(
            ii_mvmx_sublayer(rf, self.constants)
            <= ii_recurrent_sublayer(rf, self.constants)
            for rf in self.reuse
        )

    def summary(self) -> dict:
        return {
            "r_h": tuple(rf.r_h for rf in self.reuse),
            "r_x": tuple(rf.r_x for rf in self.reuse),
            "dsp": self.dsp_used(),
            "ii_layer": self.layer_iis(),
            "ii_sys_cycles": self.ii_sys_cycles(),
            "latency_cycles": self.latency_cycles(),
            "balanced": self.is_balanced(),
        }


def uniform_design(
    model: LstmModelDims,
    r: int,
    constants: HlsConstants,
    timesteps: int,
    balanced: bool = False,
) -> DesignPoint:
    """The paper's two families: naive (R_x = R_h = r, Fig. 8 red line) and
    balanced (R_h = r, R_x from Eq. 7, Fig. 8 blue line)."""
    rf = ReuseFactors(
        r_x=balanced_r_x(r, constants) if balanced else r, r_h=r
    )
    return DesignPoint(
        model=model,
        reuse=(rf,) * len(model.layers),
        constants=constants,
        timesteps=timesteps,
    )
