"""Design-space exploration: the paper's balanced-II solver (Sec. III-B/IV-B).

Given the dimensions of the LSTM layers and a resource budget, compute the
partitioning of FPGA resources (per-layer reuse factors) for a balanced
high-performance design.  "Our algorithm runs in seconds and produces a set of
reuse factors" — here it runs in microseconds because the structure collapses:

* For a target timestep-loop II ``ii``, the recurrent sub-layer constraint
  (Eq. 5/6) pins ``R_h = ii - (LT_mult + LT_sigma + LT_tail) + 1`` — identical
  for every layer since the constants are device-wide.
* The DSP-minimal ``R_x`` at that II is exactly the Eq.-7 balanced value
  ``R_h + LT_sigma + LT_tail`` (any larger would raise the layer II; any
  smaller wastes multipliers in the mvm_x shadow).  This makes "balanced"
  provably DSP-minimal at fixed II — the property behind Fig. 8's frontier
  shift and Table II's Z3/U2 designs.  (tests/test_balance.py checks this by
  brute force.)
* DSP(ii) is then monotonically non-increasing in ii, so the minimum
  achievable II under a budget is found by scanning ii upward (Eq. 3/4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

from .ii_model import (
    DesignPoint,
    HlsConstants,
    LstmModelDims,
    ReuseFactors,
    balanced_r_x,
    dsp_dense_layer,
    dsp_lstm_layer,
    ii_layer,
    uniform_design,
)


def min_ii_cycles(c: HlsConstants) -> int:
    """Smallest possible timestep-loop II (R_h = 1): the dependency floor."""
    return c.lt_mult + c.lt_sigma + c.lt_tail


def r_h_for_ii(ii: int, c: HlsConstants) -> int | None:
    """Invert Eq. (5)/(6): the R_h that realises timestep-loop II ``ii``."""
    r = ii - min_ii_cycles(c) + 1
    return r if r >= 1 else None


@dataclass(frozen=True)
class BalancedDesign:
    """Solver output: a balanced design + the budget it was solved for."""

    design: DesignPoint
    dsp_budget: int

    @property
    def ii(self) -> int:
        return self.design.layer_iis()[0]

    @property
    def dsp(self) -> int:
        return self.design.dsp_used()


def design_at_ii(
    model: LstmModelDims,
    ii: int,
    c: HlsConstants,
    timesteps: int,
    dense_reuse: int | None = None,
) -> DesignPoint | None:
    """The DSP-minimal design achieving timestep-loop II == ``ii`` (balanced)."""
    r_h = r_h_for_ii(ii, c)
    if r_h is None:
        return None
    rf = ReuseFactors(r_x=balanced_r_x(r_h, c), r_h=r_h)
    if dense_reuse is None:
        # the dense head pipelines at II = dense_reuse; keep it off the
        # critical path: serialize it up to the layer II.
        dense_reuse = max(1, ii - c.lt_mult + 1)
    return DesignPoint(
        model=model,
        reuse=(rf,) * len(model.layers),
        constants=c,
        timesteps=timesteps,
        dense_reuse=dense_reuse,
    )


def solve_min_ii(
    model: LstmModelDims,
    dsp_total: int,
    c: HlsConstants,
    timesteps: int,
    max_ii: int = 4096,
) -> BalancedDesign | None:
    """Minimum-latency balanced design under a DSP budget (the paper's DSE).

    Scans ii upward from the dependency floor; the first feasible design is
    optimal because DSP(ii) is non-increasing in ii.
    """
    for ii in range(min_ii_cycles(c), max_ii + 1):
        d = design_at_ii(model, ii, c, timesteps)
        if d is not None and d.fits(dsp_total):
            return BalancedDesign(design=d, dsp_budget=dsp_total)
    return None


def pareto_frontier(
    model: LstmModelDims,
    c: HlsConstants,
    timesteps: int,
    r_range: Sequence[int] = range(1, 11),
    balanced: bool = True,
) -> list[dict]:
    """(II, DSP) sweep — paper Fig. 8 (red line: balanced=False, blue: True)."""
    out = []
    for r in r_range:
        d = uniform_design(model, r, c, timesteps, balanced=balanced)
        out.append(
            {
                "r_h": r,
                "r_x": d.reuse[0].r_x,
                "ii": ii_layer(d.reuse[0], c),
                "dsp": d.dsp_used(),
                "balanced": balanced,
            }
        )
    return out


def dsp_saving_at_iso_ii(
    model: LstmModelDims, c: HlsConstants, timesteps: int, r_h: int = 1
) -> float:
    """Fractional DSP saving of balanced vs naive at identical II.

    This is the paper's headline "up to 42 %" (Fig. 8 point A -> point C):
    naive R_x = R_h vs balanced R_x = R_h + LT_sigma + LT_tail.
    """
    naive = uniform_design(model, r_h, c, timesteps, balanced=False)
    bal = uniform_design(model, r_h, c, timesteps, balanced=True)
    assert ii_layer(naive.reuse[0], c) == ii_layer(bal.reuse[0], c)
    return 1.0 - bal.dsp_used() / naive.dsp_used()


def enumerate_designs(
    model: LstmModelDims,
    c: HlsConstants,
    timesteps: int,
    r_h_range: Sequence[int],
    r_x_range: Sequence[int],
) -> Iterator[DesignPoint]:
    """Exhaustive (R_h, R_x) grid — used by tests to verify solver optimality."""
    for r_h in r_h_range:
        for r_x in r_x_range:
            yield DesignPoint(
                model=model,
                reuse=(ReuseFactors(r_x=r_x, r_h=r_h),) * len(model.layers),
                constants=c,
                timesteps=timesteps,
            )


def table2_designs(timesteps: int = 8) -> dict[str, DesignPoint]:
    """The six designs of paper Table II, reconstructed from its (R_h, R_x).

    Z* target the small autoencoder (2 LSTM layers, 9 hidden) on Zynq 7045
    @100 MHz; U* target the nominal GW autoencoder (32,8,8,32) on U250
    @300 MHz.  tests/test_ii_model.py asserts DSP/ii against the paper.
    """
    from .ii_model import GW_NOMINAL, GW_SMALL, U250, ZYNQ_7045

    def d(model, r_h, r_x, c):
        return DesignPoint(
            model=model,
            reuse=(ReuseFactors(r_x=r_x, r_h=r_h),) * len(model.layers),
            constants=c,
            timesteps=timesteps,
        )

    return {
        "Z1": d(GW_SMALL, 1, 1, ZYNQ_7045),
        "Z2": d(GW_SMALL, 2, 2, ZYNQ_7045),
        "Z3": d(GW_SMALL, 1, 9, ZYNQ_7045),
        "U1": d(GW_NOMINAL, 1, 1, U250),
        "U2": d(GW_NOMINAL, 1, 9, U250),
        "U3": d(GW_NOMINAL, 4, 12, U250),
    }


#: Paper Table II reference values (measured post-HLS), for benchmark display
#: and tolerance tests.  DSP deviates <= ~4 % from Eq. (3) (tool constant-
#: folding); ii matches the model exactly except U3 (routing, see paper).
TABLE2_PAPER = {
    "Z1": {"dsp": 1058, "ii": 9, "r_h": 1, "r_x": 1},
    "Z2": {"dsp": 578, "ii": 10, "r_h": 2, "r_x": 2},
    "Z3": {"dsp": 744, "ii": 9, "r_h": 1, "r_x": 9},
    "U1": {"dsp": 11123, "ii": 12, "r_h": 1, "r_x": 1},
    "U2": {"dsp": 9021, "ii": 12, "r_h": 1, "r_x": 9},
    "U3": {"dsp": 2713, "ii": 13, "r_h": 4, "r_x": 12},
}
