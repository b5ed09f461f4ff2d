"""Analytic roofline model fitted against measured sweep records.

The paper sizes its design against a resource model (DSPs, BRAM, II) and
checks the model against measured latency; the analogue here is the
classic roofline

    t(config) = c0 + sec_per_flop * FLOPs + sec_per_byte * bytes

with the FLOP and byte counts taken from the shapes of the port's own
kernels (``stack_kernel_costs``: the fused stack kernels K1 and K2 over a
packed stack) and the three coefficients fitted by non-negative least
squares over measured sweep records.  The fit reports predicted-vs-measured
relative error per record.

``HardwareModel`` carries the card's data-sheet constants (``H100_SXM``);
``roofline_terms_from_counts`` turns counts into per-resource time floors;
``predict_pack_bytes`` is the exact closed-form size of ``pack_stack``'s
packs.  ``chip_smoke.py``'s kernel bounds and the mixed-split balancer's
floors (``core.stage_balance``) both read ``stack_kernel_costs``, so the
two cannot count different work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


# ---------------------------------------------------------------------------
# hardware constants
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareModel:
    """Data-sheet constants of one accelerator (per device)."""

    name: str
    peak_flops: float          # FLOP/s (dense, the unit the kernels' arithmetic runs on)
    hbm_bw: float              # B/s device-memory streaming
    link_bw: float             # B/s per inter-device link and direction
    hbm_bytes: int = 80 * 10**9


#: NVIDIA H100 SXM (data sheet, 700 W): 67 TFLOP/s of fp32 on the CUDA cores,
#: the unit K1 and K2 compute on for every weight storage (their sums are
#: fp32 FMA chains); 3.35 TB/s of HBM3; NVLink 4 at 25 GB/s per link and
#: direction (900 GB/s over 18 links, both directions).  The bf16
#: tensor-core peak, 989 TFLOP/s, is ``core.stage_balance``'s.
H100_SXM = HardwareModel(name="h100_sxm", peak_flops=67e12, hbm_bw=3.35e12, link_bw=25e9)


def roofline_terms_from_counts(flops: float, hbm_bytes: float,
                               link_bytes: float = 0.0, *,
                               hw: HardwareModel = H100_SXM) -> dict:
    """Per-resource time floors (microseconds) and the binding resource.

    Each resource imposes an independent lower bound; the achievable
    latency is their max.  The one place counts become times.
    """
    t_compute = flops / hw.peak_flops * 1e6
    t_hbm = hbm_bytes / hw.hbm_bw * 1e6
    t_link = link_bytes / hw.link_bw * 1e6
    terms = {"compute": t_compute, "hbm": t_hbm, "link": t_link}
    bound = max(terms, key=terms.get)
    return {
        "t_compute_us": t_compute,
        "t_hbm_us": t_hbm,
        "t_link_us": t_link,
        "t_bound_us": terms[bound],
        "bound": bound,
    }


# ---------------------------------------------------------------------------
# FLOP/byte counts from the kernels' shapes
# ---------------------------------------------------------------------------

_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}


def stack_kernel_costs(n_layers: int, width: int, batch: int, t_len: int, *,
                       step: bool, weight_dtype: str = "fp32",
                       compute_bytes: int = 4) -> dict:
    """FLOPs and bytes of one launch of a fused stack kernel over a packed
    stack of ``n_layers`` layers at pack width ``width``: the step kernel
    K2 (``step=True``, the raw chunk in) or the wavefront kernel K1 (layer
    0's fp32 gate stream in).

    Bytes count each input read once and each output written once: the
    input (K2: the (B, T, W) chunk at the compute dtype; K1: the (T, B, 4W)
    fp32 gate stream), the packed weights (``w_x`` and ``w_h``, (L, W, 4W)
    at the storage dtype), the fp32 bias (L, 4W), an int8 pack's fp32
    scales (L, 2, 4), the state read and written (h at the compute dtype,
    c in fp32, (L, B, W) each), and the last layer's hidden sequence out
    (B, T, W) at the compute dtype.  FLOPs count 2 per multiply-add of the
    gate products (layer 0's input product only in K2: K1 receives it), 4
    per gate pre-activation element and 10 per cell element.
    """
    w4 = 4 * width
    x_in = batch * t_len * width * compute_bytes if step else t_len * batch * w4 * 4
    weights = 2 * n_layers * width * w4 * _ITEMSIZE[weight_dtype] + n_layers * w4 * 4
    if weight_dtype == "int8":
        weights += n_layers * 2 * 4 * 4
    state = 2 * n_layers * batch * width * (compute_bytes + 4)  # read and written
    h_out = batch * t_len * width * compute_bytes
    macs = t_len * batch * width * w4 * (2 * n_layers if step else 2 * n_layers - 1)
    flops = 2 * macs + t_len * batch * n_layers * (4 * w4 + 10 * width)
    return {"flops": float(flops), "bytes": float(x_in + weights + state + h_out)}


def _packed_segments(plan) -> list:
    """The homogeneous packed plans a plan launches kernels over."""
    if plan.backend.heterogeneous:
        return list(plan.segments)
    if not plan.backend.packs:
        raise ValueError(
            f"costs are counted from the fused stack kernels' shapes; impl={plan.impl!r} "
            "does not run them"
        )
    return [plan]


def config_costs(cfgs: Sequence, impl: str, *, batch: int = 8, t_len: int = 8,
                 weight_dtype=None, knobs: dict | None = None) -> dict:
    """FLOP/byte counts of the serving-shaped call of one configuration:
    for each packed segment of the resolved plan, K2 over (batch, t_len)
    where the chunked-step plan routes the chunk to it, else K1 (always
    K1 for ``fused_stack``), summed over a mixed plan's segments."""
    from repro_torch.core.executor import plan_stack
    from repro_torch.kernels.lstm_stack.ops import _pack_width

    plan = plan_stack(cfgs, impl=impl, weight_dtype=weight_dtype, **(knobs or {}))
    total = {"flops": 0.0, "bytes": 0.0}
    for seg in _packed_segments(plan):
        step = seg.backend.chunked_step and t_len <= seg.chunk_len
        costs = stack_kernel_costs(
            seg.n_layers, _pack_width(seg.cfgs), batch, t_len, step=step,
            weight_dtype=seg.weight_dtype,
            compute_bytes=seg.cfgs[0].dtype.itemsize,
        )
        for key in total:
            total[key] += costs[key]
    return total


def attach_costs(records: Sequence[dict]) -> list[dict]:
    """Attach ``costs`` (the counts of the measured call) to sweep records."""
    from repro_torch.core.lstm import LstmConfig

    out = []
    for rec in records:
        cfgs = [LstmConfig(in_dim=a, hidden=b) for a, b in rec["dims"]]
        costs = config_costs(cfgs, rec["impl"], batch=rec["batch"], t_len=rec["t_len"],
                             weight_dtype=rec.get("weight_dtype"),
                             knobs=rec.get("knobs") or {})
        out.append({**rec, "costs": costs})
    return out


#: (dims, weight_dtype, batch, t_len) -> costs: the mixed-split balancer
#: scores O(layers) candidate segments per plan and segments recur across
#: candidates, so each distinct segment is counted once per process
_SEGMENT_COST_MEMO: dict[tuple, dict] = {}


def segment_costs(cfgs: Sequence, weight_dtype: str | None, *,
                  batch: int = 8, t_len: int = 8) -> dict:
    """FLOP/byte counts of one homogeneous mixed-plan segment: the
    serving-shaped ``fused_step`` step, which is what the segment runs
    inside a mixed chain; memoised on geometry and storage."""
    key = (tuple((c.in_dim, c.hidden) for c in cfgs), weight_dtype, batch, t_len)
    if key not in _SEGMENT_COST_MEMO:
        _SEGMENT_COST_MEMO[key] = config_costs(
            list(cfgs), "fused_step", batch=batch, t_len=t_len, weight_dtype=weight_dtype,
        )
    return _SEGMENT_COST_MEMO[key]


def predict_segment_us(costs: dict, fit: "RooflineFit | None" = None) -> float:
    """Predicted segment time from its counts: the fitted model when there
    is one (``launch/tune.py --balanced`` passes the fresh fit), else the
    H100's roofline floors; deterministic either way."""
    if fit is not None:
        return fit.predict_us(costs["flops"], costs["bytes"])
    return roofline_terms_from_counts(costs["flops"], costs["bytes"])["t_bound_us"]


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RooflineFit:
    """Fitted coefficients and the fit's own report card.

    ``sec_per_flop``/``sec_per_byte`` are the fitted achieved rates (their
    reciprocals are the effective FLOP/s and B/s of these calls); ``c0``
    absorbs dispatch and launch overhead.  All three are non-negative.
    """

    c0: float
    sec_per_flop: float
    sec_per_byte: float
    n_records: int
    median_rel_err: float
    max_rel_err: float
    #: per-record (case, point, predicted_us, measured_us, rel_err)
    per_record: tuple = ()

    def predict_us(self, flops: float, nbytes: float) -> float:
        return (self.c0 + self.sec_per_flop * flops + self.sec_per_byte * nbytes) * 1e6

    def describe(self) -> str:
        eff_flops = 1.0 / self.sec_per_flop if self.sec_per_flop else float("inf")
        eff_bw = 1.0 / self.sec_per_byte if self.sec_per_byte else float("inf")
        return (
            f"roofline fit over {self.n_records} records: "
            f"c0={self.c0 * 1e6:.1f}us "
            f"eff_compute={eff_flops / 1e9:.2f}GFLOP/s "
            f"eff_bw={eff_bw / 1e9:.2f}GB/s "
            f"rel_err median={self.median_rel_err:.3f} "
            f"max={self.max_rel_err:.3f}"
        )


def _nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Tiny active-set non-negative least squares (3 columns): solve
    unconstrained, drop negative coefficients, re-solve over the surviving
    columns until all are >= 0."""
    active = list(range(A.shape[1]))
    x = np.zeros(A.shape[1])
    for _ in range(A.shape[1] + 1):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if np.all(sol >= -1e-18):
            x[:] = 0.0
            x[active] = np.maximum(sol, 0.0)
            return x
        active = [c for c, v in zip(active, sol) if v > 0]
    x[:] = 0.0
    if active:
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        x[active] = np.maximum(sol, 0.0)
    return x


def fit_roofline(records: Sequence[dict]) -> RooflineFit:
    """Fit t = c0 + sec_per_flop * flops + sec_per_byte * bytes over
    measured records (each needs ``us`` and ``costs``: run
    ``attach_costs`` first).  Rows are weighted by 1/measured, so fast and
    slow cases contribute comparable relative residuals."""
    rows = [r for r in records if r.get("costs") and r.get("us")]
    if not rows:
        raise ValueError(
            "no records with both timing and costs; run attach_costs on the sweep "
            "output first"
        )
    secs = np.array([r["us"] * 1e-6 for r in rows])
    A = np.array([[1.0, r["costs"]["flops"], r["costs"]["bytes"]] for r in rows])
    w = 1.0 / secs
    coef = _nnls(A * w[:, None], secs * w)
    pred = A @ coef
    rel = np.abs(pred - secs) / np.maximum(secs, 1e-12)
    per_record = tuple(
        (r.get("case", ""), r.get("point", ""), float(p * 1e6), float(r["us"]), float(e))
        for r, p, e in zip(rows, pred, rel)
    )
    return RooflineFit(
        c0=float(coef[0]), sec_per_flop=float(coef[1]), sec_per_byte=float(coef[2]),
        n_records=len(rows), median_rel_err=float(np.median(rel)),
        max_rel_err=float(np.max(rel)), per_record=per_record,
    )


# ---------------------------------------------------------------------------
# closed-form pack size
# ---------------------------------------------------------------------------

def predict_pack_bytes(cfgs: Sequence, weight_dtype: str | None = None) -> int:
    """Exact bytes a ``PackedStack`` of these configs occupies: ``w_x`` and
    ``w_h`` (L, W, 4W) at the storage dtype, the fp32 bias (L, 4W), and an
    int8 pack's (L, 2, 4) fp32 per-gate scales, at the pack width the
    kernels use (``_pack_width``)."""
    from repro_torch.kernels.lstm_stack.ops import _pack_width, resolve_weight_dtype

    if not cfgs:
        return 0
    wd = resolve_weight_dtype(cfgs[0], override=weight_dtype)
    n_layers, width = len(cfgs), _pack_width(cfgs)
    total = 2 * n_layers * width * 4 * width * _ITEMSIZE[wd] + n_layers * 4 * width * 4
    if wd == "int8":
        total += n_layers * 2 * 4 * 4
    return total
