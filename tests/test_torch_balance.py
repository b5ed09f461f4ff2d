"""The port's planners against the reference's: the FPGA II/DSP model
(``core/ii_model.py``), the balanced-II solver (``core/balance.py``) and the
stage balancer (``core/stage_balance.py``).

``ii_model`` and ``balance`` are pure Python copies: every function gives
the reference's result on the same inputs, ``table2_designs`` included.
``stage_balance`` keeps the reference's solvers with the H100's constants in
place of the v5e's, so only the constants differ: on costs that load one
resource (where every stage time scales by the same factor) the partitions,
allocations and splits are the reference's and the times are the
reference's times scaled by the ratio of the two peaks; the solvers are
exact against brute force on the port's constants; and the mixed-split
balancer picks the reference's choice under the same cost function.
"""

import dataclasses
import itertools
import math
import random

import pytest

from repro.core import balance as r_bal
from repro.core import ii_model as r_ii
from repro.core import stage_balance as r_sb
from repro.core.lstm import LstmConfig as RLstmConfig
from repro_torch.core import balance as t_bal
from repro_torch.core import ii_model as t_ii
from repro_torch.core import stage_balance as t_sb
from repro_torch.core.lstm import LstmConfig

GW_DIMS = [(1, 32), (32, 8), (8, 8), (8, 32)]


def plain(obj):
    """Dataclasses (of either package) as nested plain values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def pair(name):
    """The same named model in both packages: (reference, port)."""
    return getattr(r_ii, name), getattr(t_ii, name)


MODELS = ["GW_SMALL", "GW_NOMINAL"]
DEVICES = ["ZYNQ_7045", "U250"]


# ---------------------------------------------------------------------------
# ii_model: the paper's Eqs. (1)-(7)
# ---------------------------------------------------------------------------

def test_constants_and_models_equal():
    for name in MODELS + DEVICES:
        r, t = pair(name)
        assert plain(t) == plain(r)
    assert t_ii.DSP_TOTAL == r_ii.DSP_TOTAL


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("r_h", [1, 2, 4, 7])
def test_layer_equations_equal(device, r_h):
    rc, tc = pair(device)
    for r_x in (1, 3, r_h, 9, 12, 20):
        rf_r, rf_t = r_ii.ReuseFactors(r_x=r_x, r_h=r_h), t_ii.ReuseFactors(r_x=r_x, r_h=r_h)
        for lx, lh in [(1, 9), (9, 9), *GW_DIMS]:
            dr, dt = r_ii.LstmLayerDims(lx=lx, lh=lh), t_ii.LstmLayerDims(lx=lx, lh=lh)
            assert t_ii.dsp_lstm_layer(dt, rf_t) == r_ii.dsp_lstm_layer(dr, rf_r)
        for fn in ("ii_recurrent_sublayer", "ii_mvmx_sublayer", "ii_layer"):
            assert getattr(t_ii, fn)(rf_t, tc) == getattr(r_ii, fn)(rf_r, rc)
        assert t_ii.layer_ii_cycles(rf_t, tc, 100) == r_ii.layer_ii_cycles(rf_r, rc, 100)
        assert t_ii.system_ii_cycles([rf_t] * 3, tc, 8) == r_ii.system_ii_cycles([rf_r] * 3, rc, 8)
    assert t_ii.lt_mvm(r_h, tc) == r_ii.lt_mvm(r_h, rc)
    assert t_ii.balanced_r_x(r_h, tc) == r_ii.balanced_r_x(r_h, rc)
    assert t_ii.dsp_dense_layer(t_ii.DenseLayerDims(32, 1), r_h) == \
        r_ii.dsp_dense_layer(r_ii.DenseLayerDims(32, 1), r_h)
    assert t_ii.cycles_to_us(1234, 300.0) == r_ii.cycles_to_us(1234, 300.0)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("balanced", [False, True])
def test_uniform_designs_equal(model, device, balanced):
    (rm, tm), (rc, tc) = pair(model), pair(device)
    for r_h in range(1, 8):
        rd = r_ii.uniform_design(rm, r_h, rc, 100, balanced=balanced)
        td = t_ii.uniform_design(tm, r_h, tc, 100, balanced=balanced)
        assert plain(td) == plain(rd)
        assert td.summary() == rd.summary()
        assert (td.dsp_used(), td.layer_iis(), td.ii_sys_cycles(), td.latency_cycles(),
                td.latency_us(300.0), td.is_balanced(), td.fits(9000)) == \
            (rd.dsp_used(), rd.layer_iis(), rd.ii_sys_cycles(), rd.latency_cycles(),
             rd.latency_us(300.0), rd.is_balanced(), rd.fits(9000))


def test_segment_latency_equal():
    for device in DEVICES:
        rc, tc = pair(device)
        for pairs in [((1, 1),), ((1, 9), (1, 9)), ((2, 3), (1, 9), (4, 12)), ((1, 1),) * 4]:
            rs = r_ii.Segment(tuple(r_ii.ReuseFactors(r_h=h, r_x=x) for h, x in pairs))
            ts = t_ii.Segment(tuple(t_ii.ReuseFactors(r_h=h, r_x=x) for h, x in pairs))
            assert ts.latency_cycles(tc, 100) == rs.latency_cycles(rc, 100)
            assert t_ii.model_latency_cycles([ts, ts], tc, 100, 7) == \
                r_ii.model_latency_cycles([rs, rs], rc, 100, 7)


# ---------------------------------------------------------------------------
# balance: the DSE solver and Table II
# ---------------------------------------------------------------------------

def test_table2_designs_equal():
    for ts in (8, 100):
        rd, td = r_bal.table2_designs(ts), t_bal.table2_designs(ts)
        assert sorted(td) == sorted(rd)
        for name in rd:
            assert plain(td[name]) == plain(rd[name])
            assert td[name].summary() == rd[name].summary()
    assert t_bal.TABLE2_PAPER == r_bal.TABLE2_PAPER


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("device", DEVICES)
def test_solver_equal(model, device):
    (rm, tm), (rc, tc) = pair(model), pair(device)
    assert t_bal.min_ii_cycles(tc) == r_bal.min_ii_cycles(rc)
    for ii in range(1, 30):
        assert t_bal.r_h_for_ii(ii, tc) == r_bal.r_h_for_ii(ii, rc)
        assert plain(t_bal.design_at_ii(tm, ii, tc, 8)) == plain(r_bal.design_at_ii(rm, ii, rc, 8))
    for budget in (100, 500, 900, 2000, 9000, 12288, 50_000):
        assert plain(t_bal.solve_min_ii(tm, budget, tc, timesteps=8)) == \
            plain(r_bal.solve_min_ii(rm, budget, rc, timesteps=8))
    for balanced in (False, True):
        assert t_bal.pareto_frontier(tm, tc, 8, balanced=balanced) == \
            r_bal.pareto_frontier(rm, rc, 8, balanced=balanced)
    for r_h in (1, 2, 4):
        assert t_bal.dsp_saving_at_iso_ii(tm, tc, 8, r_h) == r_bal.dsp_saving_at_iso_ii(rm, rc, 8, r_h)
    grid = dict(r_h_range=range(1, 4), r_x_range=range(1, 6))
    assert [plain(d) for d in t_bal.enumerate_designs(tm, tc, 8, **grid)] == \
        [plain(d) for d in r_bal.enumerate_designs(rm, rc, 8, **grid)]


# ---------------------------------------------------------------------------
# stage_balance: the same solvers, the H100's constants
# ---------------------------------------------------------------------------

def test_only_the_constants_differ():
    assert (t_sb.PEAK_FLOPS_BF16, t_sb.HBM_BW, t_sb.LINK_BW_PER_LINK) == (989e12, 3.35e12, 25e9)
    assert (r_sb.PEAK_FLOPS_BF16, r_sb.HBM_BW, r_sb.ICI_BW_PER_LINK) == (197e12, 819e9, 50e9)
    for lx, lh in GW_DIMS:
        for bpe in (2, 4):
            assert plain(t_sb.lstm_layer_cost(lx, lh, 8, 100, bpe)) == \
                plain(r_sb.lstm_layer_cost(lx, lh, 8, 100, bpe))


def _costs(mod, kind, seed, n):
    rng = random.Random(seed)
    vals = [rng.uniform(1e9, 1e13) for _ in range(n)]
    if kind == "flops":
        return [mod.StageCost(flops=v, bytes_hbm=0.0) for v in vals]
    return [mod.StageCost(flops=0.0, bytes_hbm=v) for v in vals]


@pytest.mark.parametrize("kind", ["flops", "bytes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planners_equal_on_one_resource(kind, seed):
    """Stage times that load one resource all scale by one factor, so the
    port decides as the reference does and its II is the reference's
    times that factor."""
    ratio = (r_sb.PEAK_FLOPS_BF16 / t_sb.PEAK_FLOPS_BF16 if kind == "flops"
             else r_sb.HBM_BW / t_sb.HBM_BW)
    rc, tc = _costs(r_sb, kind, seed, 7), _costs(t_sb, kind, seed, 7)
    for n_stages in (1, 2, 3, 5):
        assert t_sb.partition_layers(tc, n_stages) == r_sb.partition_layers(rc, n_stages)
        for chips in (n_stages, n_stages + 3, 16):
            for balanced in (True, False):
                rp = r_sb.plan_pipeline(rc, n_stages, chips, balanced=balanced)
                tp = t_sb.plan_pipeline(tc, n_stages, chips, balanced=balanced)
                assert (tp.stage_bounds, tp.chips) == (rp.stage_bounds, rp.chips)
                assert tp.ii_seconds == pytest.approx(rp.ii_seconds * ratio, rel=1e-12)
                assert tp.imbalance == pytest.approx(rp.imbalance, rel=1e-12)
    stages_r, stages_t = rc[:3], tc[:3]
    assert t_sb.allocate_chips(stages_t, 9) == r_sb.allocate_chips(stages_r, 9)


@pytest.mark.parametrize("seed", range(6))
def test_allocation_exact_vs_bruteforce(seed):
    rng = random.Random(seed)
    stages = [t_sb.StageCost(flops=rng.uniform(1e9, 1e13), bytes_hbm=rng.uniform(1e3, 1e10),
                             bytes_collective=rng.uniform(0, 1e8))
              for _ in range(rng.randint(1, 4))]
    total = len(stages) + rng.randint(0, 6)
    alloc = t_sb.allocate_chips(stages, total)
    assert sum(alloc) == total and min(alloc) >= 1

    def compositions(n, k):
        if k == 1:
            yield (n,)
            return
        for first in range(1, n - k + 2):
            for rest in compositions(n - first, k - 1):
                yield (first, *rest)

    best = min(t_sb.pipeline_ii(stages, a) for a in compositions(total, len(stages)))
    assert t_sb.pipeline_ii(stages, alloc) <= best * (1 + 1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_partition_exact_vs_bruteforce(seed):
    rng = random.Random(seed)
    n_layers = rng.randint(2, 8)
    n_stages = min(rng.randint(1, 4), n_layers)
    layers = [t_sb.StageCost(flops=rng.uniform(1e9, 1e13), bytes_hbm=rng.uniform(1e3, 1e10))
              for _ in range(n_layers)]
    bounds = t_sb.partition_layers(layers, n_stages)
    assert bounds[0][0] == 0 and bounds[-1][1] == n_layers
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))

    def seg_time(a, b):
        acc = t_sb.ZERO_COST
        for c in layers[a:b]:
            acc = acc + c
        return acc.time_on(1)

    got = max(seg_time(a, b) for a, b in bounds)
    best = math.inf
    for cuts in itertools.combinations(range(1, n_layers), n_stages - 1):
        pts = [0, *cuts, n_layers]
        best = min(best, max(seg_time(a, b) for a, b in zip(pts, pts[1:])))
    assert got <= best * (1 + 1e-12)


def test_balanced_beats_naive_on_the_autoencoder():
    layers = [t_sb.lstm_layer_cost(lx, lh, batch=128, timesteps=100) for lx, lh in GW_DIMS]
    naive = t_sb.plan_pipeline(layers, n_stages=2, total_chips=8, balanced=False)
    bal = t_sb.plan_pipeline(layers, n_stages=2, total_chips=8, balanced=True)
    assert bal.ii_seconds <= naive.ii_seconds
    assert bal.imbalance <= naive.imbalance + 1e-9


def test_splits_and_runs_equal():
    for n in range(1, 6):
        assert t_sb.candidate_splits(n) == r_sb.candidate_splits(n)
        assert t_sb.candidate_splits(n, ("bf16", "fp32")) == r_sb.candidate_splits(n, ("bf16", "fp32"))
    for wds in [("int8",), ("int8", "int8", "fp32", "fp32"), ("fp32", "int8", "int8", "fp32"),
                ("int8", "bf16", "bf16", "fp32")]:
        assert t_sb.segment_runs(wds) == r_sb.segment_runs(wds)


def _cost_fns():
    per = {32: 8.0, 8: 1.0, 9: 2.0}
    return {
        "int8-cheap": lambda seg, wd: (0.25 if wd == "int8" else 1.0)
        * sum(per[c.hidden] for c in seg),
        "layers": lambda seg, wd: float(len(seg)),
        "in-dim": lambda seg, wd: sum(c.in_dim for c in seg) * (2.0 if wd == "fp32" else 1.5),
    }


@pytest.mark.parametrize("name", sorted(_cost_fns()))
@pytest.mark.parametrize("dims", [GW_DIMS, [(1, 9), (9, 9)], GW_DIMS[:2], GW_DIMS[2:]])
def test_choose_mixed_split_equals_the_reference(name, dims):
    fn = _cost_fns()[name]
    r_cfgs = [RLstmConfig(in_dim=a, hidden=b) for a, b in dims]
    t_cfgs = [LstmConfig(in_dim=a, hidden=b) for a, b in dims]
    assert plain(t_sb.choose_mixed_split(t_cfgs, cost_fn=fn)) == \
        plain(r_sb.choose_mixed_split(r_cfgs, cost_fn=fn))
    cands = [("fp32", "int8") * (len(dims) // 2) + ("fp32",) * (len(dims) % 2)]
    assert plain(t_sb.choose_mixed_split(t_cfgs, cost_fn=fn, candidates=cands)) == \
        plain(r_sb.choose_mixed_split(r_cfgs, cost_fn=fn, candidates=cands))
