"""The mixed path and the autotuner on the card.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mixed_cuda.py

A mixed plan runs K2 (or K1, for pieces longer than ``chunk_len``) in each
of its segments; every check is bit for bit (``torch.equal``): the chain
against hand-chained ``fused_step`` segments, a step-graph replay (the
whole chain as one graph) against the eager chain, ``push_many`` against
sequential pushes.  The scores hold against the reference's golden
fixture at 1e-5.  The kernels' shared-memory size has a Python twin
(``lstm_stack.smem_bytes``) that must equal the library's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.core.executor import plan_stack, state_leaves
from repro_torch.core.stage_balance import segment_runs
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_step
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

pytestmark = pytest.mark.gpu
WDS = ("int8", "fp32", "fp32", "int8")
CFG = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtypes=WDS, impl="mixed")
T = CFG.timesteps
FIXTURE = Path(__file__).parent / "data" / "torch_port_gw_mixed.npz"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda):
    return init_autoencoder(CFG, seed=3, device=cuda)


def test_smem_twin_equals_the_library(cuda):
    import sys

    k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
    lib = k1.library().lib
    for n_layers in (1, 2, 3, 4, 9):
        for width in (8, 9, 32, 48, 128):
            for rows in sorted({1, 2, 3, 8, k1.BLOCKED_ROWS}):
                for code, w_bytes in ((0, 4), (1, 2), (2, 1)):
                    for step in (0, 1):
                        assert k1.smem_bytes(n_layers, width, rows, w_bytes, bool(step)) == \
                            lib.lstm_stack_smem_bytes(n_layers, width, rows, code, step)
    # the row-blocked instantiation (the same layout at rows = R) exists for
    # every storage and compute dtype on the register path, and holds the
    # two CTAs an SM its launch bounds ask for; other shapes and other row
    # counts have none
    rows, blocked = k1.BLOCKED_ROWS, k1.PATH_CODES["blocked"]
    for compute, code in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2)):
        for n_layers in (1, 2):
            assert lib.lstm_stack_ctas_per_sm(n_layers, 32, rows, blocked, compute, code,
                                              None) >= 2
            assert lib.lstm_stack_ctas_per_sm(n_layers, 32, rows // 2, blocked, compute,
                                              code, None) == -1
        assert lib.lstm_stack_ctas_per_sm(2, 9, rows, blocked, compute, code, None) == -1
        assert lib.lstm_stack_ctas_per_sm(3, 32, rows, blocked, compute, code, None) == -1


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("t_len", [1, 25, 40])
def test_mixed_equals_hand_chained_segments(cuda, params, split, t_len):
    from repro_torch.core.autoencoder import encoder_layers

    plist, cfgs = encoder_layers(params, dataclasses.replace(CFG, weight_dtypes=None))
    mex = plan_stack(cfgs, impl="mixed", split=split, chunk_len=32).bind(plist)
    wds = mex.plan.weight_dtype
    subs = [plan_stack(cfgs[a:b], impl="fused_step", weight_dtype=wds[a], chunk_len=32)
            .bind(plist[a:b]) for a, b in segment_runs(wds)]
    g = torch.Generator(device=cuda).manual_seed(t_len)
    x = torch.randn(4, t_len, 1, generator=g, device=cuda)
    h_got, st = mex.step_with_output(x, mex.zero_state(4))
    h, sts = x, []
    for sub in subs:
        h, s = sub.step_with_output(h, sub.zero_state(4))
        sts.append(s)
    assert torch.equal(h_got, h)
    for a, b in zip(state_leaves(st), state_leaves(tuple(sts))):
        assert torch.equal(a, b)
    h = x
    for sub in subs:
        h = sub(h, return_state=False)
    assert torch.equal(mex(x, return_state=False), h)


@pytest.mark.parametrize("width", [1, 8, 32])
@pytest.mark.parametrize("t_len", [1, 25])
def test_mixed_step_graph_is_one_replay(cuda, params, width, t_len):
    ex = StreamingAnomalyEngine(params, CFG, batch=1, impl="mixed")._exec_enc
    n_seg = len(ex.plan.segments)
    g = torch.Generator(device=cuda).manual_seed(width + t_len)
    x = torch.randn(width, t_len, 1, generator=g, device=cuda)
    st0 = tuple((torch.randn(h.shape, generator=g, device=cuda) * 0.3,
                 torch.randn(c.shape, generator=g, device=cuda) * 0.3)
                for h, c in ex.zero_state(width))
    want = ex.step(x, st0)
    graph = ex.step_graph(width)
    first = [t.clone() for t in state_leaves(graph(x, st0))]
    before = lstm_stack_step.launches
    got = graph(x, st0)
    torch.cuda.synchronize()
    assert lstm_stack_step.launches - before == n_seg == 2
    for a, b, c in zip(first, state_leaves(got), state_leaves(want)):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_mixed_push_many_equals_sequential_pushes(cuda, params):
    rng = np.random.RandomState(7)
    n = 12
    x = rng.randn(n, 2 * T, 1).astype(np.float32)
    ids = [f"s{i}" for i in range(n)]
    pool = StreamingAnomalyEngine(params, CFG, batch=1, impl="mixed")
    got = {sid: [] for sid in ids}
    for a in range(0, 2 * T, 25):
        before = lstm_stack.launches
        res = pool.push_many(ids, x[:, a : a + 25])
        n_dec = lstm_stack.launches - before
        assert n_dec == (2 if (a + 25) % T == 0 else 0)  # one K1 per decoder segment
        for sid in ids:
            got[sid] += res[sid]
    seq = StreamingAnomalyEngine(params, CFG, batch=1, impl="mixed")
    for i, sid in enumerate(ids):
        seq.reset()
        want = [s for a in range(0, 2 * T, 25) for s in seq.push(x[i : i + 1, a : a + 25])]
        assert len(got[sid]) == len(want) == 2
        for g_, w in zip(got[sid], want):
            np.testing.assert_array_equal(g_, w)


def test_mixed_scores_match_the_reference_fixture(cuda):
    with np.load(FIXTURE) as data:
        golden = {k: data[k] for k in data.files}
    tree: dict = {}
    for key, value in golden.items():
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = value
    params = params_from_numpy(tree, cuda)
    x = golden["windows"]
    np.testing.assert_allclose(AnomalyStreamEngine(params, CFG, impl="mixed").score(x),
                               golden["scores/wdtypes"], rtol=1e-5, atol=1e-5)
    eng = StreamingAnomalyEngine(params, CFG, batch=len(x), impl="mixed")
    streamed = [s for a in range(0, T, 25) for s in eng.push(x[:, a : a + 25])]
    np.testing.assert_allclose(streamed[0], golden["streamed/wdtypes"], rtol=1e-5, atol=1e-5)
    assert {"enc": eng._exec_enc.plan.layer_assignment(),
            "dec": eng._exec_dec.plan.layer_assignment()} == \
        json.loads(str(golden["layers/wdtypes"]))


def test_sweep_times_the_card(cuda):
    from repro_torch.autotune.sweep import run_sweep, sweep_case

    records = run_sweep(sweep_case([(1, 32), (32, 8)], "mixed", batch=8, t_len=8),
                        k=2, reps=3, max_points=4, device="cuda")
    assert len(records) == 4 and all(r["us"] > 0 and r["device"] == "cuda" for r in records)


def test_capture_survives_cyclic_garbage_holding_graphs(cuda, params):
    """An executor and its step graph form a reference cycle; when the
    collector frees such garbage during a later capture, the old graph's
    destruction must not invalidate it (the collector is off while a
    capture runs)."""
    import gc

    from repro_torch.core.autoencoder import encoder_layers

    plist, cfgs = encoder_layers(params, CFG)
    x = torch.zeros(1, 1, 1, device=cuda)
    for split in (0, 1, 2):  # garbage: three executors, each holding a captured graph
        ex = plan_stack(cfgs, impl="mixed", split=split).bind(plist)
        ex.step_graph(1)(x, ex.zero_state(1))
    del ex
    old = gc.get_threshold()
    gc.set_threshold(1)  # a collection at (nearly) every allocation
    try:
        ex = plan_stack(cfgs, impl="mixed", split=1, chunk_len=16).bind(plist)
        graph = ex.step_graph(2)
        want = ex.step(x.expand(2, 1, 1), ex.zero_state(2))
        graph(x.expand(2, 1, 1), ex.zero_state(2))
        got = graph(x.expand(2, 1, 1), ex.zero_state(2))
    finally:
        gc.set_threshold(*old)
    for a, b in zip(state_leaves(got), state_leaves(want)):
        assert torch.equal(a, b)
