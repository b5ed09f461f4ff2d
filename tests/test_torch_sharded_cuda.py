"""Sharded placement on the card: the stages share one card (or take one
each where there are several), each on a CUDA stream of its own.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharded_cuda.py

``fused_stack_sharded`` on ``("cuda:0",) * S`` equals the local
``fused_stack`` bit for bit (``torch.equal``) for fp32 and int8 storage at
S in {1, 2, 4} and every tested ``n_chunks``: at a stage boundary the next
layer's input product runs through the row-wise kernel in the order K1
computes it inside the kernel.  bf16 compute rounds that product to bf16
(``project_layer0``) where K1's inner layer does not, and the recurrence
carries that rounding on: it is held to K1's bf16 tolerance (the
reference's, rtol 2e-2 / atol 1e-2, as ``test_torch_kernels.py`` does).  Each stage launches K1 once per chunk;
the engines run a sharded plan eagerly (no graph capture) and score as
the local engines do.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.core.executor import plan_stack
from repro_torch.core.lstm import LstmConfig, init_lstm
from repro_torch.kernels.lstm_stack import lstm_stack
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

pytestmark = pytest.mark.gpu
GW_DIMS = [(1, 32), (32, 8), (8, 8), (8, 32)]
BF16_TOL = dict(rtol=2e-2, atol=1e-2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _stack(dev, dtype=torch.float32, seed=0):
    cfgs = [LstmConfig(in_dim=a, hidden=b, dtype=dtype) for a, b in GW_DIMS]
    gen = torch.Generator().manual_seed(seed)
    return [init_lstm(c, gen, dev) for c in cfgs], cfgs


def _runs_equal(got, want):
    (h_g, f_g), (h_w, f_w) = got, want
    return torch.equal(h_g, h_w) and all(
        torch.equal(a, b) for fg, fw in zip(f_g, f_w) for a, b in zip(fg, fw))


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("wd", ["fp32", "int8"])
@pytest.mark.parametrize("batch", [1, 64])
def test_sharded_equals_local_on_the_card(cuda, n_stages, wd, batch):
    params, cfgs = _stack(cuda)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(batch, 100, 1, generator=gen).to(cuda)
    init = [((torch.randn(batch, c.hidden, generator=gen) * 0.3).to(cuda),
             (torch.randn(batch, c.hidden, generator=gen) * 0.3).to(cuda)) for c in cfgs]
    local = plan_stack(cfgs, impl="fused_stack", weight_dtype=wd).bind(params)
    want_zero, want_init = local(x), local(x, init)
    for n_chunks in (None, 1, 2, 4, 5):
        ex = plan_stack(cfgs, impl="fused_stack", weight_dtype=wd, placement="sharded",
                        mesh=(cuda,) * n_stages, n_chunks=n_chunks).bind(params)
        lstm_stack.launches = 0
        got = ex(x)
        torch.cuda.synchronize()
        assert lstm_stack.launches == n_stages * (n_chunks or n_stages)
        assert _runs_equal(got, want_zero), (n_chunks, (got[0] - want_zero[0]).abs().max())
        assert _runs_equal(ex(x, init), want_init), n_chunks


@pytest.mark.parametrize("n_stages", [2, 4])
def test_sharded_bf16_within_the_k1_tolerance(cuda, n_stages):
    params, cfgs = _stack(cuda, torch.bfloat16)
    x = torch.randn(8, 100, 1, generator=torch.Generator().manual_seed(2)).to(cuda)
    local = plan_stack(cfgs, impl="fused_stack").bind(params)(x)
    got = plan_stack(cfgs, impl="fused_stack", placement="sharded",
                     mesh=(cuda,) * n_stages).bind(params)(x)
    np.testing.assert_allclose(got[0].float().cpu().numpy(), local[0].float().cpu().numpy(),
                               **BF16_TOL)


def test_stage_streams_are_distinct(cuda):
    params, cfgs = _stack(cuda)
    ex = plan_stack(cfgs, impl="fused_stack_sharded", mesh=(cuda,) * 4).bind(params)
    streams = ex.staged.streams
    assert len({s.cuda_stream for s in streams}) == 4
    assert all(s.cuda_stream != torch.cuda.current_stream(cuda).cuda_stream for s in streams)


def test_sharded_on_a_side_stream_and_under_memory_churn(cuda):
    """A caller on its own stream gets the bits of the default stream; a
    run that frees and reallocates between calls keeps them."""
    params, cfgs = _stack(cuda)
    ex = plan_stack(cfgs, impl="fused_stack_sharded", mesh=(cuda,) * 4,
                    n_chunks=20).bind(params)
    x = torch.randn(64, 100, 1, generator=torch.Generator().manual_seed(3)).to(cuda)
    want = ex(x, return_state=False)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(3):
            junk = torch.empty(1 << 20, device=cuda).fill_(float("nan"))
            got = ex(x, return_state=False)
            del junk
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(got, want)


def test_more_than_one_card_when_present(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"one stage per card needs two or more cards; this machine has {n}")
    params, cfgs = _stack(cuda)
    x = torch.randn(4, 100, 1, generator=torch.Generator().manual_seed(4)).to(cuda)
    mesh = tuple(torch.device("cuda", i) for i in range(2))
    got = plan_stack(cfgs, impl="fused_stack_sharded", mesh=mesh).bind(params)(x)
    assert _runs_equal(got, plan_stack(cfgs, impl="fused_stack").bind(params)(x))


@pytest.mark.parametrize("wd", ["fp32", "int8"])
def test_engines_on_the_card(cuda, wd):
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
    params = init_autoencoder(cfg, seed=0, device="cuda")
    windows = np.random.RandomState(5).randn(8, 100, 1).astype(np.float32)
    mesh = (cuda, cuda)
    sharded = AnomalyStreamEngine(params, cfg, placement="sharded", mesh=mesh)
    np.testing.assert_array_equal(sharded.score(windows),
                                  AnomalyStreamEngine(params, cfg).score(windows))
    eng = StreamingAnomalyEngine(params, cfg, placement="sharded", mesh=mesh)
    assert not eng._graph_steps and not eng._graph_finish
    local = StreamingAnomalyEngine(params, cfg, impl="fused_stack", graphs=False)
    lstm_stack.launches = 0
    got = [s for pos in range(0, 100, 25) for s in eng.push(windows[:1, pos : pos + 25])]
    # 4 pushes x 2 encoder stages x 1 chunk (2 stages do not divide T=25),
    # then one decode over T=100: 2 stages x 2 chunks
    assert lstm_stack.launches == 4 * 2 * 1 + 2 * 2
    want = [s for pos in range(0, 100, 25) for s in local.push(windows[:1, pos : pos + 25])]
    np.testing.assert_array_equal(got[0], want[0])
    ids = [f"s{i}" for i in range(4)]
    pooled = eng.push_many(ids, windows[:4])
    for i, sid in enumerate(ids):
        eng_one = StreamingAnomalyEngine(params, cfg, placement="sharded", mesh=mesh)
        np.testing.assert_array_equal(pooled[sid][0], eng_one.push(windows[i : i + 1])[0])
