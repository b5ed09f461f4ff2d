"""CUDA-graph replay against eager runs, on the card.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs_cuda.py

A replay runs the kernels an eager call runs, on the same inputs, so it is
held bit for bit (``torch.equal``): the GW step at every pool width of the
ladder, the batched window decode, ``push_many`` against sequential
pushes, the LM engine's teacher-forced logits and greedy tokens.  A weight
swap drops every graph; a replay counts the launches its capture recorded.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_step
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine, StreamingAnomalyEngine, _pad_width

pytestmark = pytest.mark.gpu
CFG = GW_MODELS["gw_nominal"]
T = CFG.timesteps


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda):
    return init_autoencoder(CFG, seed=3, device=cuda)


@pytest.mark.parametrize("width", sorted({_pad_width(n) for n in range(1, 33)}))
@pytest.mark.parametrize("t_len", [1, 25])
def test_step_graph_replay_equals_eager(cuda, params, width, t_len):
    ex = StreamingAnomalyEngine(params, CFG, batch=1)._exec_enc
    g = torch.Generator(device=cuda).manual_seed(width * 100 + t_len)
    x = torch.randn(width, t_len, 1, generator=g, device=cuda)
    h, c = ex.zero_state(width)
    state = (torch.randn(h.shape, generator=g, device=cuda) * 0.3,
             torch.randn(c.shape, generator=g, device=cuda) * 0.3)
    want = ex.step(x, state)
    graph = ex.step_graph(width)
    first = [t.clone() for t in graph(x, state)]
    before = lstm_stack_step.launches
    got = graph(x, state)
    assert lstm_stack_step.launches == before + 1
    for a, b, w in zip(first, got, want):
        assert torch.equal(a, w) and torch.equal(b, w)


def _pool_scores(engine, ids, x, pieces):
    out = {sid: [] for sid in ids}
    for a, b in pieces:
        for sid, v in engine.push_many(ids, x[:, a:b]).items():
            out[sid] += v
    return out


@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_batched_finish_replay_equals_eager_and_sequential(cuda, params, k):
    x = np.random.RandomState(k).randn(k, 2 * T, 1).astype(np.float32)
    ids = [f"s{i}" for i in range(k)]
    pieces = [(0, 1), (1, 26), (26, T), (T, 2 * T)]
    replay = _pool_scores(StreamingAnomalyEngine(params, CFG, batch=1), ids, x, pieces)
    eager = _pool_scores(StreamingAnomalyEngine(params, CFG, batch=1, graphs=False), ids, x,
                         pieces)
    seq = StreamingAnomalyEngine(params, CFG, batch=1)
    for i, sid in enumerate(ids):
        seq.reset()
        alone = [s for a, b in pieces for s in seq.push(x[i : i + 1, a:b])]
        assert len(replay[sid]) == len(eager[sid]) == len(alone) == 2
        for r, e, a in zip(replay[sid], eager[sid], alone):
            np.testing.assert_array_equal(r, e)
            np.testing.assert_array_equal(r, a)


def test_one_decode_for_windows_completing_together(cuda, params):
    x = np.random.RandomState(0).randn(32, T, 1).astype(np.float32)
    ids = [f"s{i}" for i in range(32)]
    eng = StreamingAnomalyEngine(params, CFG, batch=1)
    eng.push_many(ids, x[:, : T - 1])
    before = lstm_stack.launches
    res = eng.push_many(ids, x[:, T - 1 :])
    assert lstm_stack.launches == before + 1 and all(len(res[s]) == 1 for s in ids)


def test_update_params_drops_the_graphs(cuda, params):
    eng = StreamingAnomalyEngine(params, CFG, batch=1)
    x = np.random.RandomState(1).randn(2, T, 1).astype(np.float32)
    eng.push(x[:1, :1])
    eng.push_many(["a", "b"], x[:, :1])
    assert eng._exec_enc._graphs and eng._pool.graphs
    new = init_autoencoder(CFG, seed=4, device=cuda)
    eng.update_params(new)
    assert not eng._exec_enc._graphs and not eng._pool.graphs
    got = eng.push_many(["a", "b"], x)
    fresh = StreamingAnomalyEngine(new, CFG, batch=1, graphs=False).push_many(["a", "b"], x)
    for sid in ("a", "b"):
        np.testing.assert_array_equal(got[sid][0], fresh[sid][0])


@pytest.mark.parametrize("name", ["smollm-360m", "mamba2-130m"])
def test_lm_replay_equals_eager(cuda, name):
    cfg = get_arch(name).reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    replay = LmEngine(params, cfg, max_len=20)
    eager = LmEngine(params, cfg, max_len=20, graphs=False)
    tokens = replay.generate(prompt, 6)
    np.testing.assert_array_equal(eager.generate(prompt, 6), tokens)
    r_pre, r_steps = replay.teacher_forced(prompt, tokens)
    e_pre, e_steps = eager.teacher_forced(prompt, tokens)
    assert torch.equal(r_pre, e_pre) and torch.equal(r_steps, e_steps)
    assert replay.launches == eager.launches


def test_lm_step_past_the_cache_raises_before_launching(cuda):
    cfg = get_arch("smollm-360m").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    eng = LmEngine(params, cfg, max_len=4)
    logits, cache = eng.prefill(np.zeros((1, 4), np.int32))
    launches = dict(eng.launches)
    with pytest.raises(ValueError, match="outside a cache"):
        eng.step(cache, logits[:, -1:, : cfg.vocab].argmax(-1))
    assert eng.launches == launches and int(cache["pos"]) == 4
