"""Port serving engines vs the reference engines, on the CPU.

Both engines run gw_small and gw_nominal (T=20) with the reference's
weights.  Scores match the reference engines at 1e-5 for fp32, bf16 and
int8 storage; streaming in chunks equals one-shot scoring at the
reference's own streaming tolerance (rtol 1e-6, atol 1e-7); ``push_many``
equals sequential single-stream pushes bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.gw import GW_MODELS as R_MODELS
from repro.core.autoencoder import init_autoencoder as r_init
from repro.core.quant import PAPER_HW as R_PAPER_HW
from repro.serve import engine as reng
from repro_torch.configs.gw import GW_MODELS as T_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core.autoencoder import auc_score, init_autoencoder
from repro_torch.core.quant import PAPER_HW
from repro_torch.serve import engine as teng

T = 20
TOL = dict(rtol=1e-5, atol=1e-5)
STREAM_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", params=["gw_small", "gw_nominal"])
def model(request):
    name = request.param
    r_cfg = dataclasses.replace(R_MODELS[name], timesteps=T)
    t_cfg = dataclasses.replace(T_MODELS[name], timesteps=T)
    params = r_init(jax.random.PRNGKey(11), r_cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    x = np.random.RandomState(3).randn(4, T, 1).astype(np.float32)
    return params, r_cfg, t_params, t_cfg, x


def _cfgs(model, wd):
    _, r_cfg, _, t_cfg, _ = model
    return (dataclasses.replace(r_cfg, weight_dtype=wd),
            dataclasses.replace(t_cfg, weight_dtype=wd))


@pytest.mark.parametrize("wd", ["fp32", "bf16", "int8"])
def test_batch_engine_matches_reference(model, wd):
    params, _, t_params, _, x = model
    r_cfg, t_cfg = _cfgs(model, wd)
    want = reng.AnomalyStreamEngine(params, r_cfg).score(x)
    eng = teng.AnomalyStreamEngine(t_params, t_cfg, device="cpu")
    assert eng.effective_impl == "fused_stack" and eng.fallback_reason is None
    np.testing.assert_allclose(eng.score(x), want, **TOL)
    assert eng.calibrate(x, fpr=0.25) == pytest.approx(
        float(np.quantile(want, 0.75)), rel=1e-5)
    np.testing.assert_array_equal(eng.flag(x), eng.score(x) > eng.threshold)


@pytest.mark.parametrize("wd,sizes", [
    pytest.param("fp32", [7, 13], id="ragged-fp32"),
    pytest.param("bf16", [7, 13], id="ragged-bf16"),
    pytest.param("int8", [7, 13], id="ragged-int8"),
    pytest.param("fp32", [1] * T, id="T1-fp32"),
])
def test_streaming_matches_reference_and_one_shot(model, wd, sizes):
    params, _, t_params, _, x = model
    r_cfg, t_cfg = _cfgs(model, wd)
    r_eng = reng.StreamingAnomalyEngine(params, r_cfg, batch=4)
    t_eng = teng.StreamingAnomalyEngine(t_params, t_cfg, batch=4, device="cpu")
    assert t_eng.effective_impl == "fused_step"
    got, want, pos = [], [], 0
    for n in sizes:
        got += t_eng.push(x[:, pos : pos + n])
        want += r_eng.push(x[:, pos : pos + n])
        pos += n
    assert len(got) == len(want) == 1 and t_eng.filled == 0
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[0], t_eng.score(x), **STREAM_TOL)


def test_push_many_bit_equal_to_sequential(model):
    """Eight streams at ragged fill levels, one coalesced step per piece."""
    _, _, t_params, t_cfg, _ = model
    n = 8
    x = np.random.RandomState(11).randn(n, 2 * T, 1).astype(np.float32)
    eng = teng.StreamingAnomalyEngine(t_params, t_cfg, device="cpu")
    seq = teng.StreamingAnomalyEngine(t_params, t_cfg, device="cpu")
    ids = [f"s{i}" for i in range(n)]
    eng.push_many(ids[:3], x[:3, :5])  # three streams run ahead by 5 samples
    got = {sid: [] for sid in ids}
    starts = [5 if i < 3 else 0 for i in range(n)]
    for a, b in ((0, 6), (6, 19), (19, 2 * T - 5)):
        res = eng.push_many(ids, np.stack([x[i, s + a : s + b] for i, s in enumerate(starts)]))
        for sid in ids:
            got[sid] += res[sid]
    assert eng.stream_ids == tuple(ids)
    for i, sid in enumerate(ids):
        seq.reset()
        want = seq.push(x[i : i + 1, : starts[i] + 2 * T - 5])
        assert len(got[sid]) == len(want) >= 1
        for g, w in zip(got[sid], want):
            np.testing.assert_array_equal(g, w)
    eng.drop_stream("s0")
    assert "s0" not in eng.stream_ids


def test_carry_state_matches_reference(model):
    params, r_cfg, t_params, t_cfg, _ = model
    x = np.random.RandomState(5).randn(2, 2 * T, 1).astype(np.float32)
    r_eng = reng.StreamingAnomalyEngine(params, r_cfg, batch=2, carry_state=True)
    t_eng = teng.StreamingAnomalyEngine(t_params, t_cfg, batch=2, carry_state=True,
                                        device="cpu")
    want, got = r_eng.push(x), t_eng.push(x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_update_params_and_setter(model):
    params, r_cfg, t_params, t_cfg, x = model
    new = jax.tree_util.tree_map(lambda a: a * 0.9, params)
    t_new = params_from_numpy(jax.tree_util.tree_map(np.asarray, new), "cpu")
    want = reng.AnomalyStreamEngine(new, r_cfg).score(x)
    eng = teng.StreamingAnomalyEngine(t_params, t_cfg, batch=4, device="cpu")
    eng.push(x[:, :3])
    eng.params = t_new
    assert eng.filled == 0
    (got,) = eng.push(x)
    np.testing.assert_allclose(got, want, **TOL)


def test_engines_require_cuda_unless_cpu_requested(model, monkeypatch):
    _, _, t_params, t_cfg, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.AnomalyStreamEngine(t_params, t_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.StreamingAnomalyEngine(t_params, t_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_autoencoder(t_cfg)


def test_paper_hw_falls_back_like_reference(model):
    params, r_cfg, t_params, t_cfg, x = model
    r_cfg = dataclasses.replace(r_cfg, acts=R_PAPER_HW)
    t_cfg = dataclasses.replace(t_cfg, acts=PAPER_HW)
    r_eng = reng.StreamingAnomalyEngine(params, r_cfg, batch=4, chunk_len=8)
    t_eng = teng.StreamingAnomalyEngine(t_params, t_cfg, batch=4, chunk_len=8, device="cpu")
    assert t_eng.effective_impl == r_eng.effective_impl == "split"
    assert t_eng.fallback_reason is not None
    np.testing.assert_allclose(t_eng.push(x)[0], r_eng.push(x)[0], **TOL)


def test_auc_matches_reference():
    from repro.core.autoencoder import auc_score as r_auc

    rng = np.random.RandomState(0)
    neg, pos = rng.randn(50).round(1), rng.randn(30).round(1) + 0.5
    assert auc_score(neg, pos) == r_auc(neg, pos)
