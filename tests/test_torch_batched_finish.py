"""Batched window decodes and the row-wise product of the GW score tail, on the CPU.

``push_many`` scores the streams that complete a window in the same piece
with one decode padded up the width ladder (the reference's
``_finish_streams``).  It must stay bit-equal (``torch.equal`` of the
scores) to pushing each stream alone, at 1-33 streams whose windows
complete together or apart, because every product of the score tail (layer
0's projection of the wavefront decoder, the dense head, the sum of the
squared error) runs through ``rowwise_matmul``, whose plain version sums
each row alone in a fixed order.  Batch scoring and streaming share that
tail and stay within 1e-5 of the reference's golden scores
(``tests/data/torch_port_gw_nominal.npz``).  Inputs are made with numpy
from a seed; the engines run on ``device="cpu"`` (plain versions, eager).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.kernels.rowwise import rowwise_matmul, rowwise_matmul_plain
from repro_torch.serve import engine as teng

FIXTURE = Path(__file__).parent / "data" / "torch_port_gw_nominal.npz"
TOL = dict(rtol=1e-5, atol=1e-5)
T = 12  # window length of the pool tests (gw_small, fused_step)


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(GW_MODELS["gw_small"], timesteps=T)
    return init_autoencoder(cfg, seed=4, device="cpu"), cfg


def _sequential(params, cfg, x: np.ndarray, cuts: list) -> list:
    """Each stream's windows pushed alone through a batch=1 engine."""
    eng = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    out = []
    for i in range(len(x)):
        eng.reset()
        out.append([sc for a, b in zip(cuts[i], cuts[i][1:])
                    for sc in eng.push(x[i : i + 1, a:b])])
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 17, 32, 33])
@pytest.mark.parametrize("together", [True, False], ids=["together", "apart"])
def test_push_many_bit_equal_to_sequential(small, n, together):
    """n streams, two windows each, chunks of 1, 4 and the rest; apart, the
    streams start 0-3 samples ahead of one another, so their windows
    complete in different pieces."""
    params, cfg = small
    rng = np.random.RandomState(n)
    lead = np.zeros(n, int) if together else rng.randint(0, 4, n)
    x = rng.randn(n, 2 * T + 4, 1).astype(np.float32)
    ids = [f"s{i}" for i in range(n)]
    pool = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    got = {sid: [] for sid in ids}
    starts = {}
    for i in range(n):  # each stream's lead, pushed alone first
        if lead[i]:
            got[ids[i]] += pool.push_many([ids[i]], x[i : i + 1, : lead[i]])[ids[i]]
        starts[i] = lead[i]
    for a, b in ((0, 1), (1, 5), (5, 2 * T)):
        res = pool.push_many(ids, np.stack([x[i, starts[i] + a : starts[i] + b]
                                            for i in range(n)]))
        for sid in ids:
            got[sid] += res[sid]
    cuts = [([0] if lead[i] else []) + [lead[i] + c for c in (0, 1, 5, 2 * T)]
            for i in range(n)]
    want = _sequential(params, cfg, x, cuts)
    for i, sid in enumerate(ids):
        assert len(got[sid]) == len(want[i]) == 2
        for g, w in zip(got[sid], want[i]):
            assert torch.equal(torch.from_numpy(g), torch.from_numpy(w)), (sid, g, w)


def test_windows_completing_together_decode_once(small, monkeypatch):
    """32 streams that complete a window in the same piece: one decode."""
    params, cfg = small
    calls = []
    score = teng.reconstruction_error_from_latent

    def counted(params_, latent, x, cfg_, **kw):
        calls.append(latent.shape[0])
        return score(params_, latent, x, cfg_, **kw)

    monkeypatch.setattr(teng, "reconstruction_error_from_latent", counted)
    pool = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    ids = [f"s{i}" for i in range(32)]
    x = np.random.RandomState(0).randn(32, T, 1).astype(np.float32)
    res = pool.push_many(ids, x)
    assert calls == [32] and all(len(res[sid]) == 1 for sid in ids)
    pool.push_many(ids[:3], x[:3, : T - 1])
    pool.push_many(ids[:3], x[:3, T - 1 :])
    assert calls == [32, 4]  # three streams pad to the ladder's 4


def test_pool_grows_and_releases_rows(small):
    """More streams than the pool's first capacity; dropped streams' rows
    are reused, zeroed."""
    params, cfg = small
    pool = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    ids = [f"s{i}" for i in range(70)]
    x = np.random.RandomState(1).randn(70, 3, 1).astype(np.float32)
    pool.push_many(ids, x)
    assert len(pool.stream_ids) == 70
    pool.drop_stream("s0")
    pool.push_many(["new"], x[:1])
    fresh = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    fresh.push_many(["new"], x[:1])
    for a, b in zip(pool._streams["new"].state, fresh._streams["new"].state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 3, 8, 33])
def test_rowwise_plain_is_row_invariant(m):
    """A row's product does not depend on how many rows share the call."""
    rng = np.random.RandomState(m)
    x = torch.from_numpy(rng.randn(33, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 128).astype(np.float32))
    b = torch.from_numpy(rng.randn(128).astype(np.float32))
    whole = rowwise_matmul(x, w, b)
    assert torch.equal(rowwise_matmul(x[:m], w, b), whole[:m])
    for i in range(m):
        assert torch.equal(rowwise_matmul(x[i : i + 1], w, b), whole[i : i + 1])


def test_rowwise_plain_is_the_sequential_sum():
    rng = np.random.RandomState(7)
    x = rng.randn(5, 9).astype(np.float32)
    w = rng.randn(9, 3).astype(np.float32)
    want = np.zeros((5, 3), np.float32)
    for k in range(9):
        want = want + x[:, k : k + 1] * w[k]
    got = rowwise_matmul_plain(torch.from_numpy(x).to(torch.bfloat16).float(),
                               torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(rowwise_matmul(torch.from_numpy(x), torch.from_numpy(w)),
                                  want)
    assert got.shape == (5, 3)


@pytest.mark.parametrize("bad", ["shape", "dtype", "bias"])
def test_rowwise_refuses_bad_operands(bad):
    x, w = torch.zeros(2, 3), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="rowwise_matmul"):
        if bad == "shape":
            rowwise_matmul(x, torch.zeros(2, 4))
        elif bad == "dtype":
            rowwise_matmul(x, w.double())
        else:
            rowwise_matmul(x, w, torch.zeros(3))


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as data:
        gold = {k: data[k] for k in data.files}
    tree: dict = {}
    for key, value in gold.items():
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = value
    return gold, params_from_numpy(tree, "cpu")


def test_batched_finish_matches_golden_scores(golden):
    """gw_nominal with the reference's weights: the 20 fixture windows
    pushed as 20 streams (one batched decode of width 24) and scored in
    one batch call both stay within 1e-5 of the reference's scores."""
    gold, params = golden
    cfg = GW_MODELS["gw_nominal"]
    windows = gold["windows"]
    pool = teng.StreamingAnomalyEngine(params, cfg, batch=1, device="cpu")
    ids = [f"w{i}" for i in range(len(windows))]
    got = {sid: [] for sid in ids}
    for a, b in ((0, 25), (25, 26), (26, 100)):
        for sid, v in pool.push_many(ids, windows[:, a:b]).items():
            got[sid] += v
    scores = np.concatenate([got[sid][0] for sid in ids])
    np.testing.assert_allclose(scores, gold["scores/fp32"], **TOL)
    np.testing.assert_allclose(pool.score(windows), gold["scores/fp32"], **TOL)
