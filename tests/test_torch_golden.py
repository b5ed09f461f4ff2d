"""Golden fixture: the reference's gw_nominal scores, for checking the port
without JAX (``chip_smoke.py`` reads it on the GPU machine).

``tests/data/torch_port_gw_nominal.npz`` holds the reference gw_nominal
params from a fixed seed, 16 background and 4 chirp windows (T=100) from
``repro.data.gw``, the reference ``AnomalyStreamEngine`` scores for fp32,
bf16 and int8 storage, and the reference streamed scores (chunks of 25).
The first test regenerates it from the JAX package and requires equality,
so the file cannot go stale; regenerate with

    PYTHONPATH=src python tests/test_torch_golden.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.gw import GW_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

FIXTURE = Path(__file__).parent / "data" / "torch_port_gw_nominal.npz"
WEIGHT_DTYPES = ("fp32", "bf16", "int8")
SEED, CHUNK = 0, 25


def make_fixture() -> dict:
    """Every array of the fixture, computed by the JAX reference."""
    import jax

    from repro.configs.gw import GW_MODELS as R_MODELS
    from repro.core.autoencoder import init_autoencoder
    from repro.data.gw import GwDataConfig, GwDataset
    from repro.serve.engine import AnomalyStreamEngine as RBatch
    from repro.serve.engine import StreamingAnomalyEngine as RStream

    cfg = R_MODELS["gw_nominal"]
    params = init_autoencoder(jax.random.PRNGKey(SEED), cfg)
    ds = GwDataset(GwDataConfig(seed=SEED, timesteps=cfg.timesteps))
    windows = np.concatenate([ds.background(16), ds.events(4)])
    out = {"windows": windows, "n_background": np.int64(16)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out["params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    for wd in WEIGHT_DTYPES:
        c = dataclasses.replace(cfg, weight_dtype=wd)
        out[f"scores/{wd}"] = RBatch(params, c, impl="fused_stack").score(windows)
        eng = RStream(params, c, batch=len(windows))
        streamed = []
        for pos in range(0, cfg.timesteps, CHUNK):
            streamed += eng.push(windows[:, pos : pos + CHUNK])
        (out[f"streamed/{wd}"],) = streamed
    return out


def load_params(data) -> dict:
    tree: dict = {}
    for key in data.files:
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = data[key]
    return tree


def test_fixture_equals_regenerated_reference():
    pytest.importorskip("jax")
    fresh = make_fixture()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for key, value in fresh.items():
            if key.startswith(("scores/", "streamed/")):
                # compiled XLA code may differ in the last bit across CPUs
                np.testing.assert_allclose(stored[key], value, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(stored[key], value)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as data:
        return {k: data[k] for k in data.files}, load_params(data)


@pytest.mark.parametrize("wd", WEIGHT_DTYPES)
def test_port_cpu_scores_match_fixture(golden, wd):
    data, tree = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
    params = params_from_numpy(tree, "cpu")
    got = AnomalyStreamEngine(params, cfg, device="cpu").score(data["windows"])
    np.testing.assert_allclose(got, data[f"scores/{wd}"], rtol=1e-5, atol=1e-5)


def test_port_cpu_streamed_scores_match_fixture(golden):
    data, tree = golden
    cfg = GW_MODELS["gw_nominal"]
    x = data["windows"]
    eng = StreamingAnomalyEngine(params_from_numpy(tree, "cpu"), cfg, batch=len(x),
                                 device="cpu")
    streamed = []
    for pos in range(0, cfg.timesteps, CHUNK):
        streamed += eng.push(x[:, pos : pos + CHUNK])
    np.testing.assert_allclose(streamed[0], data["streamed/fp32"], rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
