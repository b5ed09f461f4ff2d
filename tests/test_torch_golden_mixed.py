"""Golden fixture of the mixed path: the reference's gw_nominal scores under
per-layer storage, for checking the port without JAX (``chip_smoke.py``
reads it on the GPU machine).

``tests/data/torch_port_gw_mixed.npz`` holds the reference gw_nominal params
(T=100) from a fixed seed, 6 background and 2 chirp windows from
``repro.data.gw``, and for each mixed plan below the reference's one-shot
scores, its streamed scores (chunks of 25) and each segment plan's
``layer_assignment()`` (JSON):

* ``wdtypes``: ``weight_dtypes=("int8", "fp32", "fp32", "int8")`` through
  the reference's mixed engines;
* ``split1`` and ``split2``: ``plan_stack(..., impl="mixed", split=k)`` on
  each segment, scored through the bound executors (``split2`` stores both
  layers of each segment int8, one segment each).

The first test regenerates it from the JAX package and requires equality,
so the file cannot go stale; regenerate with

    PYTHONPATH=src python tests/test_torch_golden_mixed.py
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core.autoencoder import (
    decoder_layers,
    encoder_layers,
    reconstruction_error,
    reconstruction_error_from_latent,
)
from repro_torch.core.executor import plan_stack
from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

FIXTURE = Path(__file__).parent / "data" / "torch_port_gw_mixed.npz"
WEIGHT_DTYPES = ("int8", "fp32", "fp32", "int8")
SPLITS = (1, 2)
SEED, CHUNK = 0, 25


def split_scores(mod, params, cfg, windows, split, chunk=CHUNK):
    """(one-shot scores, streamed scores, {segment: layer_assignment}) of
    ``split=k`` on each segment, through the bound executors of either
    package (``mod`` is ``repro`` or ``repro_torch``'s namespace below)."""
    enc_p, enc_cfgs = mod["encoder_layers"](params, cfg)
    dec_p, dec_cfgs = mod["decoder_layers"](params, cfg)
    ex_enc = mod["plan_stack"](enc_cfgs, impl="mixed", split=split).bind(enc_p)
    ex_dec = mod["plan_stack"](dec_cfgs, impl="mixed", split=split).bind(dec_p)
    x = mod["array"](windows)
    one = mod["reconstruction_error"](params, x, cfg, exec_enc=ex_enc, exec_dec=ex_dec)
    state = ex_enc.zero_state(len(windows))
    for pos in range(0, windows.shape[1], chunk):
        state = ex_enc.step(mod["array"](windows[:, pos : pos + chunk]), state)
    streamed = mod["reconstruction_error_from_latent"](params, ex_enc.last_hidden(state), x,
                                                       cfg, exec_dec=ex_dec)
    layers = {"enc": ex_enc.plan.layer_assignment(), "dec": ex_dec.plan.layer_assignment()}
    return np.asarray(one), np.asarray(streamed), layers


PORT = {
    "encoder_layers": encoder_layers, "decoder_layers": decoder_layers,
    "plan_stack": plan_stack, "reconstruction_error": reconstruction_error,
    "reconstruction_error_from_latent": reconstruction_error_from_latent,
    "array": torch.from_numpy,
}


def make_fixture() -> dict:
    """Every array of the fixture, computed by the JAX reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs.gw import GW_MODELS as R_MODELS
    from repro.core import autoencoder as rae
    from repro.core.autoencoder import init_autoencoder
    from repro.core.executor import plan_stack as r_plan_stack
    from repro.data.gw import GwDataConfig, GwDataset
    from repro.serve.engine import AnomalyStreamEngine as RBatch
    from repro.serve.engine import StreamingAnomalyEngine as RStream

    cfg = R_MODELS["gw_nominal"]
    params = init_autoencoder(jax.random.PRNGKey(SEED), cfg)
    ds = GwDataset(GwDataConfig(seed=SEED, timesteps=cfg.timesteps))
    windows = np.concatenate([ds.background(6), ds.events(2)])
    out = {"windows": windows}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out["params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    mixed = dataclasses.replace(cfg, weight_dtypes=WEIGHT_DTYPES, impl="mixed")
    out["scores/wdtypes"] = RBatch(params, mixed, impl="mixed").score(windows)
    eng = RStream(params, mixed, batch=len(windows), impl="mixed")
    streamed = [s for pos in range(0, cfg.timesteps, CHUNK)
                for s in eng.push(windows[:, pos : pos + CHUNK])]
    out["streamed/wdtypes"] = np.asarray(streamed[0])
    out["layers/wdtypes"] = np.array(json.dumps({
        "enc": eng._exec_enc.plan.layer_assignment(),
        "dec": eng._exec_dec.plan.layer_assignment()}))
    ref = {"encoder_layers": rae.encoder_layers, "decoder_layers": rae.decoder_layers,
           "plan_stack": r_plan_stack, "reconstruction_error": rae.reconstruction_error,
           "reconstruction_error_from_latent": rae.reconstruction_error_from_latent,
           "array": jnp.asarray}
    for split in SPLITS:
        one, streamed, layers = split_scores(ref, params, cfg, windows, split)
        out[f"scores/split{split}"], out[f"streamed/split{split}"] = one, streamed
        out[f"layers/split{split}"] = np.array(json.dumps(layers))
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


def test_port_engines_match_fixture(golden):
    data, tree = golden
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtypes=WEIGHT_DTYPES,
                              impl="mixed")
    params = params_from_numpy(tree, "cpu")
    x = data["windows"]
    got = AnomalyStreamEngine(params, cfg, impl="mixed", device="cpu").score(x)
    np.testing.assert_allclose(got, data["scores/wdtypes"], rtol=1e-5, atol=1e-5)
    eng = StreamingAnomalyEngine(params, cfg, batch=len(x), impl="mixed", device="cpu")
    streamed = [s for pos in range(0, cfg.timesteps, CHUNK) for s in eng.push(x[:, pos : pos + CHUNK])]
    np.testing.assert_allclose(streamed[0], data["streamed/wdtypes"], rtol=1e-5, atol=1e-5)
    assert {"enc": eng._exec_enc.plan.layer_assignment(),
            "dec": eng._exec_dec.plan.layer_assignment()} == json.loads(str(data["layers/wdtypes"]))


@pytest.mark.parametrize("split", SPLITS)
def test_port_split_plans_match_fixture(golden, split):
    data, tree = golden
    params = params_from_numpy(tree, "cpu")
    one, streamed, layers = split_scores(PORT, params, GW_MODELS["gw_nominal"], data["windows"],
                                         split)
    np.testing.assert_allclose(one, data[f"scores/split{split}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(streamed, data[f"streamed/split{split}"], rtol=1e-5, atol=1e-5)
    assert layers == json.loads(str(data[f"layers/split{split}"]))


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
