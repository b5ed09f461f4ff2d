"""Golden fixtures: the reference's LM serving outputs at reduced size, for
checking the port without JAX (``chip_smoke.py`` reads them on the GPU
machine).

``tests/data/torch_port_lm_smollm.npz``, ``torch_port_lm_mamba2.npz``,
``torch_port_lm_qwen2moe.npz`` and ``torch_port_lm_hymba.npz`` hold, for
the ``reduced()`` smollm-360m, mamba2-130m, qwen2-moe-a2.7b and hymba-1.5b
(fp32): the reference's params from a fixed seed with the norm scales
(``norm_attn`` and ``norm_ssm`` too), biases, ``a_log``, ``d_skip`` and
``dt_bias`` randomised (the reference's init sets them to constants, which
would hide a wrong head or group index), a prompt (20 tokens for hymba,
longer than its reduced window of 16, so its ring wraps in prefill),
the reference ``LmEngine``'s greedy tokens, the prefill's last-token logits,
and the logits of each decode step fed those tokens (teacher forcing).  The
first test regenerates them from the JAX package, so the files cannot go
stale; regenerate with

    PYTHONPATH=src python tests/test_torch_lm_golden.py

The helpers here (``reference_params``, ``flatten``) are shared with
``test_torch_lm.py``; ``repro_torch.convert.unflatten`` reads the params
back and ``LmEngine.teacher_forced`` feeds the tokens.
"""

from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, unflatten
from repro_torch.serve.engine import LmEngine

DATA = Path(__file__).parent / "data"
FIXTURES = {"smollm-360m": DATA / "torch_port_lm_smollm.npz",
            "mamba2-130m": DATA / "torch_port_lm_mamba2.npz",
            "qwen2-moe-a2.7b": DATA / "torch_port_lm_qwen2moe.npz",
            "hymba-1.5b": DATA / "torch_port_lm_hymba.npz"}
SEED, BATCH, PROMPT, N_NEW = 0, 2, 12, 6
#: prompt lengths other than PROMPT: hymba's is longer than its window
PROMPTS = {"hymba-1.5b": 20}
#: fp32 at reduced size: the packages sum matmuls, softmaxes and the scan in
#: other orders, which moves logits by about 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)

#: leaves the reference initialises to constants, and how they are redrawn
_RANDOMISED = {"ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "ln_f": (1.0, 0.3), "ln": (1.0, 0.3),
               "norm": (1.0, 0.3), "d_skip": (1.0, 0.3), "bq": (0.0, 0.2),
               "bk": (0.0, 0.2), "bv": (0.0, 0.2), "a_log": (0.0, 0.5),
               "dt_bias": (0.0, 0.5), "norm_attn": (1.0, 0.3), "norm_ssm": (1.0, 0.3)}


def randomise(tree: dict, seed: int) -> dict:
    """Redraw the constant-initialised leaves (numpy, fp32) from ``seed``."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _RANDOMISED:
                mean, std = _RANDOMISED[k]
                out[k] = (mean + std * rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def reference_params(cfg, seed: int) -> dict:
    """The reference's params for ``cfg`` (a reference ArchConfig) as numpy,
    with ``randomise`` applied."""
    import jax

    from repro.models.api import get_model

    params = get_model(cfg).init_params(jax.random.PRNGKey(seed), cfg)
    return randomise(jax.tree_util.tree_map(np.asarray, params), seed + 1)


def flatten(tree: dict, prefix: str = "params") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def make_fixture(name: str) -> dict:
    """Every array of one fixture, computed by the JAX reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as r_get_arch
    from repro.models.api import get_model as r_get_model
    from repro.serve.engine import LmEngine as RLmEngine

    cfg = r_get_arch(name).reduced()
    params = reference_params(cfg, SEED)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    n_prompt = PROMPTS.get(name, PROMPT)
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab, (BATCH, n_prompt)).astype(np.int32)
    tokens = RLmEngine(jp, cfg, max_len=n_prompt + N_NEW).generate(prompt, N_NEW)
    api = r_get_model(cfg)
    logits, cache = api.prefill(jp, {"tokens": jnp.asarray(prompt)}, cfg, n_prompt + N_NEW)
    steps = []
    for i in range(N_NEW - 1):
        step_logits, cache = api.decode_step(jp, cache, {"tokens": jnp.asarray(tokens[:, i : i + 1])},
                                             cfg)
        steps.append(np.asarray(step_logits[:, 0]))
    return {"prompt": prompt, "tokens": np.asarray(tokens, np.int32),
            "prefill_logits": np.asarray(logits[:, 0]), "decode_logits": np.stack(steps),
            **flatten(params)}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_equals_regenerated_reference(name):
    pytest.importorskip("jax")
    fresh = make_fixture(name)
    with np.load(FIXTURES[name]) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for key, value in fresh.items():
            if key.endswith("_logits"):
                # compiled XLA code may differ in the last bit across CPUs
                np.testing.assert_allclose(stored[key], value, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(stored[key], value)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_cpu_matches_fixture(name):
    with np.load(FIXTURES[name]) as data:
        gold = {k: data[k] for k in data.files}
    cfg = get_arch(name).reduced()
    params = lm_params_from_numpy(unflatten(gold), "cpu")
    engine = LmEngine(params, cfg, max_len=gold["prompt"].shape[1] + N_NEW, device="cpu")
    pre, steps = engine.teacher_forced(gold["prompt"], gold["tokens"])
    np.testing.assert_allclose(pre.numpy(), gold["prefill_logits"], **TOL)
    np.testing.assert_allclose(steps.numpy(), gold["decode_logits"], **TOL)
    np.testing.assert_array_equal(engine.generate(gold["prompt"], N_NEW), gold["tokens"])


if __name__ == "__main__":
    DATA.mkdir(exist_ok=True)
    for arch, path in FIXTURES.items():
        np.savez_compressed(path, **make_fixture(arch))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
