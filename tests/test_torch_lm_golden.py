"""Golden fixtures: the reference's LM serving outputs at reduced size, for
checking the port without JAX (``chip_smoke.py`` reads them on the GPU
machine).

``tests/data/torch_port_lm_smollm.npz``, ``torch_port_lm_mamba2.npz``,
``torch_port_lm_qwen2moe.npz``, ``torch_port_lm_hymba.npz``,
``torch_port_lm_seamless.npz`` and ``torch_port_lm_llava.npz`` hold, for
the ``reduced()`` smollm-360m, mamba2-130m, qwen2-moe-a2.7b, hymba-1.5b,
seamless-m4t-large-v2 and llava-next-34b (fp32): the reference's params
from a fixed seed with the norm scales (``norm_attn``, ``norm_ssm``,
``ln_x`` and ``ln_enc`` too), biases, ``a_log``, ``d_skip`` and
``dt_bias`` randomised (the reference's init sets them to constants, which
would hide a wrong head or group index), a prompt (20 tokens for hymba,
longer than its reduced window of 16, so its ring wraps in prefill), the
frontend's embeddings where the model takes them (10 encoder frames for
seamless, 8 patches for llava), the greedy tokens, the prefill's
last-token logits, and the logits of each decode step fed those tokens
(teacher forcing).  The reference ``LmEngine`` gives the greedy tokens of
the token-only models; it cannot pass frontend embeddings, so for seamless
and llava the reference's own ``prefill`` and ``decode_step`` run a greedy
loop here.  The first test regenerates them from the JAX package, so the
files cannot go stale; regenerate with

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
from repro_torch.models.api import cache_rows
from repro_torch.serve.engine import LmEngine

DATA = Path(__file__).parent / "data"
FIXTURES = {"smollm-360m": DATA / "torch_port_lm_smollm.npz",
            "mamba2-130m": DATA / "torch_port_lm_mamba2.npz",
            "qwen2-moe-a2.7b": DATA / "torch_port_lm_qwen2moe.npz",
            "hymba-1.5b": DATA / "torch_port_lm_hymba.npz",
            "seamless-m4t-large-v2": DATA / "torch_port_lm_seamless.npz",
            "llava-next-34b": DATA / "torch_port_lm_llava.npz"}
SEED, BATCH, PROMPT, N_NEW = 0, 2, 12, 6
#: prompt lengths other than PROMPT: hymba's is longer than its window
PROMPTS = {"hymba-1.5b": 20}
#: frontend embeddings per prompt: seamless's encoder frames, llava's
#: patches (its reduced ``frontend_tokens``)
FRONTEND = {"seamless-m4t-large-v2": 10, "llava-next-34b": 8}
#: fp32 at reduced size: the packages sum matmuls, softmaxes and the scan in
#: other orders, which moves logits by about 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)

#: leaves the reference initialises to constants, and how they are redrawn
_RANDOMISED = {"ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "ln_f": (1.0, 0.3), "ln": (1.0, 0.3),
               "norm": (1.0, 0.3), "d_skip": (1.0, 0.3), "bq": (0.0, 0.2),
               "bk": (0.0, 0.2), "bv": (0.0, 0.2), "a_log": (0.0, 0.5),
               "dt_bias": (0.0, 0.5), "norm_attn": (1.0, 0.3), "norm_ssm": (1.0, 0.3),
               "ln_x": (1.0, 0.3), "ln_enc": (1.0, 0.3)}


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


def frontend_embeds(name: str, d_model: int) -> np.ndarray | None:
    """The fixture's frontend embeddings (BATCH, FRONTEND[name], d_model),
    fp32 from a seed; None for a model that takes tokens only."""
    if name not in FRONTEND:
        return None
    rng = np.random.default_rng(SEED + 2)
    return rng.standard_normal((BATCH, FRONTEND[name], d_model)).astype(np.float32)


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
    api = r_get_model(cfg)
    fe = frontend_embeds(name, cfg.d_model)
    if fe is None:
        tokens = RLmEngine(jp, cfg, max_len=n_prompt + N_NEW).generate(prompt, N_NEW)
        logits, cache = api.prefill(jp, {"tokens": jnp.asarray(prompt)}, cfg, n_prompt + N_NEW)
        steps = []
        for i in range(N_NEW - 1):
            step_logits, cache = api.decode_step(
                jp, cache, {"tokens": jnp.asarray(tokens[:, i : i + 1])}, cfg)
            steps.append(np.asarray(step_logits[:, 0]))
        extra = {}
    else:
        # the reference's LmEngine passes tokens only: its prefill and
        # decode_step, jitted as its engine runs them, in a greedy loop
        prefill = jax.jit(api.prefill, static_argnums=(2, 3))
        step = jax.jit(api.decode_step, static_argnums=3)
        batch = {"tokens": jnp.asarray(prompt), "frontend_embeds": jnp.asarray(fe)}
        logits, cache = prefill(jp, batch, cfg, cache_rows(cfg, n_prompt, N_NEW, fe.shape[1]))
        first, out, steps = logits, [], []
        for i in range(N_NEW):
            nxt = jnp.argmax(logits[:, -1, : cfg.vocab], axis=-1)[:, None]
            out.append(np.asarray(nxt))
            if i + 1 < N_NEW:
                logits, cache = step(jp, cache, {"tokens": nxt}, cfg)
                steps.append(np.asarray(logits[:, 0]))
        tokens, logits, extra = np.concatenate(out, axis=1), first, {"frontend_embeds": fe}
    return {"prompt": prompt, "tokens": np.asarray(tokens, np.int32),
            "prefill_logits": np.asarray(logits[:, 0]), "decode_logits": np.stack(steps),
            **extra, **flatten(params)}


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
    fe = gold.get("frontend_embeds")
    rows = cache_rows(cfg, gold["prompt"].shape[1], N_NEW, 0 if fe is None else fe.shape[1])
    engine = LmEngine(params, cfg, max_len=rows, device="cpu")
    pre, steps = engine.teacher_forced(gold["prompt"], gold["tokens"], fe)
    np.testing.assert_allclose(pre.numpy(), gold["prefill_logits"], **TOL)
    np.testing.assert_allclose(steps.numpy(), gold["decode_logits"], **TOL)
    np.testing.assert_array_equal(engine.generate(gold["prompt"], N_NEW, fe), gold["tokens"])


if __name__ == "__main__":
    DATA.mkdir(exist_ok=True)
    for arch, path in FIXTURES.items():
        np.savez_compressed(path, **make_fixture(arch))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
