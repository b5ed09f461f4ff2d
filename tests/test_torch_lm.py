"""The port's LM serving path (``dense`` and ``ssm`` families) against the
reference, on the CPU: forward, prefill and decode of ``smollm-360m`` and
``mamba2-130m`` (reduced, and at full width with 2 layers), the "decode
equals forward" contract, greedy generation through ``LmEngine``, the
plain path against the kernel path, and the CLI's ``--mode lm``.

Inputs and weights are made with numpy from a seed and fed to both
packages; the reference's params are converted with
``lm_params_from_numpy``, with the constant-initialised leaves (norm scales,
QKV biases, ``a_log``, ``d_skip``, ``dt_bias``) randomised so that a wrong
head, group or scale index cannot pass.  On the CPU the port's kernels run
their plain versions: ``decode_step`` goes through ``decode_attn_plain``
where the reference runs ``sdpa``, and the SSM prefill through
``ssd_chunked``, as the reference's.  Tolerance rtol/atol 1e-4 for whole
models in fp32: the packages sum matmuls, softmaxes and the scan in other
orders (measured differences are about 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.serve.engine import LmEngine as RLmEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve.engine import LmEngine  # noqa: E402
from test_torch_lm_golden import reference_params  # noqa: E402

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["smollm-360m", "mamba2-130m"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(name, seed=0, **replace):
    """(reference cfg, port cfg, reference params (jnp), port params (cpu))."""
    rcfg = dataclasses.replace(r_get_arch(name).reduced(), **replace)
    tcfg = dataclasses.replace(get_arch(name).reduced(),
                               **{k: v for k, v in replace.items() if k != "dtype"})
    if "dtype" in replace:
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    tree = reference_params(rcfg, seed)
    return rcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _jitted(rapi):
    """The reference's (forward, prefill, decode_step) under ``jax.jit``, as
    its ``LmEngine`` runs them (op-by-op dispatch compiles every op on its
    own and takes several times longer on the CPU)."""
    return (jax.jit(rapi.forward, static_argnums=2), jax.jit(rapi.prefill, static_argnums=(2, 3)),
            jax.jit(rapi.decode_step, static_argnums=3))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _cache_arrays(cache):
    if "k" in cache:
        return {"k": cache["k"], "v": cache["v"]}
    return dict(cache["state"])


@pytest.mark.parametrize("name", MODELS)
def test_forward_prefill_decode_match_reference(name):
    rcfg, tcfg, rp, tp = _pair(name, seed=1)
    (r_forward, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    toks = _tokens(rcfg, 2, 16, seed=1)
    np.testing.assert_allclose(_np(tapi.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)),
                               _np(r_forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)),
                               **MODEL_TOL)
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :15])}, rcfg, 20)
    t_logits, t_cache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks[:, :15])}, tcfg, 20)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    for _ in range(3):  # three decode steps, the last two on the greedy token
        step = toks[:, 15:] if t_cache["pos"] == 15 else np.asarray(
            r_logits[:, -1, : rcfg.vocab].argmax(-1))[:, None].astype(np.int32)
        r_logits, r_cache = r_decode(rp, r_cache, {"tokens": jnp.asarray(step)}, rcfg)
        t_logits, t_cache = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(step)}, tcfg)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert t_cache["pos"] == int(r_cache["pos"]) == 18
    r_arr, t_arr = _cache_arrays(r_cache), _cache_arrays(t_cache)
    assert sorted(r_arr) == sorted(t_arr)
    for key in r_arr:
        np.testing.assert_allclose(_np(t_arr[key]), _np(r_arr[key]), **MODEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_forward(name):
    """The reference's KV-cache/state contract (tests/test_arch_smoke.py),
    inside the port: prefill(x[:t]) then decode_step(x[t]) equals
    forward(x[:t+1]) at the last two positions."""
    _, tcfg, _, tp = _pair(name, seed=2)
    api = get_model(tcfg)
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=2))
    full = api.forward(tp, {"tokens": toks}, tcfg)
    pre, cache = api.prefill(tp, {"tokens": toks[:, :15]}, tcfg, max_len=20)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, -2]), **MODEL_TOL)
    dec, _ = api.decode_step(tp, cache, {"tokens": toks[:, 15:]}, tcfg)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, -1]), **MODEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_plain_path_matches_kernel_path(name):
    """``use_kernel=False`` (sdpa, ssd_chunked) computes what the kernel
    path computes."""
    _, tcfg, _, tp = _pair(name, seed=5)
    toks = _tokens(tcfg, 2, 10, seed=5)
    runs = []
    for use_kernel in (True, False):
        eng = LmEngine(tp, tcfg, max_len=16, device="cpu", use_kernel=use_kernel)
        logits, cache = eng.prefill(toks[:, :9])
        step, _ = eng.step(cache, toks[:, 9:])
        runs.append((_np(logits), _np(step)))
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_generate_matches_reference(name):
    rcfg, tcfg, rp, tp = _pair(name, seed=6)
    prompt = _tokens(rcfg, 2, 10, seed=6)
    want = RLmEngine(rp, rcfg, max_len=18).generate(prompt, 8)
    eng = LmEngine(tp, tcfg, max_len=18, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompt, 8), np.asarray(want))
    assert eng.launches == {"decode_attn": 0, "ssd_scan": 0}  # plain versions on the CPU


@pytest.mark.parametrize("name", MODELS)
def test_full_width_two_layers(name):
    """The published widths (vocab, d_model, heads, SSD dims), 2 layers, fp32."""
    rcfg = dataclasses.replace(r_get_arch(name), n_layers=2, dtype=jnp.float32)
    tcfg = dataclasses.replace(get_arch(name), n_layers=2, dtype=torch.float32)
    tree = reference_params(rcfg, 7)
    rp, tp = jax.tree_util.tree_map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")
    toks = _tokens(rcfg, 1, 9, seed=7)
    (_, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :8])}, rcfg, 12)
    t_logits, t_cache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])}, tcfg, 12)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    r_logits, _ = r_decode(rp, r_cache, {"tokens": jnp.asarray(toks[:, 8:])}, rcfg)
    t_logits, _ = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(toks[:, 8:])}, tcfg)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)


def test_ssm_block_continues_from_a_state():
    """``ssm_block`` over a second segment from the first segment's state
    (conv history and SSD state) matches the reference's."""
    rcfg, tcfg, rp, tp = _pair("mamba2-130m", seed=8)
    rb = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["ssm"])
    tb = TL.layer(tp["layers"]["ssm"], 0)
    x = np.random.default_rng(8).standard_normal((2, 11, rcfg.d_model)).astype(np.float32)
    r_block = jax.jit(lambda b, x, st: rssm.ssm_block(b, x, rcfg, state=st))
    _, r_st = r_block(rb, jnp.asarray(x[:, :5]), None)
    r_out, r_st = r_block(rb, jnp.asarray(x[:, 5:]), r_st)
    _, t_st = tssm.ssm_block(tb, torch.from_numpy(x[:, :5]), tcfg)
    t_out, t_st = tssm.ssm_block(tb, torch.from_numpy(x[:, 5:]), tcfg, state=t_st)
    np.testing.assert_allclose(_np(t_out), _np(r_out), **MODEL_TOL)
    for key in ("conv", "ssd"):
        np.testing.assert_allclose(_np(t_st[key]), _np(r_st[key]), **MODEL_TOL)


@pytest.mark.parametrize("name,family", [(name, cfg.family) for name, cfg in sorted(ARCHS.items())])
def test_later_families_are_refused(name, family):
    """No family is refused any more (the test keeps the name of the
    refusal it replaced): ``get_model`` takes every arch of the reference, which covers every family of its ``_FAMILIES``, with
    the entry points a family's serving path needs."""
    from repro.models.api import _FAMILIES

    assert set(_FAMILIES) == {cfg.family for cfg in ARCHS.values()}
    api = get_model(get_arch(name))
    assert api.family == family
    assert all(callable(getattr(api, entry)) for entry in
               ("init_params", "forward", "prefill", "decode_step", "init_cache"))


def test_lm_params_from_numpy_casts_model_dtype_leaves_only():
    tree = {"embed": np.ones((4, 2), np.float32),
            "layers": {"attn": {"wq": np.ones((1, 2, 2), np.float32),
                                "bq": np.ones((1, 2), np.float32)},
                       "ln1": np.ones((1, 2), np.float32)}}
    out = lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert out["embed"].dtype == out["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert out["layers"]["attn"]["bq"].dtype == out["layers"]["ln1"].dtype == torch.float32
    bits = np.asarray(jnp.asarray(np.linspace(-3, 3, 8, dtype=np.float32), jnp.bfloat16))
    got = lm_params_from_numpy({"embed": bits}, "cpu")["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), bits.view(np.int16))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_cli_lm_mode_on_cpu(name, capsys):
    out = tcli.main(["--mode", "lm", "--arch", name, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["launches"] == {"decode_attn": 0, "ssd_scan": 0}
    assert f"{name}: generated (2, 4)" in capsys.readouterr().out
