"""The LM cache's position as a device scalar, on the CPU.

The port's caches carry ``pos`` as a 0-d int32 tensor on the cache's
device, as the reference's do, and the decode step reads and advances it
with device ops only (so the step can be captured once and replayed).
``LmEngine`` counts each cache's position on the host and refuses a step
past the cache's last row with a ``ValueError`` before it launches
anything.  The reduced smollm-360m and mamba2-130m models keep matching
the reference's logits within 1e-4 with equal greedy tokens (the golden
fixtures of ``test_torch_lm_golden.py``, which the JAX package
regenerates); the layer's ``attention_decode`` takes a tensor ``pos`` on
both branches and agrees with the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _pair
from test_torch_lm_golden import FIXTURES, N_NEW, PROMPT, TOL

from repro.models import layers as RL
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, unflatten
from repro_torch.models import layers as TL
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine

MODELS = ["smollm-360m", "mamba2-130m"]


def _is_pos(t, value: int) -> bool:
    return (isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype == torch.int32
            and int(t) == value)


@pytest.mark.parametrize("name", MODELS)
def test_cache_pos_is_a_0d_int32_tensor_advanced_in_place(name):
    cfg = get_arch(name).reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 7)))
    assert _is_pos(api.init_cache(cfg, 2, 10, device="cpu")["pos"], 0)
    _, cache = api.prefill(params, {"tokens": toks[:, :6]}, cfg, 10)
    pos = cache["pos"]
    assert _is_pos(pos, 6)
    _, cache2 = api.decode_step(params, cache, {"tokens": toks[:, 6:]}, cfg)
    assert cache2["pos"] is pos and _is_pos(pos, 7)


@pytest.mark.parametrize("name", MODELS)
def test_engine_matches_golden_fixture(name):
    with np.load(FIXTURES[name]) as data:
        gold = {k: data[k] for k in data.files}
    cfg = get_arch(name).reduced()
    eng = LmEngine(lm_params_from_numpy(unflatten(gold), "cpu"), cfg,
                   max_len=PROMPT + N_NEW, device="cpu")
    pre, steps = eng.teacher_forced(gold["prompt"], gold["tokens"])
    np.testing.assert_allclose(pre.numpy(), gold["prefill_logits"], **TOL)
    np.testing.assert_allclose(steps.numpy(), gold["decode_logits"], **TOL)
    np.testing.assert_array_equal(eng.generate(gold["prompt"], N_NEW), gold["tokens"])


def test_engine_refuses_a_step_past_the_cache():
    cfg = get_arch("smollm-360m").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    eng = LmEngine(params, cfg, max_len=5, device="cpu")
    logits, cache = eng.prefill(np.zeros((2, 4), np.int32))
    nxt = logits[:, -1:, : cfg.vocab].argmax(-1)
    logits, cache = eng.step(cache, nxt)  # row 4, the last one
    k_before, launches = cache["k"].clone(), dict(eng.launches)
    with pytest.raises(ValueError, match="position 5 outside a cache of 5 rows"):
        eng.step(cache, nxt)
    assert torch.equal(cache["k"], k_before) and eng.launches == launches
    assert int(cache["pos"]) == 5


def test_engine_steps_a_cache_it_did_not_make():
    """A cache made elsewhere (its position read once from the tensor)."""
    cfg = get_arch("mamba2-130m").reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 6)))
    _, cache = api.prefill(params, {"tokens": toks[:, :5]}, cfg, 8)
    want, _ = api.decode_step(params, {k: (v.clone() if torch.is_tensor(v) else
                                            {kk: vv.clone() for kk, vv in v.items()})
                                       for k, v in cache.items()},
                              {"tokens": toks[:, 5:]}, cfg)
    got, cache = LmEngine(params, cfg, max_len=8, device="cpu").step(cache, toks[:, 5:])
    assert torch.equal(got, want) and _is_pos(cache["pos"], 6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_decode_takes_a_tensor_pos(use_kernel):
    rcfg, tcfg, rp, tp = _pair("qwen1.5-4b", seed=8)
    rattn = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["attn"])
    tattn = TL.layer(tp["layers"]["attn"], 0)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 20, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    want, _, _ = RL.attention_decode(rattn, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(11, jnp.int32), rcfg, use_kernel=use_kernel)
    t_k, t_v = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    pos = torch.tensor(11, dtype=torch.int32)
    got, _, _ = TL.attention_decode(tattn, torch.from_numpy(x), t_k, t_v, pos, tcfg,
                                    use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert int(pos) == 11  # the layer reads pos; the model's step advances it
