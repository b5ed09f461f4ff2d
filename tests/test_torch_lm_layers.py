"""The building blocks of the port's LM serving path against the reference,
on the CPU: ``rms_norm``, RoPE, ``sdpa`` with its causal, window, length
and offset masks, ``attention_decode`` on both branches with its in-place
cache write, ``flash_attention`` (causal, ``q_offset``, GQA), and prefill
above the flash threshold.

Inputs and weights are made with numpy from a seed and fed to both
packages (``qwen1.5-4b``'s geometry, with randomised QKV biases, for the
decode layer).  Tolerances: rtol/atol 1e-5 for single layers in fp32 and
1e-4 for a whole prefill (other summation orders); 0.02 for bf16 layer
outputs, which each package rounds to bf16 once.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.models.flash_attention import flash_attention as r_flash  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.flash_attention import flash_attention  # noqa: E402
from test_torch_lm_golden import reference_params  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.02, atol=0.02)


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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    tol = LAYER_TOL if dtype == "fp32" else BF16_TOL
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    got = TL.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(RL.rms_norm(jx, jnp.asarray(scale), 1e-5)), **tol)
    pos = np.array([0, 3, 9, 100, 511, 575, 1000])
    rc, rs = RL.rope_tables(jnp.asarray(pos), 16, 1e4)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 16, 1e4)
    np.testing.assert_allclose(_np(tc), _np(rc), **LAYER_TOL)
    np.testing.assert_allclose(_np(ts), _np(rs), **LAYER_TOL)
    got = TL.apply_rope(tx, tc, ts)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(RL.apply_rope(jx, rc, rs)), **tol)


SDPA_CASES = {
    "causal": dict(sq=9, sk=9, causal=True),
    "causal_window": dict(sq=12, sk=12, causal=True, window=4),
    "decode_kv_len": dict(sq=1, sk=20, causal=False, q_offset=13, kv_len=14),
    "decode_window": dict(sq=1, sk=20, causal=False, q_offset=13, kv_len=14, window=5),
    "chunk_q_offset": dict(sq=4, sk=20, causal=True, q_offset=10, kv_len=14),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_masks_match_reference(case, dtype):
    kw = dict(SDPA_CASES[case])
    sq, sk = kw.pop("sq"), kw.pop("sk")
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((2, sq, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 8)).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = RL.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    got = TL.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **(LAYER_TOL if dtype == "fp32" else BF16_TOL))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_decode_matches_reference(use_kernel):
    """qwen1.5 geometry (QKV biases, randomised): the new row lands in the
    cache at pos and the output matches both reference branches (the kernel
    branch runs the Pallas kernel in interpret mode)."""
    rcfg, tcfg, rp, tp = _pair("qwen1.5-4b", seed=3)
    rattn = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["attn"])
    tattn = TL.layer(tp["layers"]["attn"], 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 24, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = 17
    r_out, r_k, r_v = RL.attention_decode(rattn, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.asarray(pos, jnp.int32), rcfg, use_kernel=use_kernel)
    t_k, t_v = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t_out, t_k2, t_v2 = TL.attention_decode(tattn, torch.from_numpy(x), t_k, t_v, pos, tcfg,
                                            use_kernel=use_kernel)
    assert t_k2 is t_k  # written in place
    np.testing.assert_allclose(_np(t_out), _np(r_out), **LAYER_TOL)
    np.testing.assert_allclose(_np(t_k), _np(r_k), **LAYER_TOL)
    np.testing.assert_allclose(_np(t_v), _np(r_v), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["causal", "window", "cross"])
def test_full_sequence_attention_matches_reference(kind):
    """``attention`` (QKV biases randomised): causal self-attention with
    RoPE, a sliding window, and cross-attention (no RoPE, no mask)."""
    rcfg, tcfg, rp, tp = _pair("qwen1.5-4b", seed=9)
    rattn = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["attn"])
    tattn = TL.layer(tp["layers"]["attn"], 0)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 10, rcfg.d_model)).astype(np.float32)
    x_kv = rng.standard_normal((2, 7, rcfg.d_model)).astype(np.float32)
    kw = {"causal": {}, "window": {"window": 3}, "cross": {}}[kind]
    pos = np.arange(10)
    r_rope = RL.rope_tables(jnp.asarray(pos), rcfg.hd, rcfg.rope_theta)
    t_rope = TL.rope_tables(torch.from_numpy(pos), tcfg.hd, tcfg.rope_theta)
    r_kv = {"x_kv": jnp.asarray(x_kv)} if kind == "cross" else {}
    t_kv = {"x_kv": torch.from_numpy(x_kv)} if kind == "cross" else {}
    want = RL.attention(rattn, jnp.asarray(x), rcfg, rope=r_rope, **kw, **r_kv)
    got = TL.attention(tattn, torch.from_numpy(x), tcfg, rope=t_rope, **kw, **t_kv)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_kernel_branch_refuses_a_window():
    _, tcfg, _, tp = _pair("smollm-360m")
    cache = torch.zeros(1, 8, tcfg.n_kv_heads, tcfg.hd)
    with pytest.raises(ValueError, match="no window mask"):
        TL.attention_decode(TL.layer(tp["layers"]["attn"], 0), torch.zeros(1, 1, tcfg.d_model),
                            cache, cache.clone(), 3, tcfg, window=4, use_kernel=True)


@pytest.mark.parametrize("sq,sk,causal,q_offset", [
    (40, 40, True, 0), (8, 40, True, 32), (8, 40, True, 10), (8, 40, True, 50),
    (8, 40, True, 0), (40, 40, False, 0)])
def test_flash_attention_matches_reference(sq, sk, causal, q_offset):
    rng = np.random.default_rng(sq + sk + q_offset)
    q = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 8)).astype(np.float32) for _ in range(2))
    want = r_flash(*(jnp.asarray(a) for a in (q, k, v)), causal, None, q_offset)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal, None, q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_prefill_above_the_flash_threshold():
    """S = 1030 > 1024: both packages take their blocked path."""
    rcfg, tcfg, rp, tp = _pair("smollm-360m", seed=4)
    toks = _tokens(rcfg, 1, 1030, seed=4)
    r_prefill = jax.jit(r_get_model(rcfg).prefill, static_argnums=(2, 3))
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, 1032)
    t_logits, t_cache = get_model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 1032)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    np.testing.assert_allclose(_np(t_cache["k"]), _np(r_cache["k"]), **MODEL_TOL)
    assert t_cache["pos"] == int(r_cache["pos"]) == 1030
