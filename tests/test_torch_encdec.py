"""The port's frontend-fed LMs against the reference, on the CPU: the
``encdec`` family (``repro_torch.models.encdec``, seamless-m4t-large-v2)
and the VLM splice of the dense family (llava-next-34b), both reduced.

For seamless: ``encode``, ``_dec_layer``, ``forward``, ``prefill`` (logits
and every cache leaf) and three ``decode_step``s, at 10 frames (every
attention on ``sdpa``) and at 1,030 frames (the encoder's self-attention
and ``forward``'s cross-attention on non-causal ``flash_attention``, while
``prefill`` keeps ``sdpa``, as in the reference); the port's own contract
that prefill then decode equals ``forward``; the tree that ``init_params``
draws and ``lm_params_from_numpy`` carries.  For llava: the patches
spliced in front of the tokens in ``forward`` and ``prefill``, and decode
after a spliced prefill.  ``LmEngine``'s frontend input: a missing frame
input raises a ``ValueError`` naming it, a model without a frontend
refuses one, a VLM without one serves text only, and two frame counts
through one engine give what two engines give.

Inputs and weights are made with numpy from a seed and fed to both
packages; the reference's params are converted with
``lm_params_from_numpy``, with the constant-initialised leaves (norm
scales, ``ln_x`` and ``ln_enc`` among them) randomised.  Tolerance
rtol/atol 1e-4 for whole models in fp32 (other summation orders; measured
differences are about 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import encdec as rencdec  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.models.layers import NO_SHARD  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve.engine import LmEngine  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_lm import MODEL_TOL, _jitted, _np, _pair, _tokens  # noqa: E402
from test_torch_lm_golden import reference_params  # noqa: E402

SEAMLESS, LLAVA = "seamless-m4t-large-v2", "llava-next-34b"
#: (batch, frames): every attention on sdpa; the flash branch of the
#: encoder and of forward's cross-attention (above 1024 frames)
FRAME_CASES = [(2, 10), (1, 1030)]


def _embeds(cfg, b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the encdec family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,frames", FRAME_CASES)
def test_encode_and_dec_layer_match_reference(batch, frames):
    rcfg, tcfg, rp, tp = _pair(SEAMLESS, seed=frames)
    fe = _embeds(rcfg, batch, frames, seed=frames)
    r_enc = jax.jit(rencdec.encode, static_argnums=2)(rp, jnp.asarray(fe), rcfg)
    t_enc = tencdec.encode(tp, torch.from_numpy(fe), tcfg)
    np.testing.assert_allclose(_np(t_enc), _np(r_enc), **MODEL_TOL)
    x = _embeds(rcfg, batch, 7, seed=frames + 1)
    rope_r = RL.rope_tables(jnp.arange(7), rcfg.hd, rcfg.rope_theta)
    rope_t = TL.rope_tables(torch.arange(7), tcfg.hd, tcfg.rope_theta)
    for i in range(tcfg.n_layers):
        r_lp = jax.tree_util.tree_map(lambda a: a[i], rp["dec_layers"])
        r_out = rencdec._dec_layer(jnp.asarray(x), r_lp, r_enc, rcfg, rope_r, NO_SHARD)
        t_out = tencdec._dec_layer(torch.from_numpy(x), TL.layer(tp["dec_layers"], i), t_enc,
                                   tcfg, rope_t)
        np.testing.assert_allclose(_np(t_out), _np(r_out), **MODEL_TOL)


@pytest.mark.parametrize("batch,frames", FRAME_CASES)
def test_forward_prefill_decode_match_reference(batch, frames):
    rcfg, tcfg, rp, tp = _pair(SEAMLESS, seed=frames + 2)
    (r_forward, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    fe = _embeds(rcfg, batch, frames, seed=frames + 2)
    toks = _tokens(rcfg, batch, 16, seed=frames + 2)
    r_batch = {"frontend_embeds": jnp.asarray(fe), "tokens": jnp.asarray(toks)}
    t_batch = {"frontend_embeds": torch.from_numpy(fe), "tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(_np(tapi.forward(tp, t_batch, tcfg)),
                               _np(r_forward(rp, r_batch, rcfg)), **MODEL_TOL)
    r_logits, r_cache = r_prefill(rp, {**r_batch, "tokens": r_batch["tokens"][:, :13]}, rcfg, 20)
    t_logits, t_cache = tapi.prefill(tp, {**t_batch, "tokens": t_batch["tokens"][:, :13]}, tcfg,
                                     20)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert sorted(t_cache) == sorted(r_cache) == ["k", "pos", "v", "xk", "xv"]
    assert t_cache["xk"].shape[2] == frames and t_cache["k"].shape[2] == 20
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == 13
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(_np(t_cache[key]), _np(r_cache[key]), **MODEL_TOL)
    for i in range(13, 16):  # three decode steps
        step = toks[:, i : i + 1]
        r_logits, r_cache = r_decode(rp, r_cache, {"tokens": jnp.asarray(step)}, rcfg)
        t_logits, t_cache = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(step)},
                                             tcfg)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == 16
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(_np(t_cache[key]), _np(r_cache[key]), **MODEL_TOL)


@pytest.mark.parametrize("batch,frames", FRAME_CASES)
def test_decode_matches_forward(batch, frames):
    """prefill(x[:t]) then decode_step(x[t]) equals forward(x[:t+1]) at the
    last positions, over the same frames."""
    _, tcfg, _, tp = _pair(SEAMLESS, seed=frames + 3)
    api = get_model(tcfg)
    fe = torch.from_numpy(_embeds(tcfg, batch, frames, seed=frames + 3))
    toks = torch.from_numpy(_tokens(tcfg, batch, 16, seed=frames + 3))
    full = api.forward(tp, {"frontend_embeds": fe, "tokens": toks}, tcfg)
    pre, cache = api.prefill(tp, {"frontend_embeds": fe, "tokens": toks[:, :14]}, tcfg, 20)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, 13]), **MODEL_TOL)
    for i in (14, 15):
        dec, cache = api.decode_step(tp, cache, {"tokens": toks[:, i : i + 1]}, tcfg)
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, i]), **MODEL_TOL)


def test_init_cache_sizes_cross_kv_as_the_reference():
    rcfg, tcfg = r_get_arch(SEAMLESS).reduced(), get_arch(SEAMLESS).reduced()
    want = jax.eval_shape(lambda: rencdec.init_cache(rcfg, 3, 24))
    got = tencdec.init_cache(tcfg, 3, 24, device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
    assert got["xk"].shape[2] == tencdec.ENC_LEN_DECODE == rencdec.ENC_LEN_DECODE


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
@pytest.mark.parametrize("bf16", [False, True])
def test_init_params_tree_and_dtypes(name, bf16):
    """``init_params`` (drawn on the target device, here the CPU) makes the
    reference's tree, shapes and dtypes, the norm scales fp32; the same
    seed gives the same weights; ``lm_params_from_numpy`` carries the
    reference's tree across with the same dtypes."""
    rcfg, tcfg = r_get_arch(name).reduced(), get_arch(name).reduced()
    if bf16:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: r_get_model(rcfg).init_params(jax.random.PRNGKey(0), rcfg))
    flat_w = {"/".join(str(k.key) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = flatten(get_model(tcfg).init_params(tcfg, seed=0, device="cpu"))
    again = flatten(get_model(tcfg).init_params(tcfg, seed=0, device="cpu"))
    tree = reference_params(dataclasses.replace(rcfg, dtype=jnp.float32), 0)
    carried = flatten(lm_params_from_numpy(tree, "cpu", dtype=tcfg.dtype))
    assert sorted(got) == sorted(flat_w) == sorted(carried)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == tuple(flat_w[key].shape) == tuple(carried[key].shape), key
        assert str(leaf.dtype).split(".")[-1] == str(flat_w[key].dtype), key
        assert carried[key].dtype == leaf.dtype, key
        assert torch.equal(leaf, again[key]), key
        if key.split("/")[-1].startswith("ln"):
            assert leaf.dtype == torch.float32, key


# ---------------------------------------------------------------------------
# the VLM splice (llava)
# ---------------------------------------------------------------------------

def test_llava_splice_matches_reference():
    """Patches spliced in front of the tokens: forward, prefill (logits and
    cache, position P + S) and three decode steps after it."""
    rcfg, tcfg, rp, tp = _pair(LLAVA, seed=11)
    (r_forward, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    n_patch = tcfg.frontend_tokens
    fe = _embeds(rcfg, 2, n_patch, seed=11)
    toks = _tokens(rcfg, 2, 12, seed=11)
    r_batch = {"frontend_embeds": jnp.asarray(fe), "tokens": jnp.asarray(toks)}
    t_batch = {"frontend_embeds": torch.from_numpy(fe), "tokens": torch.from_numpy(toks)}
    t_full = tapi.forward(tp, t_batch, tcfg)
    assert t_full.shape[1] == n_patch + 12
    np.testing.assert_allclose(_np(t_full), _np(r_forward(rp, r_batch, rcfg)), **MODEL_TOL)
    rows = n_patch + 12 + 3
    r_logits, r_cache = r_prefill(rp, {**r_batch, "tokens": r_batch["tokens"][:, :9]}, rcfg, rows)
    t_logits, t_cache = tapi.prefill(tp, {**t_batch, "tokens": t_batch["tokens"][:, :9]}, tcfg,
                                     rows)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == n_patch + 9
    for i in range(9, 12):
        step = toks[:, i : i + 1]
        r_logits, r_cache = r_decode(rp, r_cache, {"tokens": jnp.asarray(step)}, rcfg)
        t_logits, t_cache = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(step)},
                                             tcfg)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
        # decode after a spliced prefill equals the spliced forward
        np.testing.assert_allclose(_np(t_logits[:, 0]), _np(t_full[:, n_patch + i]), **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(t_cache[key]), _np(r_cache[key]), **MODEL_TOL)


def test_llava_engine_splices_and_counts_the_patches():
    """``LmEngine`` with patches equals the reference's greedy loop over its
    own prefill and decode_step; its host position counts the patches;
    without patches it serves text only, as the reference does."""
    rcfg, tcfg, rp, tp = _pair(LLAVA, seed=12)
    _, r_prefill, r_decode = _jitted(r_get_model(rcfg))
    fe = _embeds(rcfg, 2, tcfg.frontend_tokens, seed=12)
    prompt = _tokens(rcfg, 2, 6, seed=12)
    rows = tcfg.frontend_tokens + 6 + 4
    eng = LmEngine(tp, tcfg, max_len=rows, device="cpu")
    logits, cache = eng.prefill(prompt, fe)
    assert eng._position(cache) == int(cache["pos"]) == tcfg.frontend_tokens + 6
    for with_patches in (True, False):
        batch = {"tokens": jnp.asarray(prompt)}
        if with_patches:
            batch["frontend_embeds"] = jnp.asarray(fe)
        r_logits, r_cache = r_prefill(rp, batch, rcfg, rows)
        want = []
        for _ in range(4):
            nxt = jnp.argmax(r_logits[:, -1, : rcfg.vocab], axis=-1)[:, None]
            want.append(np.asarray(nxt))
            r_logits, r_cache = r_decode(rp, r_cache, {"tokens": nxt}, rcfg)
        got = eng.generate(prompt, 4, fe if with_patches else None)
        np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


# ---------------------------------------------------------------------------
# LmEngine's frontend input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["prefill", "teacher_forced", "generate"])
def test_engine_needs_the_frames(entry):
    """An encoder-decoder model without its frames: a ValueError that names
    the input (the reference's engine dies on a KeyError there)."""
    _, tcfg, _, tp = _pair(SEAMLESS, seed=4)
    eng = LmEngine(tp, tcfg, max_len=12, device="cpu")
    prompt = _tokens(tcfg, 2, 5, seed=4)
    call = {"prefill": lambda: eng.prefill(prompt),
            "teacher_forced": lambda: eng.teacher_forced(prompt, prompt),
            "generate": lambda: eng.generate(prompt, 3)}[entry]
    with pytest.raises(ValueError, match="frontend_embeds"):
        call()


@pytest.mark.parametrize("name,shape", [("smollm-360m", (2, 4, 64)), (SEAMLESS, (2, 4, 32)),
                                        (SEAMLESS, (3, 4, 64)), (LLAVA, (2, 4))])
def test_engine_refuses_frontend_embeds_it_cannot_take(name, shape):
    """A model with neither a frontend nor an encoder refuses them; a wrong
    batch or width, or a tensor that is not (B, P, d_model), is refused."""
    cfg = get_arch(name).reduced()
    eng = LmEngine(get_model(cfg).init_params(cfg, seed=0, device="cpu"), cfg, max_len=16,
                   device="cpu")
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.prefill(_tokens(cfg, 2, 5), np.zeros(shape, np.float32))


def test_two_frame_counts_through_one_engine():
    """Requests with 10 and 14 frames through one engine, in turns, give the
    logits and tokens that an engine of their own gives each."""
    _, tcfg, _, tp = _pair(SEAMLESS, seed=9)
    prompt = _tokens(tcfg, 2, 6, seed=9)
    fes = {n: _embeds(tcfg, 2, n, seed=n) for n in (10, 14)}
    shared = LmEngine(tp, tcfg, max_len=12, device="cpu")
    for n in (10, 14, 10):
        alone = LmEngine(tp, tcfg, max_len=12, device="cpu")
        pre_s, steps_s = shared.teacher_forced(prompt, prompt, fes[n])
        pre_a, steps_a = alone.teacher_forced(prompt, prompt, fes[n])
        assert torch.equal(pre_s, pre_a) and torch.equal(steps_s, steps_a)
        np.testing.assert_array_equal(shared.generate(prompt, 5, fes[n]),
                                      alone.generate(prompt, 5, fes[n]))
    assert shared.launches == {"decode_attn": 0, "ssd_scan": 0}  # no kernel in this family
