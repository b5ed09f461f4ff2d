"""The port's hybrid family (``repro_torch.models.hybrid``, hymba-1.5b) and
windowed ``flash_attention`` against the reference, on the CPU.

Reduced hymba-1.5b has a window of 16: prompts shorter than it, prompts
whose decode steps wrap the ring, and prompts longer than it (the ring
wraps in prefill) go through prefill and teacher-forced decode in both
packages; the ring cache, the SSM state, greedy generation through
``LmEngine`` (whose position check lets a ring wrap), the CLI, and a
prefill above the 1024-token flash threshold.  Windowed ``flash_attention``
at S=1030 with windows 16 and 300, ``q_offset`` 0 and > 0.

Inputs and weights are made with numpy from a seed; the reference's params
are converted with ``lm_params_from_numpy`` (``norm_attn``, ``norm_ssm``
and the other constant-initialised leaves randomised).  Tolerances: whole
models rtol/atol 1e-4 in fp32, attention 1e-5 (other summation orders;
measured differences are about 1e-6).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import hybrid as rhybrid  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.models.flash_attention import flash_attention as r_flash  # noqa: E402
from repro.serve.engine import LmEngine as RLmEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.flash_attention import flash_attention  # noqa: E402
from repro_torch.serve.engine import LmEngine  # noqa: E402
from test_torch_lm import MODEL_TOL, _jitted, _np, _pair, _tokens  # noqa: E402

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "hymba-1.5b"


def _cache_arrays(cache):
    return {"k": cache["k"], "v": cache["v"], **cache["state"]}


@pytest.mark.parametrize("prompt,n_new", [(10, 6), (12, 10), (20, 6)])
def test_prefill_and_decode_match_reference(prompt, n_new):
    """Window 16: a prompt inside the ring (10), one whose decode steps wrap
    it (12 + 10 over 16 slots) and one longer than it (20)."""
    rcfg, tcfg, rp, tp = _pair(NAME, seed=prompt)
    (_, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    toks = _tokens(rcfg, 2, prompt + n_new, seed=prompt)
    max_len = prompt + n_new
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :prompt])}, rcfg, max_len)
    t_logits, t_cache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks[:, :prompt])}, tcfg,
                                     max_len)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert t_cache["k"].shape[2] == min(16, max_len)
    for i in range(prompt, prompt + n_new - 1):  # teacher forcing
        step = toks[:, i : i + 1]
        r_logits, r_cache = r_decode(rp, r_cache, {"tokens": jnp.asarray(step)}, rcfg)
        t_logits, t_cache = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(step)}, tcfg)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert t_cache["pos"] == int(r_cache["pos"]) == prompt + n_new - 1
    r_arr, t_arr = _cache_arrays(r_cache), _cache_arrays(t_cache)
    for key in r_arr:
        np.testing.assert_allclose(_np(t_arr[key]), _np(r_arr[key]), **MODEL_TOL)


def test_forward_matches_reference_and_decode():
    rcfg, tcfg, rp, tp = _pair(NAME, seed=3)
    toks = _tokens(rcfg, 2, 24, seed=3)
    r_forward = jax.jit(r_get_model(rcfg).forward, static_argnums=2)
    api = get_model(tcfg)
    full = api.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(full), _np(r_forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)),
                               **MODEL_TOL)
    # decode equals forward, across the wrap of a 16-slot ring
    pre, cache = api.prefill(tp, {"tokens": torch.from_numpy(toks[:, :14])}, tcfg, max_len=24)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, 13]), **MODEL_TOL)
    for i in range(14, 24):
        dec, cache = api.decode_step(tp, cache, {"tokens": torch.from_numpy(toks[:, i : i + 1])},
                                     tcfg)
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, i]), **MODEL_TOL)


def test_generate_matches_reference():
    """Greedy tokens equal with the ring wrapping (prompt 12, 10 new tokens,
    16 slots): the engine's position check lets a ring pass its rows."""
    rcfg, tcfg, rp, tp = _pair(NAME, seed=6)
    prompt = _tokens(rcfg, 2, 12, seed=6)
    want = RLmEngine(rp, rcfg, max_len=22).generate(prompt, 10)
    for use_kernel in (True, False):
        eng = LmEngine(tp, tcfg, max_len=22, device="cpu", use_kernel=use_kernel)
        np.testing.assert_array_equal(eng.generate(prompt, 10), np.asarray(want))
        assert eng.launches == {"decode_attn": 0, "ssd_scan": 0}  # plain versions on the CPU


def test_prefill_above_the_flash_threshold():
    """S = 1030 > 1024: both packages take their blocked, windowed path."""
    rcfg, tcfg, rp, tp = _pair(NAME, seed=4)
    toks = _tokens(rcfg, 1, 1030, seed=4)
    r_prefill = jax.jit(r_get_model(rcfg).prefill, static_argnums=(2, 3))
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, 1032)
    t_logits, t_cache = get_model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 1032)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    for key, arr in _cache_arrays(r_cache).items():
        np.testing.assert_allclose(_np(_cache_arrays(t_cache)[key]), _np(arr), **MODEL_TOL)


@pytest.mark.parametrize("window", [16, 300])
@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (1030, 1030, 0, True), (30, 1030, 1000, True), (1030, 1100, 70, True),
    (1030, 1030, 0, False)])
def test_windowed_flash_attention_matches_reference(window, sq, sk, q_offset, causal):
    rng = np.random.default_rng(window + sq + q_offset)
    q = rng.standard_normal((1, sq, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, 2, 8)).astype(np.float32) for _ in range(2))
    want = r_flash(*(jnp.asarray(a) for a in (q, k, v)), causal, window, q_offset)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal, window, q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


def test_windowed_flash_attention_refuses_a_query_with_no_key():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="none of the 4 keys"):
        flash_attention(x, x, x, True, 2, 6)


def test_init_params_and_conversion_keep_the_reference_dtypes():
    """bf16 conversion: attention, MLP, SSM projections and embeddings at
    the model dtype; norms (``norm_attn``, ``norm_ssm`` too) and the SSM's
    scalars fp32, as the reference and ``init_params`` keep them."""
    import dataclasses

    from repro.configs import get_arch as r_get_arch
    from repro_torch.tree import flatten
    from test_torch_lm_golden import reference_params

    rcfg = dataclasses.replace(r_get_arch(NAME).reduced(), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch(NAME).reduced(), dtype=torch.bfloat16)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), reference_params(rcfg, 0))
    got = flatten(lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16))
    made = flatten(thybrid.init_params(tcfg, seed=0, device="cpu"))
    assert sorted(got) == sorted(made)
    for key, leaf in got.items():
        fp32 = key.split("/")[-1] in ("ln1", "ln2", "ln_f", "norm_attn", "norm_ssm", "norm",
                                      "conv_w", "a_log", "d_skip", "dt_bias")
        assert leaf.dtype == made[key].dtype == (torch.float32 if fp32 else torch.bfloat16), key
        assert leaf.shape == made[key].shape, key


def test_cli_lm_mode_on_cpu(capsys):
    out = tcli.main(["--mode", "lm", "--arch", NAME, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "20", "--new-tokens", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["launches"] == {"decode_attn": 0, "ssd_scan": 0}
    assert f"{NAME}: generated (2, 4)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card (marked gpu: skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("prompt", [10, 20])
def test_graph_replay_equals_eager(cuda, prompt):
    """Replayed prefill and decode graphs give the eager kernel path's
    logits bit for bit across the ring's wrap; K4 once per layer per
    prefill, K5 once per layer per decode step."""
    cfg = get_arch(NAME).reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    tokens_in = _tokens(cfg, 3, prompt, seed=prompt)
    replay = LmEngine(params, cfg, max_len=prompt + 12)
    eager = LmEngine(params, cfg, max_len=prompt + 12, graphs=False)
    tokens = replay.generate(tokens_in, 12)
    np.testing.assert_array_equal(eager.generate(tokens_in, 12), tokens)
    r_pre, r_steps = replay.teacher_forced(tokens_in, tokens)
    e_pre, e_steps = eager.teacher_forced(tokens_in, tokens)
    assert torch.equal(r_pre, e_pre) and torch.equal(r_steps, e_steps)
    assert replay.launches == eager.launches == {"decode_attn": 2 * cfg.n_layers * 11,
                                                 "ssd_scan": 2 * cfg.n_layers}


@pytest.mark.gpu
@pytest.mark.parametrize("t_len", [1, 64, 512, 1536])
def test_ssd_scan_at_the_hymba_shape(cuda, t_len):
    """K4 at hymba's H=25, P=64, N=16, G=1 against its plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    gen = torch.Generator(device=cuda).manual_seed(t_len)
    dt = F.softplus(torch.randn(8, t_len, 25, generator=gen, device=cuda))
    a = -torch.exp(torch.randn(25, generator=gen, device=cuda) * 0.5)
    x = torch.randn(8, t_len, 25, 64, generator=gen, device=cuda)
    bm, cm = (torch.randn(8, t_len, 1, 16, generator=gen, device=cuda) * 0.3 for _ in range(2))
    y, s_f = ssd_scan(x, dt, a, bm, cm, None, chunk=64)
    y_p, s_p = ssd_chunked(x, dt, a, bm, cm, None, chunk=64)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_f, s_p, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_at_the_hymba_geometry(cuda, dtype):
    """K5 at hymba's 25/5 heads, D=64 (G=5), over a ring of 1024 slots."""
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain

    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(8, 25, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(8, 1024, 5, 64, generator=gen, device=cuda).to(dtype) for _ in range(2))
    lengths = torch.tensor([1024, 1, 63, 64, 65, 513, 1000, 1023], dtype=torch.int32, device=cuda)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(decode_attn(q, k, v, lengths).float(),
                               decode_attn_plain(q, k, v, lengths).float(), **tol)
