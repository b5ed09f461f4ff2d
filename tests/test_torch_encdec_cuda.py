"""The frontend-fed LMs on the card (marked ``gpu``; skipped without one):
replayed graphs against eager runs, bit for bit, for reduced
seamless-m4t-large-v2 with two encoder lengths through one engine (each
its own captured prefill, step and cache) and for reduced llava-next-34b
with patches spliced in (K5 once per layer per decode step), and K5 at
llava's full-width head geometry (56/8 heads, D=128: G=7).

Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_encdec_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(cfg, batch, n_tokens, n_front, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, n_tokens)).astype(np.int32)
    fe = rng.standard_normal((batch, n_front, cfg.d_model)).astype(np.float32)
    return tokens, torch.from_numpy(fe).to(cfg.dtype)


def test_two_encoder_lengths_replay_equals_eager(cuda):
    """Frames of 10 and 1030 (the encoder on flash) through one replaying
    engine, in turns: each length its own captured prefill, step and
    static cache; logits and tokens equal to an eager engine's."""
    cfg = get_arch("seamless-m4t-large-v2").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    replay = LmEngine(params, cfg, max_len=20)
    eager = LmEngine(params, cfg, max_len=20, graphs=False)
    runs = {n: _inputs(cfg, 2, 8, n, seed=n) for n in (10, 1030)}
    for n in (10, 1030, 10):
        prompt, fe = runs[n]
        tokens = replay.generate(prompt, 10, fe)
        np.testing.assert_array_equal(eager.generate(prompt, 10, fe), tokens)
        r_pre, r_steps = replay.teacher_forced(prompt, tokens, fe)
        e_pre, e_steps = eager.teacher_forced(prompt, tokens, fe)
        assert torch.equal(r_pre, e_pre) and torch.equal(r_steps, e_steps)
    # one captured step and one static cache per encoder length
    steps = [key[1:] for key in replay._calls if key[0] == "step"]
    assert sorted(steps) == sorted(replay._static) and len(steps) == 2
    caches = replay._static.values()
    assert sorted(c["xk"].shape[2] for c in caches) == [10, 1030]
    assert all(c["k"].shape[1:3] == (2, 20) for c in caches)
    assert replay.launches == eager.launches == {"decode_attn": 0, "ssd_scan": 0}


def test_llava_splice_replay_equals_eager(cuda):
    cfg = get_arch("llava-next-34b").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    rows = cfg.frontend_tokens + 6 + 8
    replay = LmEngine(params, cfg, max_len=rows)
    eager = LmEngine(params, cfg, max_len=rows, graphs=False)
    prompt, fe = _inputs(cfg, 3, 6, cfg.frontend_tokens, seed=3)
    tokens = replay.generate(prompt, 8, fe)
    np.testing.assert_array_equal(eager.generate(prompt, 8, fe), tokens)
    r_pre, r_steps = replay.teacher_forced(prompt, tokens, fe)
    e_pre, e_steps = eager.teacher_forced(prompt, tokens, fe)
    assert torch.equal(r_pre, e_pre) and torch.equal(r_steps, e_steps)
    assert replay.launches == eager.launches == {"decode_attn": 2 * cfg.n_layers * 7,
                                                 "ssd_scan": 0}
    _, cache = replay.prefill(prompt, fe)
    assert replay._position(cache) == int(cache["pos"]) == cfg.frontend_tokens + 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_at_the_llava_geometry(cuda, dtype):
    """K5 at llava's 56/8 heads, D=128 (G=7: the head tiles' odd tail) over
    1,152 rows with ragged lengths."""
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain

    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(8, 56, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(8, 1152, 8, 128, generator=gen, device=cuda).to(dtype) for _ in range(2))
    lengths = torch.tensor([1152, 1, 63, 64, 65, 577, 1088, 1151], dtype=torch.int32, device=cuda)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(decode_attn(q, k, v, lengths).float(),
                               decode_attn_plain(q, k, v, lengths).float(), **tol)
