"""LM training on the CPU: the loss, layer remat, the flash-attention
backward, the kernels' grad guard and ``launch/train.py``.

* ``flash_attention``'s gradients (PyTorch's ``scaled_dot_product_attention``
  autograd, which recomputes tiles instead of keeping S x S) against
  ``jax.grad`` of the reference's ``flash_attention``, whose custom VJP
  (``_flash_bwd``) is the blocked FlashAttention-2 backward: causal GQA,
  the windowed path, non-causal cross attention with Sq != Sk, a
  ``q_offset``, and sequences that are no multiple of the reference's
  blocks (small ``q_block``/``kv_block`` run several tiles and ragged
  tails); within 1e-5 of each gradient's largest |g| (measured: 7e-7).
* ``softmax_xent`` against the reference's, the pad of the vocabulary
  masked, on fp32 and on bf16 logits.
* Remat changes no number: every family's loss and gradients with each
  layer rematerialised equal those without, bit for bit, and keep fewer
  activations.
* K4 (``ssd_scan``) and K5 (``decode_attn``) raise when a gradient is
  asked for, on the CPU as on the card, and no ``loss_fn`` reaches them.
* The launcher runs, checkpoints and resumes, and refuses an
  encoder-decoder batch without frames.

The reference's golden loss, gradients and AdamW steps of every family
are held in ``test_torch_lm_train_golden.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as RL  # noqa: E402
from repro.models.flash_attention import flash_attention as r_flash  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import LmDataConfig, lm_batch  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as tdense  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.flash_attention import flash_attention  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

GRAD_REL = 1e-5
FAMILY_ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b",
                "seamless-m4t-large-v2", "llava-next-34b"]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# flash attention: forward and backward against the reference's custom VJP
# ---------------------------------------------------------------------------

#: (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, q_block, kv_block)
FLASH_CASES = {
    "causal_gqa": (2, 70, 70, 6, 2, 16, True, None, 0, 16, 32),
    "windowed": (2, 70, 70, 6, 2, 16, True, 24, 0, 16, 32),
    "cross": (2, 45, 70, 6, 2, 16, False, None, 0, 16, 32),
    "offset_ragged": (2, 37, 53, 4, 4, 16, True, None, 16, 16, 32),
    "windowed_blocks": (1, 1030, 1030, 4, 2, 16, True, 16, 0, 512, 1024),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_reference_vjp(case):
    b, sq, sk, hq, hkv, d, causal, window, q_offset, qb, kb = FLASH_CASES[case]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32) for _ in range(2))

    def r_fn(q, k, v):
        return r_flash(q, k, v, causal, window, q_offset, qb, kb)

    r_out, vjp = jax.vjp(r_fn, *(jnp.asarray(a) for a in (q, k, v)))
    r_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, causal, window, q_offset)
    out.backward(torch.from_numpy(do))
    assert _rel(out, r_out) <= GRAD_REL
    for name, leaf, ref in zip("qkv", leaves, r_grads):
        assert _rel(leaf.grad, ref) <= GRAD_REL, f"d{name}"


# ---------------------------------------------------------------------------
# the loss and remat
# ---------------------------------------------------------------------------

def test_softmax_xent_masks_the_vocab_pad_as_the_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 256))).astype(np.float32)
    labels = rng.integers(0, 250, (2, 5)).astype(np.int32)
    for valid in (None, 250):
        r_loss, r_grad = jax.value_and_grad(RL.softmax_xent)(jnp.asarray(logits),
                                                             jnp.asarray(labels), valid)
        t = torch.from_numpy(logits).requires_grad_(True)
        loss = TL.softmax_xent(t, labels, valid)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-6)
        assert _rel(t.grad, r_grad) <= GRAD_REL
    # the pad takes no probability: its gradient is exactly 0
    assert torch.count_nonzero(t.grad[..., 250:]) == 0


@pytest.mark.parametrize("valid", [None, 1000])
def test_softmax_xent_on_bf16_logits_as_the_reference(valid):
    """A model's logits are bf16: the loss and its gradient in fp32 from them."""
    g = torch.Generator().manual_seed(0)
    logits = (4 * torch.randn(3, 17, 1024, generator=g)).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (3, 17), generator=g)
    r_loss, r_grad = jax.value_and_grad(RL.softmax_xent)(
        jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16), jnp.asarray(labels.numpy()),
        valid)
    t = logits.clone().requires_grad_(True)
    loss = TL.softmax_xent(t, labels, valid)
    loss.backward()
    assert loss.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-6)
    assert _rel(t.grad.float(), r_grad.astype(jnp.float32)) <= GRAD_REL


def _reduced(name: str, seq: int = 24):
    cfg = get_arch(name).reduced()
    api = get_model(cfg)
    batch = lm_batch(LmDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2), 0)
    if cfg.frontend is not None or cfg.encdec:  # llava's patches, seamless's frames
        rng = np.random.default_rng(1)
        batch["frontend_embeds"] = rng.standard_normal(
            (2, cfg.frontend_tokens or 8, cfg.d_model)).astype(np.float32)
    return cfg, api, api.init_params(cfg, seed=0, device="cpu"), batch


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_remat_changes_no_number(name, monkeypatch):
    cfg, api, params, batch = _reduced(name)
    runs = {}
    for remat in (True, False):
        if not remat:  # every layer through the plain call
            monkeypatch.setattr(TL, "remat", lambda fn, *args: fn(*args))
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            runs[remat] = value_and_grad(lambda p, b: api.loss_fn(p, b, cfg), params, batch)
        runs[remat] += (sum(saved),)
    (l1, g1, kept1), (l0, g0, kept0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for key, leaf in flatten(g1).items():
        assert torch.equal(leaf, flatten(g0)[key]), key
    assert kept1 < kept0  # with remat, only each layer's inputs stay outside it


# ---------------------------------------------------------------------------
# the grad guard of K4 and K5
# ---------------------------------------------------------------------------

def _scan_inputs(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 8, generator=g)
    dt = torch.rand(1, 8, 2, generator=g)
    a = -torch.rand(2, generator=g)
    bm, cm = torch.randn(1, 8, 1, 8, generator=g), torch.randn(1, 8, 1, 8, generator=g)
    return [t.requires_grad_(requires_grad) for t in (x, dt, a, bm, cm)]


def _attn_inputs(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, generator=g)
    k, v = torch.randn(2, 6, 2, 8, generator=g), torch.randn(2, 6, 2, 8, generator=g)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)] + [
        torch.tensor([3, 6], dtype=torch.int32)]


@pytest.mark.parametrize("entry,make", [(ssd_scan, _scan_inputs), (decode_attn, _attn_inputs)],
                         ids=["ssd_scan", "decode_attn"])
def test_kernel_wrappers_refuse_a_gradient(entry, make):
    with pytest.raises(RuntimeError, match="has no backward"):
        entry(*make(True))
    with torch.no_grad():  # serving: the same inputs run
        entry(*make(True))
    entry(*make(False))


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_kernel_forward_refuses_training_and_loss_fn_does_not(name):
    cfg, api, params, batch = _reduced(name)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        api.forward(leaves, batch, cfg)  # use_kernel=True: K4 in the path
    counts = ssd_scan.launches, decode_attn.launches
    loss, grads = value_and_grad(lambda p, b: api.loss_fn(p, b, cfg), params, batch)
    assert torch.isfinite(loss)
    assert (ssd_scan.launches, decode_attn.launches) == counts
    # the scan's own parameters are trained
    assert torch.count_nonzero(grads["layers"]["ssm"]["a_log"]) > 0


def test_decode_step_refuses_training():
    cfg, api, params, batch = _reduced("smollm-360m")
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="decode_attn has no backward"):
        tdense.decode_step(leaves, cache, {"tokens": batch["tokens"][:, :1]}, cfg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--seq-len", "16",
            "--batch", "2", "--ckpt", str(tmp_path)]
    first = tlaunch.main(argv + ["--steps", "2"])
    assert first.step == 2 and first.resumed_from is None and len(first.losses) == 2
    assert all(np.isfinite(first.losses))
    resumed = tlaunch.main(argv + ["--steps", "4"])
    assert resumed.resumed_from == 2 and resumed.step == 4 and len(resumed.losses) == 2
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("smollm-360m: step 4 loss ") and out[-1].endswith(
        "stragglers=0 resumed_from=2")


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-moe-a2.7b"])
def test_launcher_microbatches_and_compressed_gradients(arch, tmp_path):
    result = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                           "--seq-len", "16", "--batch", "4", "--microbatches", "2",
                           "--compress-grads", "--ckpt", str(tmp_path)])
    assert result.step == 2 and all(np.isfinite(result.losses))


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tlaunch.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])


def test_encdec_without_frames_is_refused(tmp_path):
    cfg, api, params, batch = _reduced("seamless-m4t-large-v2")
    batch.pop("frontend_embeds")
    with pytest.raises(ValueError, match="frontend_embeds"):
        api.loss_fn(params, batch, cfg)
    with pytest.raises(ValueError, match="frontend_embeds"):  # lm_stream yields tokens only
        tlaunch.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--device", "cpu",
                      "--steps", "1", "--seq-len", "8", "--batch", "2", "--ckpt", str(tmp_path)])
