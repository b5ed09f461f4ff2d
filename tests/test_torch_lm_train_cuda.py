"""LM training on the card.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_train_cuda.py

* K4 and K5 refuse a gradient on CUDA tensors, before any launch.
* Every family's reduced golden fixture (``torch_port_lm_train.npz``) in
  fp32 on the card: loss, gradients and 3 AdamW steps within the limits of
  ``test_torch_lm_train_golden.py``.
* Replayed train steps (``CapturedStep``) bit-equal to eager ones for the
  reduced dense, SSM and hybrid models.
* ``flash_attention`` at smollm-360m's training shape (B=1, S=4096, bf16)
  runs on a fused SDPA backend forward and backward (the math one
  disabled, so a fallback raises), within the bf16 tolerance of the plain
  ``sdpa``'s fp32 gradients that ``chip_smoke.py`` states.
* The launcher trains on the card (its default device) and resumes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, unflatten
from repro_torch.core.graphs import CapturedStep
from repro_torch.data.lm import LmDataConfig, lm_batch
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.models.flash_attention import flash_attention
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import flatten, tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import FLASH_GRAD_TOL, FLASH_OUT_TOL  # noqa: E402
from chip_smoke import LM_TRAIN_GRAD_REL as GRAD_REL  # noqa: E402
from chip_smoke import LM_TRAIN_GRAD_REL_LEAF as GRAD_REL_LEAF  # noqa: E402
from chip_smoke import LM_TRAIN_LOSS_RTOL as LOSS_RTOL  # noqa: E402
from chip_smoke import LM_TRAIN_OPT as OPT  # noqa: E402

pytestmark = pytest.mark.gpu
DATA = Path(__file__).parent / "data"
FIXTURES = {"smollm-360m": "smollm", "mamba2-130m": "mamba2", "qwen2-moe-a2.7b": "qwen2moe",
            "hymba-1.5b": "hymba", "seamless-m4t-large-v2": "seamless",
            "llava-next-34b": "llava"}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def test_kernels_refuse_a_gradient_on_the_card(cuda):
    x = torch.randn(1, 8, 2, 8, device=cuda, requires_grad=True)
    dt, a = torch.rand(1, 8, 2, device=cuda), -torch.rand(2, device=cuda)
    bm = cm = torch.randn(1, 8, 1, 8, device=cuda)
    counts = ssd_scan.launches, decode_attn.launches
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        ssd_scan(x, dt, a, bm, cm)
    q = torch.randn(2, 4, 8, device=cuda, requires_grad=True)
    k = v = torch.randn(2, 6, 2, 8, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attn has no backward"):
        decode_attn(q, k, v, torch.tensor([3, 6], dtype=torch.int32, device=cuda))
    assert (ssd_scan.launches, decode_attn.launches) == counts


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reduced_fixture_on_the_card(cuda, name):
    with np.load(DATA / "torch_port_lm_train.npz") as data:
        gold = {k[len(name) + 1:]: data[k] for k in data.files if k.startswith(name + "/")}
    with np.load(DATA / f"torch_port_lm_{FIXTURES[name]}.npz") as data:
        params = lm_params_from_numpy(unflatten({k: data[k] for k in data.files}), cuda)
    cfg = get_arch(name).reduced()
    api = get_model(cfg)

    def batch_at(i):
        b = {"tokens": gold["tokens"][i], "labels": gold["labels"][i]}
        if "frontend_embeds" in gold:
            b["frontend_embeds"] = gold["frontend_embeds"]
        return {k: torch.as_tensor(v).to(cuda) for k, v in b.items()}

    def loss_fn(p, b):
        return api.loss_fn(p, b, cfg)

    loss, grads = value_and_grad(loss_fn, params, batch_at(0))
    np.testing.assert_allclose(loss.item(), gold["loss"], rtol=LOSS_RTOL)
    got = flatten(grads)
    for key, ref in flatten(unflatten(gold, prefix="grads/")).items():
        err = float(np.abs(got[key].cpu().numpy() - ref).max()) / max(float(np.abs(ref).max()),
                                                                      1e-30)
        assert err <= GRAD_REL_LEAF.get(key, GRAD_REL), f"{key}: {err:.3g}"
    step = make_train_step(loss_fn, AdamWConfig(**OPT))
    p, opt, losses = params, init_opt_state(params, AdamWConfig(**OPT)), []
    for i in range(len(gold["step_losses"])):
        value, p, opt = step(p, opt, batch_at(i))
        losses.append(value.item())
    np.testing.assert_allclose(losses, gold["step_losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["smollm-360m", "mamba2-130m", "hymba-1.5b"])
def test_replayed_lm_steps_equal_eager_steps(cuda, name):
    cfg = get_arch(name).reduced()
    api = get_model(cfg)
    step = make_train_step(lambda p, b: api.loss_fn(p, b, cfg), AdamWConfig(**OPT))
    data = LmDataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in lm_batch(data, i).items()}
               for i in range(4)]
    params = api.init_params(cfg, seed=0, device=cuda)
    eager = [params, init_opt_state(params, AdamWConfig(**OPT))]

    def as_state(st, b):
        loss, p, o = step(st["params"], st["opt"], b)
        return loss, {"params": p, "opt": o}

    start = tree_map(lambda t: t.clone(), {"params": eager[0], "opt": eager[1]})
    captured = CapturedStep(as_state, start, cuda)
    for b in batches:
        loss, p, o = step(eager[0], eager[1], b)
        eager = [p, o]
        assert torch.equal(captured(b), loss)
    for x, y in zip(tree_leaves({"params": eager[0], "opt": eager[1]}),
                    tree_leaves(captured.state), strict=True):
        assert torch.equal(x, y)


def test_flash_takes_a_fused_backend_at_the_training_shape(cuda):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    cfg = get_arch("smollm-360m")
    g = torch.Generator(device=cuda).manual_seed(0)
    shape_q, shape_kv = (1, 4096, cfg.n_heads, cfg.hd), (1, 4096, cfg.n_kv_heads, cfg.hd)
    q, dout = (torch.randn(shape_q, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn(shape_kv, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        out = flash_attention(*leaves, True, None, 0)
        out.backward(dout)
    refs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out_ref = L.sdpa(*refs, causal=True)
    out_ref.backward(dout.float())
    for a, b, tol in ((out, out_ref, FLASH_OUT_TOL),
                      *((x.grad, y.grad, FLASH_GRAD_TOL) for x, y in zip(leaves, refs))):
        scale = b.detach().abs().max()
        torch.testing.assert_close(a.detach().float() / scale, b.detach() / scale, **tol)


def test_launcher_trains_on_the_card_and_resumes(cuda, tmp_path):
    argv = ["--arch", "smollm-360m", "--reduced", "--seq-len", "32", "--batch", "2",
            "--ckpt", str(tmp_path)]
    first = tlaunch.main(argv + ["--steps", "3"])
    assert first.step == 3 and all(np.isfinite(first.losses))
    resumed = tlaunch.main(argv + ["--steps", "5"])
    assert resumed.resumed_from == 3 and resumed.step == 5
