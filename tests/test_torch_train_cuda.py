"""GW training on the card: replayed steps, resume, and packs after training.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py

Every equality is bit for bit (``torch.equal``): N steps through
``CapturedStep`` (the first eager, the rest replayed) against N eager
steps; a ``Trainer`` run killed and resumed against one that never
stopped; a replayed ``Trainer`` against an eager one.  After replayed
training, or after replays of ``CapturedStep`` itself, the fused path
scores with the trained weights (within 1e-5 of the split path), never
with a pack made before the replays wrote them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder, mse_loss, reconstruction_error
from repro_torch.core.graphs import CapturedStep
from repro_torch.data.gw import GwDataConfig, GwDataset
from repro_torch.kernels.rowwise import rowwise_matmul, rowwise_matmul_plain
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.gpu
SMALL = dataclasses.replace(GW_MODELS["gw_small"], timesteps=40)
NOMINAL = dataclasses.replace(GW_MODELS["gw_nominal"], timesteps=40)
OPT = AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=50)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def batches(n, batch, t, seed=0):
    ds = GwDataset(GwDataConfig(timesteps=t, seed=seed))
    return [ds.background(batch) for _ in range(n)]


def assert_bit_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y), (x - y).abs().max().item()


@pytest.mark.parametrize("cfg,batch,microbatches", [(SMALL, 32, 1), (NOMINAL, 16, 1),
                                                    (SMALL, 32, 4)])
def test_replayed_steps_equal_eager_steps(cuda, cfg, batch, microbatches):
    step = make_train_step(lambda p, b: mse_loss(p, b, cfg), OPT, microbatches)
    data = [torch.from_numpy(x).to(cuda) for x in batches(6, batch, cfg.timesteps)]
    params = init_autoencoder(cfg, 1, device=cuda)
    opt = init_opt_state(params, OPT)
    eager_losses = []
    for x in data:
        loss, params, opt = step(params, opt, x)
        eager_losses.append(loss)
    start = init_autoencoder(cfg, 1, device=cuda)
    state = {"params": start, "opt": init_opt_state(start, OPT)}

    def step_fn(st, x):
        loss, p, o = step(st["params"], st["opt"], x)
        return loss, {"params": p, "opt": o}

    captured = CapturedStep(step_fn, state, cuda)
    replay_losses = [captured(x).clone() for x in data]
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(replay_losses), torch.stack(eager_losses))
    assert_bit_equal(state, {"params": params, "opt": opt})
    assert int(state["opt"]["step"]) == len(data)


def _trainer(tmp, data, total, graphs=True, every=4):
    return Trainer(lambda p, b: mse_loss(p, b, SMALL),
                   lambda gen: init_autoencoder(SMALL, gen, device="cpu"), iter(data),
                   TrainerConfig(total_steps=total, checkpoint_every=every, opt=OPT), str(tmp),
                   device="cuda", graphs=graphs)


def test_replayed_trainer_equals_eager_trainer(cuda, tmp_path):
    data = batches(10, 32, SMALL.timesteps)
    replay = _trainer(tmp_path / "replay", data, 10)
    eager = _trainer(tmp_path / "eager", data, 10, graphs=False)
    r1 = replay.run(torch.Generator().manual_seed(0))
    r2 = eager.run(torch.Generator().manual_seed(0))
    assert r1.losses == r2.losses
    assert_bit_equal({"p": replay.params, "o": replay.opt_state},
                     {"p": eager.params, "o": eager.opt_state})
    for step in (4, 8, 10):  # the async checkpoints hold the same bits
        a = replay.ckpt.restore({"params": replay.params}, step=step)
        b = eager.ckpt.restore({"params": eager.params}, step=step)
        assert_bit_equal(a, b)


def test_replay_after_restore_equals_uninterrupted_run(cuda, tmp_path):
    data = batches(12, 32, SMALL.timesteps, seed=2)
    whole = _trainer(tmp_path / "whole", data, 12)
    rw = whole.run(torch.Generator().manual_seed(0))
    _trainer(tmp_path / "cut", data, 8).run(torch.Generator().manual_seed(0))
    rest = _trainer(tmp_path / "cut", data[8:], 12)
    rr = rest.run(torch.Generator().manual_seed(5))
    assert rr.resumed_from == 8 and rr.losses == rw.losses[8:]
    assert_bit_equal({"p": rest.params, "o": rest.opt_state},
                     {"p": whole.params, "o": whole.opt_state})


def test_fused_scores_after_training_are_the_trained_weights(cuda, tmp_path):
    """The trainer copies the init in, so a pack cached on the caller's
    init stays right for it; the trained parameters, written by replays,
    miss that cache."""
    init = init_autoencoder(SMALL, 4, device=cuda)
    before_init = [t.clone() for t in tree_leaves(init)]
    x = torch.from_numpy(batches(1, 64, SMALL.timesteps, seed=9)[0]).to(cuda)
    fused = dataclasses.replace(SMALL, impl="fused_stack")
    with torch.no_grad():
        untrained = reconstruction_error(init, x, fused)  # caches a pack of `init`
    trainer = Trainer(lambda p, b: mse_loss(p, b, SMALL), lambda gen: init,
                      iter(batches(20, 32, SMALL.timesteps, seed=3)),
                      TrainerConfig(total_steps=20, checkpoint_every=100, opt=OPT),
                      str(tmp_path), device="cuda")
    trainer.run(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(init), before_init))
    with torch.no_grad():
        after = reconstruction_error(trainer.params, x, fused)
        split = reconstruction_error(trainer.params, x, SMALL)
        again = reconstruction_error(init, x, fused)
    torch.testing.assert_close(after, split, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(after, untrained, rtol=1e-5, atol=1e-5)
    assert torch.equal(again, untrained)


def test_replays_miss_a_pack_cached_before_them(cuda):
    """``CapturedStep`` bumps every state leaf's version after a replay, so
    a fused evaluation of its own static parameters repacks them."""
    params = init_autoencoder(SMALL, 6, device=cuda)
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    step = make_train_step(lambda p, b: mse_loss(p, b, SMALL), OPT)

    def step_fn(st, x):
        loss, p, o = step(st["params"], st["opt"], x)
        return loss, {"params": p, "opt": o}

    data = [torch.from_numpy(b).to(cuda) for b in batches(8, 32, SMALL.timesteps, seed=6)]
    x = torch.from_numpy(batches(1, 64, SMALL.timesteps, seed=7)[0]).to(cuda)
    fused = dataclasses.replace(SMALL, impl="fused_stack")
    captured = CapturedStep(step_fn, state, cuda)
    captured(data[0])  # the eager step and the capture
    with torch.no_grad():
        cached = reconstruction_error(state["params"], x, fused)  # packs after step 1
    versions = [t._version for t in tree_leaves(state)]
    for b in data[1:]:
        captured(b)
    assert all(t._version == v + len(data) - 1
               for t, v in zip(tree_leaves(state), versions, strict=True))
    with torch.no_grad():
        after = reconstruction_error(state["params"], x, fused)
        split = reconstruction_error(state["params"], x, SMALL)
    torch.testing.assert_close(after, split, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(after, cached, rtol=1e-5, atol=1e-5)


def test_training_forward_launches_the_rowwise_kernel(cuda):
    params = init_autoencoder(SMALL, 0, device=cuda)
    x = torch.from_numpy(batches(1, 8, SMALL.timesteps)[0]).to(cuda)
    step = make_train_step(lambda p, b: mse_loss(p, b, SMALL), OPT)
    rowwise_matmul.launches = 0
    step(params, init_opt_state(params, OPT), x)
    assert rowwise_matmul.launches == 2  # the dense head and the error sum, forward only


@pytest.mark.parametrize("m,k,n", [(3200, 9, 1), (32, 100, 1), (64, 32, 5)])
def test_rowwise_gradient_on_the_card_equals_the_cpu(cuda, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    x0, w0, b0 = (torch.randn(m, k, generator=gen), torch.randn(k, n, generator=gen),
                  torch.randn(n, generator=gen))
    g = torch.randn(m, n, generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        x, w, b = (t.clone().to(dev).requires_grad_(True) for t in (x0, w0, b0))
        out = rowwise_matmul(x, w, b)
        (out * g.to(dev)).sum().backward()
        grads[str(dev)] = (out.detach().cpu(), x.grad.cpu(), w.grad.cpu(), b.grad.cpu())
    cpu, card = grads["cpu"], grads[str(cuda)]
    assert torch.equal(card[0], cpu[0])  # the kernel's forward is the plain version's bits
    assert torch.equal(cpu[0], rowwise_matmul_plain(x0, w0, b0))
    for a, b in zip(card[1:], cpu[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * b.abs().max().item())
