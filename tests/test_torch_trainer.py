"""``repro_torch.train.trainer`` on the CPU: restart-first recovery, the
non-finite-loss guard, and the refusal to train through a forward-only
kernel backend.

The reference's own kill-and-resume case (``tests/test_substrate.py::
TestTrainerRestart``) runs on the port; a resumed run is also held bit for
bit against one that never stopped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder, mse_loss, reconstruction_error
from repro_torch.data.gw import GwDataConfig, GwDataset
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import value_and_grad
from repro_torch.train.trainer import Prefetcher, Trainer, TrainerConfig
from repro_torch.tree import tree_leaves


def linear_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"]) ** 2)


def linear_init(gen):
    return {"w": torch.randn(4, 2, generator=gen)}


def batches(start=0):
    """Batch i depends on i alone, so a resumed stream can start at i."""
    i = start
    while True:
        rng = np.random.default_rng(i)
        yield {"x": rng.normal(0, 1, (8, 4)).astype(np.float32)}
        i += 1


def trainer(tmp_path, total, every=5, data=None, **kw):
    cfg = TrainerConfig(total_steps=total, checkpoint_every=every, log_every=100,
                        opt=AdamWConfig(lr=1e-2, warmup_steps=0), **kw)
    return Trainer(linear_loss, linear_init, data if data is not None else batches(), cfg,
                   str(tmp_path), device="cpu")


def test_resume_from_checkpoint(tmp_path):
    """Kill and restart: a second Trainer resumes at the saved step."""
    t1 = trainer(tmp_path, 10)
    r1 = t1.run(torch.Generator().manual_seed(0))
    assert r1.step == 10 and r1.resumed_from is None and len(r1.losses) == 10
    t2 = trainer(tmp_path, 15)
    r2 = t2.run(torch.Generator().manual_seed(1))
    assert r2.resumed_from == 10  # picked up where t1 left off
    assert r2.step == 15 and len(r2.losses) == 5
    assert t1.ckpt.all_steps() == [5, 10, 15]


def test_resume_equals_uninterrupted_run(tmp_path):
    whole = trainer(tmp_path / "whole", 12, every=4)
    rw = whole.run(torch.Generator().manual_seed(0))
    first = trainer(tmp_path / "cut", 8, every=4)
    first.run(torch.Generator().manual_seed(0))
    rest = trainer(tmp_path / "cut", 12, every=4, data=batches(8))
    rr = rest.run(torch.Generator().manual_seed(99))  # the init is overwritten
    assert rr.resumed_from == 8
    assert rr.losses == rw.losses[8:]
    for a, b in zip(tree_leaves({"p": rest.params, "o": rest.opt_state}),
                    tree_leaves({"p": whole.params, "o": whole.opt_state})):
        assert torch.equal(a, b)


def test_nothing_left_to_run(tmp_path):
    trainer(tmp_path, 5).run(torch.Generator().manual_seed(0))
    again = trainer(tmp_path, 5)
    r = again.run(torch.Generator().manual_seed(0))
    assert r.step == 5 and r.losses == [] and r.resumed_from == 5


def test_non_finite_loss_raises(tmp_path):
    def data():
        yield from [{"x": np.ones((8, 4), np.float32)}] * 3
        yield {"x": np.full((8, 4), np.inf, np.float32)}

    with pytest.raises(FloatingPointError, match="step 3"):
        trainer(tmp_path, 10, data=data()).run(torch.Generator().manual_seed(0))


def test_handed_out_params_are_fresh_copies(tmp_path):
    t = trainer(tmp_path, 3)
    t.run(torch.Generator().manual_seed(0))
    assert not t.params["w"].requires_grad
    restored = t.ckpt.restore({"params": t.params, "opt": t.opt_state})
    assert torch.equal(restored["params"]["w"], t.params["w"])


def test_prefetcher_passes_the_source_error_on():
    def source():
        yield 1
        raise ValueError("bad shard")

    p = Prefetcher(source(), depth=2)
    assert next(p) == 1
    with pytest.raises(ValueError, match="bad shard"):
        next(p)


def test_gw_trainer_descends(tmp_path):
    """``Trainer`` over ``mse_loss`` on gw_small (T=20): the GW recipe's
    shape, a few steps on the CPU."""
    cfg = dataclasses.replace(GW_MODELS["gw_small"], timesteps=20)
    ds = GwDataset(GwDataConfig(timesteps=20, seed=0))
    x = ds.background(16)
    tc = TrainerConfig(total_steps=12, checkpoint_every=100,
                       opt=AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                                       weight_decay=0.0))
    t = Trainer(lambda p, b: mse_loss(p, b, cfg),
                lambda gen: init_autoencoder(cfg, gen, device="cpu"),
                iter([x] * 12), tc, str(tmp_path), device="cpu")
    r = t.run(torch.Generator().manual_seed(0))
    assert r.losses[-1] < r.losses[0]
    with torch.no_grad():
        assert float(reconstruction_error(t.params, torch.from_numpy(x), cfg).mean()) < \
            r.losses[0]


# -- a gradient through a forward-only kernel backend is refused -------------

@pytest.mark.parametrize("impl", ["fused_stack", "fused_step", "kernel", "mixed"])
def test_training_through_a_kernel_backend_raises(impl):
    cfg = dataclasses.replace(GW_MODELS["gw_small"], timesteps=8, impl=impl)
    params = init_autoencoder(cfg, 0, device="cpu")
    x = torch.from_numpy(GwDataset(GwDataConfig(timesteps=8, seed=0)).background(2))
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(lambda p, b: mse_loss(p, b, cfg), params, x)
    with torch.no_grad():  # scoring through it stays legal
        assert reconstruction_error(params, x, cfg).shape == (2,)
    split = dataclasses.replace(cfg, impl="split")
    _, grads = value_and_grad(lambda p, b: mse_loss(p, b, split), params, x)
    assert all(g.abs().sum() > 0 for g in tree_leaves(grads))


def _wrapper_cases():
    from repro_torch.kernels.lstm_scan import lstm_scan, lstm_scan_layer
    from repro_torch.kernels.lstm_stack.lstm_stack import lstm_stack
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step

    L, W, Bn, T_ = 1, 4, 2, 3
    w = torch.randn(L, W, 4 * W) * 0.1
    b = torch.zeros(L, 4 * W)
    h0, c0 = torch.zeros(L, Bn, W), torch.zeros(L, Bn, W)
    return {
        "lstm_stack": lambda r: lstm_stack(torch.randn(T_, Bn, 4 * W), r(w), w, b, h0, c0),
        "lstm_stack_step": lambda r: lstm_stack_step(torch.randn(Bn, T_, W), w, r(w), b, h0,
                                                     c0),
        "lstm_scan": lambda r: lstm_scan(torch.randn(T_, Bn, 4 * W), r(w[0]), h0[0], c0[0]),
        "lstm_scan_layer": lambda r: lstm_scan_layer(torch.randn(Bn, T_, 1),
                                                     r(torch.randn(1, 4 * W)), b[0], w[0],
                                                     h0[0], c0[0]),
    }


@pytest.mark.parametrize("entry", ["lstm_stack", "lstm_stack_step", "lstm_scan",
                                   "lstm_scan_layer"])
def test_lstm_kernel_wrappers_refuse_a_gradient(entry):
    call = _wrapper_cases()[entry]
    with pytest.raises(RuntimeError, match=f"{entry} has no backward"):
        call(lambda t: t.clone().requires_grad_(True))
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_(True))
    hs = call(lambda t: t)[0]
    assert hs.grad_fn is None
