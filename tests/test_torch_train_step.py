"""The port's training loss and step against the reference's.

Shared inputs: the reference's params from a fixed key, converted through
``convert.params_from_numpy``, and numpy windows from a seed.  Limits
(starting values, none loosened): the loss within 1e-6 relative; each
leaf's gradient within 1e-5 x that leaf's largest |g| (the two frameworks
order the sums of the backward pass differently).  ``fixed_quant``'s
forward is bit-equal to the reference's; its gradient is the upstream
gradient, saturated entries included.  ``rowwise_matmul``'s hand-written
backward equals autograd through its plain version within 1e-6 of each
gradient's largest magnitude (other summation orders); with a bf16 ``x``,
``grad_x`` is rounded to bf16 once, so within 2^-8 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as rae
from repro.core import quant as rq
from repro.core.autoencoder import AutoencoderConfig as RConfig
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.optimizer import init_opt_state as r_init
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.core import autoencoder as tae
from repro_torch.core import quant as tq
from repro_torch.core.autoencoder import AutoencoderConfig as TConfig
from repro_torch.kernels.rowwise import rowwise_matmul, rowwise_matmul_plain
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves

#: (hidden, latent_boundary): gw_small and a gw_nominal-wide stack, at T=20
STACKS = {"gw_small": ((9, 9), 1), "wide": ((32, 8, 8, 32), None)}
T, B = 20, 4
LOSS_RTOL, GRAD_REL = 1e-6, 1e-5


def configs(name):
    hidden, boundary = STACKS[name]
    kw = dict(hidden=hidden, latent_boundary=boundary, timesteps=T)
    return RConfig(**kw), TConfig(**kw)


def shared(name, seed=0):
    rcfg, tcfg = configs(name)
    rparams = rae.init_autoencoder(jax.random.PRNGKey(seed), rcfg)
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    x = np.random.default_rng(seed).normal(size=(B, T, 1)).astype(np.float32)
    return rcfg, tcfg, rparams, params_from_numpy(np_params, "cpu"), x


def assert_grads(got: dict, want: dict):
    lw = jax.tree_util.tree_leaves(want)
    lg = tree_leaves(got)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_REL * np.abs(w).max())


@pytest.mark.parametrize("name", sorted(STACKS))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(name, seed):
    rcfg, tcfg, rparams, tparams, x = shared(name, seed)
    want_loss, want_g = jax.value_and_grad(rae.mse_loss)(rparams, jnp.asarray(x), rcfg)
    loss, grads = value_and_grad(lambda p, b: tae.mse_loss(p, b, tcfg), tparams,
                                 torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert_grads(grads, want_g)
    # the caller's tensors are read, never made to require grad
    assert not any(t.requires_grad for t in tree_leaves(tparams))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_train_step_matches_reference(name):
    """One step of each package's ``make_train_step`` over ``mse_loss``:
    Adam's first step is lr * sign(g) (plus decay), so an entry whose
    reference gradient lies under the gradient tolerance may step the other
    way; those entries are left out, every other one must agree to 1e-6."""
    rcfg, tcfg, rparams, tparams, x = shared(name)
    ropt = RAdamW(lr=3e-3, warmup_steps=0, total_steps=200)
    topt = TAdamW(lr=3e-3, warmup_steps=0, total_steps=200)
    rstep = r_make_train_step(lambda p, b: rae.mse_loss(p, b, rcfg), ropt)
    tstep = make_train_step(lambda p, b: tae.mse_loss(p, b, tcfg), topt)
    rl, rp, _ = rstep(rparams, r_init(rparams, ropt), jnp.asarray(x))
    tl, tp, ts = tstep(tparams, init_opt_state(tparams, topt), torch.from_numpy(x))
    _, rg = jax.value_and_grad(rae.mse_loss)(rparams, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_RTOL)
    assert int(ts["step"]) == 1
    for got, want, g in zip(tree_leaves(tp), jax.tree_util.tree_leaves(rp),
                            jax.tree_util.tree_leaves(rg)):
        g = np.asarray(g)
        decided = np.abs(g) > GRAD_REL * np.abs(g).max()
        np.testing.assert_allclose(got.numpy()[decided], np.asarray(want)[decided],
                                   rtol=0, atol=1e-6)


def test_microbatch_equivalence():
    """Accumulating k microbatches equals one big batch (a loss linear in
    the batch mean), as the reference's own case (test_substrate.py)."""
    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(0, 1, (8, 4)).astype(np.float32))}
    batch = {"x": torch.from_numpy(rng.normal(0, 1, (16, 8)).astype(np.float32)),
             "y": torch.from_numpy(rng.normal(0, 1, (16, 4)).astype(np.float32))}
    cfg = TAdamW(lr=1e-2, warmup_steps=0)
    l1, p1, _ = make_train_step(loss_fn, cfg, 1)(params, init_opt_state(params, cfg), batch)
    l4, p4, _ = make_train_step(loss_fn, cfg, 4)(params, init_opt_state(params, cfg), batch)
    assert float(l1) == pytest.approx(float(l4), rel=1e-5)
    np.testing.assert_allclose(p1["w"].numpy(), p4["w"].numpy(), rtol=1e-5, atol=1e-6)


def test_microbatches_match_reference():
    """``microbatches=4`` over mse_loss against the reference's scan."""
    rcfg, tcfg, rparams, tparams, x = shared("gw_small")
    ropt, topt = RAdamW(lr=1e-3, warmup_steps=0), TAdamW(lr=1e-3, warmup_steps=0)
    rl, rp, _ = r_make_train_step(lambda p, b: rae.mse_loss(p, b, rcfg), ropt, 4)(
        rparams, r_init(rparams, ropt), jnp.asarray(x))
    tl, tp, _ = make_train_step(lambda p, b: tae.mse_loss(p, b, tcfg), topt, 4)(
        tparams, init_opt_state(tparams, topt), torch.from_numpy(x))
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_RTOL)
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_microbatches_must_divide_the_batch():
    step = make_train_step(lambda p, b: (b @ p["w"]).sum(), TAdamW(), 3)
    params = {"w": torch.ones(2, 1)}
    with pytest.raises(ValueError, match="microbatches"):
        step(params, init_opt_state(params), torch.ones(4, 2))


def test_unreached_leaf_gets_zero_grad():
    params = {"used": torch.ones(3), "unused": torch.ones(2, 2)}
    loss, grads = value_and_grad(lambda p, _: p["used"].sum(), params, None)
    assert float(loss) == 3.0
    assert torch.equal(grads["unused"], torch.zeros(2, 2))
    assert torch.equal(grads["used"], torch.ones(3))


# -- fixed_quant / quantize_tree ------------------------------------------

def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=4096) * 40).astype(np.float32)  # past <16,8>'s +-128
    edges = np.array([0.0, -0.0, 127.99609375, 128.0, -128.0, -128.5, 1e6, -1e6,
                      0.001953125, 0.005859375, -0.001953125, 2.5e-3], np.float32)
    return np.concatenate([x, edges])


@pytest.mark.parametrize("bits", [(16, 8), (8, 4), (16, 12), (12, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_quant_forward_bit_equal(bits, seed):
    x = _quant_inputs(seed)
    want = np.asarray(rq.fixed_quant(jnp.asarray(x), *bits))
    got = tq.fixed_quant(torch.from_numpy(x), *bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [(16, 8), (8, 4)])
def test_fixed_quant_gradient_is_straight_through(bits):
    """The upstream gradient passes unchanged, also where the forward
    saturates, as the reference's custom JVP gives it."""
    x = _quant_inputs(0)
    upstream = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(rq.fixed_quant(v, *bits) * upstream))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tq.fixed_quant(xt, *bits) * torch.from_numpy(upstream)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), upstream)
    np.testing.assert_array_equal(want, upstream)
    lo = -(2.0 ** (bits[0] - 1)) / 2 ** bits[1]
    assert (x < lo).any()  # the saturated region is exercised


def test_fixed_quant_shares_the_activation_quant_chain():
    x = torch.from_numpy(_quant_inputs(2))
    for bits in tq.ACT_BITS:
        assert torch.equal(tq.fixed_quant(x, bits, bits // 2), tq.make_act_quant(bits)(x))


def test_quantize_tree_matches_reference():
    _, _, rparams, tparams, _ = shared("gw_small")
    want = jax.tree_util.tree_leaves(rq.quantize_tree(rparams))
    got = tree_leaves(tq.quantize_tree(tparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- rowwise_matmul's gradient ------------------------------------------------

@pytest.mark.parametrize("m,k,n,bias", [(40, 9, 1, True), (100, 32, 1, True),
                                        (6, 100, 1, False), (33, 8, 5, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowwise_gradients_match_plain_autograd(m, k, n, bias, dtype):
    gen = torch.Generator().manual_seed(m * k + n)
    x0 = torch.randn(m, k, generator=gen).to(dtype)
    w0 = torch.randn(k, n, generator=gen)
    b0 = torch.randn(n, generator=gen)
    g = torch.randn(m, n, generator=gen)
    grads = []
    for fn in (rowwise_matmul, rowwise_matmul_plain):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True) if bias else None
        out = fn(x, w, b)
        assert out.dtype == torch.float32
        (out * g).sum().backward()
        grads.append([x.grad, w.grad] + ([b.grad] if bias else []))
    assert torch.equal(rowwise_matmul(x0, w0, b0 if bias else None),
                       rowwise_matmul_plain(x0, w0, b0 if bias else None))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        scale = want.float().abs().max().item()
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0,
                                   atol=1e-6 * scale if dtype == torch.float32
                                   else 2 ** -8 * scale)


def test_rowwise_gradient_only_where_asked():
    x = torch.randn(4, 3, requires_grad=True)
    w = torch.randn(3, 2)
    rowwise_matmul(x, w).sum().backward()
    assert x.grad is not None and w.grad is None
