"""The port's AdamW (``repro_torch.train.optimizer``) against the reference's.

The same numpy trees from a seed go through both packages.  Limits:
``schedule``, ``compress_decompress`` and an ``adamw_update`` whose
gradients need no clipping are bit-equal (the same fp32 op chain, in the
same order).  The global norm sums each leaf's squares with the
framework's own reduction tree, so it and everything it scales (clipped
gradients, then the moments) may differ in the last bits: rtol 1e-6 of each
leaf's largest magnitude.  The reference's own optimizer cases
(``tests/test_substrate.py::TestOptimizer``) follow, run on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ro
from repro_torch.train import optimizer as to
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline fallback (tests/_hypothesis_compat.py)
    from _hypothesis_compat import given, settings, st

CFGS = {
    "default": ro.AdamWConfig(),
    "fig9": ro.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200, weight_decay=0.0),
    "compress": ro.AdamWConfig(compress_grads=True, warmup_steps=0),
    "no_warmup": ro.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=50),
}
CLOSE = 1e-6  # the global norm's reduction order (module docstring)


def port_cfg(cfg: ro.AdamWConfig) -> to.AdamWConfig:
    return to.AdamWConfig(**dataclasses.asdict(cfg))


def make_tree(seed: int, scale: float = 1.0) -> dict:
    """Keys out of sorted order on purpose: leaf order is the sorted one."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"z": {"w": f(5, 7), "b": f(7)}, "a": f(3, 4), "m": {"k": {"w_h": f(2, 8)}}}


def both(tree: dict):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tree_map(lambda a: torch.from_numpy(a.copy()), tree))


def assert_trees(got, want, rel: float = 0.0):
    lw = jax.tree_util.tree_leaves(want)
    lg = tree_leaves(got)
    assert len(lw) == len(lg)
    for a, b in zip(lg, lw):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if rel == 0.0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30))


def test_leaf_order_is_the_references():
    tree = make_tree(0)
    jt, tt = both(tree)
    assert [np.asarray(x).shape for x in jax.tree_util.tree_leaves(jt)] == \
        [tuple(x.shape) for x in tree_leaves(tt)]


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("step", [0, 1, 7, 19, 20, 21, 99, 100, 101, 150, 199, 200, 500,
                                  9_999, 10_000, 12_000])
def test_schedule_bit_equal(name, step):
    cfg = CFGS[name]
    want = np.asarray(ro.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = to.schedule(port_cfg(cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm(seed, max_norm):
    jt, tt = both(make_tree(seed, scale=0.3))
    want, wnorm = ro.clip_by_global_norm(jt, max_norm)
    got, gnorm = to.clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=CLOSE)
    assert_trees(got, want, rel=0.0 if max_norm > float(wnorm) else CLOSE)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_decompress_bit_equal(seed):
    jg, tg = both(make_tree(seed))
    je, te = both(make_tree(seed + 10, scale=1e-3))
    wq, werr = ro.compress_decompress(jg, je)
    gq, gerr = to.compress_decompress(tg, te)
    for a, b in zip(tree_leaves(gq), jax.tree_util.tree_leaves(wq)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert_trees(gerr, werr)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches(name, clipped):
    """Five steps on the same gradients; ``clipped=False`` keeps the global
    norm under ``grad_clip`` (scale exactly 1), so every leaf is bit-equal."""
    cfg = CFGS[name]
    jp, tp = both(make_tree(0))
    jg, tg = both(make_tree(1, scale=3.0 if clipped else 0.05))
    if not clipped:
        assert float(ro._global_norm(jg)) < cfg.grad_clip
    js, ts = ro.init_opt_state(jp, cfg), to.init_opt_state(tp, port_cfg(cfg))
    assert set(ts) == set(js)
    for _ in range(5):
        jp, js = ro.adamw_update(jp, jg, js, cfg)
        tp, ts = to.adamw_update(tp, tg, ts, port_cfg(cfg))
    rel = CLOSE if clipped else 0.0
    assert_trees(tp, jp, rel)
    assert_trees(ts["m"], js["m"], rel)
    assert_trees(ts["v"], js["v"], rel)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert int(ts["step"]) == int(js["step"]) == 5
    if cfg.compress_grads:
        assert_trees(ts["err"], js["err"])


def test_update_stays_on_device_tensors():
    """Nothing in a step reads a value back to the host: the step counter,
    the rate and the corrections stay 0-d tensors (what lets the step be
    captured); the inputs are not written."""
    tp = tree_map(torch.from_numpy, make_tree(0))
    before = tree_map(torch.clone, tp)
    state = to.init_opt_state(tp, to.AdamWConfig())
    new_p, new_s = to.adamw_update(tp, tree_map(torch.ones_like, tp), state, to.AdamWConfig())
    assert isinstance(new_s["step"], torch.Tensor)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(before)))
    assert int(state["step"]) == 0
    assert all(a is not b for a, b in zip(tree_leaves(new_p), tree_leaves(tp)))


# -- the reference's own optimizer cases (tests/test_substrate.py), on the port --

def _params():
    return {"w": torch.ones(4, 4), "b": torch.zeros(4)}


def test_descends_quadratic():
    cfg = to.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=1000)
    params = _params()
    state = to.init_opt_state(params, cfg)
    target = {"w": torch.full((4, 4), 3.0), "b": torch.full((4,), -1.0)}

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in p)

    for _ in range(200):
        _, grads = value_and_grad(lambda p, _: loss(p), params, None)
        params, state = to.adamw_update(params, grads, state, cfg)
    assert float(loss(params)) < 1e-2


def test_schedule_warmup_and_decay():
    cfg = to.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(to.schedule(cfg, torch.tensor(0))) == 0.0
    assert float(to.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(to.schedule(cfg, torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


def test_clip_by_global_norm_scales_to_max():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = to.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0 * np.sqrt(10), rel=1e-5)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == pytest.approx(1.0, rel=1e-5)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_compression_error_feedback_bounded(seed):
    rng = np.random.default_rng(seed)
    g_true = torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))
    err = {"g": torch.zeros(64)}
    acc_q = np.zeros((64,), np.float64)
    for _ in range(20):
        q, err = to.compress_decompress({"g": g_true}, err)
        acc_q += q["g"].double().numpy()
    np.testing.assert_allclose(acc_q, g_true.double().numpy() * 20, rtol=0.02, atol=0.05)


def test_adamw_step_counts_and_dtypes():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    cfg = to.AdamWConfig()
    st_ = to.init_opt_state(params, cfg)
    p2, st2 = to.adamw_update(params, {"w": torch.ones(4, 4, dtype=torch.bfloat16)}, st_, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert st2["m"]["w"].dtype == torch.float32
    assert int(st2["step"]) == 1
