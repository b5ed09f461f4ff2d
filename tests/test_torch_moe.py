"""The port's MoE family (``repro_torch.models.moe``) against the reference,
on the CPU: ``capacity``, the routed FFN at capacities that drop tokens
(kept slots and the keep mask exactly equal), forward, prefill and decode
of reduced qwen2-moe-a2.7b (with its shared expert) and reduced dbrx-132b
(without), decode against forward at ``reduced()``'s no-drop capacity,
greedy generation through ``LmEngine`` and the CLI.

Inputs and weights are made with numpy from a seed and fed to both
packages; the reference's params are converted with
``lm_params_from_numpy`` (constant-initialised leaves randomised).
Tolerances: the routed FFN's output and aux loss within 1e-5, whole models
within rtol/atol 1e-4 in fp32 (the packages sum matmuls and softmaxes in
other orders; measured differences are about 1e-6).  Routing is compared
exactly: a different expert or slot would move the output by its own size.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.serve.engine import LmEngine as RLmEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve.engine import LmEngine  # noqa: E402
from test_torch_lm import MODEL_TOL, _jitted, _np, _pair, _tokens  # noqa: E402

FFN_TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = ["qwen2-moe-a2.7b", "dbrx-132b"]


def _reference_routing(p, x, cfg):
    """The reference's routing, as ``repro/models/moe.py:moe_ffn`` computes
    it (which keeps it internal): (top_i, slot of each choice, keep)."""
    g, s, _ = x.shape
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.top_k)
    flat = jax.nn.one_hot(top_i, cfg.n_experts, dtype=jnp.int32).reshape(g, s * cfg.top_k, -1)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(g, s, cfg.top_k)
    return top_i, pos, pos < rmoe.capacity(cfg, s)


@pytest.mark.parametrize("k,e", [(1, 8), (2, 8), (4, 60), (4, 16), (2, 4)])
def test_capacity_matches_reference(k, e):
    for s in (1, 2, 7, 32, 512, 1030):
        for cf in (0.5, 1.0, 1.25, 2.0, 15.0):
            rcfg = dataclasses.replace(r_get_arch("qwen2-moe-a2.7b"), n_experts=e, top_k=k,
                                       moe_capacity_factor=cf)
            tcfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b"), n_experts=e, top_k=k,
                                       moe_capacity_factor=cf)
            assert tmoe.capacity(tcfg, s) == rmoe.capacity(rcfg, s), (s, k, e, cf)
    full = get_arch("qwen2-moe-a2.7b")
    assert (tmoe.capacity(full, 512), tmoe.capacity(full, 1)) == (43, 1)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_ffn_drops_tokens_as_the_reference(cf, shared):
    """E=8, k=2, S=32: at cf 0.5 (C=4) and 1.25 (C=10) experts overflow and
    tokens are dropped; the routing, slots and keep mask are equal."""
    rcfg, tcfg, rp, tp = _pair("qwen2-moe-a2.7b", seed=11, n_experts=8, top_k=2,
                               moe_capacity_factor=cf, n_shared_experts=int(shared))
    rb = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["moe"])
    tb = TL.layer(tp["layers"]["moe"], 0)
    x = np.random.default_rng(11).standard_normal((3, 32, rcfg.d_model)).astype(np.float32)
    r_top, r_pos, r_keep = _reference_routing(rb, jnp.asarray(x), rcfg)
    _, _, t_top = tmoe.route(tb, torch.from_numpy(x), tcfg)
    t_pos, t_keep = tmoe.slots(t_top, tcfg.n_experts, tmoe.capacity(tcfg, 32))
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(r_top))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(r_pos))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(r_keep))
    assert not t_keep.all() and t_keep.any()  # some choices are dropped, some kept
    r_out, r_aux = jax.jit(lambda p, x: rmoe.moe_ffn(p, x, rcfg))(rb, jnp.asarray(x))
    t_out, t_aux = tmoe.moe_ffn(tb, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(t_out), _np(r_out), **FFN_TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **FFN_TOL)


def test_route_puts_the_lower_index_first_on_ties():
    """Equal probabilities (a zero router): the experts in index order, as
    ``jax.lax.top_k`` gives them."""
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(), n_experts=8, top_k=3)
    p = {"router": torch.zeros(cfg.d_model, 8)}
    _, top_p, top_i = tmoe.route(p, torch.randn(2, 5, cfg.d_model), cfg)
    assert (top_i == torch.arange(3)).all() and torch.allclose(top_p, torch.full_like(top_p, 1 / 8))


@pytest.mark.parametrize("name", MODELS)
def test_forward_prefill_decode_match_reference(name):
    rcfg, tcfg, rp, tp = _pair(name, seed=1)
    (r_forward, r_prefill, r_decode), tapi = _jitted(r_get_model(rcfg)), get_model(tcfg)
    toks = _tokens(rcfg, 2, 16, seed=1)
    t_logits, t_aux = tmoe.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    r_logits, r_aux = jax.jit(rmoe.forward, static_argnums=2)(rp, {"tokens": jnp.asarray(toks)},
                                                              rcfg)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **MODEL_TOL)
    np.testing.assert_allclose(_np(tapi.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)),
                               _np(r_forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)),
                               **MODEL_TOL)
    r_logits, r_cache = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :13])}, rcfg, 20)
    t_logits, t_cache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks[:, :13])}, tcfg, 20)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    for i in range(5):  # three teacher-forced decode steps, then two on the greedy token
        want = np.asarray(r_logits[:, -1, : rcfg.vocab].argmax(-1))
        np.testing.assert_array_equal(t_logits[:, -1, : tcfg.vocab].argmax(-1).numpy(), want)
        step = toks[:, 13 + i : 14 + i] if i < 3 else want[:, None].astype(np.int32)
        r_logits, r_cache = r_decode(rp, r_cache, {"tokens": jnp.asarray(step)}, rcfg)
        t_logits, t_cache = tapi.decode_step(tp, t_cache, {"tokens": torch.from_numpy(step)}, tcfg)
        np.testing.assert_allclose(_np(t_logits), _np(r_logits), **MODEL_TOL)
    assert t_cache["pos"] == int(r_cache["pos"]) == 18
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(t_cache[key]), _np(r_cache[key]), **MODEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_forward(name):
    """At ``reduced()``'s capacity no token is dropped, so prefill(x[:t])
    then decode_step(x[t]) equals forward(x[:t+1]) at the last positions."""
    _, tcfg, _, tp = _pair(name, seed=2)
    api = get_model(tcfg)
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=2))
    full = api.forward(tp, {"tokens": toks}, tcfg)
    pre, cache = api.prefill(tp, {"tokens": toks[:, :14]}, tcfg, max_len=20)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, 13]), **MODEL_TOL)
    for i in (14, 15):
        dec, cache = api.decode_step(tp, cache, {"tokens": toks[:, i : i + 1]}, tcfg)
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, i]), **MODEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_generate_matches_reference(name):
    rcfg, tcfg, rp, tp = _pair(name, seed=6)
    prompt = _tokens(rcfg, 2, 10, seed=6)
    want = RLmEngine(rp, rcfg, max_len=18).generate(prompt, 8)
    eng = LmEngine(tp, tcfg, max_len=18, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompt, 8), np.asarray(want))
    assert eng.launches == {"decode_attn": 0, "ssd_scan": 0}  # plain versions on the CPU


def test_init_params_tree_and_dtypes():
    """The reference's tree, shapes and dtypes: the router and the norms
    fp32, everything else at the model dtype; experts stacked per layer.
    ``lm_params_from_numpy`` casts the reference's fp32 tree the same way."""
    rcfg = dataclasses.replace(r_get_arch("qwen2-moe-a2.7b").reduced(), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(), dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: rmoe.init_params(jax.random.PRNGKey(0), rcfg))
    got = tmoe.init_params(tcfg, seed=0, device="cpu")
    flat_w = {"/".join(str(k.key) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    from repro_torch.tree import flatten

    flat_g = flatten(got)
    assert sorted(flat_g) == sorted(flat_w)
    for key, leaf in flat_g.items():
        assert tuple(leaf.shape) == tuple(flat_w[key].shape), key
        assert str(leaf.dtype).split(".")[-1] == str(flat_w[key].dtype), key
    again = tmoe.init_params(tcfg, seed=0, device="cpu")
    assert all(torch.equal(a, flatten(again)[k]) for k, a in flat_g.items())
    from repro_torch.convert import lm_params_from_numpy
    from test_torch_lm_golden import reference_params

    fp32_tree = reference_params(dataclasses.replace(rcfg, dtype=jnp.float32), 0)
    converted = flatten(lm_params_from_numpy(fp32_tree, "cpu", dtype=torch.bfloat16))
    assert {k: t.dtype for k, t in converted.items()} == {k: t.dtype for k, t in flat_g.items()}
    assert converted["layers/moe/router"].dtype == torch.float32


@pytest.mark.parametrize("name", MODELS)
def test_cli_lm_mode_on_cpu(name, capsys):
    out = tcli.main(["--mode", "lm", "--arch", name, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["launches"] == {"decode_attn": 0, "ssd_scan": 0}
    assert f"{name}: generated (2, 4)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card (marked gpu: skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda):
    """Replayed prefill and decode graphs give the eager kernel path's
    logits bit for bit, and K5 once per layer per decode step."""
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=cuda)
    prompt = _tokens(cfg, 3, 9, seed=3)
    replay = LmEngine(params, cfg, max_len=16)
    eager = LmEngine(params, cfg, max_len=16, graphs=False)
    tokens = replay.generate(prompt, 6)
    np.testing.assert_array_equal(eager.generate(prompt, 6), tokens)
    r_pre, r_steps = replay.teacher_forced(prompt, tokens)
    e_pre, e_steps = eager.teacher_forced(prompt, tokens)
    assert torch.equal(r_pre, e_pre) and torch.equal(r_steps, e_steps)
    assert replay.launches == eager.launches == {"decode_attn": 2 * cfg.n_layers * 5,
                                                 "ssd_scan": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_at_the_moe_geometry(cuda, dtype):
    """K5 at qwen2-moe's 16/16 heads, D=128 (G=1), against its plain version."""
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(8, 16, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(8, 576, 16, 128, generator=gen, device=cuda).to(dtype) for _ in range(2))
    lengths = torch.tensor([576, 1, 63, 64, 65, 513, 300, 575], dtype=torch.int32, device=cuda)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(decode_attn(q, k, v, lengths).float(),
                               decode_attn_plain(q, k, v, lengths).float(), **tol)


# ---------------------------------------------------------------------------
# chip_smoke.py's routing probes, on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_routing_probes():
    """``recording_routes`` sees every ``moe_ffn`` call, ``routing_flips``
    counts the decisions two runs differ on (prefill and decode apart), and
    ``pinned_routes`` replays recorded decisions: with the run's own ones
    the logits are unchanged, with others they move."""
    cs = _chip_smoke()
    _, tcfg, _, tp = _pair("qwen2-moe-a2.7b", seed=9)
    toks = _tokens(tcfg, 2, 10, seed=9)
    eng = LmEngine(tp, tcfg, max_len=16, device="cpu")
    runs = {}
    for key in ("a", "b"):
        runs[key] = []
        with cs.recording_routes(tmoe, runs[key]):
            pre, steps = eng.teacher_forced(toks[:, :7], toks[:, 7:])
    assert tmoe.route.__name__ == "route"  # restored
    assert len(runs["a"]) == tcfg.n_layers * 3  # prefill and two steps
    flips = cs.routing_flips(runs["a"], runs["b"])
    assert flips["prefill"]["decisions"] == 2 * 7 * tcfg.top_k * tcfg.n_layers
    assert flips["decode"]["tokens"] == 2 * 2 * tcfg.n_layers
    assert flips["prefill"]["choices_differ"] == flips["decode"]["choices_differ"] == 0
    other = [t.clone() for t in runs["a"]]
    other[-1][0, 0] = other[-1][0, 0].flip(-1)  # the same experts in another order
    other[-2][1, 0, 0] = (other[-2][1, 0, 0] + 1) % tcfg.n_experts
    flips = cs.routing_flips(other, runs["a"])
    assert flips["decode"]["choices_differ"] == tcfg.top_k + 1
    assert flips["decode"]["tokens_with_other_experts"] == 1
    with cs.pinned_routes(tmoe, runs["a"]):
        same = eng.teacher_forced(toks[:, :7], toks[:, 7:])
    assert torch.equal(same[0], pre) and torch.equal(same[1], steps)
    other = [t.clone() for t in runs["a"]]
    other[-1] = (other[-1] + 1) % tcfg.n_experts
    with cs.pinned_routes(tmoe, other):
        moved = eng.teacher_forced(toks[:, :7], toks[:, 7:])
    assert torch.equal(moved[0], pre) and not torch.equal(moved[1], steps)


def test_chip_smoke_control_reaches_the_decode_path(monkeypatch):
    """``k5_plain_in_path`` puts K5's plain version where the decode path
    looks K5's entry up, once per layer and step, and puts the entry back:
    the control of chip_smoke's routing check is not the kernel path."""
    import repro_torch.kernels.decode_attn as k5_pkg

    cs = _chip_smoke()
    plain, op, calls = k5_pkg.decode_attn_plain, k5_pkg.decode_attn_op, []

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(k5_pkg, "decode_attn_plain", spy)
    _, tcfg, _, tp = _pair("qwen2-moe-a2.7b", seed=9)
    toks = _tokens(tcfg, 2, 10, seed=9)
    eng = LmEngine(tp, tcfg, max_len=16, device="cpu")
    with cs.k5_plain_in_path():
        eng.teacher_forced(toks[:, :7], toks[:, 7:])
    assert calls == [(2, tcfg.n_heads, tcfg.hd)] * (tcfg.n_layers * 2)
    assert k5_pkg.decode_attn_op is op
    eng.teacher_forced(toks[:, :7], toks[:, 7:])
    assert len(calls) == tcfg.n_layers * 2
