"""The per-layer scan kernel (K3) and the ``kernel`` backend, against the
reference, on the CPU.

The port's ``lstm_scan`` runs its plain version here (``ref.lstm_scan_ref``,
the CUDA kernel's operation order).  Inputs are made with numpy from a seed
and fed to both packages; the reference's Pallas ``lstm_scan`` runs in
interpret mode.  Tolerance rtol/atol 1e-5, the reference's own for this
kernel (``tests/test_lstm_scan_kernel.py``): the two packages round the
transcendentals and the ``h @ W_h`` sum differently.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline container: fixed-example stand-ins
    from _hypothesis_compat import given, settings, st

from repro.core import lstm as rlstm  # noqa: E402
from repro.core import quant as rq  # noqa: E402
from repro.core.autoencoder import AutoencoderConfig as RAeConfig  # noqa: E402
from repro.core.autoencoder import autoencoder_forward as r_ae_forward  # noqa: E402
from repro.core.autoencoder import init_autoencoder as r_init_ae  # noqa: E402
from repro.kernels.lstm_scan import lstm_scan_op as r_scan_op  # noqa: E402
from repro.kernels.lstm_scan import lstm_scan_ref as r_scan_ref  # noqa: E402
from repro.serve import engine as reng  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.autoencoder import AutoencoderConfig  # noqa: E402
from repro_torch.core.autoencoder import reconstruction_error  # noqa: E402
from repro_torch.core.lstm import LstmConfig, lstm_forward  # noqa: E402
from repro_torch.kernels.lstm_scan import (  # noqa: E402
    lstm_scan,
    lstm_scan_layer,
    lstm_scan_layer_ref,
    lstm_scan_op,
    lstm_scan_ref,
    pad_gates,
)
from repro_torch.kernels.lstm_stack.ref import seq_dot  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STREAM_TOL = dict(rtol=1e-6, atol=1e-7)
ACTS = {"exact": (rq.EXACT, tq.EXACT), "hard": (rq.HARD, tq.HARD),
        "paper_hw": (rq.PAPER_HW, tq.PAPER_HW)}


def _mk(seed, b, t, h, dtype=np.float32):
    rng = np.random.RandomState(seed)
    xw = rng.randn(b, t, 4 * h).astype(np.float32)
    w_h = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    h0 = rng.randn(b, h).astype(np.float32)
    c0 = rng.randn(b, h).astype(np.float32)
    return xw, w_h, h0, c0


def _torch(*arrays, dtype=None):
    out = [torch.from_numpy(a) for a in arrays]
    return out if dtype is None else [out[0], out[1].to(dtype), out[2].to(dtype), out[3]]


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, dtype=np.float32), **(tol or TOL))


class TestPlainVersusReference:
    @pytest.mark.parametrize("h", [4, 9, 32, 128])
    @pytest.mark.parametrize("b,t", [(1, 1), (3, 8), (8, 33), (16, 100)])
    def test_shape_sweep_fp32(self, h, b, t):
        xw, w_h, h0, c0 = _mk(h * 100 + b, b, t, h)
        got = lstm_scan_op(*_torch(xw, w_h, h0, c0))
        want = r_scan_op(*map(jnp.asarray, (xw, w_h, h0, c0)), interpret=True)
        _close(got, want)
        hs_r, hf_r, cf_r = r_scan_ref(jnp.swapaxes(xw, 0, 1), w_h, h0, c0)
        _close(got, (jnp.swapaxes(hs_r, 0, 1), hf_r, cf_r))

    @pytest.mark.parametrize("name", list(ACTS))
    def test_activation_variants(self, name):
        r_acts, t_acts = ACTS[name]
        xw, w_h, h0, c0 = _mk(0, 4, 12, 16)
        got = lstm_scan_op(*_torch(xw, w_h, h0, c0), acts=t_acts)
        want = r_scan_op(*map(jnp.asarray, (xw, w_h, h0, c0)), acts=r_acts,
                         interpret=True)
        _close(got, want)

    def test_paper_hw_runs_its_kernel_twin(self):
        """PAPER_HW's lookup table has no kernel form: the op swaps it for
        PAPER_HW_KERNEL, and the kernel wrapper itself refuses it."""
        xw, w_h, h0, c0 = _torch(*_mk(9, 4, 12, 16))
        a = lstm_scan_op(xw, w_h, h0, c0, acts=tq.PAPER_HW)
        b = lstm_scan_op(xw, w_h, h0, c0, acts=tq.PAPER_HW_KERNEL)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        with pytest.raises(ValueError, match="kernel form"):
            lstm_scan(xw.transpose(0, 1).contiguous(), w_h, h0, c0, acts=tq.PAPER_HW)

    def test_bf16_weights_fp32_state(self):
        """bf16 h and W_h, fp32 cell carry: the reference kernel's dtypes."""
        xw, w_h, h0, c0 = _mk(1, 4, 16, 32)
        hs, h_f, c_f = lstm_scan_op(*_torch(xw, w_h, h0, c0, dtype=torch.bfloat16))
        assert hs.dtype == h_f.dtype == torch.bfloat16 and c_f.dtype == torch.float32
        bf = jnp.bfloat16
        want = r_scan_op(jnp.asarray(xw), jnp.asarray(w_h).astype(bf),
                         jnp.asarray(h0).astype(bf), jnp.asarray(c0), interpret=True)
        # bf16 rounding of h: a one-ulp gate difference can move h by one
        # bf16 step (2**-8 relative), which the reference bounds at 0.05
        _close((hs, h_f, c_f), want, rtol=0.05, atol=0.05)

    def test_bf16_weights_under_fp32_compute(self):
        """bf16 W_h with fp32 h promotes to fp32, as jnp.dot does."""
        xw, w_h, h0, c0 = _mk(2, 3, 9, 8)
        w16 = torch.from_numpy(w_h).to(torch.bfloat16)
        got = lstm_scan_op(torch.from_numpy(xw), w16, torch.from_numpy(h0),
                           torch.from_numpy(c0))
        want = r_scan_op(jnp.asarray(xw), jnp.asarray(w_h).astype(jnp.bfloat16),
                         jnp.asarray(h0), jnp.asarray(c0), interpret=True)
        _close(got, want)

    @given(b=st.integers(1, 6), t=st.integers(1, 12), h=st.integers(1, 24),
           seed=st.integers(0, 1000))
    @settings(max_examples=15, deadline=None)
    def test_property_random_shapes(self, b, t, h, seed):
        xw, w_h, h0, c0 = _mk(seed, b, t, h)
        got = lstm_scan_op(*_torch(xw, w_h, h0, c0))
        hs_r, hf_r, cf_r = r_scan_ref(jnp.swapaxes(xw, 0, 1), w_h, h0, c0)
        _close(got, (jnp.swapaxes(hs_r, 0, 1), hf_r, cf_r))


class TestRowIndependence:
    @pytest.mark.parametrize("block_b", [None, 1, 3, 8])
    def test_rows_do_not_depend_on_batch_or_block(self, block_b):
        """A row's bits do not depend on B or on block_b (one CTA per block
        of rows on the card, the same per-row order here)."""
        xw, w_h, h0, c0 = _torch(*_mk(2, 8, 10, 8))
        whole = lstm_scan_op(xw, w_h, h0, c0, block_b=block_b)
        for i in (0, 5, 7):
            row = lstm_scan_op(xw[i : i + 1], w_h, h0[i : i + 1], c0[i : i + 1])
            for a, b in zip(row, whole):
                assert torch.equal(a, b[i : i + 1])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    def test_layer_entry_rows_are_independent(self, dtype):
        """The in-launch input product keeps rows independent too, and
        equals the scan over the same product formed outside."""
        rng = np.random.RandomState(8)
        xs = torch.from_numpy(rng.randn(6, 9, 32).astype(np.float32))
        w_x = torch.from_numpy((rng.randn(32, 32) * 0.2).astype(np.float32)).to(dtype)
        b = torch.from_numpy(rng.randn(32).astype(np.float32))
        w_h = torch.from_numpy((rng.randn(8, 32) * 0.3).astype(np.float32)).to(dtype)
        h0 = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).to(dtype)
        c0 = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
        whole = lstm_scan_layer(xs, w_x, b, w_h, h0, c0)
        xw = seq_dot(xs.to(dtype).float(), w_x.float()).to(dtype).float() + b
        for a, bb in zip(whole, lstm_scan(xw.transpose(0, 1).contiguous(), w_h, h0, c0)):
            assert torch.equal(a, bb)
        for i in (0, 5):
            row = lstm_scan_layer(xs[i : i + 1, 2:], w_x, b, w_h, whole[0][1, i : i + 1],
                                  lstm_scan_layer_ref(xs[i : i + 1, :2].to(dtype), w_x, b, w_h,
                                                      h0[i : i + 1], c0[i : i + 1])[2])
            assert torch.equal(row[0], whole[0][2:, i : i + 1])

    def test_layer_entry_refuses_bad_operands(self):
        xs, w_x = torch.zeros(2, 3, 4), torch.zeros(4, 32)
        b, w_h, h0, c0 = torch.zeros(32), torch.zeros(8, 32), torch.zeros(2, 8), torch.zeros(2, 8)
        lstm_scan_layer(xs, w_x, b, w_h, h0, c0)
        with pytest.raises(ValueError, match="w_x"):
            lstm_scan_layer(xs, w_x.to(torch.bfloat16), b, w_h, h0, c0)
        with pytest.raises(ValueError, match="b is"):
            lstm_scan_layer(xs, w_x, b.double(), w_h, h0, c0)
        with pytest.raises(ValueError, match="h0"):
            lstm_scan_layer(xs, w_x, b, w_h, h0[:1], c0)

    def test_pad_gates_segmentwise(self):
        x = torch.arange(8, dtype=torch.float32).reshape(1, 8)  # H=2, 4 gates
        out = pad_gates(x, 2, 3)
        assert torch.equal(out[0], torch.tensor([0, 1, 0, 2, 3, 0, 4, 5, 0, 6, 7, 0.0]))
        assert pad_gates(x, 2, 2) is x

    def test_hidden_padding_exactness(self):
        """Gate-aware H padding (9 -> 16) leaves the real lanes' bits."""
        xw, w_h, h0, c0 = _torch(*_mk(4, 2, 5, 9))
        hp = 16
        xw_p = pad_gates(xw, 9, hp)
        w_h_p = pad_gates(torch.nn.functional.pad(w_h, (0, 0, 0, hp - 9)), 9, hp)
        h0_p = torch.nn.functional.pad(h0, (0, hp - 9))
        c0_p = torch.nn.functional.pad(c0, (0, hp - 9))
        hs_p, _, _ = lstm_scan_op(xw_p, w_h_p, h0_p, c0_p)
        hs, _, _ = lstm_scan_op(xw, w_h, h0, c0)
        assert torch.equal(hs_p[:, :, :9], hs)

    @pytest.mark.parametrize("bad", ["xw_dtype", "w_h_shape", "c0_dtype", "h0_shape"])
    def test_wrapper_refuses_bad_operands(self, bad):
        xw, w_h, h0, c0 = _torch(*_mk(5, 2, 3, 4))
        xw = xw.transpose(0, 1).contiguous()
        if bad == "xw_dtype":
            xw = xw.double()
        elif bad == "w_h_shape":
            w_h = w_h[:3]
        elif bad == "c0_dtype":
            c0 = c0.to(torch.bfloat16)
        else:
            h0 = h0[:1]
        with pytest.raises(ValueError, match="lstm_scan"):
            lstm_scan(xw, w_h, h0, c0)


class TestKernelBackend:
    @pytest.mark.parametrize("lx,lh,t,b", [(1, 9, 8, 2), (32, 32, 16, 4), (8, 8, 5, 3)])
    def test_lstm_forward_kernel_impl(self, lx, lh, t, b):
        key = jax.random.PRNGKey(5)
        r_cfg = rlstm.LstmConfig(in_dim=lx, hidden=lh)
        params = rlstm.init_lstm(key, r_cfg)
        xs = np.array(jax.random.normal(jax.random.fold_in(key, 1), (b, t, lx)))
        rng = np.random.RandomState(b)
        state = (rng.randn(b, lh).astype(np.float32), rng.randn(b, lh).astype(np.float32))
        t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
        t_cfg = LstmConfig(in_dim=lx, hidden=lh)
        t_state = tuple(map(torch.from_numpy, state))
        hs_k, (h_k, c_k) = lstm_forward(t_params, torch.from_numpy(xs), t_cfg, t_state,
                                        impl="kernel")
        hs_r, (h_r, c_r) = rlstm.lstm_forward(params, xs, r_cfg, state, impl="kernel")
        _close((hs_k, h_k, c_k), (hs_r, h_r, c_r))
        hs_s, (h_s, c_s) = lstm_forward(t_params, torch.from_numpy(xs), t_cfg, t_state,
                                        impl="split")
        _close((hs_k, h_k, c_k), (hs_s, h_s, c_s))

    def test_autoencoder_kernel_impl(self):
        r_k = RAeConfig(hidden=(9, 9), latent_boundary=1, impl="kernel")
        params = r_init_ae(jax.random.PRNGKey(6), r_k)
        x = np.array(jax.random.normal(jax.random.PRNGKey(7), (3, 12, 1)))
        t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
        want_k = np.mean((np.asarray(r_ae_forward(params, x, r_k)) - x) ** 2, axis=(1, 2))
        r_s = dataclasses.replace(r_k, impl="split")
        want_s = np.mean((np.asarray(r_ae_forward(params, x, r_s)) - x) ** 2, axis=(1, 2))
        xt = torch.from_numpy(x)
        for impl, want in (("kernel", want_k), ("split", want_s)):
            cfg = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, impl=impl)
            got = reconstruction_error(t_params, xt, cfg).numpy()
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(want_k, want_s, **TOL)

    def test_plan_registers_kernel_backend(self):
        cfgs = [LstmConfig(in_dim=1, hidden=4), LstmConfig(in_dim=4, hidden=4)]
        plan = tex.plan_stack(cfgs, impl="kernel")
        assert plan.backend.kernel_acts and plan.backend.state_layout == "layers"
        assert not plan.backend.packs and plan.weight_dtype is None
        for kw, match in ((dict(block_b=2), "block_b only applies"),
                          (dict(chunk_len=4), "chunk_len only applies"),
                          (dict(act_bits=16), "act_bits only applies"),
                          (dict(weight_dtype="int8"), "quantized-capable")):
            with pytest.raises(ValueError, match=match):
                tex.plan_stack(cfgs, impl="kernel", **kw)


@pytest.fixture(scope="module", params=["gw_small", "gw_nominal"])
def model(request):
    from repro.configs.gw import GW_MODELS as R_MODELS
    from repro_torch.configs.gw import GW_MODELS as T_MODELS

    name, T = request.param, 20
    r_cfg = dataclasses.replace(R_MODELS[name], timesteps=T)
    t_cfg = dataclasses.replace(T_MODELS[name], timesteps=T)
    params = r_init_ae(jax.random.PRNGKey(11), r_cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    x = np.random.RandomState(3).randn(4, T, 1).astype(np.float32)
    return params, r_cfg, t_params, t_cfg, x


class TestEnginesOnKernel:
    def test_batch_engine_matches_reference(self, model):
        params, r_cfg, t_params, t_cfg, x = model
        want = reng.AnomalyStreamEngine(params, r_cfg, impl="kernel").score(x)
        eng = teng.AnomalyStreamEngine(t_params, t_cfg, impl="kernel", device="cpu")
        assert eng.effective_impl == "kernel"
        np.testing.assert_allclose(eng.score(x), want, **TOL)

    @pytest.mark.parametrize("sizes", [[7, 13], [1] * 20], ids=["ragged", "T1"])
    def test_streaming_matches_reference_and_one_shot(self, model, sizes):
        params, r_cfg, t_params, t_cfg, x = model
        r_eng = reng.StreamingAnomalyEngine(params, r_cfg, batch=4, impl="kernel")
        t_eng = teng.StreamingAnomalyEngine(t_params, t_cfg, batch=4, impl="kernel",
                                            device="cpu")
        got, want, pos = [], [], 0
        for n in sizes:
            got += t_eng.push(x[:, pos : pos + n])
            want += r_eng.push(x[:, pos : pos + n])
            pos += n
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[0], t_eng.score(x), **STREAM_TOL)

    def test_push_many_bit_equal_to_sequential(self, model):
        _, _, t_params, t_cfg, _ = model
        T, n = t_cfg.timesteps, 8
        x = np.random.RandomState(12).randn(n, 2 * T, 1).astype(np.float32)
        eng = teng.StreamingAnomalyEngine(t_params, t_cfg, impl="kernel", device="cpu")
        seq = teng.StreamingAnomalyEngine(t_params, t_cfg, impl="kernel", device="cpu")
        ids = [f"s{i}" for i in range(n)]
        eng.push_many(ids[:3], x[:3, :5])
        got = {sid: [] for sid in ids}
        starts = [5 if i < 3 else 0 for i in range(n)]
        for a, b in ((0, 1), (1, 19), (19, 2 * T - 5)):
            res = eng.push_many(ids, np.stack([x[i, s + a : s + b]
                                               for i, s in enumerate(starts)]))
            for sid in ids:
                got[sid] += res[sid]
        for i, sid in enumerate(ids):
            seq.reset()
            cuts = ([0] if starts[i] else []) + [starts[i] + a for a in (0, 1, 19, 2 * T - 5)]
            want = [s for a, b in zip(cuts, cuts[1:]) for s in seq.push(x[i : i + 1, a:b])]
            assert len(got[sid]) == len(want) >= 1
            for g, w in zip(got[sid], want):
                np.testing.assert_array_equal(g, w)
