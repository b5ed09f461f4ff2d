"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (the decision is made inside the
``cuda`` fixture, never at import).  On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The LSTM kernels K1 and K2 and their plain versions perform the same fp32
operations in the same order, so they are held bit for bit
(``torch.equal``), on both of the kernel's paths (W=32 at L <= 2 with the
weights in registers, every other shape at run-time width), layer counts
whose threads take turns inside a step, and every storage dtype.  K3 is
held bit for bit too, on its warp-cell kernel (H=8 and H=32 at compile time,
IN up to 32) and its run-time-width kernel, with a row's bits independent of
B and ``block_b``.  K1's row-blocked instantiations (every thread carrying
several batch rows through each step, the launch at a large batch) are
held bit for bit against the one-row launch and the plain version, with a
partial last CTA.  The server tests hold the
StreamServer on both engines of the card (``fused_step`` and ``kernel``)
bit-equal to sequential pushes.

The LM kernels K5 (decode attention) and K4 (SSD scan) are held at the
reference's own tolerances for those kernels: rtol/atol 2e-5 (K5) and 2e-4
(K4) in fp32.  K5 sums in another order than its plain version (fmaf chains
against PyTorch's reductions); K4 sums as cuBLAS does the plain version's
einsums here (fp32 FMA chains in index order) and agrees with it bit for
bit at mamba2's shapes, but cuBLAS's order is its own choice, so the
tolerance stays.  In bf16 both read the same bf16 inputs,
compute in fp32 and round once, so they differ by at most one bf16 ulp
(2^-7 of the value): rtol 8e-3, atol 1e-3.  K5 is also held at the edges of
its splits of ``SPLIT_ROWS`` cache rows, and a row's output must not
depend on the batch it is served in (bitwise).  K4 is held at the edges
of its chunks (T = 1, 63, 65, 500) and its 16-row state tiles (P = 40),
with B/C groups, a padded state width (N = 24, 8) and strided views.
The LM engine runs the reduced golden fixtures on the card with both
kernels and must match the reference's logits within 1e-4 and its tokens.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
from repro_torch.core.quant import EXACT, HARD, PAPER_HW_KERNEL, make_act_quant
from repro_torch.kernels.lstm_scan import (
    lstm_scan,
    lstm_scan_layer,
    lstm_scan_layer_ref,
    lstm_scan_ref,
)
from repro_torch.kernels.lstm_scan.lstm_scan import kernel_path
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_step
from repro_torch.kernels.lstm_stack.ops import pack_stack
from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref
from repro_torch.kernels.lstm_stack.step import lstm_stack_step_plain
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain
from repro_torch.kernels.decode_attn.decode_attn import SPLIT_ROWS
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.serve.engine import LmEngine, StreamingAnomalyEngine
from repro_torch.serve.server import ServerConfig, StreamServer

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _packs(device, wd):
    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
    params = init_autoencoder(cfg, seed=1, device=device)
    return (pack_stack(*encoder_layers(params, cfg)),
            pack_stack(*decoder_layers(params, cfg)))


def _state(pk, batch, device, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (pk.n_layers, batch, pk.width_p)
    return ((torch.randn(shape, generator=g) * 0.3).to(device),
            (torch.randn(shape, generator=g) * 0.3).to(device))


CASES = [("fp32", EXACT, None), ("bf16", PAPER_HW_KERNEL, 16), ("int8", EXACT, 16),
         ("int8", PAPER_HW_KERNEL, None)]


def _plain_kw(pk, acts, act_bits):
    return dict(scales=pk.stacked.get("scales"), sigma=acts.sigma, tanh=acts.tanh,
                act_quant=make_act_quant(act_bits) if act_bits else None)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("wd,acts,act_bits", CASES)
def test_wavefront_kernel_matches_plain(cuda, wd, acts, act_bits, batch):
    for pk in _packs(cuda, wd):
        s = pk.stacked
        g = torch.Generator().manual_seed(batch)
        xw0 = torch.randn(100, batch, 4 * pk.width_p, generator=g).to(cuda)
        h0, c0 = _state(pk, batch, cuda, 7)
        got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, scales=s.get("scales"),
                         acts=acts, act_bits=act_bits)
        want = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                              **_plain_kw(pk, acts, act_bits))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("t_len,batch", [(1, 1), (25, 8), (32, 64), (25, 1), (32, 1)])
@pytest.mark.parametrize("wd,acts,act_bits", CASES)
def test_step_kernel_matches_plain(cuda, wd, acts, act_bits, t_len, batch):
    for pk in _packs(cuda, wd):
        s = pk.stacked
        g = torch.Generator().manual_seed(t_len)
        xs = torch.randn(batch, t_len, pk.width_p, generator=g).to(cuda)
        h0, c0 = _state(pk, batch, cuda, 3)
        got = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                              scales=s.get("scales"), acts=acts, act_bits=act_bits)
        want = lstm_stack_step_plain(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                                     **_plain_kw(pk, acts, act_bits))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _random_stack(n_layers, width, batch, wd, compute, seed):
    """Random packed weights at storage ``wd`` ((L, W, 4W); int8 codes with
    per-gate scales), biases and a non-zero state, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    shape = (n_layers, width, 4 * width)
    if wd == "int8":
        w_x, w_h = (torch.randint(-127, 128, shape, generator=g).to(torch.int8)
                    for _ in range(2))
        scales = torch.rand(n_layers, 2, 4, generator=g) * 0.02 + 0.002
    else:
        w_x, w_h = ((torch.randn(shape, generator=g) * width**-0.5).to(
            torch.float32 if wd == "fp32" else torch.bfloat16) for _ in range(2))
        scales = None
    b = torch.randn(n_layers, 4 * width, generator=g) * 0.1
    h0 = (torch.randn(n_layers, batch, width, generator=g) * 0.3).to(compute)
    c0 = torch.randn(n_layers, batch, width, generator=g) * 0.3
    return w_x, w_h, b, h0, c0, scales


def _hold_k1_k2_bitwise(cuda, n_layers, width, wd, compute, acts, act_bits, t_lens, batches):
    """K1 (xw0 streamed in) and K2 (raw chunk) against their plain versions
    with torch.equal over every (T, B)."""
    for t_len in t_lens:
        for batch in batches:
            seed = 1000 * n_layers + 10 * width + t_len + batch
            w_x, w_h, b, h0, c0, scales = (
                None if t is None else t.to(cuda)
                for t in _random_stack(n_layers, width, batch, wd, compute, seed))
            g = torch.Generator().manual_seed(seed + 1)
            xw0 = torch.randn(t_len, batch, 4 * width, generator=g).to(cuda)
            xs = torch.randn(batch, t_len, width, generator=g).to(compute).to(cuda)
            kw = dict(scales=scales, sigma=acts.sigma, tanh=acts.tanh,
                      act_quant=make_act_quant(act_bits) if act_bits else None)
            pairs = [(lstm_stack(xw0, w_x, w_h, b, h0, c0, scales=scales, acts=acts,
                                 act_bits=act_bits),
                      lstm_stack_ref(xw0, w_x, w_h, b, h0, c0, **kw))]
            if t_len * n_layers <= 512:
                pairs.append((lstm_stack_step(xs, w_x, w_h, b, h0, c0, scales=scales,
                                              acts=acts, act_bits=act_bits),
                              lstm_stack_step_plain(xs, w_x, w_h, b, h0, c0, **kw)))
            torch.cuda.synchronize()
            for got, want in pairs:
                for a, b_ in zip(got, want):
                    assert torch.equal(a, b_), (n_layers, width, wd, t_len, batch)


@pytest.mark.parametrize("width", [9, 32, 64])
@pytest.mark.parametrize("n_layers", [1, 2, 3, 4])
def test_stack_kernels_bitwise_over_shapes(cuda, n_layers, width):
    """L in 1..4, W in {9, 32, 64}, T in {1, 2, 100}, B in {1, 64}, fp32
    compute.  W=32 at L <= 2 keeps its weights in registers; every other
    shape runs at run-time width from shared memory (W=64 at L=4 fills 1024
    threads).  W=64 stores int8 codes: its fp32 or bf16 weights fit the 227
    KB of shared memory at L=1 only."""
    _hold_k1_k2_bitwise(cuda, n_layers, width, "int8" if width == 64 else "fp32",
                        torch.float32, EXACT, None, (1, 2, 100), (1, 64))


@pytest.mark.parametrize("n_layers,width,wd,compute", [
    (5, 64, "int8", torch.float32),      # 4 of 5 layers at once
    (9, 32, "bf16", torch.bfloat16),     # W=32 past the register path: 8 of 9 layers at once
    (6, 16, "fp32", torch.float32),      # L*4W = 384 threads
    (1, 128, "int8", torch.bfloat16),    # the widest: 512 threads, int8 fits shared memory
    (2, 8, "bf16", torch.float32),
])
def test_stack_kernels_bitwise_in_turns_and_dtypes(cuda, n_layers, width, wd, compute):
    _hold_k1_k2_bitwise(cuda, n_layers, width, wd, compute, PAPER_HW_KERNEL, 16,
                        (1, 37), (1, 3))


def test_rows_are_independent_of_batch_grouping(cuda):
    enc, _ = _packs(cuda, "fp32")
    s = enc.stacked
    xs = torch.randn(16, 5, enc.width_p, generator=torch.Generator().manual_seed(0)).to(cuda)
    h0, c0 = _state(enc, 16, cuda, 1)
    whole = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0, block_b=4)
    for i in (0, 7, 15):
        row = lstm_stack_step(xs[i : i + 1], s["w_x"], s["w_h"], s["b"],
                              h0[:, i : i + 1].contiguous(), c0[:, i : i + 1].contiguous())
        assert torch.equal(row[0], whole[0][i : i + 1])
        assert torch.equal(row[2], whole[2][:, i : i + 1])


BLOCKED_CASES = [("fp32", torch.float32, EXACT, None),
                 ("fp32", torch.float32, PAPER_HW_KERNEL, 16),
                 ("bf16", torch.float32, PAPER_HW_KERNEL, None),
                 ("int8", torch.float32, EXACT, 16),
                 ("bf16", torch.bfloat16, EXACT, None),
                 ("int8", torch.bfloat16, PAPER_HW_KERNEL, 16)]


def _k1_module():
    return sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]


def _wavefront(xw0, w_x, w_h, b, h0, c0, scales, acts, act_bits, path):
    """One wavefront launch through the wrapper's ``launch`` on the path
    forced (a ``KernelPath``)."""
    t_len, batch, width = xw0.shape[0], h0.shape[1], h0.shape[2]
    out = (torch.empty(t_len, batch, width, dtype=h0.dtype, device=h0.device),
           torch.empty_like(h0), torch.empty_like(c0))
    _k1_module().launch("lstm_stack_wavefront", xw0, w_x, w_h, b, h0, c0, scales, *out,
                        t_len=t_len, acts=acts, act_bits=act_bits, path=path)
    return out


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("wd,compute,acts,act_bits", BLOCKED_CASES)
def test_blocked_wavefront_is_bitwise(cuda, n_layers, wd, compute, acts, act_bits):
    """The row-blocked launch gives the one-row launch's and the plain
    version's hs, h_f and c_f bit for bit, from a non-zero state, at B = R
    + 1, SMs + 1 (the least batch the wrapper row-blocks) and 2 * SMs * R
    + 3 (a partial last CTA each time)."""
    k1 = _k1_module()
    sms = k1.sm_count(cuda.index or 0)
    rows = k1.BLOCKED_ROWS
    assert k1.kernel_path(sms + 1, n_layers, 32, sms) == ("blocked", rows)
    for batch in (rows + 1, sms + 1, 2 * sms * rows + 3):
        seed = 100 * rows + batch + n_layers
        w_x, w_h, b, h0, c0, scales = (
            None if t is None else t.to(cuda)
            for t in _random_stack(n_layers, 32, batch, wd, compute, seed))
        g = torch.Generator().manual_seed(seed)
        xw0 = torch.randn(100, batch, 128, generator=g).to(cuda)
        blocked = _wavefront(xw0, w_x, w_h, b, h0, c0, scales, acts, act_bits,
                             k1.KernelPath("blocked", rows))
        one = _wavefront(xw0, w_x, w_h, b, h0, c0, scales, acts, act_bits,
                         k1.KernelPath("one_row", 1))
        plain = lstm_stack_ref(xw0, w_x, w_h, b, h0, c0, scales=scales, sigma=acts.sigma,
                               tanh=acts.tanh,
                               act_quant=make_act_quant(act_bits) if act_bits else None)
        torch.cuda.synchronize()
        for got, a, p in zip(blocked, one, plain):
            assert torch.equal(got, a), (rows, batch)
            assert torch.equal(got, p), (rows, batch)


def test_blocked_rows_are_independent_of_batch_grouping(cuda):
    """At a batch the wrapper row-blocks, rows run one by one (B=1, one row
    a CTA) equal the same rows of the whole batch."""
    k1 = _k1_module()
    enc, _ = _packs(cuda, "fp32")
    s = enc.stacked
    batch = 2 * k1.sm_count(cuda.index or 0) * k1.BLOCKED_ROWS + 3
    assert k1.kernel_path(batch, enc.n_layers, enc.width_p,
                          k1.sm_count(cuda.index or 0)).kind == "blocked"
    g = torch.Generator().manual_seed(5)
    xw0 = torch.randn(100, batch, 4 * enc.width_p, generator=g).to(cuda)
    h0, c0 = _state(enc, batch, cuda, 2)
    before = lstm_stack.launches_by_path["blocked"]
    whole = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0)
    assert lstm_stack.launches_by_path["blocked"] == before + 1
    for i in (0, 1, batch // 2, batch - 1):
        row = lstm_stack(xw0[:, i : i + 1].contiguous(), s["w_x"], s["w_h"], s["b"],
                         h0[:, i : i + 1].contiguous(), c0[:, i : i + 1].contiguous())
        assert torch.equal(row[0], whole[0][:, i : i + 1]), i
        assert torch.equal(row[1], whole[1][:, i : i + 1]), i
        assert torch.equal(row[2], whole[2][:, i : i + 1]), i
    assert lstm_stack.launches_by_path["blocked"] == before + 1


def test_batch_score_blocks_rows_and_keeps_their_bits(cuda):
    """A batch score over the row-blocking threshold launches K1 row-blocked
    twice (encoder and decoder) and gives each window the score it gets in
    a batch of 64, where K1 runs one row a CTA."""
    from repro_torch.serve.engine import AnomalyStreamEngine

    k1 = _k1_module()
    cfg = GW_MODELS["gw_nominal"]
    eng = AnomalyStreamEngine(init_autoencoder(cfg, seed=4, device=cuda), cfg)
    batch = 2 * k1.sm_count(cuda.index or 0) * k1.BLOCKED_ROWS + 3
    x = np.random.RandomState(1).randn(batch, cfg.timesteps, 1).astype(np.float32)
    lstm_stack.launches = 0
    lstm_stack.launches_by_path.clear()
    whole = eng.score(x)
    assert (lstm_stack.launches, lstm_stack.launches_by_path) == (2, {"blocked": 2})
    parts = np.concatenate([eng.score(x[i : i + 64]) for i in range(0, batch, 64)])
    assert lstm_stack.launches_by_path["blocked"] == 2
    np.testing.assert_array_equal(whole, parts)


def test_engine_runs_both_kernels_and_push_many_is_bit_equal(cuda):
    cfg = GW_MODELS["gw_nominal"]
    params = init_autoencoder(cfg, seed=2, device=cuda)
    x = np.random.RandomState(0).randn(8, 2 * cfg.timesteps, 1).astype(np.float32)
    eng = StreamingAnomalyEngine(params, cfg)
    seq = StreamingAnomalyEngine(params, cfg)
    assert eng.effective_impl == "fused_step"
    lstm_stack.launches = lstm_stack_step.launches = 0
    ids = [f"s{i}" for i in range(8)]
    got = {sid: [] for sid in ids}
    for a, b in ((0, 5), (5, 11), (11, 16), (16, 200)):
        for sid, scores in eng.push_many(ids, x[:, a:b]).items():
            got[sid] += scores
    assert lstm_stack.launches > 0 and lstm_stack_step.launches > 0
    for i, sid in enumerate(ids):
        seq.reset()
        want = []
        for a, b in ((0, 5), (5, 11), (11, 16), (16, 200)):
            want += seq.push(x[i : i + 1, a:b])
        assert len(got[sid]) == len(want) == 2
        for g, w in zip(got[sid], want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("acts", [EXACT, HARD, PAPER_HW_KERNEL], ids=lambda a: a.name)
def test_scan_kernel_matches_plain(cuda, dtype, acts):
    g = torch.Generator().manual_seed(5)
    for hidden, t_len, batch in ((8, 1, 1), (8, 100, 64), (32, 25, 1), (32, 100, 64)):
        xw = torch.randn(t_len, batch, 4 * hidden, generator=g).to(cuda)
        w_h = (torch.randn(hidden, 4 * hidden, generator=g) * 0.3).to(dtype).to(cuda)
        h0 = torch.randn(batch, hidden, generator=g).to(dtype).to(cuda)
        c0 = torch.randn(batch, hidden, generator=g).to(cuda)
        x = torch.randn(batch, t_len, 32, generator=g).to(dtype).to(cuda)
        w_x = (torch.randn(32, 4 * hidden, generator=g) * 0.2).to(dtype).to(cuda)
        b = torch.randn(4 * hidden, generator=g).to(cuda)
        fns = dict(sigma=acts.sigma, tanh=acts.tanh)
        pairs = ((lstm_scan(xw, w_h, h0, c0, acts=acts), lstm_scan_ref(xw, w_h, h0, c0, **fns)),
                 (lstm_scan_layer(x, w_x, b, w_h, h0, c0, acts=acts),
                  lstm_scan_layer_ref(x, w_x, b, w_h, h0, c0, **fns)))
        torch.cuda.synchronize()
        for got, want in pairs:
            for a, b_ in zip(got, want):
                assert torch.equal(a, b_), (hidden, t_len, batch)


def test_scan_rows_are_independent_of_batch_grouping(cuda):
    g = torch.Generator().manual_seed(6)
    xw = torch.randn(20, 16, 128, generator=g).to(cuda)
    w_h = (torch.randn(32, 128, generator=g) * 0.3).to(cuda)
    h0, c0 = torch.randn(16, 32, generator=g).to(cuda), torch.randn(16, 32, generator=g).to(cuda)
    whole = lstm_scan(xw, w_h, h0, c0, block_b=4)
    for i in (0, 9, 15):
        row = lstm_scan(xw[:, i : i + 1].contiguous(), w_h, h0[i : i + 1], c0[i : i + 1])
        assert torch.equal(row[0], whole[0][:, i : i + 1])
        assert torch.equal(row[2], whole[2][i : i + 1])


F32, BF16 = torch.float32, torch.bfloat16


def _scan_operands(hidden, n_in, batch, t_len, ct, wd, device, seed):
    """Random K3 operands: xw for lstm_scan, x, W_x and b for
    lstm_scan_layer, W_h and a non-zero state for both."""
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(t_len, batch, 4 * hidden, generator=g).to(device)
    x = torch.randn(batch, t_len, n_in, generator=g).to(ct).to(device)
    w_x = (torch.randn(n_in, 4 * hidden, generator=g) * n_in**-0.5).to(wd).to(device)
    w_h = (torch.randn(hidden, 4 * hidden, generator=g) * hidden**-0.5).to(wd).to(device)
    b = (torch.randn(4 * hidden, generator=g) * 0.1).to(device)
    h0 = (torch.randn(batch, hidden, generator=g) * 0.3).to(ct).to(device)
    c0 = (torch.randn(batch, hidden, generator=g) * 0.3).to(device)
    return xw, x, w_x, b, w_h, h0, c0


def _hold_k3_bitwise(cuda, hidden, n_in, ct, wd, acts, t_lens, batches, blocks):
    """Both K3 entries against their plain versions with torch.equal over
    every (T, B, block_b)."""
    fns = dict(sigma=acts.sigma, tanh=acts.tanh)
    for t_len in t_lens:
        for batch in batches:
            xw, x, w_x, b, w_h, h0, c0 = _scan_operands(
                hidden, n_in, batch, t_len, ct, wd, cuda, 100 * hidden + 10 * n_in + t_len + batch)
            want = (*lstm_scan_ref(xw, w_h, h0, c0, **fns),
                    *lstm_scan_layer_ref(x, w_x, b, w_h, h0, c0, **fns))
            for block_b in blocks:
                got = (*lstm_scan(xw, w_h, h0, c0, block_b=block_b, acts=acts),
                       *lstm_scan_layer(x, w_x, b, w_h, h0, c0, block_b=block_b, acts=acts))
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    assert torch.equal(g_, w_), (hidden, n_in, ct, wd, t_len, batch, block_b)


@pytest.mark.parametrize("ct,wd", [(F32, F32), (F32, BF16), (BF16, BF16)],
                         ids=["fp32", "fp32-bf16w", "bf16"])
@pytest.mark.parametrize("hidden,n_in", [(32, 1), (32, 8), (32, 32), (8, 1), (8, 5), (8, 8),
                                         (8, 32)])
def test_scan_warp_cell_is_bitwise(cuda, hidden, n_in, ct, wd):
    """K3's compile-time widths (gw_nominal's layers: H=32 at IN 1 and 8,
    H=8 at IN 8 and 32) run the warp-cell kernel in lstm_scan_layer and
    equal the plain version bit for bit at B 1, 3, 64, block_b 1 and 2, T
    1, 25 and 100 (several input chunks, a ragged last one); IN=5 runs the
    8-long x chain with three zero terms.  The xw entry, held beside it,
    runs the run-time-width kernel at every width."""
    assert kernel_path(hidden, n_in) == f"warp_cell H={hidden}"
    assert kernel_path(hidden) == f"run_time H={hidden}"
    acts = {1: EXACT, 5: HARD, 8: PAPER_HW_KERNEL, 32: HARD}[n_in]
    lstm_scan.launches_by_path.clear()
    _hold_k3_bitwise(cuda, hidden, n_in, ct, wd, acts, (1, 25, 100), (1, 3, 64), (1, 2))
    assert set(lstm_scan.launches_by_path) == {f"warp_cell H={hidden}", f"run_time H={hidden}"}


@pytest.mark.parametrize("hidden,n_in", [(9, 1), (16, 8), (8, 40), (32, 33), (64, 16)])
def test_scan_run_time_path_is_bitwise(cuda, hidden, n_in):
    """Every other shape (gw_small's H=9, H=16 and 64, IN past 32 at H=8
    and 32) runs the run-time-width kernel, bit for bit too."""
    assert kernel_path(hidden, n_in) == f"run_time H={hidden}"
    _hold_k3_bitwise(cuda, hidden, n_in, F32, F32, EXACT, (1, 25), (1, 3), (1, 2))
    _hold_k3_bitwise(cuda, hidden, n_in, BF16, BF16, PAPER_HW_KERNEL, (7,), (2,), (1,))


@pytest.mark.parametrize("hidden,n_in", [(8, 32), (32, 1)])
def test_scan_warp_cell_rows_are_independent_of_batch_and_block(cuda, hidden, n_in):
    """A row alone equals the same row in a batch of 64 run with block_b
    1, 2 or 3 (the last CTA then holds one row), bitwise."""
    _, x, w_x, b, w_h, h0, c0 = _scan_operands(hidden, n_in, 64, 20, F32, F32, cuda, 9)
    for block_b in (1, 2, 3):
        whole = lstm_scan_layer(x, w_x, b, w_h, h0, c0, block_b=block_b)
        for i in (0, 31, 63):
            row = lstm_scan_layer(x[i : i + 1], w_x, b, w_h, h0[i : i + 1], c0[i : i + 1])
            assert torch.equal(row[0], whole[0][:, i : i + 1]), (block_b, i)
            assert torch.equal(row[1], whole[1][i : i + 1]), (block_b, i)
            assert torch.equal(row[2], whole[2][i : i + 1]), (block_b, i)


@pytest.mark.parametrize("impl", ["fused_step", "kernel"])
def test_server_on_card_is_bit_equal_to_sequential_pushes(cuda, impl):
    cfg = GW_MODELS["gw_nominal"]
    params = init_autoencoder(cfg, seed=4, device=cuda)
    T = cfg.timesteps
    x = np.random.RandomState(1).randn(6, 2 * T, 1).astype(np.float32)
    cuts = (0, 1, 26, 51, 100, 101, 126, 200)
    srv = StreamServer(StreamingAnomalyEngine(params, cfg, impl=impl),
                       ServerConfig(deadline_us=1e9))
    lstm_scan.launches = lstm_stack.launches = lstm_stack_step.launches = 0
    for a, b in zip(cuts, cuts[1:]):
        for i in range(6):
            srv.submit(f"s{i}", x[i, a:b])
        srv.tick(force=True)
    srv.drain()
    got = srv.pop_scores()
    if impl == "kernel":
        assert lstm_scan.launches > 0 and lstm_stack.launches == lstm_stack_step.launches == 0
    else:
        assert lstm_scan.launches == 0 and lstm_stack.launches > 0 < lstm_stack_step.launches
    seq = StreamingAnomalyEngine(params, cfg, impl=impl)
    for i in range(6):
        seq.reset()
        want = [s for a, b in zip(cuts, cuts[1:]) for s in seq.push(x[i : i + 1, a:b])]
        assert len(got[f"s{i}"]) == len(want) == 2
        for g_, w in zip(got[f"s{i}"], want):
            np.testing.assert_array_equal(g_, w)


def _tol(dtype, fp32_tol):
    return dict(rtol=fp32_tol, atol=fp32_tol) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(15, 5, 64), (32, 8, 64), (20, 20, 128), (32, 4, 128)])
def test_decode_attn_kernel_matches_plain(cuda, hq, hkv, d, dtype):
    g = torch.Generator().manual_seed(hq + d)
    for s_len, lengths in ((1, [1, 1, 1]), (70, [70, 33, 1]), (576, [576, 300, 32])):
        q = torch.randn(3, hq, d, generator=g).to(dtype).to(cuda)
        k, v = (torch.randn(3, s_len, hkv, d, generator=g).to(dtype).to(cuda) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        before = decode_attn.launches
        got = decode_attn(q, k, v, lens)
        want = decode_attn_plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert decode_attn.launches == before + 1 and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, 2e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(15, 5, 64), (32, 8, 64), (20, 20, 128), (32, 4, 128)])
def test_decode_attn_kernel_at_split_edges(cuda, hq, hkv, d, dtype):
    """Lengths one below, at and one above a split, shorter than a split,
    1 beside a full row, and S not a multiple of SPLIT_ROWS; NaN past every
    row's length must never be read."""
    g = torch.Generator().manual_seed(hq * d)
    s_len = 2 * SPLIT_ROWS + 7
    lengths = [SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 5, 1, s_len]
    batch = len(lengths)
    q = torch.randn(batch, hq, d, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(batch, s_len, hkv, d, generator=g).to(dtype).to(cuda) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    want = decode_attn_plain(q, k, v, lens)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    got = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, 2e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_attn_rows_are_independent_of_the_batch(cuda, dtype):
    """A row served alone equals the same row in a batch of 8, bitwise
    (smollm-360m's heads at its serving cache)."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn(8, 15, 64, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(8, 576, 5, 64, generator=g).to(dtype).to(cuda) for _ in range(2))
    lens = torch.tensor([576, 513, 1, 64, 65, 300, 128, 575], dtype=torch.int32, device=cuda)
    whole = decode_attn(q, k, v, lens)
    for i in range(8):
        row = decode_attn(q[i : i + 1], k[i : i + 1], v[i : i + 1], lens[i : i + 1])
        assert torch.equal(row, whole[i : i + 1]), i
    assert torch.equal(decode_attn(q, k, v, lens), whole)  # and run to run


@pytest.mark.parametrize("layout", ["strided", "misaligned"])
def test_decode_attn_refuses_a_cache_it_would_copy(cuda, layout):
    """The kernel reads the cache in place by 16-byte copies; a cache that is
    not contiguous or not 16-byte aligned is refused, never copied."""
    q = torch.randn(2, 4, 64, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, 70, 2, 64, device=cuda).to(torch.bfloat16)
    if layout == "strided":
        bad = torch.randn(2, 70, 2, 128, device=cuda).to(torch.bfloat16)[..., :64]
    else:
        bad = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)[1:].view(k.shape)
    lens = torch.tensor([70, 5], dtype=torch.int32, device=cuda)
    before = decode_attn.launches
    for args in ((q, bad, k, lens), (q, k, bad, lens)):
        with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
            decode_attn(*args)
    assert decode_attn.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("groups", [1, 4])
def test_ssd_scan_kernel_matches_plain(cuda, groups, dtype):
    g = torch.Generator().manual_seed(groups)
    heads, p, n = 24, 64, 128
    for t_len, nonzero in ((1, False), (64, True), (100, False), (130, True)):
        x = torch.randn(2, t_len, heads, p, generator=g).to(dtype).to(cuda)
        dt = torch.nn.functional.softplus(torch.randn(2, t_len, heads, generator=g) - 1).to(cuda)
        a = -torch.exp(torch.randn(heads, generator=g) * 0.5).to(cuda)
        bm, cm = ((torch.randn(2, t_len, groups, n, generator=g) * 0.3).to(dtype).to(cuda)
                  for _ in range(2))
        s0 = (torch.randn(2, heads, p, n, generator=g) * 0.3).to(cuda) if nonzero else None
        before = ssd_scan.launches
        y, s_f = ssd_scan(x, dt, a, bm, cm, s0, chunk=64)
        y_p, s_p = ssd_chunked(x, dt, a, bm, cm, s0, chunk=64)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        torch.testing.assert_close(y.float(), y_p.float(), **_tol(dtype, 2e-4))
        torch.testing.assert_close(s_f, s_p, rtol=2e-4, atol=2e-4)


def _ssd_operands(g, batch, t_len, heads, groups, p, n, dtype, nonzero, device):
    x = torch.randn(batch, t_len, heads, p, generator=g).to(dtype).to(device)
    dt = torch.nn.functional.softplus(torch.randn(batch, t_len, heads, generator=g) - 1)
    a = -torch.exp(torch.randn(heads, generator=g) * 0.5)
    bm, cm = ((torch.randn(batch, t_len, groups, n, generator=g) * 0.3).to(dtype).to(device)
              for _ in range(2))
    s0 = (torch.randn(batch, heads, p, n, generator=g) * 0.3).to(device) if nonzero else None
    return x, dt.to(device), a.to(device), bm, cm, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t_len", [1, 63, 65, 500])
def test_ssd_scan_kernel_at_tile_and_chunk_edges(cuda, t_len, dtype):
    """T around the 64-step chunk; P=40 (two 16-row state tiles and a ragged
    8-row one); G=3; N=24 and N=8 (state columns padded to a k16 step);
    chunk 16 (rows past the chunk unused); zero and non-zero s0."""
    g = torch.Generator().manual_seed(t_len)
    for heads, groups, p, n, chunk, nonzero in ((24, 1, 64, 128, 64, False),
                                                (6, 3, 40, 24, 64, True),
                                                (4, 1, 16, 8, 64, True),
                                                (6, 3, 64, 128, 16, True)):
        args = _ssd_operands(g, 2, t_len, heads, groups, p, n, dtype, nonzero, cuda)
        before = ssd_scan.launches
        y, s_f = ssd_scan(*args, chunk=chunk)
        y_p, s_p = ssd_chunked(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        what = (heads, groups, p, n, chunk, nonzero)
        torch.testing.assert_close(y.float(), y_p.float(), **_tol(dtype, 2e-4),
                                   msg=lambda m: f"{what} y: {m}")
        torch.testing.assert_close(s_f, s_p, rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"{what} state: {m}")


def test_ssd_scan_bf16_roundings_do_not_lean_toward_zero(cuda):
    """At mamba2-130m's prefill shape (B=8, T=512, H=24, P=64, N=128; four
    seeds each of SiLU inputs as the SSM block makes them and of zero-mean
    ones), the bf16 y elements that round apart from the plain version lie
    toward zero and away from it alike: at most 55% toward zero
    (chip_smoke.py's K4_LEAN_MAX) once 500 or more differ.  A sum that drops
    its low bits toward zero leans one way and passes the one-ulp limit all
    the same."""
    shape_x, shape_bc = (8, 512, 24, 64), (8, 512, 1, 128)
    differ = toward = 0
    for seed in range(8):
        g = torch.Generator(device=cuda).manual_seed(seed)
        if seed % 2 == 0:  # x, B and C after SiLU
            x, bm, cm = (torch.nn.functional.silu(torch.randn(*s, generator=g, device=cuda))
                         .bfloat16() for s in (shape_x, shape_bc, shape_bc))
            a = -torch.ones(24, device=cuda)
        else:
            x = torch.randn(*shape_x, generator=g, device=cuda).bfloat16()
            bm, cm = ((torch.randn(*shape_bc, generator=g, device=cuda) * 0.3).bfloat16()
                      for _ in range(2))
            a = -torch.exp(torch.randn(24, generator=g, device=cuda) * 0.5)
        dt = torch.nn.functional.softplus(torch.randn(8, 512, 24, generator=g, device=cuda))
        y, _ = ssd_scan(x, dt, a, bm, cm, chunk=64)
        y_p, _ = ssd_chunked(x, dt, a, bm, cm, chunk=64)
        d = y.float() - y_p.float()
        differ += int((d != 0).sum())
        toward += int(((d != 0) & (d.sign() != y_p.float().sign())).sum())
    assert differ < 500 or toward / differ <= 0.55, (toward, differ)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ssd_scan_reads_projection_views_in_place(cuda, dtype):
    """x, B and C as the SSM block hands them over (views into one
    projection, token stride 1792): read in place, and equal bit for bit to
    the same values made contiguous."""
    mod = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]
    g = torch.Generator().manual_seed(3)
    u = torch.randn(2, 130, 24 * 64 + 2 * 128, generator=g).to(dtype).to(cuda)
    x = u[..., : 24 * 64].reshape(2, 130, 24, 64)
    bm = u[..., 24 * 64 : 24 * 64 + 128].reshape(2, 130, 1, 128)
    cm = u[..., 24 * 64 + 128 :].reshape(2, 130, 1, 128)
    assert not x.is_contiguous() and all(mod._strided_ok(t) for t in (x, bm, cm))
    dt = torch.nn.functional.softplus(torch.randn(2, 130, 24, generator=g)).to(cuda)
    a = -torch.exp(torch.randn(24, generator=g) * 0.5).to(cuda)
    got = ssd_scan(x, dt, a, bm, cm, chunk=64)
    want = ssd_scan(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["chunk", "state", "head_dim"])
def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda, bad):
    g = torch.Generator().manual_seed(4)
    p, n, chunk = {"chunk": (64, 128, 128), "state": (64, 136, 64),
                   "head_dim": (12, 128, 64)}[bad]
    args = _ssd_operands(g, 1, 200, 4, 1, p, n, torch.bfloat16, False, cuda)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="the kernel takes"):
        ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("name,fixture", [("smollm-360m", "torch_port_lm_smollm.npz"),
                                          ("mamba2-130m", "torch_port_lm_mamba2.npz")])
def test_lm_engine_on_card_matches_golden(cuda, name, fixture):
    from pathlib import Path

    from test_torch_lm_golden import N_NEW, PROMPT

    from repro_torch.convert import unflatten

    with np.load(Path(__file__).parent / "data" / fixture) as data:
        gold = {k: data[k] for k in data.files}
    cfg = get_arch(name).reduced()
    eng = LmEngine(lm_params_from_numpy(unflatten(gold), cuda), cfg, max_len=PROMPT + N_NEW)
    pre, steps = eng.teacher_forced(gold["prompt"], gold["tokens"])
    np.testing.assert_allclose(pre.cpu().numpy(), gold["prefill_logits"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(steps.cpu().numpy(), gold["decode_logits"], rtol=1e-4, atol=1e-4)
    want = {"decode_attn": cfg.n_layers * (N_NEW - 1), "ssd_scan": 0}
    if cfg.family == "ssm":
        want = {"decode_attn": 0, "ssd_scan": cfg.n_layers}
    assert eng.launches == want
    np.testing.assert_array_equal(eng.generate(gold["prompt"], N_NEW), gold["tokens"])
