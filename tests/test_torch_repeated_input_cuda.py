"""The wavefront kernel (K1) on a layer-0 stream repeated over time, on the
card.

The decoder's gate stream is one (B, 4W) block at every step (time stride
0, ``ops.project_layer0``); K1 reads it in place, every step from the same
rows.  Held bit for bit (``torch.equal``) against K1 on the materialised
copy and against the plain version, on the one-row path (B = 64), the
row-blocked path (B = 2 * SMs * 8 + 3, a partial last CTA) and the
run-time-width path (W = 9), for fp32, bf16 and int8 storage.  Operands the
kernel cannot read in place (an offset block, transposed rows) are still
copied first, and the step kernel (K2) copies a repeated chunk.  Marked
``gpu``: each test skips with a reason where ``torch.cuda.is_available()``
is False.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_repeated_input_cuda.py
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.core.quant import EXACT, PAPER_HW_KERNEL, make_act_quant
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_step, ops
from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref

pytestmark = pytest.mark.gpu

k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
T_LEN = 100


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _stack(n_layers, width, batch, wd, compute, seed, device):
    """Random packed weights at storage ``wd`` (int8 codes with per-gate
    scales), biases and a non-zero state."""
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
    return [None if t is None else t.to(device) for t in (w_x, w_h, b, h0, c0, scales)]


def _block(batch, w4, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, batch, w4, generator=g).to(device)


def _run(xw0, ops_, acts, act_bits):
    w_x, w_h, b, h0, c0, scales = ops_
    return lstm_stack(xw0, w_x, w_h, b, h0, c0, scales=scales, acts=acts, act_bits=act_bits)


def _counts():
    return (lstm_stack.launches, lstm_stack.launches_by_path["blocked"],
            lstm_stack.repeated_input_launches)


def _batch(cuda, path):
    sms = k1.sm_count(cuda.index or 0)
    return {"one_row": 64, "blocked": 2 * sms * k1.BLOCKED_ROWS + 3, "run_time": 64}[path]


STORAGE = [("fp32", torch.float32, EXACT, None), ("bf16", torch.float32, PAPER_HW_KERNEL, 16),
           ("int8", torch.float32, EXACT, 16), ("bf16", torch.bfloat16, EXACT, None),
           ("int8", torch.bfloat16, PAPER_HW_KERNEL, 16)]


@pytest.mark.parametrize("wd,compute,acts,act_bits", STORAGE)
@pytest.mark.parametrize("path,width", [("one_row", 32), ("blocked", 32), ("run_time", 9)])
def test_k1_on_a_repeated_stream_is_bitwise(cuda, path, width, wd, compute, acts, act_bits):
    batch = _batch(cuda, path)
    blocked = path == "blocked"
    sms = k1.sm_count(cuda.index or 0)
    assert (k1.kernel_path(batch, 2, width, sms).kind == "blocked") == blocked
    assert k1.weights_in_registers(2, width) == (path != "run_time")
    seed = 10 * batch + width
    stack = _stack(2, width, batch, wd, compute, seed, cuda)
    rep = _block(batch, 4 * width, seed, cuda).expand(T_LEN, batch, 4 * width)
    dense = rep.contiguous()
    before = _counts()
    got = _run(rep, stack, acts, act_bits)
    mid = _counts()
    want = _run(dense, stack, acts, act_bits)
    after = _counts()
    w_x, w_h, b, h0, c0, scales = stack
    plain = lstm_stack_ref(rep, w_x, w_h, b, h0, c0, scales=scales, sigma=acts.sigma,
                           tanh=acts.tanh,
                           act_quant=make_act_quant(act_bits) if act_bits else None)
    torch.cuda.synchronize()
    assert np.subtract(mid, before).tolist() == [1, int(blocked), 1]
    assert np.subtract(after, mid).tolist() == [1, int(blocked), 0]
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w), (path, wd)
        assert torch.equal(g, p), (path, wd)


def _misaligned_block(batch, w4, seed, device):
    flat = torch.randn(batch * w4 + 1, generator=torch.Generator().manual_seed(seed)).to(device)
    return flat[1:].view(1, batch, w4)


@pytest.mark.parametrize("path,width", [("one_row", 32), ("blocked", 32), ("run_time", 9)])
def test_launch_still_copies_views_it_cannot_read_in_place(cuda, path, width):
    """An offset stream, a transposed one, an offset repeat and a repeat of
    transposed rows: each copied, each the dense stream's bits, none
    counted as a repeated stream."""
    batch = _batch(cuda, path)
    w4 = 4 * width
    stack = _stack(2, width, batch, "fp32", torch.float32, batch + width, cuda)
    g = torch.Generator().manual_seed(width)
    flat = torch.randn(T_LEN * batch * w4 + 1, generator=g).to(cuda)
    offset = flat[1:].view(T_LEN, batch, w4)
    transposed = torch.randn(batch, T_LEN, w4, generator=g).to(cuda).transpose(0, 1)
    rep_offset = _misaligned_block(batch, w4, width + 1, cuda).expand(T_LEN, batch, w4)
    rows_t = torch.randn(w4, batch, generator=g).to(cuda).t()[None].expand(T_LEN, batch, w4)
    for view in (offset, transposed, rep_offset, rows_t):
        assert not k1.repeated_stream(view)
        before = _counts()
        got = _run(view, stack, EXACT, None)
        assert _counts()[2] == before[2]
        want = _run(view.contiguous(), stack, EXACT, None)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), path


def test_the_step_kernel_copies_a_repeated_chunk(cuda):
    width, batch, t_len = 32, 8, 25
    w_x, w_h, b, h0, c0, _ = _stack(2, width, batch, "fp32", torch.float32, 3, cuda)
    g = torch.Generator().manual_seed(4)
    rep = torch.randn(batch, 1, width, generator=g).to(cuda).expand(batch, t_len, width)
    got = lstm_stack_step(rep, w_x, w_h, b, h0, c0)
    want = lstm_stack_step(rep.contiguous(), w_x, w_h, b, h0, c0)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("name,pack", [("gw_nominal", "fp32"), ("gw_nominal", "int8"),
                                       ("gw_small", "fp32")])
def test_batch_score_reads_the_decoders_stream_in_place(cuda, name, pack, monkeypatch):
    """One of a batch score's two K1 launches (the decoder's) reads a
    repeated stream, and every score equals the one from the decoder fed a
    materialised repeat."""
    from repro_torch.serve.engine import AnomalyStreamEngine

    cfg = dataclasses.replace(GW_MODELS[name], weight_dtype=pack)
    params = init_autoencoder(cfg, seed=3, device=cuda)
    batch = _batch(cuda, "blocked")
    windows = np.random.RandomState(5).randn(batch, cfg.timesteps, 1).astype(np.float32)
    eng = AnomalyStreamEngine(params, cfg, impl="fused_stack")
    eng.score(windows[:64])
    before = _counts()
    got = eng.score(windows)
    launches, _, repeated = np.subtract(_counts(), before).tolist()
    assert (launches, repeated) == (2, 1)
    monkeypatch.setattr(ops, "repeats_over_time", lambda xs: False)
    before = _counts()
    want = eng.score(windows)
    assert np.subtract(_counts(), before).tolist()[2] == 0
    np.testing.assert_array_equal(got, want)
