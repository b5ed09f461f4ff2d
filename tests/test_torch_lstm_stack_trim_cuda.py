"""K1's row-blocked launch at the layers' own widths, on the card.

Given a pack's real widths, the row-blocked launch runs only the warps of
real elements (ceil(h / 8) a layer) and ends each chain at its layer's
width rounded up to 4.  Held bit for bit (the tensors' bits, so signed
zeros count) in the whole of hs, h_f and c_f, padded positions included,
against the padded one-row launch, the padded row-blocked launch, the
padded plain version and the plain version at the real widths:

* gw_nominal's encoder (dense stream) and decoder (its repeated latent,
  time stride 0) packs, and two stacks whose widths are not multiples of 8;
* B = 133, 4,099 and 73,728 (the nominal cell's batch);
* fp32, bf16 and int8 storage, fp32 and bf16 compute, the three activation
  sets, with and without ``act_bits``; the zero state and a real-width
  state holding +0 and -0.

A state that holds other values at its padded positions (one handed in at
the pack width) reaches no real output: those keep the padded launches'
bits.  Also: ``lstm_stack.trimmed_launches`` reads 2 a gw_nominal batch
score and 0 a gw_small one (``launches_by_path`` unchanged), the nominal
score's windows keep their bits, an SM holds three trimmed CTAs of either
nominal segment (two padded), and neither row-blocked instantiation (the
layers' own widths, the padded geometry) spills.  Marked ``gpu``: each test skips with a
reason where ``torch.cuda.is_available()`` is False.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lstm_stack_trim_cuda.py
"""

import ctypes
import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
from repro_torch.core.lstm import LstmConfig, init_lstm
from repro_torch.core.quant import EXACT, HARD, PAPER_HW_KERNEL, make_act_quant
from repro_torch.kernels._build import ptxas_report
from repro_torch.kernels.lstm_stack import lstm_stack
from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0
from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref

pytestmark = pytest.mark.gpu

k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
T_LEN = 100
#: (storage, compute dtype, activation set, act_bits)
CASES = [("fp32", torch.float32, EXACT, None), ("fp32", torch.float32, HARD, 16),
         ("bf16", torch.float32, PAPER_HW_KERNEL, None), ("int8", torch.float32, EXACT, 16),
         ("bf16", torch.bfloat16, HARD, None), ("int8", torch.bfloat16, PAPER_HW_KERNEL, 16)]
#: (in_dims, hidden) of each stack, every one packed to W=32
STACKS = {
    "nominal_enc": ((1, 32), (32, 8)),
    "nominal_dec": ((8, 8), (8, 32)),
    "h32_h12": ((1, 32), (32, 12)),
    "h20_h32": ((1, 20), (20, 32)),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def _pack(stack, wd, compute, acts, device, seed=0):
    """``stack`` packed at storage ``wd``: gw_nominal's segments from
    ``init_autoencoder``, the others from ``init_lstm`` with biases drawn
    at every real position."""
    if stack.startswith("nominal"):
        cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd, dtype=compute,
                                  acts=acts)
        params = init_autoencoder(cfg, seed=seed, device=device)
        return pack_stack(*(encoder_layers if stack == "nominal_enc"
                            else decoder_layers)(params, cfg))
    g = torch.Generator().manual_seed(seed)
    in_dims, hidden = STACKS[stack]
    cfgs = [LstmConfig(in_dim=i, hidden=h, dtype=compute, acts=acts, weight_dtype=wd)
            for i, h in zip(in_dims, hidden)]
    params = []
    for c in cfgs:
        p = init_lstm(c, g, device="cpu")
        p["b"] = torch.randn(4 * c.hidden, generator=g) * 0.5
        params.append({k: v.to(device) for k, v in p.items()})
    return pack_stack(params, cfgs)


def _signed(shape, g, scale=1.0):
    """Random values with exact +0 and -0 among them."""
    x = torch.randn(shape, generator=g) * scale
    pick = torch.randint(0, 4, shape, generator=g)
    return torch.where(pick == 0, torch.zeros(()), torch.where(pick == 1, -torch.zeros(()), x))


def _operands(pk, batch, seed, zero_state, repeated, device):
    """Layer 0's gate stream (``repeated``: one latent repeated over the
    window, time stride 0, as the decoder's) from an input holding +0 and
    -0, and the zero state or a real-width state holding +0 and -0, packed."""
    g = torch.Generator().manual_seed(seed)
    d_in = pk.in_dims[0]
    if repeated:  # moved before the expand: a copy to the card is dense
        x = _signed((batch, 1, d_in), g).to(pk.dtype).to(device).expand(batch, T_LEN, d_in)
    else:
        x = _signed((batch, T_LEN, d_in), g).to(pk.dtype).to(device)
    xw0 = project_layer0(pk.pad_input(x), pk.stacked, pk.weight_dtype)
    if zero_state:
        h0, c0 = pk.zero_state(batch)
    else:
        h0, c0 = pk.pack_state([(_signed((batch, h), g, 0.5).to(device),
                                 _signed((batch, h), g, 0.5).to(device)) for h in pk.hidden])
    return xw0, h0, c0


def _launch(pk, xw0, h0, c0, acts, act_bits, path, widths=None):
    s = pk.stacked
    out = (torch.empty(T_LEN, h0.shape[1], pk.width_p, dtype=h0.dtype, device=h0.device),
           torch.empty_like(h0), torch.empty_like(c0))
    k1.launch("lstm_stack_wavefront", xw0, s["w_x"], s["w_h"], s["b"], h0, c0, s.get("scales"),
              *out, t_len=T_LEN, acts=acts, act_bits=act_bits, path=path, widths=widths)
    return out


@pytest.mark.parametrize("batch", [133, 4_099, 73_728])
@pytest.mark.parametrize("wd,compute,acts,act_bits", CASES)
@pytest.mark.parametrize("stack", list(STACKS))
def test_trimmed_blocked_launch_is_bitwise(cuda, stack, wd, compute, acts, act_bits, batch):
    sms = k1.sm_count(cuda.index or 0)
    assert k1.kernel_path(batch, 2, 32, sms) == ("blocked", k1.BLOCKED_ROWS)
    pk = _pack(stack, wd, compute, acts, cuda)
    widths = (pk.in_dims, pk.hidden)
    assert widths == STACKS[stack] and k1.trims(widths, pk.width_p)
    blocked = k1.KernelPath("blocked", k1.BLOCKED_ROWS)
    for zero_state in (True, False):
        xw0, h0, c0 = _operands(pk, batch, batch + len(stack) + zero_state, zero_state,
                                stack == "nominal_dec", cuda)
        assert (xw0.stride(0) == 0) == (stack == "nominal_dec")
        got = _launch(pk, xw0, h0, c0, acts, act_bits, blocked, widths)
        padded_blocked = _launch(pk, xw0, h0, c0, acts, act_bits, blocked)
        one_row = _launch(pk, xw0, h0, c0, acts, act_bits, k1.KernelPath("one_row", 1))
        s = pk.stacked
        kw = dict(scales=s.get("scales"), sigma=acts.sigma, tanh=acts.tanh,
                  act_quant=make_act_quant(act_bits) if act_bits else None)
        plain = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, **kw)
        plain_real = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, widths=widths, **kw)
        torch.cuda.synchronize()
        for want in (padded_blocked, one_row, plain, plain_real):
            for a, b in zip(got, want, strict=True):
                assert torch.equal(bits(a), bits(b)), (stack, wd, acts.name, batch, zero_state)
        del xw0, got, padded_blocked, one_row, plain, plain_real
        torch.cuda.empty_cache()


@pytest.mark.parametrize("batch", [133, 73_728])
@pytest.mark.parametrize("wd,compute,acts,act_bits", CASES)
@pytest.mark.parametrize("stack", list(STACKS))
def test_trimmed_launch_reads_no_padded_state(cuda, stack, wd, compute, acts, act_bits, batch):
    """A packed state holding +0, -0 and other values at every position,
    the padded ones too: each real position of hs, h_f and c_f has the bits
    of the padded launches and of both plain versions."""
    pk = _pack(stack, wd, compute, acts, cuda)
    xw0, _, _ = _operands(pk, batch, batch + 3 * len(stack), True, stack == "nominal_dec", cuda)
    g = torch.Generator().manual_seed(batch + len(stack))
    shape = (pk.n_layers, batch, pk.width_p)
    h0 = _signed(shape, g, 0.5).to(pk.dtype).to(cuda)
    c0 = _signed(shape, g).to(cuda)
    blocked = k1.KernelPath("blocked", k1.BLOCKED_ROWS)
    got = _launch(pk, xw0, h0, c0, acts, act_bits, blocked, pk.widths)
    s = pk.stacked
    kw = dict(scales=s.get("scales"), sigma=acts.sigma, tanh=acts.tanh,
              act_quant=make_act_quant(act_bits) if act_bits else None)
    wants = (_launch(pk, xw0, h0, c0, acts, act_bits, blocked),
             _launch(pk, xw0, h0, c0, acts, act_bits, k1.KernelPath("one_row", 1)),
             lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, **kw),
             lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, widths=pk.widths, **kw))
    torch.cuda.synchronize()
    last = pk.hidden[-1]
    for want in wants:
        assert torch.equal(bits(got[0][..., :last]), bits(want[0][..., :last])), (stack, wd)
        for l, h in enumerate(pk.hidden):
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(bits(a[l, :, :h]), bits(b[l, :, :h])), (stack, wd, l)
    del xw0, h0, c0, got, wants
    torch.cuda.empty_cache()


def test_row_blocked_kernels_do_not_spill(cuda):
    """ptxas's report: both row-blocked instantiations of each of the five
    dtype pairs (the layers' own widths and the padded geometry) keep their
    weights in registers within the two-CTA bound (128), with no stack
    frame and no spills."""
    blocked = re.compile(r"lstm_stack_kernel(<.*, 32, 8, (true|false)>|I.*Li32ELi8ELb[01]E)")
    report = [k for k in ptxas_report(k1.library().log) if blocked.search(k["kernel"])]
    assert len(report) == 5 * 2, [k["kernel"] for k in report]
    for k in report:
        assert k["registers"] <= 128, k
        assert (k["stack_frame"], k["spill_stores"], k["spill_loads"]) == (0, 0, 0), k


def _score_counts(eng, x):
    lstm_stack.launches = lstm_stack.trimmed_launches = 0
    lstm_stack.launches_by_path.clear()
    scores = eng.score(x)
    return scores, (lstm_stack.launches, dict(lstm_stack.launches_by_path),
                    lstm_stack.trimmed_launches)


def test_trimmed_launches_count_and_scores_keep_their_bits(cuda, monkeypatch):
    """A gw_nominal batch score trims both segments' launches and gives every
    window the padded launches' score; a gw_small one (W=9, one row a
    thread, no padding) trims none."""
    from repro_torch.serve.engine import AnomalyStreamEngine

    sms = k1.sm_count(cuda.index or 0)
    cfg = GW_MODELS["gw_nominal"]
    eng = AnomalyStreamEngine(init_autoencoder(cfg, seed=6, device=cuda), cfg, impl="fused_stack")
    x = np.random.RandomState(2).randn(2 * sms * k1.BLOCKED_ROWS + 3, cfg.timesteps, 1)
    scores, counts = _score_counts(eng, x.astype(np.float32))
    assert counts == (2, {"blocked": 2}, 2)
    monkeypatch.setattr(k1, "trims", lambda widths, width: False)
    padded, counts = _score_counts(eng, x.astype(np.float32))
    assert counts == (2, {"blocked": 2}, 0)
    np.testing.assert_array_equal(scores, padded)
    monkeypatch.undo()

    small = GW_MODELS["gw_small"]
    eng = AnomalyStreamEngine(init_autoencoder(small, seed=7, device=cuda), small,
                              impl="fused_stack")
    x = np.random.RandomState(3).randn(k1.row_thread_threshold(sms) + 3, small.timesteps, 1)
    _, counts = _score_counts(eng, x.astype(np.float32))
    assert counts == (2, {"row_thread": 2}, 0)


def test_an_sm_holds_three_trimmed_ctas(cuda):
    """At either gw_nominal segment's widths a row-blocked CTA is 160 threads
    where the padded one is 256: an SM holds three where it held two, for
    every storage and compute dtype.  Widths off the row-blocked path, or
    outside [1, W], have no kernel."""
    lib = k1.library().lib
    blocked, rows = k1.PATH_CODES["blocked"], k1.BLOCKED_ROWS
    for compute, code in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2)):
        assert lib.lstm_stack_ctas_per_sm(2, 32, rows, blocked, compute, code, None) == 2
        for widths in (STACKS["nominal_enc"], STACKS["nominal_dec"]):
            arg = k1.widths_arg(widths, 2, 32)
            assert lib.lstm_stack_ctas_per_sm(2, 32, rows, blocked, compute, code, arg) == 3
            assert lib.lstm_stack_ctas_per_sm(2, 32, 1, k1.PATH_CODES["one_row"], compute,
                                              code, arg) == -1
        for bad in ([1, 32, 32, 0], [1, 33, 32, 8]):
            arg = (ctypes.c_int * 4)(*bad)
            assert lib.lstm_stack_ctas_per_sm(2, 32, rows, blocked, compute, code, arg) == -1
