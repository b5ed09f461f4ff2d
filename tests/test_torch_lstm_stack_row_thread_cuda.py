"""K1's row-thread path (one batch row a thread), on the card.

Held bit for bit (``torch.equal``) against the one-row launch and the plain
version at W=9 (the one row-thread width) over L in (1, 2), the five pairs
of storage and compute dtype, the three activation sets with a kernel form
and ``act_bits``: at a batch that is not a multiple of 32 (launched
row-thread by hand), at ``row_thread_threshold`` (the wrapper keeps one row
a CTA) and one above it (the wrapper takes the row-thread path); (L, W) in
(1, 8) and (2, 16) keep one row a CTA above it, with the plain version's
bits.  Also: a stream of time stride 0, rows independent of how they are
grouped, a
gw_small batch score above the threshold against the one-row path, the
library's shared-memory size and occupancy against the wrapper's, and no
spills.  Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lstm_stack_row_thread_cuda.py
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import init_autoencoder
from repro_torch.core.quant import EXACT, HARD, PAPER_HW_KERNEL, make_act_quant
from repro_torch.kernels._build import ptxas_report
from repro_torch.kernels.lstm_stack import lstm_stack
from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref

pytestmark = pytest.mark.gpu

k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
ROW_THREAD = k1.KernelPath("row_thread", k1.ROW_THREAD_ROWS)
ONE_ROW = k1.KernelPath("one_row", 1)
T_LEN = 100
SHAPES = [(1, 9), (2, 9)]
# (storage, compute, activation set, act_bits): the five dtype pairs
STORAGE = [("fp32", torch.float32, EXACT, None), ("bf16", torch.float32, PAPER_HW_KERNEL, 16),
           ("int8", torch.float32, HARD, 16), ("bf16", torch.bfloat16, EXACT, None),
           ("int8", torch.bfloat16, PAPER_HW_KERNEL, 16)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _stack(n_layers, width, batch, wd, compute, seed, device):
    """Random packed weights at storage ``wd`` (int8 codes with per-gate
    scales), biases, a non-zero state and a dense layer-0 stream."""
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
    xw0 = torch.randn(T_LEN, batch, 4 * width, generator=g)
    return [None if t is None else t.to(device) for t in (xw0, w_x, w_h, b, h0, c0, scales)]


def _launch(ops, acts, act_bits, path):
    """One wavefront launch through the wrapper's ``launch``, on the path
    forced: ``ROW_THREAD`` or ``ONE_ROW``."""
    xw0, w_x, w_h, b, h0, c0, scales = ops
    out = (torch.empty(xw0.shape[0], h0.shape[1], h0.shape[2], dtype=h0.dtype,
                       device=h0.device), torch.empty_like(h0), torch.empty_like(c0))
    k1.launch("lstm_stack_wavefront", xw0, w_x, w_h, b, h0, c0, scales, *out,
              t_len=xw0.shape[0], acts=acts, act_bits=act_bits, path=path)
    return out


def _plain(ops, acts, act_bits):
    xw0, w_x, w_h, b, h0, c0, scales = ops
    return lstm_stack_ref(xw0, w_x, w_h, b, h0, c0, scales=scales, sigma=acts.sigma,
                          tanh=acts.tanh,
                          act_quant=make_act_quant(act_bits) if act_bits else None)


def _wrapper(ops, acts, act_bits):
    xw0, w_x, w_h, b, h0, c0, scales = ops
    return lstm_stack(xw0, w_x, w_h, b, h0, c0, scales=scales, acts=acts, act_bits=act_bits)


def _assert_equal(got, *wants, what):
    torch.cuda.synchronize()
    for want in wants:
        for a, b in zip(got, want):
            assert torch.equal(a, b), what


@pytest.mark.parametrize("wd,compute,acts,act_bits", STORAGE)
@pytest.mark.parametrize("n_layers,width", SHAPES)
def test_row_thread_is_bitwise(cuda, n_layers, width, wd, compute, acts, act_bits):
    """hs, h_f and c_f of the row-thread launch equal the one-row launch's
    and the plain version's at B = 37 (two warps, the second with 5 rows),
    at the threshold and one above, where the wrapper picks each path."""
    sms = k1.sm_count(cuda.index or 0)
    cut = k1.row_thread_threshold(sms)
    for batch in (37, cut, cut + 1):
        ops = _stack(n_layers, width, batch, wd, compute, 1000 * width + batch + n_layers, cuda)
        by_thread = _launch(ops, acts, act_bits, ROW_THREAD)
        one = _launch(ops, acts, act_bits, ONE_ROW)
        _assert_equal(by_thread, one, _plain(ops, acts, act_bits), what=(batch, wd))
        if batch >= cut:
            before = (lstm_stack.launches, lstm_stack.launches_by_path["row_thread"])
            wrapped = _wrapper(ops, acts, act_bits)
            counts = (lstm_stack.launches - before[0],
                      lstm_stack.launches_by_path["row_thread"] - before[1])
            assert counts == (1, int(batch > cut)), batch
            _assert_equal(wrapped, by_thread, what=(batch, wd))


@pytest.mark.parametrize("cta_rows", [32, k1.ROW_THREAD_MAX_ROWS])
def test_cta_size_leaves_the_bits(cuda, cta_rows):
    """CTAs of 32 or 128 rows give the bits of the wrapper's 64."""
    batch = k1.row_thread_threshold(k1.sm_count(cuda.index or 0)) + 45
    ops = _stack(2, 9, batch, "int8", torch.float32, 11 + cta_rows, cuda)
    xw0, w_x, w_h, b, h0, c0, scales = ops
    out = (torch.empty(T_LEN, batch, 9, device=cuda), torch.empty_like(h0),
           torch.empty_like(c0))
    k1.launch("lstm_stack_wavefront", xw0, w_x, w_h, b, h0, c0, scales, *out, t_len=T_LEN,
              acts=HARD, act_bits=16, path=k1.KernelPath("row_thread", cta_rows))
    _assert_equal(out, _launch(ops, HARD, 16, ROW_THREAD), what=cta_rows)


@pytest.mark.parametrize("wd,compute,acts,act_bits", STORAGE)
@pytest.mark.parametrize("n_layers,width", [(1, 8), (2, 16)])
def test_other_narrow_widths_keep_one_row_a_cta(cuda, n_layers, width, wd, compute, acts,
                                                act_bits):
    """Above the threshold a width without a row-thread instantiation runs
    one row a CTA, with the plain version's bits."""
    batch = k1.row_thread_threshold(k1.sm_count(cuda.index or 0)) + 1
    ops = _stack(n_layers, width, batch, wd, compute, 10 * width + n_layers, cuda)
    before = (lstm_stack.launches, lstm_stack.launches_by_path["row_thread"])
    got = _wrapper(ops, acts, act_bits)
    assert (lstm_stack.launches - before[0],
            lstm_stack.launches_by_path["row_thread"] - before[1]) == (1, 0)
    _assert_equal(got, _plain(ops, acts, act_bits), what=(width, wd))


@pytest.mark.parametrize("wd,compute,acts,act_bits", [STORAGE[0], STORAGE[2], STORAGE[4]])
@pytest.mark.parametrize("n_layers,width", [(1, 9), (2, 9)])
def test_row_thread_on_a_repeated_stream(cuda, n_layers, width, wd, compute, acts, act_bits):
    """A stream of time stride 0 (the decoder's repeated latent) is staged
    once and gives the materialised copy's bits."""
    batch = k1.row_thread_threshold(k1.sm_count(cuda.index or 0)) + 29
    ops = _stack(n_layers, width, batch, wd, compute, 7 * width + n_layers, cuda)
    rep = ops[0][:1].expand(T_LEN, batch, 4 * width)
    assert k1.repeated_stream(rep)
    before = (lstm_stack.launches_by_path["row_thread"], lstm_stack.repeated_input_launches)
    got = _wrapper([rep] + ops[1:], acts, act_bits)
    assert (lstm_stack.launches_by_path["row_thread"] - before[0],
            lstm_stack.repeated_input_launches - before[1]) == (1, 1)
    dense = [rep.contiguous()] + ops[1:]
    _assert_equal(got, _launch(dense, acts, act_bits, ONE_ROW), _plain(dense, acts, act_bits),
                  what=wd)


def test_rows_are_independent_of_grouping(cuda):
    """Rows of a batch the wrapper runs one row a thread equal the same
    rows run alone, one row a thread and one row a CTA."""
    batch = k1.row_thread_threshold(k1.sm_count(cuda.index or 0)) + 70
    ops = _stack(2, 9, batch, "fp32", torch.float32, 3, cuda)
    whole = _wrapper(ops, PAPER_HW_KERNEL, 16)
    for i in (0, 31, 32, batch // 2, batch - 1):
        xw0, w_x, w_h, b, h0, c0, scales = ops
        alone = [xw0[:, i : i + 1].contiguous(), w_x, w_h, b, h0[:, i : i + 1].contiguous(),
                 c0[:, i : i + 1].contiguous(), scales]
        part = [whole[0][:, i : i + 1], whole[1][:, i : i + 1], whole[2][:, i : i + 1]]
        for path in (ROW_THREAD, ONE_ROW):
            _assert_equal(_launch(alone, PAPER_HW_KERNEL, 16, path), part, what=(i, path))


@pytest.mark.parametrize("weight_dtype", ["fp32", "int8"])
def test_gw_small_batch_score_takes_it_with_the_same_bits(cuda, weight_dtype, monkeypatch):
    """A gw_small batch score above the threshold launches K1 one row a
    thread twice (encoder and decoder), and every score equals the one-row
    path's."""
    import dataclasses

    from repro_torch.serve.engine import AnomalyStreamEngine

    cfg = dataclasses.replace(GW_MODELS["gw_small"], weight_dtype=weight_dtype)
    eng = AnomalyStreamEngine(init_autoencoder(cfg, seed=6, device=cuda), cfg,
                              impl="fused_stack")
    batch = k1.row_thread_threshold(k1.sm_count(cuda.index or 0)) + 101
    x = np.random.RandomState(2).randn(batch, cfg.timesteps, 1).astype(np.float32)
    eng.score(x[:64])
    before = (lstm_stack.launches, lstm_stack.launches_by_path["row_thread"])
    got = eng.score(x)
    assert (lstm_stack.launches - before[0],
            lstm_stack.launches_by_path["row_thread"] - before[1]) == (2, 2)
    monkeypatch.setattr(k1, "kernel_path", lambda *args, **kwargs: ONE_ROW)
    before = lstm_stack.launches_by_path["row_thread"]
    want = eng.score(x)
    assert lstm_stack.launches_by_path["row_thread"] == before
    np.testing.assert_array_equal(got, want)


def test_library_layout_and_occupancy(cuda):
    """The library's shared-memory size of a row-thread CTA is the
    wrapper's twin's; every dtype pair has an instantiation at each width
    of ``ROW_THREAD_WIDTHS`` that an SM holds; other widths, a CTA that is
    not whole warps or more than 128 rows have none."""
    lib = k1.library().lib
    code = k1.PATH_CODES["row_thread"]
    for n_layers in (1, 2, 3, 9):
        for width in (8, 9, 16, 32):
            for rows in (32, 64, 128, 256):
                assert (lib.lstm_stack_row_thread_smem_bytes(n_layers, width, rows)
                        == k1.row_thread_smem_bytes(n_layers, width, rows))
    for compute, wd in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2)):
        for width in k1.ROW_THREAD_WIDTHS:
            for n_layers in (1, 2):
                assert lib.lstm_stack_ctas_per_sm(n_layers, width, k1.ROW_THREAD_ROWS, code,
                                                  compute, wd, None) >= 1
            assert lib.lstm_stack_ctas_per_sm(1, width, 48, code, compute, wd, None) == -1
            assert lib.lstm_stack_ctas_per_sm(1, width, 256, code, compute, wd, None) == -1
        for width in (8, 10, 16, 32):
            assert lib.lstm_stack_ctas_per_sm(1, width, k1.ROW_THREAD_ROWS, code,
                                              compute, wd, None) == -1


def test_row_thread_kernels_do_not_spill(cuda):
    """ptxas's report: every row-thread instantiation keeps its row's
    state and sums in registers (no stack frame, no spills)."""
    report = [k for k in ptxas_report(k1.library().log)
              if "lstm_stack_kernel_row_thread" in k["kernel"]]
    # five dtype pairs, three activation sets
    assert len(report) == 5 * 3 * len(k1.ROW_THREAD_WIDTHS)
    for k in report:
        assert (k["stack_frame"], k["spill_stores"], k["spill_loads"]) == (0, 0, 0), k
