"""K1's row-thread path, on the CPU: which wavefront launches run one batch
row a thread (``row_thread``), what the wrapper refuses, and that the plain
version counts no launch.

The row-thread kernel itself runs only on the card
(``tests/test_torch_lstm_stack_row_thread_cuda.py``, ``-m gpu``), where it
is held bit for bit against the one-row launch and the plain version.
"""

import sys

import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
from repro_torch.core.quant import EXACT
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_ref
from repro_torch.kernels.lstm_stack.ops import pack_stack

# the module, not the function the package re-exports under its name
k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]

H100_SMS = 132


def _packs(name, weight_dtype="fp32"):
    cfg = GW_MODELS[name]
    params = init_autoencoder(cfg, seed=0, device="cpu")
    return [pack_stack(*layers(params, cfg), weight_dtype=weight_dtype)
            for layers in (encoder_layers, decoder_layers)]


@pytest.mark.parametrize("weight_dtype", ["fp32", "bf16", "int8"])
def test_gw_small_takes_the_row_thread_path_at_its_cell(weight_dtype):
    """Both of gw_small's packs (L=1, W=9) run one row a thread at the
    benchmark's 294,912 windows, whatever the storage dtype."""
    for pk in _packs("gw_small", weight_dtype):
        assert (pk.n_layers, pk.width_p) == (1, 9)
        assert k1.row_thread(294_912, pk.n_layers, pk.width_p, H100_SMS)
        assert k1.rows_per_thread(294_912, pk.n_layers, pk.width_p, H100_SMS) == 1


@pytest.mark.parametrize("batch", [1, 64, 4096, 73_728, 294_912])
def test_gw_nominal_never_takes_it(batch):
    """gw_nominal's packs (L=2, W=32) are on the register path."""
    for pk in _packs("gw_nominal"):
        assert k1.weights_in_registers(pk.n_layers, pk.width_p)
        assert not k1.row_thread(batch, pk.n_layers, pk.width_p, H100_SMS)


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers,width", [(1, 8), (1, 9), (2, 9), (2, 16), (4, 8)])
def test_batches_of_64_or_fewer_never_take_it(n_layers, width, sms):
    """The streaming decode, the server, the sharded stages and ``mixed``
    at B <= 64 keep one row a CTA."""
    for batch in range(1, 65):
        assert not k1.row_thread(batch, n_layers, width, sms)


@pytest.mark.parametrize("block_b", [1, 2, 4, 8, 16])
def test_an_explicit_block_b_keeps_its_meaning(block_b):
    assert not k1.row_thread(294_912, 1, 9, H100_SMS, block_b=block_b)
    assert k1.row_thread(294_912, 1, 9, H100_SMS)


@pytest.mark.parametrize("n_layers,width", [(1, 8), (2, 16), (1, 7), (1, 10), (2, 12),
                                            (1, 17), (2, 32), (3, 32), (1, 64), (2, 128)])
def test_widths_without_an_instantiation_never_take_it(n_layers, width):
    """Only gw_small's width is instantiated: every other narrow width
    (gw_nominal's 8-wide layers on the ``mixed`` path among them) keeps one
    row a CTA at any batch."""
    assert width not in k1.ROW_THREAD_WIDTHS
    assert not k1.row_thread(294_912, n_layers, width, H100_SMS)


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers,width", [(1, 9), (2, 9), (4, 9)])
def test_once_a_batch_takes_it_every_larger_batch_does(n_layers, width, sms):
    picks = [k1.row_thread(b, n_layers, width, sms) for b in range(1, 300_000, 89)]
    assert set(picks) == {False, True}
    first = picks.index(True)
    assert all(picks[first:])


def test_the_threshold_is_the_first_row_past_it():
    for sms in (16, 114, H100_SMS):
        cut = k1.row_thread_threshold(sms)
        assert cut >= 64
        assert not k1.row_thread(cut, 1, 9, sms)
        assert k1.row_thread(cut + 1, 1, 9, sms)


def test_packs_too_deep_for_shared_memory_never_take_it():
    deep = next(n for n in range(1, 500)
                if k1.row_thread_smem_bytes(n, 9) > k1.MAX_SMEM_BYTES)
    assert k1.row_thread(294_912, deep - 1, 9, H100_SMS)
    assert not k1.row_thread(294_912, deep, 9, H100_SMS)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_gw_small_layouts_fit_shared_memory(n_layers):
    """gw_small's packs (L=1) and two-layer packs at W=9, with the CTAs of
    the sweep (32, 64 and 128 rows)."""
    for rows in (32, 64, 128):
        assert k1.row_thread_smem_bytes(n_layers, 9, rows) <= k1.MAX_SMEM_BYTES


def test_threshold_is_24_rows_an_sm():
    """The crossover of the sweep on the H100: 3,168 rows on 132 SMs."""
    assert k1.row_thread_threshold(H100_SMS) == 3_168
    assert k1.row_thread_threshold(1) == 64


def _operands(batch, n_layers=1, width=9, t_len=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    w4 = 4 * width
    xw0 = torch.randn(t_len, batch, w4, generator=g)
    w_x = torch.randn(n_layers, width, w4, generator=g) * width**-0.5
    w_h = torch.randn(n_layers, width, w4, generator=g) * width**-0.5
    b = torch.randn(n_layers, w4, generator=g) * 0.1
    h0 = torch.randn(n_layers, batch, width, generator=g) * 0.3
    c0 = torch.randn(n_layers, batch, width, generator=g) * 0.3
    return xw0, w_x, w_h, b, h0, c0


@pytest.mark.parametrize("batch", [1, 64, k1.row_thread_threshold(H100_SMS) + 3])
def test_plain_path_counts_no_launch(batch):
    ops = _operands(batch)
    before = (lstm_stack.launches, lstm_stack.row_thread_launches)
    got = lstm_stack(*ops)
    assert (lstm_stack.launches, lstm_stack.row_thread_launches) == before
    for a, b in zip(got, lstm_stack_ref(*ops)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry,width,n_layers,block_b,rows,cta_rows", [
    ("lstm_stack_wavefront", 32, 2, None, 1, 64),   # the register path's width
    ("lstm_stack_wavefront", 10, 1, None, 1, 64),   # no instantiation at this width
    ("lstm_stack_wavefront", 8, 1, None, 1, 64),    # nor at gw_nominal's narrow layers'
    ("lstm_stack_wavefront", 16, 2, None, 1, 64),   # nor here
    ("lstm_stack_wavefront", 9, 1, 2, 1, 64),       # with an explicit block_b
    ("lstm_stack_step", 9, 1, None, 1, 64),         # the step kernel has none
    ("lstm_stack_wavefront", 9, 1, None, 1, 48),    # CTAs of part of a warp
    ("lstm_stack_wavefront", 9, 1, None, 1, 0),
    ("lstm_stack_wavefront", 9, 1, None, 1, 160),   # above ROW_THREAD_MAX_ROWS
])
def test_launch_refuses_a_row_thread_shape_it_has_no_kernel_for(entry, width, n_layers,
                                                                 block_b, rows, cta_rows):
    """Refused before the library is built or loaded."""
    batch, t_len = 5, 2
    w = torch.zeros(n_layers, width, 4 * width)
    h0 = c0 = torch.zeros(n_layers, batch, width)
    x = torch.zeros(t_len, batch, 4 * width)
    out = (torch.zeros(t_len, batch, width), torch.zeros_like(h0), torch.zeros_like(c0))
    with pytest.raises(ValueError, match="no row-thread kernel"):
        k1.launch(entry, x, w, w, torch.zeros(n_layers, 4 * width), h0, c0, None, *out,
                  t_len=t_len, acts=EXACT, act_bits=None, block_b=block_b,
                  rows_per_thread=rows, row_thread_rows=cta_rows)


def test_launch_refuses_row_blocking_and_row_threads_at_once():
    batch, t_len, width = 5, 2, 32
    w = torch.zeros(2, width, 4 * width)
    h0 = c0 = torch.zeros(2, batch, width)
    out = (torch.zeros(t_len, batch, width), torch.zeros_like(h0), torch.zeros_like(c0))
    with pytest.raises(ValueError, match="no row-blocked kernel"):
        k1.launch("lstm_stack_wavefront", torch.zeros(t_len, batch, 4 * width), w, w,
                  torch.zeros(2, 4 * width), h0, c0, None, *out, t_len=t_len, acts=EXACT,
                  act_bits=None, block_b=None, rows_per_thread=k1.BLOCKED_ROWS,
                  row_thread_rows=k1.ROW_THREAD_ROWS)


def test_the_kernel_library_builds_split_and_is_keyed_on_it():
    """K1's source compiles on every CPU at once (``--split-compile``), and
    the split build is keyed apart from a plain one."""
    from repro_torch.kernels import _build

    assert _build.source_digest(k1.SOURCE, split=True) != _build.source_digest(k1.SOURCE)
    assert "--split-compile=0" in _build._flags((), split=True)
    assert "--split-compile=0" not in _build._flags(())
