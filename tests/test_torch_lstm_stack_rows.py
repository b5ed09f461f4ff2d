"""K1's row blocking, on the CPU: which launches carry several batch rows
through every thread (``rows_per_thread``), what the wrapper refuses, and
that the plain version counts no launch.

The row-blocked kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``-m gpu``), where it is held bit for bit
against the one-row launch and the plain version.
"""

import dataclasses
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


def _packs(name):
    cfg = GW_MODELS[name]
    params = init_autoencoder(cfg, seed=0, device="cpu")
    return (pack_stack(*encoder_layers(params, cfg)), pack_stack(*decoder_layers(params, cfg)))


@pytest.mark.parametrize("n_layers,width", [(1, 9), (2, 9), (2, 16), (1, 64), (3, 32),
                                            (9, 32), (2, 128)])
@pytest.mark.parametrize("batch", [64, 4096, 73_728, 294_912])
def test_run_time_width_packs_run_one_row(n_layers, width, batch):
    assert not k1.weights_in_registers(n_layers, width)
    assert k1.rows_per_thread(batch, n_layers, width, H100_SMS) == 1


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_small_batches_run_one_row(n_layers, sms):
    """The serving, streaming and server paths (B <= 64) never row-block."""
    for batch in range(1, 65):
        assert k1.rows_per_thread(batch, n_layers, 32, sms) == 1


@pytest.mark.parametrize("block_b", [1, 2, 4, 8, 16])
def test_explicit_block_b_keeps_its_meaning(block_b):
    assert k1.rows_per_thread(73_728, 2, 32, H100_SMS, block_b=block_b) == 1


@pytest.mark.parametrize("n_layers", [1, 2])
def test_the_nominal_batch_is_row_blocked(n_layers):
    assert k1.rows_per_thread(73_728, n_layers, 32, H100_SMS) == k1.BLOCKED_ROWS


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_one_wave_of_one_row_ctas_is_the_threshold(n_layers, sms):
    """One row a CTA up to one wave of them (and up to B=64), the row
    block from the next row on."""
    wave = max(64, sms)
    assert k1.rows_per_thread(wave, n_layers, 32, sms) == 1
    assert k1.rows_per_thread(wave + 1, n_layers, 32, sms) == k1.BLOCKED_ROWS


def test_rows_per_thread_follows_the_batch():
    """One or a compiled row block at every batch; once blocked, a larger
    batch stays blocked."""
    picks = [k1.rows_per_thread(b, 2, 32, H100_SMS) for b in range(1, 80_000, 97)]
    assert set(picks) == {1, k1.BLOCKED_ROWS}
    first = next(i for i, r in enumerate(picks) if r > 1)
    assert all(r > 1 for r in picks[first:])


@pytest.mark.parametrize("name,batch,blocked", [("gw_nominal", 73_728, True),
                                                ("gw_small", 294_912, False)])
def test_benchmark_packs(name, batch, blocked):
    """gw_nominal's encoder and decoder packs (L=2, W=32) row-block at its
    cell's batch; gw_small's (W=9, run-time width) do not at its own."""
    for pk in _packs(name):
        rows = k1.rows_per_thread(batch, pk.n_layers, pk.width_p, H100_SMS)
        assert (rows > 1) == blocked, (name, pk.n_layers, pk.width_p)


@pytest.mark.parametrize("w_bytes", [4, 2, 1])
def test_blocked_layout_fits_shared_memory(w_bytes):
    for n_layers in (1, 2):
        assert k1.smem_bytes(n_layers, 32, k1.BLOCKED_ROWS, w_bytes, False) <= k1.MAX_SMEM_BYTES


def _operands(batch, t_len=3, seed=0):
    pk = _packs("gw_nominal")[0]
    s = pk.stacked
    g = torch.Generator().manual_seed(seed)
    xw0 = torch.randn(t_len, batch, 4 * pk.width_p, generator=g)
    h0 = torch.randn(pk.n_layers, batch, pk.width_p, generator=g) * 0.3
    c0 = torch.randn(pk.n_layers, batch, pk.width_p, generator=g) * 0.3
    return xw0, s["w_x"], s["w_h"], s["b"], h0, c0


@pytest.mark.parametrize("batch", [1, 64, 2 * H100_SMS * k1.BLOCKED_ROWS + 3])
def test_plain_path_counts_no_launch(batch):
    ops = _operands(batch)
    launches, blocked = lstm_stack.launches, lstm_stack.blocked_launches
    got = lstm_stack(*ops)
    assert (lstm_stack.launches, lstm_stack.blocked_launches) == (launches, blocked)
    for a, b in zip(got, lstm_stack_ref(*ops)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry,rows,block_b,n_layers,width", [
    ("lstm_stack_wavefront", 3, None, 2, 32),   # not a compiled row block
    ("lstm_stack_wavefront", 4, None, 2, 32),   # nor this one
    ("lstm_stack_wavefront", 8, 2, 2, 32),      # with an explicit block_b
    ("lstm_stack_wavefront", 8, None, 2, 9),    # run-time width
    ("lstm_stack_wavefront", 8, None, 3, 32),   # past the register path
    ("lstm_stack_step", 8, None, 2, 32),        # the step kernel has none
])
def test_launch_refuses_a_row_block_it_has_no_kernel_for(entry, rows, block_b, n_layers, width):
    """Refused before the library is built or loaded."""
    batch, t_len = 5, 2
    w = torch.zeros(n_layers, width, 4 * width)
    h0 = c0 = torch.zeros(n_layers, batch, width)
    x = torch.zeros(t_len, batch, 4 * width)
    out = (torch.zeros(t_len, batch, width), torch.zeros_like(h0), torch.zeros_like(c0))
    with pytest.raises(ValueError, match="no row-blocked kernel"):
        k1.launch(entry, x, w, w, torch.zeros(n_layers, 4 * width), h0, c0, None, *out,
                  t_len=t_len, acts=EXACT, act_bits=None, block_b=block_b,
                  rows_per_thread=rows)


def test_int8_and_bf16_packs_follow_the_same_rule():
    """The rule reads the pack's shape, not its storage dtype."""
    for wd in ("int8", "bf16"):
        cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
        params = init_autoencoder(cfg, seed=0, device="cpu")
        pk = pack_stack(*encoder_layers(params, cfg))
        assert k1.rows_per_thread(73_728, pk.n_layers, pk.width_p, H100_SMS) == k1.BLOCKED_ROWS
        assert k1.rows_per_thread(64, pk.n_layers, pk.width_p, H100_SMS) == 1
