"""K1's launch path, on the CPU: which launches ``kernel_path`` runs
row-blocked (several batch rows carried through every thread), what
``launch`` refuses, that every path ``kernel_path`` returns passes that
check, and that the plain version counts no launch.  The row-thread side
of ``kernel_path`` is in ``test_torch_lstm_stack_row_thread.py``.

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
ONE_ROW = ("one_row", 1)
BLOCKED = ("blocked", k1.BLOCKED_ROWS)


def _packs(name):
    cfg = GW_MODELS[name]
    params = init_autoencoder(cfg, seed=0, device="cpu")
    return (pack_stack(*encoder_layers(params, cfg)), pack_stack(*decoder_layers(params, cfg)))


@pytest.mark.parametrize("n_layers,width", [(1, 9), (2, 9), (2, 16), (1, 64), (3, 32),
                                            (9, 32), (2, 128)])
@pytest.mark.parametrize("batch", [64, 4096, 73_728, 294_912])
def test_run_time_width_packs_run_one_row(n_layers, width, batch):
    """Off the register path no launch is row-blocked (W=9 takes the
    row-thread path above its threshold instead)."""
    assert not k1.weights_in_registers(n_layers, width)
    assert k1.kernel_path(batch, n_layers, width, H100_SMS).kind != "blocked"


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_small_batches_run_one_row(n_layers, sms):
    """The serving, streaming and server paths (B <= 64) never row-block."""
    for batch in range(1, 65):
        assert k1.kernel_path(batch, n_layers, 32, sms) == ONE_ROW


@pytest.mark.parametrize("n_layers,width,batch", [(2, 32, 73_728), (1, 9, 294_912)])
@pytest.mark.parametrize("block_b", [1, 2, 4, 8, 16])
def test_explicit_block_b_keeps_its_meaning(block_b, n_layers, width, batch):
    """An explicit ``block_b`` keeps one row a CTA, its rows one after
    another, at a batch that takes the row-blocked (W=32) or the row-thread
    (W=9) path without it."""
    assert k1.kernel_path(batch, n_layers, width, H100_SMS).kind != "one_row"
    assert k1.kernel_path(batch, n_layers, width, H100_SMS, block_b=block_b) == \
        ("one_row", block_b)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_the_nominal_batch_is_row_blocked(n_layers):
    assert k1.kernel_path(73_728, n_layers, 32, H100_SMS) == BLOCKED


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_one_wave_of_one_row_ctas_is_the_threshold(n_layers, sms):
    """One row a CTA up to one wave of them (and up to B=64), the row
    block from the next row on."""
    wave = max(64, sms)
    assert k1.kernel_path(wave, n_layers, 32, sms) == ONE_ROW
    assert k1.kernel_path(wave + 1, n_layers, 32, sms) == BLOCKED


def test_the_register_path_follows_the_batch():
    """One row a CTA or a compiled row block at every batch; once blocked,
    a larger batch stays blocked."""
    picks = [k1.kernel_path(b, 2, 32, H100_SMS) for b in range(1, 80_000, 97)]
    assert set(picks) == {ONE_ROW, BLOCKED}
    first = picks.index(BLOCKED)
    assert all(p == BLOCKED for p in picks[first:])


@pytest.mark.parametrize("name,batch,kind", [("gw_nominal", 73_728, "blocked"),
                                             ("gw_small", 294_912, "row_thread")])
def test_benchmark_packs(name, batch, kind):
    """gw_nominal's encoder and decoder packs (L=2, W=32) row-block at its
    cell's batch; gw_small's (W=9, run-time width) run one row a thread at
    its own."""
    for pk in _packs(name):
        got = k1.kernel_path(batch, pk.n_layers, pk.width_p, H100_SMS)
        assert got.kind == kind, (name, pk.n_layers, pk.width_p)


@pytest.mark.parametrize("w_bytes", [4, 2, 1])
def test_blocked_layout_fits_shared_memory(w_bytes):
    for n_layers in (1, 2):
        assert k1.smem_bytes(n_layers, 32, k1.BLOCKED_ROWS, w_bytes, False) <= k1.MAX_SMEM_BYTES


def test_int8_and_bf16_packs_follow_the_same_rule():
    """The rule reads the pack's shape, not its storage dtype."""
    for wd in ("int8", "bf16"):
        cfg = dataclasses.replace(GW_MODELS["gw_nominal"], weight_dtype=wd)
        params = init_autoencoder(cfg, seed=0, device="cpu")
        pk = pack_stack(*encoder_layers(params, cfg))
        assert k1.kernel_path(73_728, pk.n_layers, pk.width_p, H100_SMS) == BLOCKED
        assert k1.kernel_path(64, pk.n_layers, pk.width_p, H100_SMS) == ONE_ROW


def _operands(batch, n_layers, width, t_len=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    w4 = 4 * width
    xw0 = torch.randn(t_len, batch, w4, generator=g)
    w_x = torch.randn(n_layers, width, w4, generator=g) * width**-0.5
    w_h = torch.randn(n_layers, width, w4, generator=g) * width**-0.5
    b = torch.randn(n_layers, w4, generator=g) * 0.1
    h0 = torch.randn(n_layers, batch, width, generator=g) * 0.3
    c0 = torch.randn(n_layers, batch, width, generator=g) * 0.3
    return xw0, w_x, w_h, b, h0, c0


@pytest.mark.parametrize("n_layers,width,batch", [
    (2, 32, 1), (2, 32, 64), (2, 32, 2 * H100_SMS * k1.BLOCKED_ROWS + 3),
    (1, 9, 1), (1, 9, 64), (1, 9, k1.row_thread_threshold(H100_SMS) + 3),
])
def test_plain_path_counts_no_launch(n_layers, width, batch):
    """At batches the card runs on each path, the plain version on CPU
    tensors counts no launch and gives its own bits."""
    ops = _operands(batch, n_layers, width)
    before = (lstm_stack.launches, dict(lstm_stack.launches_by_path))
    got = lstm_stack(*ops)
    assert (lstm_stack.launches, dict(lstm_stack.launches_by_path)) == before
    for a, b in zip(got, lstm_stack_ref(*ops)):
        assert torch.equal(a, b)


def _launch(entry, path, n_layers, width):
    """``launch`` on zero CPU operands of batch 5."""
    batch, t_len = 5, 2
    w = torch.zeros(n_layers, width, 4 * width)
    h0 = c0 = torch.zeros(n_layers, batch, width)
    x = torch.zeros(t_len, batch, 4 * width)
    out = (torch.zeros(t_len, batch, width), torch.zeros_like(h0), torch.zeros_like(c0))
    k1.launch(entry, x, w, w, torch.zeros(n_layers, 4 * width), h0, c0, None, *out,
              t_len=t_len, acts=EXACT, act_bits=None, path=k1.KernelPath(*path))


@pytest.mark.parametrize("entry,path,n_layers,width", [
    ("lstm_stack_wavefront", ("blocked", 3), 2, 32),       # not a compiled row block
    ("lstm_stack_wavefront", ("blocked", 4), 2, 32),       # nor this one
    ("lstm_stack_wavefront", ("blocked", 8), 2, 9),        # run-time width
    ("lstm_stack_wavefront", ("blocked", 8), 3, 32),       # past the register path
    ("lstm_stack_step", ("blocked", 8), 2, 32),            # the step kernel has none
    ("lstm_stack_wavefront", ("row_thread", 64), 2, 32),   # the register path's width
    ("lstm_stack_wavefront", ("row_thread", 64), 1, 10),   # no instantiation at this width
    ("lstm_stack_wavefront", ("row_thread", 64), 1, 8),    # nor at gw_nominal's narrow layers'
    ("lstm_stack_wavefront", ("row_thread", 64), 2, 16),   # nor here
    ("lstm_stack_step", ("row_thread", 64), 1, 9),         # the step kernel has none
    ("lstm_stack_wavefront", ("row_thread", 48), 1, 9),    # CTAs of part of a warp
    ("lstm_stack_wavefront", ("row_thread", 0), 1, 9),
    ("lstm_stack_wavefront", ("row_thread", 160), 1, 9),   # above ROW_THREAD_MAX_ROWS
    ("lstm_stack_wavefront", ("two_rows", 2), 2, 32),      # no such path
    ("lstm_stack_wavefront", ("one_row", 0), 2, 32),       # a CTA of no rows
    ("lstm_stack_step", ("one_row", 0), 2, 32),
])
def test_launch_refuses_a_path_it_has_no_kernel_for(entry, path, n_layers, width):
    """Refused before the library is built or loaded."""
    with pytest.raises(ValueError, match="no kernel for path"):
        _launch(entry, path, n_layers, width)


class _LibraryReached(Exception):
    pass


@pytest.mark.parametrize("block_b", [None, 1, 8])
def test_every_path_kernel_path_returns_passes_the_check(block_b, monkeypatch):
    """Over batches on each side of both thresholds, L 1-4, W 8, 9, 16 and
    32 and three SM counts, ``launch`` takes the path ``kernel_path``
    returns as far as loading the library."""
    def reached():
        raise _LibraryReached

    monkeypatch.setattr(k1, "library", reached)
    kinds = set()
    for sms in (16, 114, H100_SMS):
        cut = k1.row_thread_threshold(sms)
        for batch in (1, 64, sms, sms + 1, 1_000, cut, cut + 1, 73_728, 294_912):
            for n_layers in (1, 2, 3, 4):
                for width in (8, 9, 16, 32):
                    path = k1.kernel_path(batch, n_layers, width, sms, block_b)
                    kinds.add(path.kind)
                    with pytest.raises(_LibraryReached):
                        _launch("lstm_stack_wavefront", path, n_layers, width)
    assert kinds == ({"one_row", "blocked", "row_thread"} if block_b is None else {"one_row"})
