"""K1's row-thread path, on the CPU: which wavefront launches ``kernel_path``
runs one batch row a thread, the layouts it relies on and how the library
is built.  What ``launch`` refuses and the plain version's counts are in
``test_torch_lstm_stack_rows.py``.

The row-thread kernel itself runs only on the card
(``tests/test_torch_lstm_stack_row_thread_cuda.py``, ``-m gpu``), where it
is held bit for bit against the one-row launch and the plain version.
"""

import sys

import pytest

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
from repro_torch.kernels.lstm_stack import lstm_stack  # noqa: F401  (binds the module)
from repro_torch.kernels.lstm_stack.ops import pack_stack

# the module, not the function the package re-exports under its name
k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]

H100_SMS = 132
ROW_THREAD = ("row_thread", k1.ROW_THREAD_ROWS)


def _packs(name, weight_dtype="fp32"):
    cfg = GW_MODELS[name]
    params = init_autoencoder(cfg, seed=0, device="cpu")
    return [pack_stack(*layers(params, cfg), weight_dtype=weight_dtype)
            for layers in (encoder_layers, decoder_layers)]


def _row_thread(batch, n_layers, width, sms):
    return k1.kernel_path(batch, n_layers, width, sms).kind == "row_thread"


@pytest.mark.parametrize("weight_dtype", ["fp32", "bf16", "int8"])
def test_gw_small_takes_the_row_thread_path_at_its_cell(weight_dtype):
    """Both of gw_small's packs (L=1, W=9) run one row a thread, in CTAs of
    ``ROW_THREAD_ROWS`` rows, at the benchmark's 294,912 windows, whatever
    the storage dtype."""
    for pk in _packs("gw_small", weight_dtype):
        assert (pk.n_layers, pk.width_p) == (1, 9)
        assert k1.kernel_path(294_912, pk.n_layers, pk.width_p, H100_SMS) == ROW_THREAD


@pytest.mark.parametrize("batch", [1, 64, 4096, 73_728, 294_912])
def test_gw_nominal_never_takes_it(batch):
    """gw_nominal's packs (L=2, W=32) are on the register path."""
    for pk in _packs("gw_nominal"):
        assert k1.weights_in_registers(pk.n_layers, pk.width_p)
        assert not _row_thread(batch, pk.n_layers, pk.width_p, H100_SMS)


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers,width", [(1, 8), (1, 9), (2, 9), (2, 16), (4, 8)])
def test_batches_of_64_or_fewer_never_take_it(n_layers, width, sms):
    """The streaming decode, the server, the sharded stages and ``mixed``
    at B <= 64 keep one row a CTA."""
    for batch in range(1, 65):
        assert k1.kernel_path(batch, n_layers, width, sms) == ("one_row", 1)


@pytest.mark.parametrize("n_layers,width", [(1, 8), (2, 16), (1, 7), (1, 10), (2, 12),
                                            (1, 17), (2, 32), (3, 32), (1, 64), (2, 128)])
def test_widths_without_an_instantiation_never_take_it(n_layers, width):
    """Only gw_small's width is instantiated: every other narrow width
    (gw_nominal's 8-wide layers on the ``mixed`` path among them) keeps one
    row a CTA, or the register path's row block, at any batch."""
    assert width not in k1.ROW_THREAD_WIDTHS
    assert not _row_thread(294_912, n_layers, width, H100_SMS)


@pytest.mark.parametrize("sms", [16, 114, H100_SMS])
@pytest.mark.parametrize("n_layers,width", [(1, 9), (2, 9), (4, 9)])
def test_once_a_batch_takes_it_every_larger_batch_does(n_layers, width, sms):
    picks = [_row_thread(b, n_layers, width, sms) for b in range(1, 300_000, 89)]
    assert set(picks) == {False, True}
    first = picks.index(True)
    assert all(picks[first:])


def test_the_threshold_is_the_first_row_past_it():
    for sms in (16, 114, H100_SMS):
        cut = k1.row_thread_threshold(sms)
        assert cut >= 64
        assert k1.kernel_path(cut, 1, 9, sms) == ("one_row", 1)
        assert k1.kernel_path(cut + 1, 1, 9, sms) == ROW_THREAD


def test_packs_too_deep_for_shared_memory_never_take_it():
    deep = next(n for n in range(1, 500)
                if k1.row_thread_smem_bytes(n, 9) > k1.MAX_SMEM_BYTES)
    assert k1.kernel_path(294_912, deep - 1, 9, H100_SMS) == ROW_THREAD
    assert k1.kernel_path(294_912, deep, 9, H100_SMS) == ("one_row", 1)


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


def test_the_kernel_library_builds_split_and_is_keyed_on_it():
    """K1's source compiles on every CPU at once (``--split-compile``), and
    the split build is keyed apart from a plain one."""
    from repro_torch.kernels import _build

    assert _build.source_digest(k1.SOURCE, split=True) != _build.source_digest(k1.SOURCE)
    assert "--split-compile=0" in _build._flags((), split=True)
    assert "--split-compile=0" not in _build._flags(())
