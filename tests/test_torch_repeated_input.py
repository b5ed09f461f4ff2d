"""Layer 0's input repeated over time, kept a view down to the wavefront
kernel, on the CPU.

The decoder's input is its latent repeated over the window (RepeatVector:
``latent[:, None, :].expand(B, T, h)``, time stride 0).  ``pad_input``
pads its one (B, 1, h) slice and expands it again; ``project_layer0``
projects the one (B, W) block and returns the (T, B, 4W) gate stream as a
view of time stride 0; the wavefront kernel (and its plain version) reads
that view in place.  Every operation on every value is the one the
materialised input gets, so the bits do not change:

* ``project_layer0`` of a repeat equals ``project_layer0`` of its
  ``.contiguous()`` copy, for fp32, bf16-compute and int8 packs, and comes
  back with a time stride of 0;
* ``reconstruction_error`` through ``fused_stack``, ``fused_step``,
  ``mixed`` and the sharded CPU stages equals the path that materialises
  the repeat (``repeats_over_time`` forced to False), and the decoder's
  wavefront call is handed a stream of time stride 0;
* a ``pad_input`` of an input that does not repeat comes back contiguous;
* ``repeated_stream``, the wrapper's test for reading a stream in place,
  takes only an aligned repeat of contiguous rows.

The kernel side runs only on the card (``tests/test_torch_repeated_input_cuda.py``).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core import autoencoder as tae
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_ref, ops
from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0

# the module, not the function the package re-exports under its name
k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]

T_LEN = 12
PACKS = {
    "fp32": dict(weight_dtype="fp32"),
    "bf16": dict(weight_dtype="bf16", dtype=torch.bfloat16),
    "int8": dict(weight_dtype="int8"),
}


def _cfg(name, **kw):
    return dataclasses.replace(GW_MODELS[name], **kw)


def _decoder_pack(name, pack):
    cfg = _cfg(name, **PACKS[pack])
    params = tae.init_autoencoder(cfg, seed=1, device="cpu")
    return pack_stack(*tae.decoder_layers(params, cfg))


def _repeat(batch, width, t_len=T_LEN, seed=0):
    latent = torch.rand(batch, width, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    return latent[:, None, :].expand(batch, t_len, width)


@pytest.mark.parametrize("name", ["gw_nominal", "gw_small"])
@pytest.mark.parametrize("pack", list(PACKS))
def test_project_layer0_of_a_repeat_is_the_materialised_projection(name, pack):
    pk = _decoder_pack(name, pack)
    xs = pk.pad_input(_repeat(5, pk.in_dims[0]))
    assert ops.repeats_over_time(xs)
    got = project_layer0(xs, pk.stacked, pk.weight_dtype)
    want = project_layer0(xs.contiguous(), pk.stacked, pk.weight_dtype)
    assert got.shape == want.shape == (T_LEN, 5, 4 * pk.width_p)
    assert got.stride(0) == 0 and want.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["gw_nominal", "gw_small"])
@pytest.mark.parametrize("pack", list(PACKS))
def test_pad_input_keeps_a_repeat_a_view(name, pack):
    pk = _decoder_pack(name, pack)
    x = _repeat(4, pk.in_dims[0])
    got = pk.pad_input(x)
    assert got.shape == (4, T_LEN, pk.width_p) and got.stride(1) == 0
    assert got.dtype == pk.dtype
    assert torch.equal(got, pk.pad_input(x.contiguous()))


@pytest.mark.parametrize("name", ["gw_nominal", "gw_small"])
def test_pad_input_of_an_input_that_does_not_repeat_is_contiguous(name):
    pk = _decoder_pack(name, "fp32")
    g = torch.Generator().manual_seed(2)
    wide = torch.randn(3, T_LEN + 2, pk.in_dims[0] + 1, generator=g)
    for x in (wide[:, :T_LEN, : pk.in_dims[0]].contiguous(),
              wide[:, 2:, : pk.in_dims[0]],             # a sliced view
              _repeat(3, pk.in_dims[0], t_len=1)):      # one step repeats nothing
        assert not ops.repeats_over_time(x)
        got = pk.pad_input(x)
        assert got.is_contiguous()
        assert torch.equal(got[..., : pk.in_dims[0]], x)
        assert not got[..., pk.in_dims[0]:].any()


def test_a_one_step_input_projects_as_before():
    pk = _decoder_pack("gw_nominal", "fp32")
    xs = pk.pad_input(_repeat(3, pk.in_dims[0], t_len=1))
    got = project_layer0(xs, pk.stacked, pk.weight_dtype)
    assert got.shape == (1, 3, 4 * pk.width_p) and got.is_contiguous()


@pytest.mark.parametrize("pack", list(PACKS))
def test_the_plain_wavefront_reads_a_repeated_stream(pack):
    """The CPU twin of the kernel takes the view of time stride 0 as it is,
    and counts no launch."""
    pk = _decoder_pack("gw_nominal", pack)
    s = pk.stacked
    xw0 = project_layer0(pk.pad_input(_repeat(4, pk.in_dims[0])), s, pk.weight_dtype)
    assert xw0.stride(0) == 0
    h0, c0 = pk.zero_state(4)
    counts = (lstm_stack.launches, dict(lstm_stack.launches_by_path),
              lstm_stack.repeated_input_launches)
    scales = s.get("scales")
    got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, scales=scales)
    want = lstm_stack_ref(xw0.contiguous(), s["w_x"], s["w_h"], s["b"], h0, c0,
                          scales=scales)
    assert counts == (lstm_stack.launches, dict(lstm_stack.launches_by_path),
                      lstm_stack.repeated_input_launches)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _aligned(shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(3))


def test_repeated_stream_takes_only_an_aligned_repeat_of_contiguous_rows():
    t_len, batch, w4 = 6, 5, 36
    block = _aligned((1, batch, w4))
    assert block.data_ptr() % 16 == 0
    assert k1.repeated_stream(block.expand(t_len, batch, w4))
    assert k1.repeated_stream(_aligned((batch, w4)).expand(t_len, batch, w4))
    # a dense stream, a one-step repeat, an offset block, transposed rows
    assert not k1.repeated_stream(_aligned((t_len, batch, w4)))
    assert not k1.repeated_stream(block.expand(1, batch, w4))
    flat = _aligned((batch * w4 + 1,))
    offset = flat[1:].view(1, batch, w4)
    assert offset.data_ptr() % 16 != 0
    assert not k1.repeated_stream(offset.expand(t_len, batch, w4))
    rows_t = _aligned((w4, batch)).t()[None]
    assert not k1.repeated_stream(rows_t.expand(t_len, batch, w4))
    assert not k1.repeated_stream(_aligned((batch, t_len, w4)).transpose(0, 1))


# ---------------------------------------------------------------------------
# whole scores through every backend that reaches the decoder's stream
# ---------------------------------------------------------------------------

def _windows(batch, seed=4):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(batch, T_LEN, 1).astype(np.float32))


BACKENDS = {
    "fused_stack": dict(impl="fused_stack"),
    "fused_step": dict(impl="fused_step"),
    "mixed": dict(impl="mixed", cfg=dict(weight_dtypes=("int8", "fp32", "fp32", "int8"))),
    "sharded": dict(impl="fused_stack", placement="sharded", mesh=("cpu", "cpu")),
    "sharded_int8": dict(impl="fused_stack", placement="sharded", mesh=("cpu", "cpu"),
                         cfg=dict(weight_dtype="int8")),
}


def _score(cfg, params, x, kw):
    enc, dec = tae.segment_executors(params, cfg, impl=kw["impl"],
                                     placement=kw.get("placement", "local"),
                                     mesh=kw.get("mesh"))
    with torch.no_grad():
        return tae.reconstruction_error(params, x, cfg, exec_enc=enc, exec_dec=dec)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_scores_equal_the_materialised_path(backend, monkeypatch):
    """Bit for bit, against the decoder fed a contiguous copy of the
    repeated latent; the decoder's wavefront call reads a stream of time
    stride 0 (the encoder's, and a sharded stage's inner hand-off, are
    dense)."""
    kw = BACKENDS[backend]
    cfg = _cfg("gw_nominal", **kw.get("cfg", {}))
    params = tae.init_autoencoder(cfg, seed=2, device="cpu")
    x = _windows(3)
    strides = []
    plain = k1.lstm_stack_ref

    def recording(xw0, *args, **kwargs):
        strides.append(xw0.stride(0))
        return plain(xw0, *args, **kwargs)

    monkeypatch.setattr(k1, "lstm_stack_ref", recording)
    got = _score(cfg, params, x, kw)
    repeated = strides.count(0)
    assert repeated >= 1, strides
    strides.clear()
    monkeypatch.setattr(ops, "repeats_over_time", lambda xs: False)
    want = _score(cfg, params, x, kw)
    assert strides and 0 not in strides
    assert got.shape == (3,)
    assert torch.equal(got, want)
