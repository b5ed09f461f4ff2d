"""The yardstick's pieces on the CPU: the frozen cost arithmetic, the frozen
data generator, the plain reference (held against the program's plain
path, which it must agree with), TF32 rounding and the trace reduction."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gwbench import costs, gwdata, tracing
from gwbench.harness import load_json, load_manifest, load_module

REF = load_module("references", "lstm_autoencoder")
NOMINAL = load_json("configs", "gw_nominal")
SMALL = load_json("configs", "gw_small")
TRAFFIC = load_json("traffic", load_manifest()["workloads"][0]["traffic"])


@pytest.mark.parametrize("layers,width,batch", [(1, 32, 64), (2, 32, 4096), (4, 8, 7)])
def test_stack_costs_equal_the_programs_count_at_one_width(layers, width, batch):
    from repro_torch.autotune.model import stack_kernel_costs

    want = stack_kernel_costs(layers, width, batch, 100, step=False)
    assert costs.stack_costs([(width, width)] * layers, batch, 100) == want


def test_layer_dims_and_products():
    assert costs.layer_dims(NOMINAL) == [(1, 32), (32, 8), (8, 8), (8, 32)]
    assert costs.layer_dims(SMALL) == [(1, 9), (9, 9)]
    enc, dec = costs.segments(NOMINAL)
    assert enc == [(1, 32), (32, 8)] and dec == [(8, 8), (8, 32)]
    products = costs.score_products(NOMINAL, 4096)
    rows = 4096 * 100
    assert products[0] == {"flops": 2.0 * rows * 128, "bytes": 4.0 * (rows + 128 + rows * 128)}
    assert products[3] == {"flops": 2.0 * 4096 * 100, "bytes": 4.0 * (4096 * 100 + 100 + 4096)}
    assert costs.bound_s({"flops": 67e12, "bytes": 0.0}) == pytest.approx(1.0)
    assert costs.bound_s({"flops": 0.0, "bytes": 3.35e12}) == pytest.approx(1.0)


def test_forward_flops_count_every_product_once():
    t_len = NOMINAL["timesteps"]
    gates = sum(2 * t_len * 4 * h * (i + h) for i, h in costs.layer_dims(NOMINAL))
    flops = costs.forward_flops_per_window(NOMINAL)
    assert gates < flops < 1.2 * gates


def test_colored_noise_and_chirp_follow_the_programs_pipeline():
    from repro_torch.data import gw as program_gw

    freqs = np.fft.rfftfreq(2048, 1 / 2048.0)
    np.testing.assert_allclose(gwdata.analytic_psd(torch.from_numpy(freqs)).numpy(),
                               program_gw.analytic_psd(freqs), rtol=1e-12)
    np.testing.assert_array_equal(gwdata.inspiral_chirp(2048, 2048.0, 30.0, 200.0),
                                  program_gw.inspiral_chirp(2048, 2048.0, f0=30.0, f1=200.0))
    # the same white noise through both colourings
    gen = torch.Generator().manual_seed(4)
    source = gwdata.StrainSource(TRAFFIC, 100, gen)
    white = np.random.default_rng(5).standard_normal(2048)

    class Fixed:
        def standard_normal(self, n):
            return white

    want = program_gw.colored_noise(Fixed(), 2048, 2048.0)
    out = torch.fft.irfft(torch.fft.rfft(torch.from_numpy(white)) * source._color, 2048)
    got = (out / out.std(correction=0)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_windows_are_seeded_whitened_and_carry_chirps():
    def make(seed):
        return gwdata.StrainSource(TRAFFIC, 100, torch.Generator().manual_seed(seed))

    a = make(1).windows(64, 0.5)
    assert a.shape == (64, 100, 1) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, make(1).windows(64, 0.5), rtol=0, atol=0)
    assert not torch.equal(a, make(2).windows(64, 0.5))
    noise = make(3).windows(256, 0.0)
    assert 0.5 < float(noise.std()) < 2.0
    loud = make(3).windows(256, 1.0)
    # a matched-filter SNR of 5-15 over 100 samples adds about one unit of power
    assert float((loud ** 2).mean()) > 1.5 * float((noise ** 2).mean())


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    got = REF.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0])
    assert torch.equal(got, want)  # ties to even, both ways
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    r = REF.round_tf32(y)
    assert torch.equal(REF.round_tf32(r), r)
    assert float(((r - y) / y).abs().max()) <= 2 ** -11


def _program_params(params):
    return {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}


@pytest.mark.parametrize("config", [NOMINAL, SMALL], ids=["gw_nominal", "gw_small"])
def test_reference_scores_equal_the_programs_plain_path(config):
    from repro_torch.serve.engine import AnomalyStreamEngine

    from gwbench.gwprogram import autoencoder_config

    gen = torch.Generator().manual_seed(7)
    params = REF.init_params(config, gen)
    x = gwdata.StrainSource(TRAFFIC, 100, gen).windows(16, 0.25)
    engine = AnomalyStreamEngine(_program_params(params), autoencoder_config(config),
                                 device="cpu")
    got = engine.score(x.numpy())
    want = REF.scores_in_blocks(params, x, config).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    control = REF.scores_in_blocks(params, x, config, tf32=True).numpy()
    assert np.abs(control / want - 1).max() > 1e-5


def test_union_of_intervals():
    assert tracing.union_s([]) == 0.0
    assert tracing.union_s([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == pytest.approx(3.0)
    assert tracing.union_s([(3.0, 4.0), (0.0, 5.0)]) == pytest.approx(5.0)
    assert math.isclose(tracing.union_s([(1.0, 1.0)]), 0.0)
