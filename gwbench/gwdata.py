"""Strain windows from the seed: a frozen copy of the program's GW data
pipeline (``data/gw.py``, paper Sec. V-A), made on the device.

The same steps as the program's ``GwDataset``: Gaussian noise coloured by
an aLIGO-like analytic PSD over one-second segments; leading-order
inspiral chirps injected at a matched-filter SNR drawn from a range;
whitening by an ASD estimated from a 64-segment off-source ensemble; a
hard band-pass; a dataset-global scale; the window of ``timesteps``
consecutive samples ending at the merger.  Only the random draws differ:
they come from a ``torch.Generator`` in bulk, so a pool of tens of
thousands of windows is made on the card in a few calls, and a seed gives
the same windows on every run on one kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: segments whitened per pass (bounds the device memory a pass takes)
CHUNK = 8192
#: off-source segments the whitening ASD and the global scale are taken from
ENSEMBLE = 64
#: the merger's place in a segment (the chirp ends there, the window too)
T_FRAC = 0.75


def analytic_psd(freqs: torch.Tensor) -> torch.Tensor:
    """aLIGO-like one-sided PSD: a seismic wall clamped at 20 Hz, a
    suspension term, a flat floor and a shot-noise rise."""
    f = torch.clamp(freqs.abs(), min=20.0)
    x = f / 215.0
    return 1e4 * (20.0 / f) ** 14 + 0.6 * x ** -4 + 1.0 + x ** 2


def inspiral_chirp(n: int, sample_rate: float, f0: float, f1: float,
                   duration: int = 120) -> np.ndarray:
    """Newtonian inspiral ending at ``T_FRAC`` of the segment: f grows as
    (1 - t/tc)^(-3/8) up to ``f1``, amplitude as f^(2/3), the first fifth
    tapered, over the last ``duration`` samples before the merger."""
    t_c = int(T_FRAC * n)
    start = max(t_c - duration, 0)
    local = np.arange(duration) / duration
    tau = np.maximum(1.0 - local, 1e-3)
    freq = np.minimum(f0 * tau ** (-3.0 / 8.0), f1)
    phase = 2 * np.pi * np.cumsum(freq) / sample_rate
    amp = (freq / f0) ** (2.0 / 3.0)
    ramp = np.minimum(local / 0.2, 1.0)
    h = np.zeros(n, np.float32)
    h[start:t_c] = (amp * np.cos(phase) * ramp)[: t_c - start]
    return h


class StrainSource:
    """Whitened, band-passed, normalised windows (n, timesteps, 1) fp32,
    drawn from ``generator`` on its device.  ``traffic`` holds
    ``sample_rate``, ``segment_seconds``, ``f_low``, ``f_high`` and
    ``snr_range``."""

    def __init__(self, traffic: dict, timesteps: int, generator: torch.Generator):
        self.gen, self.device = generator, generator.device
        self.t_len = timesteps
        self.rate = float(traffic["sample_rate"])
        self.n = int(self.rate * traffic["segment_seconds"])
        self.snr = tuple(traffic["snr_range"])
        freqs = torch.fft.rfftfreq(self.n, 1.0 / self.rate, dtype=torch.float64,
                                   device=self.device)
        self._color = torch.sqrt(analytic_psd(freqs))
        spec = torch.fft.rfft(self._colored(ENSEMBLE), dim=-1)
        asd = torch.sqrt(torch.mean(spec.abs() ** 2, dim=0))
        self._asd = torch.clamp(asd, min=1e-3 * asd.max().item())
        self._band = ((freqs >= traffic["f_low"]) & (freqs <= traffic["f_high"])).double()
        w_ens = torch.fft.irfft(spec / self._asd * self._band, self.n, dim=-1)
        self._global_std = w_ens.std(correction=0).item() + 1e-12
        chirp = inspiral_chirp(self.n, self.rate, traffic["f_low"], traffic["f_high"])
        self._chirp = torch.from_numpy(chirp).double().to(self.device)
        wc = torch.fft.irfft(torch.fft.rfft(self._chirp) / self._asd * self._band, self.n)
        self._chirp_wnorm = math.sqrt(float(torch.sum(wc ** 2))) + 1e-12

    def _colored(self, count: int) -> torch.Tensor:
        white = torch.randn(count, self.n, generator=self.gen, dtype=torch.float64,
                            device=self.device)
        out = torch.fft.irfft(torch.fft.rfft(white, dim=-1) * self._color, self.n, dim=-1)
        # the program rounds each noise segment to fp32 before whitening
        return (out / out.std(dim=-1, correction=0, keepdim=True)).float().double()

    def windows(self, count: int, signal_fraction: float = 0.0) -> torch.Tensor:
        """``count`` windows; ``round(count * signal_fraction)`` of them,
        at places drawn from the seed, hold a chirp."""
        n_signal = round(count * signal_fraction)
        snrs = torch.zeros(count, dtype=torch.float64, device=self.device)
        if n_signal:
            where = torch.randperm(count, generator=self.gen, device=self.device)[:n_signal]
            lo, hi = self.snr
            draw = torch.rand(n_signal, generator=self.gen, dtype=torch.float64,
                              device=self.device)
            snrs[where] = lo + (hi - lo) * draw
        end = int(T_FRAC * self.n)
        out = torch.empty(count, self.t_len, 1, dtype=torch.float32, device=self.device)
        for a in range(0, count, CHUNK):
            b = min(a + CHUNK, count)
            xs = self._colored(b - a)
            scale = snrs[a:b, None] * self._global_std / self._chirp_wnorm
            xs = xs + scale * self._chirp
            spec = torch.fft.rfft(xs, dim=-1) / self._asd * self._band
            white = torch.fft.irfft(spec, self.n, dim=-1) / self._global_std
            out[a:b, :, 0] = white[:, end - self.t_len:end].float()
        return out
