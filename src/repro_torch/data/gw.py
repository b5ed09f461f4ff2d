"""Synthetic gravitational-wave data generation (paper Sec. V-A, offline).

The paper builds its dataset with GGWD/PyCBC: colored Gaussian noise at a
target power spectral density (detector background) plus simulated compact-
binary-coalescence chirps (SEOBNRv4), then whitens, band-passes and
normalizes.  Those packages are not available offline, so this module
implements the same pipeline from first principles:

  * ``colored_noise``  — Gaussian noise shaped to an aLIGO-like analytic
    PSD (power-law seismic wall + flat thermal floor + f^2 shot rise).
  * ``inspiral_chirp`` — leading-order (Newtonian, quadrupole) inspiral:
    f(t) grows as (t_c - t)^(-3/8), amplitude as f^(2/3), Hann-tapered.
    This is the analytic stand-in for the SEOBNRv4 approximant.
  * ``whiten``         — divide by the amplitude spectral density in the
    frequency domain (estimated from a noise ensemble, as real pipelines
    estimate it from off-source data).
  * ``bandpass``       — hard FFT mask (paper band-passes after whitening).
  * windows of ``timesteps`` consecutive full-rate samples ending at
    the merger time, normalized by a dataset-global background scale.

Everything is numpy (host-side data pipeline), deterministic per seed, and
fast enough to generate the paper-scale 240k-event training sets on the fly.
This is a copy of the reference's module: a seed gives arrays equal to the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GwDataConfig:
    sample_rate: float = 2048.0   # Hz
    segment_seconds: float = 1.0
    timesteps: int = 100          # model window (paper default TS)
    # Model windows are ``timesteps`` CONSECUTIVE full-rate samples ending
    # at the merger, so the band can span the paper-like range (35-350 Hz
    # scaled to what ~50 ms windows resolve).
    f_low: float = 30.0
    f_high: float = 200.0
    snr_range: tuple[float, float] = (5.0, 15.0)
    seed: int = 0

    @property
    def n_samples(self) -> int:
        return int(self.sample_rate * self.segment_seconds)


def analytic_psd(freqs: np.ndarray) -> np.ndarray:
    """aLIGO-like analytic one-sided PSD (arbitrary overall scale).

    Seismic wall below ~20 Hz, suspension ~ f^-4, flat floor around
    100-200 Hz, shot-noise rise ~ f^2 above.  The wall is clamped at 20 Hz
    (dynamic range ~1e4 in power) the way real pipelines high-pass the
    strain before processing — an unclamped f^-14 wall exceeds float32
    dynamic range and numerically erases the in-band content.
    """
    f = np.maximum(np.abs(freqs), 20.0)
    x = f / 215.0
    wall = 1e4 * (20.0 / f) ** 14
    psd = wall + 0.6 * x**-4 + 1.0 + x**2
    return psd


def colored_noise(rng: np.ndarray, n: int, sample_rate: float) -> np.ndarray:
    """Gaussian noise with the analytic detector PSD."""
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    asd = np.sqrt(analytic_psd(freqs))
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white) * asd
    out = np.fft.irfft(spec, n)
    return (out / out.std()).astype(np.float32)


def inspiral_chirp(
    n: int, sample_rate: float, f0: float = 35.0, f1: float = 300.0,
    t_frac: float = 0.75, duration: int = 120,
) -> np.ndarray:
    """Leading-order inspiral chirp ending at ``t_frac`` of the segment.

    Newtonian chirp: f(t) = f0 * (1 - t/tc)^(-3/8), h ~ f^(2/3) cos(phi(t)),
    active over the last ``duration`` samples before the merger — a heavy-
    binary event whose in-band sweep is tens of ms (GW150914-class), so the
    model's ``timesteps`` window captures essentially all of the energy.
    """
    t_c_idx = int(t_frac * n)
    start = max(t_c_idx - duration, 0)
    local = np.arange(duration) / duration          # 0 .. 1 over the sweep
    tau = np.maximum(1.0 - local, 1e-3)
    freq = np.minimum(f0 * tau ** (-3.0 / 8.0), f1)
    phase = 2 * np.pi * np.cumsum(freq) / sample_rate
    amp = (freq / f0) ** (2.0 / 3.0)
    ramp = np.minimum(local / 0.2, 1.0)             # taper the start
    h = np.zeros(n, np.float32)
    h[start:t_c_idx] = (amp * np.cos(phase) * ramp)[: t_c_idx - start]
    return h.astype(np.float32)


class GwDataset:
    """Deterministic synthetic LIGO-like stream segments.

    ``background(n)`` -> (n, timesteps, 1) noise-only windows (training data
    for the unsupervised autoencoder); ``events(n, signal=True)`` -> windows
    with injected chirps at random SNR (test positives).
    """

    def __init__(self, cfg: GwDataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        # estimate the whitening ASD from an off-source noise ensemble
        ens = np.stack(
            [colored_noise(self._rng, cfg.n_samples, cfg.sample_rate)
             for _ in range(64)]
        )
        spec = np.fft.rfft(ens, axis=-1)
        self._asd = np.sqrt(np.mean(np.abs(spec) ** 2, axis=0))
        self._asd = np.maximum(self._asd, 1e-3 * self._asd.max())
        freqs = np.fft.rfftfreq(cfg.n_samples, 1.0 / cfg.sample_rate)
        self._band = (freqs >= cfg.f_low) & (freqs <= cfg.f_high)
        # dataset-global normalization scale from the background ensemble
        w_ens = np.fft.irfft(spec / self._asd * self._band, cfg.n_samples, axis=-1)
        self._global_std = float(w_ens.std() + 1e-12)
        # unit chirp template + its whitened norm (matched-filter SNR calib)
        self._chirp = inspiral_chirp(
            cfg.n_samples, cfg.sample_rate, f0=cfg.f_low, f1=cfg.f_high
        )
        wc = np.fft.irfft(
            np.fft.rfft(self._chirp) / self._asd * self._band, cfg.n_samples
        )
        self._chirp_wnorm = float(np.sqrt(np.sum(wc**2)) + 1e-12)

    # ------------------------------------------------------------------
    def _whiten_bandpass(self, x: np.ndarray) -> np.ndarray:
        """Whiten + band-pass, then normalize by a GLOBAL background scale.

        Normalization must be dataset-global (paper: 'whitened and band-
        passed, then normalized'), NOT per-segment: per-segment scaling
        erases the amplitude excess that makes events reconstruct badly —
        the loss-spike signal the detector thresholds on.
        """
        spec = np.fft.rfft(x, axis=-1) / self._asd
        spec = spec * self._band
        out = np.fft.irfft(spec, self.cfg.n_samples, axis=-1)
        return (out / self._global_std).astype(np.float32)

    def _window(self, x: np.ndarray) -> np.ndarray:
        """Cut (timesteps,) of CONSECUTIVE full-rate samples ending at the
        merger time — the paper's windows are full-rate strain around the
        loud part of the event, not a decimated summary (averaging 2048
        samples down to 100 throws away ~95% of the signal energy while
        leaving the per-sample noise power unchanged)."""
        ts = self.cfg.timesteps
        end = int(0.75 * self.cfg.n_samples)  # merger time (chirp t_frac)
        return x[..., end - ts:end, None].astype(np.float32)

    # ------------------------------------------------------------------
    def batch(self, n: int, signal: bool) -> np.ndarray:
        """(n, timesteps, 1) whitened, band-passed, normalized windows."""
        cfg = self.cfg
        xs = np.stack(
            [colored_noise(self._rng, cfg.n_samples, cfg.sample_rate)
             for _ in range(n)]
        )
        if signal:
            # scale so the whitened matched-filter SNR equals the draw:
            # after global normalization the whitened noise is ~unit
            # variance per sample, so snr = ||whiten(scale*chirp)/std|| =
            # scale * ||wc|| / global_std
            snrs = self._rng.uniform(*cfg.snr_range, size=(n, 1))
            scale = snrs * self._global_std / self._chirp_wnorm
            xs = xs + scale * self._chirp[None, :]
        return self._window(self._whiten_bandpass(xs))

    def background(self, n: int) -> np.ndarray:
        return self.batch(n, signal=False)

    def events(self, n: int) -> np.ndarray:
        return self.batch(n, signal=True)

    def train_stream(self, batch_size: int):
        """Endless generator of background batches (unsupervised training)."""
        while True:
            yield self.background(batch_size)
