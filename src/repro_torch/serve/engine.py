"""Serving engines: batched scoring and stateful streaming.

* ``AnomalyStreamEngine``: one-shot batch scoring: strain windows scored by
  autoencoder reconstruction error against a calibrated threshold
  (FPR-targeted, like the paper's loss-spike flagging).
* ``StreamingAnomalyEngine``: the paper's deployment unit: strain arrives
  as a stream of small chunks at batch 1 (or a few parallel streams).
  Per-stream LSTM ``(h, c)`` state stays resident on the device across
  calls and weights are packed once at engine init.

Streaming state lifecycle (``StreamingAnomalyEngine``):

    push(chunk) -> encoder (h, c) advances
    ... window fills up (cfg.timesteps samples) ...
    window complete -> latent -> decode + head -> score; encoder state
    resets to zero (default, matches one-shot window scoring) or carries
    on (``carry_state=True``, the continuous-stream mode)

The kernels return fresh state tensors on every push; nothing a caller
holds is ever overwritten in place.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.autoencoder import (
    AutoencoderConfig,
    decoder_layers,
    encoder_layers,
    reconstruction_error,
    reconstruction_error_from_latent,
    segment_executors,
)
from repro_torch.core.backends import get_backend, resolve_impl
from repro_torch.device import resolve_device

logger = logging.getLogger(__name__)


def _params_to(params: dict, device: torch.device) -> dict:
    """The params tree on ``device`` (tensors already there are kept as
    they are, so the pack cache's identity keys stay valid)."""
    return {k: (_params_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _windows(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


@dataclass
class AnomalyStreamEngine:
    """Score strain windows; flag anomalies above an FPR-calibrated threshold."""

    params: dict
    cfg: AutoencoderConfig
    threshold: float = float("inf")
    #: inference backend; None keeps cfg.impl.  Serving defaults to the
    #: fused wavefront stack (one kernel launch per segment).  The upgrade is
    #: declined when cfg.acts has no kernel form; the backend actually run
    #: is ``effective_impl`` (the fallback is logged).
    impl: str | None = "fused_stack"
    device: str = "cuda"
    #: backend the engine actually runs (set in __post_init__)
    effective_impl: str = field(init=False, default="")
    #: non-None iff the requested impl was declined (the logged reason)
    fallback_reason: str | None = field(init=False, default=None)

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self.params = _params_to(self.params, self._device)
        self.cfg, self.effective_impl, self.fallback_reason = resolve_impl(
            self.cfg, self.impl
        )
        if self.fallback_reason is not None:
            logger.warning("AnomalyStreamEngine: %s", self.fallback_reason)
        # plan + bind eagerly: an illegal impl/weight_dtype combination raises
        # at construction, not on the first score()
        self._execs()

    def _execs(self):
        """The current params' bound segment executors (plans memoised,
        packs identity-cached; re-binds if params were swapped)."""
        return segment_executors(self.params, self.cfg, impl=self.effective_impl)

    def calibrate(self, background: np.ndarray, fpr: float = 0.01) -> float:
        """Set the anomaly threshold at a target false-positive rate on
        background (noise-only) windows."""
        self.threshold = float(np.quantile(self.score(background), 1.0 - fpr))
        return self.threshold

    def score(self, windows: np.ndarray) -> np.ndarray:
        exec_enc, exec_dec = self._execs()
        with torch.no_grad():
            scores = reconstruction_error(
                self.params, _windows(windows, self._device), self.cfg,
                exec_enc=exec_enc, exec_dec=exec_dec,
            )
        return scores.cpu().numpy()

    def flag(self, windows: np.ndarray) -> np.ndarray:
        return self.score(windows) > self.threshold


@dataclass
class _StreamSlot:
    """One named stream's resident state in the ``push_many`` pool: its
    encoder state at B=1, the chunks of its partial window, the fill."""

    state: object
    chunks: list = field(default_factory=list)
    filled: int = 0


class StreamingAnomalyEngine:
    """Persistent-state chunked scoring: the paper's continuous-stream mode.

    Strain chunks of any length (down to single samples) arrive via
    ``push``; the encoder's per-layer ``(h, c)`` advances without
    re-scoring earlier samples.  Every ``window`` accumulated samples the
    engine emits one anomaly score, equal to scoring that window one-shot to
    fp tolerance.

    By default the engine plans ``impl="fused_step"``: chunks up to the
    plan's ``chunk_len`` run the step kernel, longer pushes and the T-long
    decoder the wavefront kernel, both on the same packed weights.

    ``push_many(stream_ids, chunks)`` keeps a pool of named B=1 streams at
    independent window fill levels and advances any subset with one
    gathered B=N step: bit-equal to sequential single-stream pushes on the
    card, because the kernels compute each row independently of the batch.
    """

    def __init__(self, params: dict, cfg: AutoencoderConfig, *, batch: int = 1,
                 window: int | None = None, impl: str | None = "fused_step",
                 chunk_len: int | None = None, carry_state: bool = False,
                 threshold: float = float("inf"), device: str = "cuda"):
        self.device = resolve_device(device)
        self.cfg, self.effective_impl, self.fallback_reason = resolve_impl(cfg, impl)
        if self.fallback_reason is not None:
            logger.warning("StreamingAnomalyEngine: %s", self.fallback_reason)
        if self.cfg.boundary < 1:
            raise ValueError("streaming engine needs >= 1 encoder layer")
        if (chunk_len is not None and self.fallback_reason is not None
                and not get_backend(self.effective_impl).chunked_step):
            # the impl request already fell back (logged); the chunk_len that
            # came with it falls back the same way instead of crashing
            logger.warning(
                "StreamingAnomalyEngine: ignoring chunk_len=%d: resolved "
                "impl=%r has no chunked-step capability", chunk_len,
                self.effective_impl,
            )
            chunk_len = None
        self.batch = batch
        self.window = int(window or self.cfg.timesteps)
        self.carry_state = carry_state
        self.threshold = threshold
        self._params = _params_to(params, self.device)
        self._exec_enc, self._exec_dec = segment_executors(
            self._params, self.cfg, impl=self.effective_impl, chunk_len=chunk_len
        )
        self._packed_layout = (
            self._exec_enc.plan.backend.state_layout == "packed"
        )
        self.reset()

    # -- state lifecycle -----------------------------------------------------

    def reset(self) -> None:
        """Zero the encoder state, drop any partial window, and clear the
        named-stream pool (``push_many``)."""
        self._state = self._exec_enc.zero_state(self.batch)
        self._chunks: list[np.ndarray] = []
        self._filled = 0
        self._streams: dict = {}

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        # a bare ``engine.params = new`` must never leave the engine scoring
        # with a new dense head and stale packed LSTM stacks
        self.update_params(params)

    def update_params(self, params: dict) -> None:
        """Swap params on a live engine: re-bind each segment executor
        (evicting the superseded packs) and reset stream state."""
        self._params = _params_to(params, self.device)
        self._exec_enc = self._exec_enc.update_params(
            encoder_layers(self._params, self.cfg)[0])
        self._exec_dec = self._exec_dec.update_params(
            decoder_layers(self._params, self.cfg)[0])
        self.reset()

    @property
    def filled(self) -> int:
        """Samples accumulated toward the current window."""
        return self._filled

    # -- streaming -----------------------------------------------------------

    def push(self, chunk: np.ndarray) -> list[np.ndarray]:
        """Advance every stream by ``chunk``: (B, t, input_dim), any t >= 1.

        Returns one (B,) score array per window completed during this push
        (empty while a window is still filling).  Chunks may span window
        boundaries; they are split internally.
        """
        chunk = np.asarray(chunk, dtype=np.float32)
        if (chunk.ndim != 3 or chunk.shape[0] != self.batch
                or chunk.shape[2] != self.cfg.input_dim):
            raise ValueError(
                f"chunk must be (batch={self.batch}, t, {self.cfg.input_dim}), "
                f"got {chunk.shape}"
            )
        scores: list[np.ndarray] = []
        pos = 0
        while pos < chunk.shape[1]:
            take = min(chunk.shape[1] - pos, self.window - self._filled)
            # copy: the caller may reuse its buffer; the piece is held until
            # the window completes
            piece = np.array(chunk[:, pos : pos + take])
            with torch.no_grad():
                self._state = self._exec_enc.step(
                    torch.as_tensor(piece, device=self.device), self._state)
            self._chunks.append(piece)
            self._filled += take
            pos += take
            if self._filled == self.window:
                scores.append(self._finish(self._state, self._chunks))
                self._chunks, self._filled = [], 0
                if not self.carry_state:
                    self._state = self._exec_enc.zero_state(self.batch)
        return scores

    def _finish(self, state, chunks: list[np.ndarray]) -> np.ndarray:
        """Score a completed window from its encoder state: latent ->
        decode + head -> MSE against the window's samples."""
        x = torch.as_tensor(np.concatenate(chunks, axis=1), device=self.device)
        with torch.no_grad():
            scores = reconstruction_error_from_latent(
                self._params, self._exec_enc.last_hidden(state), x, self.cfg,
                exec_dec=self._exec_dec,
            )
        return scores.cpu().numpy()

    # -- multi-stream coalescing ---------------------------------------------

    @property
    def stream_ids(self) -> tuple:
        """Streams currently resident in the ``push_many`` pool."""
        return tuple(self._streams)

    def drop_stream(self, stream_id) -> None:
        """Release one named stream's state and partial window."""
        self._streams.pop(stream_id, None)

    def _gather(self, states: list):
        """N B=1 native states -> one B=N state (batch axis 1 of the packed
        (L, B, W) pair, axis 0 of per-layer (B, H) tensors)."""
        if self._packed_layout:
            return tuple(torch.cat(parts, dim=1) for parts in zip(*states))
        return [tuple(torch.cat(parts, dim=0) for parts in zip(*layer))
                for layer in zip(*states)]

    def _scatter(self, state, n: int) -> list:
        if self._packed_layout:
            return [tuple(t[:, i : i + 1] for t in state) for i in range(n)]
        return [[tuple(t[i : i + 1] for t in layer) for layer in state]
                for i in range(n)]

    def push_many(self, stream_ids, chunks: np.ndarray) -> dict:
        """Advance N independent B=1 streams with one coalesced step call.

        ``chunks``: (N, t, input_dim), row i belonging to ``stream_ids[i]``.
        The N streams' states are concatenated along the batch axis, advanced
        by one kernel launch per piece, and split back.  Streams are created
        on first use and may sit at different window fill levels: the chunk
        is split at every stream's window boundary.  A stream that completes
        a window is scored on its own, exactly as ``push`` scores it, so the
        pool is bit-equal to sequential single-stream pushes.

        Returns ``{stream_id: [scores...]}`` with one ``(1,)`` score array per
        window the stream completed.  Requires ``batch == 1``.
        """
        if self.batch != 1:
            raise ValueError(
                "push_many coalesces independent B=1 streams; construct the "
                f"engine with batch=1 (got batch={self.batch})"
            )
        ids = list(stream_ids)
        if len(set(ids)) != len(ids):
            raise ValueError("push_many: duplicate stream ids in one call")
        chunks = np.asarray(chunks, dtype=np.float32)
        if (chunks.ndim != 3 or chunks.shape[0] != len(ids)
                or chunks.shape[2] != self.cfg.input_dim):
            raise ValueError(
                f"chunks must be (n_streams={len(ids)}, t, {self.cfg.input_dim}), "
                f"got {chunks.shape}"
            )
        slots = []
        for sid in ids:
            if sid not in self._streams:
                self._streams[sid] = _StreamSlot(state=self._exec_enc.zero_state(1))
            slots.append(self._streams[sid])
        out: dict = {sid: [] for sid in ids}
        pos, t_total = 0, chunks.shape[1]
        while pos < t_total:
            take = min(t_total - pos, min(self.window - s.filled for s in slots))
            piece = np.array(chunks[:, pos : pos + take])
            with torch.no_grad():
                new = self._exec_enc.step(
                    torch.as_tensor(piece, device=self.device),
                    self._gather([s.state for s in slots]))
            for i, (slot, state) in enumerate(zip(slots, self._scatter(new, len(slots)))):
                slot.state = state
                slot.chunks.append(piece[i : i + 1])
                slot.filled += take
            pos += take
            for sid, slot in zip(ids, slots):
                if slot.filled == self.window:
                    out[sid].append(self._finish(slot.state, slot.chunks))
                    slot.chunks, slot.filled = [], 0
                    if not self.carry_state:
                        slot.state = self._exec_enc.zero_state(1)
        return out

    # -- batch path (calibration / offline) ----------------------------------

    def score(self, windows: np.ndarray) -> np.ndarray:
        """One-shot batch scoring on the same bound executors (does not touch
        stream state); equals chunked scoring to fp tolerance."""
        with torch.no_grad():
            scores = reconstruction_error(
                self._params, _windows(windows, self.device), self.cfg,
                exec_enc=self._exec_enc, exec_dec=self._exec_dec,
            )
        return scores.cpu().numpy()

    def flag(self, windows: np.ndarray) -> np.ndarray:
        return self.score(windows) > self.threshold

    def calibrate(self, background: np.ndarray, fpr: float = 0.01) -> float:
        """FPR-targeted threshold on background windows (batch path)."""
        self.threshold = float(np.quantile(self.score(background), 1.0 - fpr))
        return self.threshold
