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

On the card the serving calls replay CUDA graphs, as the reference runs
them as compiled programs (``core/graphs.py``): ``push`` replays the
executor's step graph (``StackExecutor.step_graph``) for chunks up to the
plan's ``chunk_len`` and ``push_many`` one gather -> step -> scatter graph
per pool width (the reference's ``_coalesced_step``); streams that
complete a window in the same piece are scored by one decode padded up the
width ladder (the reference's ``_finish_streams``), captured per width.
Graphs need a packed local backend (``fused_step``/``fused_stack``/``mixed``;
a mixed plan's whole segment chain is one graph); the ``kernel`` backend,
sharded placement (``placement="sharded"``: each segment's sub-stacks
pipelined across stage devices, ``fused_stack_sharded``), longer chunks and
the CPU run eagerly.  Resident state
lives in the graphs' and the pool's buffers and is updated in place; a
snapshot copies it out.

``LmEngine``: LM serving for every LM family (``dense`` with its VLM
backbone, ``moe``, ``ssm``, ``hybrid``, ``encdec``): one batched prefill,
with the frontend's embeddings where the model takes them, then greedy
decode steps against the cache, with the decode-attention (K5) and
SSD-scan (K4) kernels on their paths; on the card each prefill shape and
each decode batch replays a captured graph.

Fault tolerance (``StreamingAnomalyEngine``): ``snapshot``/``restore``
carry every stream's state, partial windows and the threshold through the
versioned ``.npz`` format of ``serve/health.py``, gated by
``fingerprint()``; ``state_absmax`` is the server's post-step watchdog
probe.  Fingerprints and snapshot files read the same in this package and
the reference, so a snapshot written by one restores in the other.
"""

from __future__ import annotations

import logging
import weakref
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
from repro_torch.core.executor import state_leaves, state_like
from repro_torch.core.graphs import CapturedCall
from repro_torch.convert import dtype_name, to_numpy, to_tensor
from repro_torch.device import resolve_device
from repro_torch.trace import span
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.serve.health import (
    SNAPSHOT_VERSION,
    SnapshotMismatchError,
    check_fingerprint,
    read_snapshot,
    write_snapshot,
)

logger = logging.getLogger(__name__)

#: step of the pool-width ladder above its power-of-two rungs (the
#: reference's width of one batch tile, kept so both servers pad alike)
POOL_STEP = 8


def _pad_width(n: int) -> int:
    """Pool-width ladder: the width a batch of ``n`` independent rows is
    padded up to: {1, 2, 4} below ``POOL_STEP``, then multiples of it.  A
    bounded set of batch widths across every fill level (the shapes a
    captured launch sequence per width would cover), without forcing a
    lone stream through a wide batch.  Rows are independent in the
    kernels, so padding never changes a real row's result.
    """
    if n >= POOL_STEP:
        return (n + POOL_STEP - 1) // POOL_STEP * POOL_STEP
    w = 1
    while w < n:
        w *= 2
    return w


def _device_leaf(arr, like: torch.Tensor) -> torch.Tensor:
    """A snapshot leaf back onto ``like``'s device and dtype (2-byte void
    items are bf16 bits, as ``convert.to_numpy`` writes them)."""
    t = to_tensor(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise SnapshotMismatchError(
            f"snapshot state leaf has shape {tuple(t.shape)}, this engine's "
            f"is {tuple(like.shape)}"
        )
    return t.to(device=like.device, dtype=like.dtype)


def _params_to(params: dict, device: torch.device) -> dict:
    """The params tree on ``device`` (tensors already there are kept as
    they are, so the pack cache's identity keys stay valid)."""
    return {k: (_params_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _copy_tree(dst: dict, src: dict) -> None:
    """Copy every tensor of the nested dict ``src`` into ``dst``'s."""
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_tree(dst[key], value)
        else:
            dst[key].copy_(value)


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
    #: stage placement of the fused path: "local" (one device) or "sharded"
    #: (sub-stacks on the stage devices of ``mesh``, ``fused_stack_sharded``)
    placement: str = "local"
    #: sharded placement's stage devices; None = the default stage mesh
    mesh: tuple | None = None
    #: plan knobs: "default" (hand-set), "cached" (the autotune store) or
    #: "balanced" (the mixed backend's model-chosen storage split)
    tune: str = "default"
    #: backend the engine actually runs (set in __post_init__)
    effective_impl: str = field(init=False, default="")
    #: non-None iff the requested impl was declined (the logged reason)
    fallback_reason: str | None = field(init=False, default=None)
    #: ``score`` calls made; the ``score`` span carries it as ``call``
    calls: int = field(init=False, default=0)

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self.params = _params_to(self.params, self._device)
        self.cfg, self.effective_impl, self.fallback_reason = resolve_impl(
            self.cfg, self.impl
        )
        if self.fallback_reason is not None:
            logger.warning("AnomalyStreamEngine: %s", self.fallback_reason)
        # plan + bind eagerly: an illegal impl/placement/weight_dtype
        # combination raises at construction, not on the first score()
        self._execs()

    def _execs(self):
        """The current params' bound segment executors (plans memoised,
        packs identity-cached; re-binds if params were swapped)."""
        return segment_executors(self.params, self.cfg, impl=self.effective_impl,
                                 placement=self.placement, mesh=self.mesh, tune=self.tune)

    def calibrate(self, background: np.ndarray, fpr: float = 0.01) -> float:
        """Set the anomaly threshold at a target false-positive rate on
        background (noise-only) windows."""
        self.threshold = float(np.quantile(self.score(background), 1.0 - fpr))
        return self.threshold

    def score(self, windows: np.ndarray) -> np.ndarray:
        self.calls += 1
        with span("score", {"call": self.calls, "windows": len(windows)}):
            with span("score.plan"):
                exec_enc, exec_dec = self._execs()
            with span("score.stage_in"):
                x = _windows(windows, self._device)
            with torch.no_grad():
                scores = reconstruction_error(self.params, x, self.cfg,
                                              exec_enc=exec_enc, exec_dec=exec_dec)
            with span("score.fetch"):
                return scores.cpu().numpy()

    def flag(self, windows: np.ndarray) -> np.ndarray:
        return self.score(windows) > self.threshold


class _Pool:
    """Every ``push_many`` stream's encoder state as one row of a
    batch-major native state (the leaves' batch axis ``ax``; the leaves in
    ``state_leaves`` order, one ``[h, c]`` per segment of a mixed plan,
    each at its own width).  Row ``ZERO``
    stays zero: the pad rows of a padded step read it.  Row ``SINK`` takes
    the pad rows' results.  Streams get the rows above; the rows keep their
    addresses while the pool does not grow, so a captured step gathers and
    scatters them in place.  ``graphs`` holds the graphs captured over
    these buffers (dropped when the pool grows)."""

    ZERO, SINK = 0, 1

    def __init__(self, executor, packed: bool, capacity: int = 64):
        self.ex, self.ax = executor, 1 if packed else 0
        self.template = executor.zero_state(capacity + 2)
        self.leaves = state_leaves(self.template)
        self.graphs: dict = {}
        self.release_all()

    def release_all(self) -> None:
        self.free = list(range(self.leaves[0].shape[self.ax] - 1, 1, -1))  # pop() gives the lowest

    def alloc(self) -> int:
        if not self.free:
            self._grow()
        row = self.free.pop()
        for leaf in self.leaves:
            leaf.narrow(self.ax, row, 1).zero_()
        return row

    def release(self, row: int) -> None:
        self.free.append(row)

    def _grow(self) -> None:
        rows = self.leaves[0].shape[self.ax]
        grown = state_leaves(self.ex.zero_state(2 * rows))
        for new, old in zip(grown, self.leaves):
            new.narrow(self.ax, 0, rows).copy_(old)
        self.leaves, self.graphs = grown, {}
        self.free = list(range(2 * rows - 1, rows - 1, -1)) + self.free

    def row_state(self, row: int):
        """One row as a B=1 native state (views into the pool)."""
        return state_like([leaf.narrow(self.ax, row, 1) for leaf in self.leaves],
                          self.template)

    def set_row(self, row: int, state) -> None:
        for leaf, src in zip(self.leaves, state_leaves(state)):
            leaf.narrow(self.ax, row, 1).copy_(src)

    def gather(self, idx: torch.Tensor):
        return state_like([leaf.index_select(self.ax, idx) for leaf in self.leaves],
                          self.template)

    def scatter(self, idx: torch.Tensor, state) -> None:
        for leaf, src in zip(self.leaves, state_leaves(state)):
            leaf.index_copy_(self.ax, idx, src)

    def zero_rows(self, idx: torch.Tensor) -> None:
        for leaf in self.leaves:
            leaf.index_fill_(self.ax, idx, 0)


class _StreamSlot:
    """One named stream of the ``push_many`` pool: its row, the chunks of
    its partial window, the fill.  ``state`` reads the row as a B=1 native
    state (views) and assigns it by copy."""

    def __init__(self, pool: _Pool, row: int):
        self.pool, self.row = pool, row
        self.chunks: list = []
        self.filled = 0

    @property
    def state(self):
        return self.pool.row_state(self.row)

    @state.setter
    def state(self, value) -> None:
        self.pool.set_row(self.row, value)


class StreamingAnomalyEngine:
    """Persistent-state chunked scoring: the paper's continuous-stream mode.

    Strain chunks of any length (down to single samples) arrive via
    ``push``; the encoder's per-layer ``(h, c)`` advances without
    re-scoring earlier samples.  Every ``window`` accumulated samples the
    engine emits one anomaly score, equal to scoring that window one-shot to
    fp tolerance.

    By default the engine plans ``impl="fused_step"``: chunks up to the
    plan's ``chunk_len`` run the step kernel, longer pushes and the T-long
    decoder the wavefront kernel, both on the same packed weights.  On the
    card these calls replay CUDA graphs (``graphs=False`` runs them
    eagerly, with the same bits).  ``placement="sharded"`` pipelines each
    segment's sub-stacks across the stage devices of ``mesh`` (the default
    stage mesh if None) on the wavefront kernel, eagerly; the state keeps
    the local layout, so snapshots cross placements.

    ``push_many(stream_ids, chunks)`` keeps a pool of named B=1 streams at
    independent window fill levels and advances any subset with one
    gathered step padded up the width ladder, and scores the streams that
    complete a window together with one padded decode: bit-equal to
    sequential single-stream pushes, because every kernel of the step and
    of the score tail computes each row independently of the batch.
    """

    def __init__(self, params: dict, cfg: AutoencoderConfig, *, batch: int = 1,
                 window: int | None = None, impl: str | None = "fused_step",
                 placement: str = "local", mesh: tuple | None = None,
                 chunk_len: int | None = None, tune: str = "default",
                 carry_state: bool = False, threshold: float = float("inf"),
                 device: str = "cuda", graphs: bool = True):
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
        self.graphs = graphs
        self.window = int(window or self.cfg.timesteps)
        self.carry_state = carry_state
        self.threshold = threshold
        self._params = _params_to(params, self.device)
        self.tune = tune
        self._exec_enc, self._exec_dec = segment_executors(
            self._params, self.cfg, impl=self.effective_impl, placement=placement, mesh=mesh,
            chunk_len=chunk_len, tune=tune,
        )
        self._packed_layout = (
            self._exec_enc.plan.backend.state_layout == "packed"
        )
        self._new_graphs()
        self.reset()

    def _new_graphs(self) -> None:
        """A fresh pool and no captured graphs (construction and weight
        swaps): graphs on the card for packed local backends only, unless
        the engine was made with ``graphs=False`` (eager)."""
        cuda = (self.device.type == "cuda" and self.graphs
                and not self._exec_enc.plan.backend.sharded)
        self._graph_steps = cuda and self._exec_enc.plan.backend.chunked_step
        self._graph_finish = cuda and self._packed_layout
        self._pool = _Pool(self._exec_enc, self._packed_layout)
        self._finish_graphs: dict = {}  # lock-step finish, by batch

    # -- state lifecycle -----------------------------------------------------

    def reset(self) -> None:
        """Zero the encoder state, drop any partial window, and clear the
        named-stream pool (``push_many``)."""
        self._state = self._exec_enc.zero_state(self.batch)
        self._chunks: list[np.ndarray] = []
        self._filled = 0
        self._streams: dict = {}
        self._pool.release_all()

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
        self._new_graphs()
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
                if self._graph_steps and take <= self._exec_enc.plan.chunk_len:
                    self._state = self._exec_enc.step_graph(self.batch)(
                        torch.from_numpy(piece), self._state)
                else:
                    self._state = self._exec_enc.step(
                        torch.as_tensor(piece, device=self.device), self._state)
            self._chunks.append(piece)
            self._filled += take
            pos += take
            if self._filled == self.window:
                scores.append(self._finish_window())
                self._chunks, self._filled = [], 0
                if not self.carry_state:
                    self._state = self._exec_enc.zero_state(self.batch)
        return scores

    def _score_tail(self, latent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """latent -> decode + head -> MSE against the window's samples."""
        return reconstruction_error_from_latent(self._params, latent, x, self.cfg,
                                                exec_dec=self._exec_dec)

    def _finish_window(self) -> np.ndarray:
        """Score the lock-step window that just completed (the reference's
        ``_finish_window``): on the card one captured decode per batch, its
        latent copied in."""
        x = np.concatenate(self._chunks, axis=1)
        with torch.no_grad():
            latent = self._exec_enc.last_hidden(self._state)
            if not self._graph_finish:
                return self._score_tail(latent, torch.as_tensor(x, device=self.device)) \
                    .cpu().numpy()
            entry = self._finish_graphs.get(self.batch)
            if entry is None:
                bufs = (latent.clone(), torch.as_tensor(x, device=self.device))
                call = CapturedCall(lambda: self._score_tail(*bufs), self.device)
                self._finish_graphs[self.batch] = (bufs, call)
                return call.first.cpu().numpy()
            (latent_buf, x_buf), call = entry
            latent_buf.copy_(latent)
            x_buf.copy_(torch.from_numpy(x))
            return call.replay().cpu().numpy()

    # -- multi-stream coalescing ---------------------------------------------

    @property
    def stream_ids(self) -> tuple:
        """Streams currently resident in the ``push_many`` pool."""
        return tuple(self._streams)

    def drop_stream(self, stream_id) -> None:
        """Release one named stream's state and partial window."""
        slot = self._streams.pop(stream_id, None)
        if slot is not None:
            self._pool.release(slot.row)

    # -- fault tolerance: snapshot/restore + numeric watchdog ----------------

    def fingerprint(self) -> dict:
        """The geometry + dtype identity a snapshot must match to be
        restorable into this engine: every key changes either the state
        leaves' shapes and dtypes or the meaning of their values.  The
        values are spelled as the reference spells them."""
        cfg = self.cfg
        packed = self._exec_enc.packed
        if packed is None:
            wd = "native"
        elif isinstance(packed, tuple):
            # a mixed plan binds one pack per segment; the per-layer storage
            # signature is what the state values mean
            wd = "+".join(self._exec_enc.plan.weight_dtype)
        else:
            wd = packed.weight_dtype
        fp = {
            "hidden": list(cfg.hidden),
            "boundary": int(cfg.boundary),
            "input_dim": int(cfg.input_dim),
            "timesteps": int(cfg.timesteps),
            "window": int(self.window),
            "batch": int(self.batch),
            "dtype": dtype_name(cfg.dtype),
            "acts": cfg.acts.name,
            "carry_state": bool(self.carry_state),
            "state_layout": self._exec_enc.plan.backend.state_layout,
            "weight_dtype": wd,
        }
        act_bits = self._exec_enc.plan.act_bits
        if act_bits is not None:
            # activation fake-quant changes the meaning of carried state
            fp["act_bits"] = int(act_bits)
        return fp

    @staticmethod
    def _unflatten(template, leaves: list):
        like = state_leaves(template)
        if len(leaves) != len(like):
            raise SnapshotMismatchError(
                f"snapshot state has {len(leaves)} leaves, this engine's has {len(like)}"
            )
        return state_like([_device_leaf(a, t) for a, t in zip(leaves, like)], template)

    def snapshot(self) -> dict:
        """Every stream's resident state in host memory: the lock-step
        ``push`` path's (h, c) and partial window, the whole ``push_many``
        pool, the calibrated threshold and the ``fingerprint()`` that gates
        ``restore``.  Arrays are copies; a restored engine resumes
        bit-equal to an uninterrupted run."""
        return {
            "version": SNAPSHOT_VERSION,
            "fingerprint": self.fingerprint(),
            "threshold": float(self.threshold),
            "state": [to_numpy(t) for t in state_leaves(self._state)],
            "chunks": [np.array(c) for c in self._chunks],
            "filled": int(self._filled),
            "streams": {
                sid: {
                    "state": [to_numpy(t) for t in state_leaves(slot.state)],
                    "chunks": [np.array(c) for c in slot.chunks],
                    "filled": int(slot.filled),
                }
                for sid, slot in self._streams.items()
            },
        }

    def save_snapshot(self, path) -> None:
        """``snapshot()`` to ``path`` as a versioned ``.npz`` (atomic
        write: temp file + rename)."""
        write_snapshot(path, self.snapshot())

    def restore(self, snap) -> None:
        """Load a snapshot (in-memory dict or a path from
        ``save_snapshot``) into this engine, replacing all stream state.

        The version and the fingerprint are checked first
        (``SnapshotMismatchError`` on any disagreement), so state from a
        differently shaped or differently quantized engine is never
        installed.  State leaves, partial windows, fill counts and the
        threshold round-trip exactly.
        """
        if isinstance(snap, (str, bytes)) or hasattr(snap, "__fspath__"):
            snap = read_snapshot(snap)
        if snap.get("version") != SNAPSHOT_VERSION:
            raise SnapshotMismatchError(
                f"snapshot schema version {snap.get('version')!r} != "
                f"{SNAPSHOT_VERSION} supported by this engine"
            )
        check_fingerprint(self.fingerprint(), snap["fingerprint"])
        state = self._unflatten(self._exec_enc.zero_state(self.batch), snap["state"])
        zero1 = self._exec_enc.zero_state(1)
        states = {sid: self._unflatten(zero1, s["state"]) for sid, s in snap["streams"].items()}
        self.reset()
        for sid, s in snap["streams"].items():
            slot = self._streams[sid] = _StreamSlot(self._pool, self._pool.alloc())
            slot.state = states[sid]
            slot.chunks = [np.array(c) for c in s["chunks"]]
            slot.filled = int(s["filled"])
        self.threshold = float(snap["threshold"])
        self._state = state
        self._chunks = [np.array(c) for c in snap["chunks"]]
        self._filled = int(snap["filled"])

    def state_absmax(self, stream_ids) -> np.ndarray:
        """Max ``|h|, |c|`` per named stream: the post-step watchdog's
        probe.  NaN propagates (a poisoned stream reads NaN, Inf reads
        inf), so ``not (value <= limit)`` catches non-finite and exploded
        states in one comparison.  Streams not in the pool read 0.  One
        gathered reduction and one device-to-host copy per call."""
        ids = list(stream_ids)
        out = np.zeros(len(ids), dtype=np.float64)
        present = [(i, self._streams[sid]) for i, sid in enumerate(ids)
                   if sid in self._streams]
        if not present:
            return out
        ax = self._pool.ax
        with torch.no_grad():
            rows = torch.tensor([slot.row for _, slot in present], device=self.device)
            batched = self._pool.gather(rows)
            per_leaf = [
                leaf.to(torch.float32).abs().amax(
                    dim=tuple(d for d in range(leaf.dim()) if d != ax))
                for leaf in state_leaves(batched)
            ]
            vals = torch.stack(per_leaf).amax(dim=0).cpu().numpy()
        for (i, _), v in zip(present, vals):
            out[i] = v
        return out

    def push_many(self, stream_ids, chunks: np.ndarray) -> dict:
        """Advance N independent B=1 streams with one coalesced step call.

        ``chunks``: (N, t, input_dim), row i belonging to ``stream_ids[i]``.
        The N streams' states are concatenated along the batch axis, advanced
        by one kernel launch per piece (one graph replay on the card), and
        split back.  Streams are created on first use and may sit at
        different window fill levels: the chunk is split at every stream's
        window boundary.  Streams that complete a window in the same piece
        are scored by one decode; the pool is bit-equal to sequential
        single-stream pushes.

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
                self._streams[sid] = _StreamSlot(self._pool, self._pool.alloc())
            slots.append(self._streams[sid])
        rows = [slot.row for slot in slots]
        out: dict = {sid: [] for sid in ids}
        pos, t_total = 0, chunks.shape[1]
        while pos < t_total:
            take = min(t_total - pos, min(self.window - s.filled for s in slots))
            piece = np.array(chunks[:, pos : pos + take])
            with torch.no_grad():
                self._pool_step(rows, piece)
            for i, slot in enumerate(slots):
                slot.chunks.append(piece[i : i + 1])
                slot.filled += take
            pos += take
            done = [(sid, slot) for sid, slot in zip(ids, slots) if slot.filled == self.window]
            if done:
                scores = self._finish_streams([slot for _, slot in done])
                for (sid, _), score in zip(done, scores):
                    out[sid].append(score)
        return out

    def _padded(self, rows: list, x: np.ndarray):
        """Rows and inputs of a call padded up the width ladder: (gather
        and scatter rows (2, width) int64, x (width, ...) float32), pad rows
        reading the zero row, writing the sink row, with zero inputs."""
        n = len(rows)
        width = _pad_width(n)
        idx = np.empty((2, width), np.int64)
        idx[:, :n] = rows
        idx[0, n:], idx[1, n:] = _Pool.ZERO, _Pool.SINK
        xp = np.zeros((width, *x.shape[1:]), np.float32)
        xp[:n] = x
        return torch.from_numpy(idx), torch.from_numpy(xp)

    def _replay(self, key, fn, *args: torch.Tensor):
        """``fn(*args)`` as the graph captured under ``key`` in the pool:
        its first call runs ``fn`` eagerly on the args moved to the card,
        then captures it; later calls copy the args into its buffers and
        replay."""
        entry = self._pool.graphs.get(key)
        if entry is None:
            bufs = tuple(a.to(self.device, copy=True) for a in args)
            call = CapturedCall(lambda: fn(*bufs), self.device)
            self._pool.graphs[key] = (bufs, call)
            return call.first
        bufs, call = entry
        for buf, a in zip(bufs, args):
            buf.copy_(a)
        return call.replay()

    def _pool_step(self, rows: list, piece: np.ndarray) -> None:
        """The reference's ``_coalesced_step``: gather the rows, one step,
        scatter them back, over the padded width; one replay on the card."""
        idx, x = self._padded(rows, piece)
        if self._graph_steps and piece.shape[1] <= self._exec_enc.plan.chunk_len:
            self._replay(("step", idx.shape[1], piece.shape[1]), self._step_rows, idx, x)
        else:
            self._step_rows(idx.to(self.device), x.to(self.device))

    def _step_rows(self, idx: torch.Tensor, x: torch.Tensor) -> None:
        self._pool.scatter(idx[1], self._exec_enc.step(x, self._pool.gather(idx[0])))

    def _finish_streams(self, slots: list) -> list[np.ndarray]:
        """Score the streams that just completed a window with one decode
        padded up the width ladder (the reference's ``_finish_streams``);
        bit-equal to scoring each alone, because the decode and the score
        tail compute each row independently of the batch."""
        k = len(slots)
        x = np.concatenate([np.concatenate(slot.chunks, axis=1) for slot in slots])
        idx, xp = self._padded([slot.row for slot in slots], x)
        if self._graph_finish:
            scores = self._replay(("finish", idx.shape[1]), self._finish_rows, idx, xp)
        else:
            scores = self._finish_rows(idx.to(self.device), xp.to(self.device))
        scores = scores.cpu().numpy()[:k]
        for slot in slots:
            slot.chunks, slot.filled = [], 0
        return [scores[i : i + 1] for i in range(k)]

    def _finish_rows(self, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        scores = self._score_tail(self._exec_enc.last_hidden(self._pool.gather(idx[0])), x)
        if not self.carry_state:
            self._pool.zero_rows(idx[1])
        return scores

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


class LmEngine:
    """Prefill + greedy decode (the reference's ``LmEngine``).

    The model's cache is updated in place by each decode step (the
    reference donates it to the jitted step).  ``use_kernel=False`` runs
    the plain path: ``sdpa`` for decode attention and ``ssd_chunked`` for
    the prefill scan.  ``launches`` counts the K5 (``decode_attn``) and K4
    (``ssd_scan``) launches this engine made.

    Frontend input.  ``prefill``, ``teacher_forced`` and ``generate`` take
    an optional ``frontend_embeds`` (B, P, d_model): a VLM's patch
    embeddings, spliced in front of the tokens (without them a VLM serves
    text only, as in the reference), or an encoder-decoder model's frames,
    which it needs (a ``ValueError`` names them when they are missing).  A
    model with neither refuses them.  After prefill the position is P + S
    for a VLM and S for an encoder-decoder model, whose frames are not in
    its self-attention cache.

    On the card the kernel path replays CUDA graphs, the counterparts of
    the reference's two ``jax.jit``s: one per prompt shape (B, S_prompt,
    P) for ``prefill`` and one per cache shape (every leaf's, so the
    batch, the rows and an encoder-decoder cache's encoder length) for
    ``step``.  The tokens and the frontend embeddings are
    staged in buffers of their own.  The cache they return is the engine's
    own for that batch and cache shape, updated in place: the next
    ``prefill`` that makes a cache of that shape overwrites it.
    ``graphs=False`` runs the kernel path eagerly; the plain path and the
    CPU always do.  The engine counts each cache's position on the host
    and refuses a step past the cache's last row before launching
    anything; the hybrid family's ring cache wraps instead, so its
    position may pass its rows.
    """

    def __init__(self, params: dict, cfg, max_len: int = 256,
                 device: str | torch.device = "cuda", *, use_kernel: bool = True,
                 graphs: bool = True):
        from repro_torch.models.api import get_model

        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _params_to(params, self.device)
        self.api = get_model(cfg)
        self.max_len = max_len
        self.use_kernel = use_kernel
        # only the entry points that reach the family's kernels take use_kernel
        self._entry_kw = {"prefill": {}, "decode_step": {}}
        for entry in self.api.kernel_entry:
            self._entry_kw[entry] = {"use_kernel": use_kernel}
        self.launches = {"decode_attn": 0, "ssd_scan": 0}
        self._graphs = graphs and use_kernel and self.device.type == "cuda"
        # ("prefill", B, S, P) | ("step", *cache leaf shapes) -> (input buffers, graph)
        self._calls: dict = {}
        self._static: dict = {}   # cache leaf shapes -> this engine's cache of that shape
        self._prefilled: dict = {}  # (B, S, P) -> the cache its prefill graph fills
        self._positions: dict = {}  # id(cache["pos"]) -> (weakref to it, host position)

    @staticmethod
    def _kernel_counts() -> dict:
        from repro_torch.kernels.decode_attn import decode_attn
        from repro_torch.kernels.ssd_scan import ssd_scan

        return {"decode_attn": decode_attn.launches, "ssd_scan": ssd_scan.launches}

    def _counted(self, fn, *args, **kwargs):
        before = self._kernel_counts()
        out = fn(*args, **kwargs)
        for name, count in self._kernel_counts().items():
            self.launches[name] += count - before[name]
        return out

    # -- the host's count of each cache's position ---------------------------

    def _set_position(self, cache: dict, pos: int) -> None:
        if len(self._positions) > 64:  # forget caches that are gone
            self._positions = {k: v for k, v in self._positions.items() if v[0]() is not None}
        self._positions[id(cache["pos"])] = (weakref.ref(cache["pos"]), pos)

    def _position(self, cache: dict) -> int:
        entry = self._positions.get(id(cache["pos"]))
        if entry is not None and entry[0]() is cache["pos"]:
            return entry[1]
        return int(cache["pos"])  # a cache this engine did not make: read it once

    @staticmethod
    def _rows(cache: dict) -> int:
        """Rows of a KV cache, a ring's slots for the hybrid family's (0 for
        an SSM state, which has no length)."""
        return cache["k"].shape[2] if "k" in cache else 0

    @staticmethod
    def _shape_key(cache: dict) -> tuple:
        """The shape of every leaf of a cache, which tells apart caches of
        other batches, lengths or encoder lengths."""
        return tuple(t.shape for t in tree_leaves(cache))

    def _static_cache(self, like: dict) -> dict:
        """The engine's cache for ``like``'s shape, made at first use."""
        key = self._shape_key(like)
        if key not in self._static:
            self._static[key] = tree_map(torch.empty_like, like)
        return self._static[key]

    def _graph(self, key, inputs: dict, fn):
        """``fn(buffers)`` replayed: at first use run eagerly, then captured,
        over one buffer per input tensor (``inputs``: name -> tensor)."""
        entry = self._calls.get(key)
        if entry is None:
            # never the caller's tensors
            bufs = {name: t.to(self.device, copy=True) for name, t in inputs.items()}
            call = self._counted(CapturedCall, lambda: fn(bufs), self.device)
            self._calls[key] = (bufs, call)
            return call.first
        bufs, call = entry
        for name, t in inputs.items():
            bufs[name].copy_(t)
        return self._counted(call.replay)

    def _frontend(self, frontend_embeds, batch: int) -> torch.Tensor | None:
        """``frontend_embeds`` checked against the model: (B, P, d_model) at
        the model's dtype, or None for a text-only prompt."""
        cfg = self.cfg
        if frontend_embeds is None:
            if cfg.encdec:
                raise ValueError(
                    f"LmEngine: {cfg.name} is an encoder-decoder model: its prefill needs "
                    f"frontend_embeds, the encoder's frames (B, S_enc, {cfg.d_model})")
            return None
        if not cfg.encdec and cfg.frontend is None:
            raise ValueError(f"LmEngine: {cfg.name} takes tokens only; frontend_embeds are "
                             f"for a VLM backbone or an encoder-decoder model")
        fe = frontend_embeds if isinstance(frontend_embeds, torch.Tensor) else \
            torch.as_tensor(np.asarray(frontend_embeds))
        if fe.dim() != 3 or fe.shape[0] != batch or fe.shape[2] != cfg.d_model:
            raise ValueError(f"LmEngine: frontend_embeds of shape {tuple(fe.shape)}; "
                             f"want ({batch}, P, {cfg.d_model})")
        return fe.to(cfg.dtype)

    # -- serving ----------------------------------------------------------------

    def prefill(self, tokens, frontend_embeds=None) -> tuple[torch.Tensor, dict]:
        """tokens: (B, S_prompt), with the frontend's embeddings (B, P,
        d_model) where the model takes them -> (last-token logits (B, 1,
        V_padded), cache)."""
        from repro_torch.models.api import cache_rows

        tokens = torch.as_tensor(np.asarray(tokens))
        batch, s_len = tokens.shape
        fe = self._frontend(frontend_embeds, batch)
        n_front = 0 if fe is None else fe.shape[1]
        inputs = {"tokens": tokens.long()}
        if fe is not None:
            inputs["frontend_embeds"] = fe
        kw = self._entry_kw["prefill"]
        with torch.inference_mode():
            if not self._graphs:
                logits, cache = self._counted(
                    self.api.prefill, self.params,
                    {name: t.to(self.device) for name, t in inputs.items()},
                    self.cfg, self.max_len, **kw)
            else:
                key = (batch, s_len, n_front)

                def run(bufs):
                    logits, made = self.api.prefill(self.params, bufs, self.cfg, self.max_len,
                                                    **kw)
                    static = self._prefilled[key] = self._static_cache(made)
                    _copy_tree(static, made)
                    return logits

                logits = self._graph(("prefill", *key), inputs, run).clone()
                cache = self._prefilled[key]
        self._set_position(cache, cache_rows(self.cfg, s_len, n_front=n_front))
        return logits, cache

    def step(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One decode step for tokens (B, 1) -> (logits (B, 1, V_padded), cache)."""
        pos = self._position(cache)
        rows = self._rows(cache)
        if rows and not self.api.ring_cache and not 0 <= pos < rows:  # a ring wraps
            raise ValueError(f"LmEngine.step: position {pos} outside a cache of {rows} rows")
        tokens = torch.as_tensor(tokens)
        kw = self._entry_kw["decode_step"]
        with torch.inference_mode():
            if not self._graphs:
                logits, cache = self._counted(
                    self.api.decode_step, self.params, cache,
                    {"tokens": tokens.to(self.device)}, self.cfg, **kw)
            else:
                static = self._static_cache(cache)
                if cache is not static:
                    _copy_tree(static, cache)
                cache = static
                logits = self._graph(
                    ("step", *self._shape_key(static)), {"tokens": tokens.long()},
                    lambda bufs: self.api.decode_step(self.params, static, bufs,
                                                      self.cfg, **kw)[0]).clone()
        self._set_position(cache, pos + 1)
        return logits, cache

    def teacher_forced(self, prompt, tokens,
                       frontend_embeds=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Logits of ``prompt`` (with ``frontend_embeds`` as ``prefill``
        takes them), then of ``tokens`` (B, n) fed one by one (teacher
        forcing): (prefill (B, V_padded), decode steps (n-1, B, V_padded)),
        float32 on the engine's device."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits, cache = self.prefill(prompt, frontend_embeds)
        pre, steps = logits[:, 0].float(), []
        for i in range(tokens.shape[1] - 1):
            logits, cache = self.step(cache, tokens[:, i : i + 1])
            steps.append(logits[:, 0].float())
        return pre, torch.stack(steps) if steps else pre.new_zeros((0, *pre.shape))

    def generate(self, tokens: np.ndarray, n_new: int, frontend_embeds=None) -> np.ndarray:
        """tokens: (B, S_prompt), with ``frontend_embeds`` as ``prefill``
        takes them -> (B, n_new) greedy continuation (argmax over the real
        vocabulary, never the padded rows)."""
        vocab = self.cfg.vocab
        logits, cache = self.prefill(tokens, frontend_embeds)
        out = []
        for i in range(n_new):
            nxt = logits[:, -1, :vocab].argmax(dim=-1, keepdim=True)
            out.append(nxt)
            if i + 1 < n_new:  # the last token needs no step of its own
                logits, cache = self.step(cache, nxt)
        if not out:
            return np.zeros((len(tokens), 0), np.int64)
        return torch.cat(out, dim=1).cpu().numpy()
