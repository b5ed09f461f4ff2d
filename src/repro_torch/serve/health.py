"""Fault-tolerance layer for the serving stack: input sanitization,
state snapshot/restore, and scheduler supervision knobs.

The paper's premise — GW events "happen at unknown times and of varying
durations" — cuts both ways: the input is a *raw* detector stream, and
raw strain is not clean (LIGO publishes data-quality flags precisely
because dropouts, saturated glitches, and disconnecting channels are
routine).  A recurrent serving engine is uniquely exposed to that: one
NaN chunk does not produce one NaN score, it poisons the stream's
persistent ``(h, c)`` **forever** — every score after the glitch is
garbage, silently.  This module carries the three defenses and their
shared configuration:

* **chunk screening** (``screen_chunk``) — a one-pass NaN/Inf/saturation
  check the ``StreamServer`` applies *before* a chunk can enter a
  coalesced ``push_many`` batch, with a per-server quarantine policy
  (``HealthConfig.sanitize``): ``reject`` the chunk loudly, ``hold`` the
  stream's state and skip it, or ``reset`` the stream with a score
  hold-down window.  The screen is a single ``max(|x|)`` reduction over
  the chunk;
* **snapshot format** (``write_snapshot`` / ``read_snapshot``) — the
  versioned on-disk serialization behind
  ``StreamingAnomalyEngine.snapshot()/restore()``: one ``.npz`` holding
  every stream's ``(h, c)`` leaves, partial-window chunks, fill counts,
  and the calibrated threshold, plus a geometry + ``weight_dtype``
  fingerprint that ``restore`` checks before touching engine state — a
  snapshot taken by a differently-shaped (or differently-quantized)
  server is refused with a named error, never silently mis-restored;
* **supervision knobs** (``HealthConfig``) — scheduler heartbeat
  timeout, bounded-backoff restart budget, ``stop(drain=True)``
  deadline, and periodic-checkpoint cadence, consumed by
  ``serve/server.py``.

Nothing here imports the engine or the server: this module is the leaf
both of them share.  It is numpy only and keeps the reference's on-disk
layout, so a snapshot written by either package restores in the other.
"""

from __future__ import annotations

import io
import json
import math
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "SNAPSHOT_VERSION",
    "ChunkRejectedError",
    "HealthConfig",
    "SnapshotMismatchError",
    "read_snapshot",
    "screen_chunk",
    "write_snapshot",
]

#: on-disk snapshot schema version; bumped on any layout change so an old
#: server can never misparse a new snapshot (and vice versa)
SNAPSHOT_VERSION = 1

SANITIZE_POLICIES = ("off", "reject", "hold", "reset")


class ChunkRejectedError(ValueError):
    """Raised by ``StreamServer.submit`` under ``sanitize="reject"`` when a
    chunk fails the NaN/Inf/saturation screen (named stream + reason)."""


class SnapshotMismatchError(ValueError):
    """Raised by ``restore`` when a snapshot's version or geometry /
    ``weight_dtype`` fingerprint disagrees with the live engine."""


@dataclass
class HealthConfig:
    """Robustness knobs for ``StreamServer`` (``ServerConfig.health``).

    Input quarantine:

    ``sanitize`` — per-chunk screening policy applied in ``submit``,
    *before* the chunk can enter a coalesced batch: ``"off"`` disables
    screening; ``"reject"`` raises ``ChunkRejectedError`` naming the
    stream and the defect (caller-managed retry/skip); ``"hold"``
    silently skips the bad chunk, freezing the stream's resident state —
    the stream's scores then equal a replay of only its clean chunks;
    ``"reset"`` discards the stream's pending chunks, zeroes its engine
    state and partial window, and suppresses its next
    ``holddown_windows`` scores (the state-warmup hold-down).
    ``saturation_limit`` — ``|x|`` above this screens as a saturated
    glitch (``None`` disables the amplitude check; NaN/Inf are always
    screened while ``sanitize != "off"``).

    Post-step watchdog:

    ``watchdog`` — after every engine step, check the batch's resident
    ``(h, c)`` against ``state_limit``; a non-finite or exploded stream
    is auto-reset (fresh zero state, window dropped), error-marked, and
    counted in ``ServerStats.watchdog_resets`` — the backstop that
    catches an *already-poisoned* stream whatever the poison source.
    ``state_limit`` — max ``|h|, |c|`` considered healthy.

    Scheduler supervision:

    ``supervise`` — run a supervisor thread alongside the scheduler
    (``start()``): a scheduler thread that died outside the per-batch
    isolation is restarted with bounded exponential backoff
    (``restart_backoff_s`` doubling per restart, capped at
    ``max_backoff_s``), at most ``max_restarts`` times, counted in
    ``ServerStats.scheduler_restarts``.
    ``supervise_interval_s`` — supervisor poll cadence.
    ``heartbeat_timeout_s`` — ``server.healthy()`` reports False when
    the scheduler's heartbeat is older than this with work pending (a
    wedged engine call cannot be killed from Python, but it can be
    *detected*).

    Shutdown + checkpointing:

    ``drain_deadline_s`` — default deadline for ``stop(drain=True)``:
    a wedged engine step cannot hang shutdown past this (``None`` waits
    forever).
    ``checkpoint_interval_s`` / ``checkpoint_path`` — when both are
    set, the scheduler thread snapshots the engine to
    ``checkpoint_path`` every interval (``ServerStats.checkpoints``);
    ``StreamServer.restart_from`` resumes a fresh server from the file.
    """

    sanitize: str = "reject"
    saturation_limit: float | None = None
    watchdog: bool = True
    state_limit: float = 1e6
    holddown_windows: int = 1
    supervise: bool = True
    supervise_interval_s: float = 0.25
    heartbeat_timeout_s: float = 5.0
    max_restarts: int = 3
    restart_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    drain_deadline_s: float | None = None
    checkpoint_interval_s: float | None = None
    checkpoint_path: str | None = None

    def __post_init__(self):
        if self.sanitize not in SANITIZE_POLICIES:
            raise ValueError(
                f"sanitize must be one of {SANITIZE_POLICIES}, "
                f"got {self.sanitize!r}"
            )
        if self.saturation_limit is not None and not self.saturation_limit > 0:
            raise ValueError(
                f"saturation_limit must be > 0 (or None to disable), "
                f"got {self.saturation_limit}"
            )
        if not self.state_limit > 0:
            raise ValueError(f"state_limit must be > 0, got {self.state_limit}")
        if self.holddown_windows < 0:
            raise ValueError(
                f"holddown_windows must be >= 0, got {self.holddown_windows}"
            )
        if not self.supervise_interval_s > 0:
            raise ValueError(
                f"supervise_interval_s must be > 0, "
                f"got {self.supervise_interval_s}"
            )
        if not self.heartbeat_timeout_s > 0:
            raise ValueError(
                f"heartbeat_timeout_s must be > 0, "
                f"got {self.heartbeat_timeout_s}"
            )
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if not self.restart_backoff_s > 0:
            raise ValueError(
                f"restart_backoff_s must be > 0, got {self.restart_backoff_s}"
            )
        if self.max_backoff_s < self.restart_backoff_s:
            raise ValueError(
                "max_backoff_s must be >= restart_backoff_s, got "
                f"{self.max_backoff_s} < {self.restart_backoff_s}"
            )
        if self.drain_deadline_s is not None and not self.drain_deadline_s > 0:
            raise ValueError(
                f"drain_deadline_s must be > 0 (or None for no deadline), "
                f"got {self.drain_deadline_s}"
            )
        if (
            self.checkpoint_interval_s is not None
            and not self.checkpoint_interval_s > 0
        ):
            raise ValueError(
                f"checkpoint_interval_s must be > 0 (or None to disable), "
                f"got {self.checkpoint_interval_s}"
            )


def screen_chunk(
    chunk: np.ndarray, saturation_limit: float | None = None
) -> str | None:
    """One-pass numeric screen: the defect description, or ``None`` if the
    chunk is clean.

    Cost is a single ``max(|x|)`` reduction over the chunk — NaN
    propagates through the max, Inf survives it, and saturation is a
    compare on the result, so one pass answers all three questions.
    """
    m = float(np.max(np.abs(chunk)))
    if math.isnan(m):
        return "non-finite values (NaN)"
    if math.isinf(m):
        return "non-finite values (Inf)"
    if saturation_limit is not None and m > saturation_limit:
        return (
            f"saturated glitch (max |x| = {m:.6g} > "
            f"saturation_limit = {saturation_limit:g})"
        )
    return None


# ---------------------------------------------------------------------------
# snapshot serialization (the on-disk format behind engine.snapshot/restore)
# ---------------------------------------------------------------------------
#
# Layout: one .npz archive.
#   meta                 -- JSON (version, fingerprint, threshold, counts)
#   engine_state_{j}     -- lock-step push path: state leaf j
#   engine_chunk_{k}     -- lock-step push path: partial-window chunk k
#   stream_{i}_state_{j} -- push_many pool, stream i (meta order): leaf j
#   stream_{i}_chunk_{k} -- push_many pool, stream i: partial-window chunk k
#
# Stream ids are JSON-encoded in meta (snapshot order == meta order), so
# any JSON-serializable id round-trips; exotic ids fail loudly at
# snapshot time instead of silently mangling at restore.


def _check_ids_serializable(snap: dict) -> None:
    for sid in snap["streams"]:
        try:
            round_trip = json.loads(json.dumps(sid))
        except (TypeError, ValueError):
            round_trip = None
        if round_trip != sid or not isinstance(sid, (str, int, float, bool)):
            raise ValueError(
                f"stream id {sid!r} is not snapshot-serializable: snapshot/"
                "restore carries ids through JSON, so use str/int/float ids "
                "for streams that must survive a restart"
            )


def write_snapshot(path: str | os.PathLike, snap: dict) -> None:
    """Serialize an in-memory engine snapshot (``engine.snapshot()``) to
    ``path`` atomically (write temp + rename: a crash mid-checkpoint
    leaves the previous snapshot intact, never a truncated one)."""
    _check_ids_serializable(snap)
    arrays: dict[str, np.ndarray] = {}
    meta = {
        "version": snap["version"],
        "fingerprint": snap["fingerprint"],
        "threshold": snap["threshold"],
        "filled": snap["filled"],
        "n_state": len(snap["state"]),
        "n_chunks": len(snap["chunks"]),
        "streams": [],
    }
    for j, leaf in enumerate(snap["state"]):
        arrays[f"engine_state_{j}"] = leaf
    for k, c in enumerate(snap["chunks"]):
        arrays[f"engine_chunk_{k}"] = c
    for i, (sid, s) in enumerate(snap["streams"].items()):
        meta["streams"].append(
            {
                "id": sid,
                "filled": s["filled"],
                "n_state": len(s["state"]),
                "n_chunks": len(s["chunks"]),
            }
        )
        for j, leaf in enumerate(s["state"]):
            arrays[f"stream_{i}_state_{j}"] = leaf
        for k, c in enumerate(s["chunks"]):
            arrays[f"stream_{i}_chunk_{k}"] = c

    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8), **arrays)
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(buf.getvalue())
    os.replace(tmp, path)


def read_snapshot(path: str | os.PathLike) -> dict:
    """Load a snapshot file back into the in-memory schema
    (``engine.restore`` consumes this; the version gate lives here so a
    wrong-schema file fails before any arrays are interpreted)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        version = meta.get("version")
        if version != SNAPSHOT_VERSION:
            raise SnapshotMismatchError(
                f"snapshot {os.fspath(path)!r} has schema version "
                f"{version!r}; this build reads version {SNAPSHOT_VERSION} "
                "— re-snapshot with a matching build"
            )
        snap = {
            "version": version,
            "fingerprint": meta["fingerprint"],
            "threshold": meta["threshold"],
            "filled": meta["filled"],
            "state": [z[f"engine_state_{j}"] for j in range(meta["n_state"])],
            "chunks": [z[f"engine_chunk_{k}"] for k in range(meta["n_chunks"])],
            "streams": {},
        }
        for i, rec in enumerate(meta["streams"]):
            snap["streams"][rec["id"]] = {
                "filled": rec["filled"],
                "state": [
                    z[f"stream_{i}_state_{j}"] for j in range(rec["n_state"])
                ],
                "chunks": [
                    z[f"stream_{i}_chunk_{k}"] for k in range(rec["n_chunks"])
                ],
            }
    return snap


def check_fingerprint(have: dict, want: dict) -> None:
    """Refuse a snapshot whose geometry/dtype fingerprint disagrees with
    the live engine — per-key diff in the error so a mismatched restore
    is diagnosable at a glance."""
    if have == want:
        return
    diffs = [
        f"{k}: snapshot={want.get(k)!r} engine={have.get(k)!r}"
        for k in sorted(set(have) | set(want))
        if have.get(k) != want.get(k)
    ]
    raise SnapshotMismatchError(
        "snapshot fingerprint does not match this engine — restoring would "
        "mis-shape or mis-scale every stream's (h, c); mismatched keys: "
        + "; ".join(diffs)
    )
