"""Versioned tuned-plan store: the autotuner's output, ``plan_stack``'s input.

The file format, ``CACHE_VERSION``, ``KNOB_NAMES``, the key shape and the
unreachable-entry rule are the JAX package's (``autotune/cache.py``), so a
file written by either package loads in the other; the device fingerprint
is spelled so that it never equals one the reference writes, which leaves
entries measured on one package's kernels inert in the other.

One JSON file maps ``(stack geometry, backend, weight dtype, device
fingerprint)`` to the knob assignment a measured sweep found fastest.
``core.executor.plan_stack(tune="cached")`` consults the process-default
cache at plan time and falls back to the deterministic hand-set defaults
for any knob (or any whole entry) the cache cannot answer — a missing or
stale cache can never change behaviour, only speed.

Invalidation is structural, not temporal:

* ``CACHE_VERSION`` — a format bump discards the whole file on load;
* the device fingerprint rides in every entry key, so a cache tuned on
  one device kind (or device count) is silently inert on another;
* unknown knob names in an entry are rejected at ``put`` time, so a file
  can never teach ``plan_stack`` a knob it does not have.

The default path is ``runs/autotune/tuned.json`` (override with the
``REPRO_AUTOTUNE_CACHE`` environment variable, or programmatically via
``set_cache`` — tests inject an in-memory cache that way).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Mapping, Sequence

CACHE_VERSION = 1

#: the only knobs a tuned entry may carry — must stay a subset of the
#: plan-time knobs ``plan_stack`` accepts (executor validates legality per
#: backend; this guards against typo'd or future-format cache files)
KNOB_NAMES = ("chunk_len", "block_b", "fuse_gates", "n_chunks", "split")

DEFAULT_CACHE_PATH = os.environ.get(
    "REPRO_AUTOTUNE_CACHE", os.path.join("runs", "autotune", "tuned.json")
)


def device_fingerprint() -> str:
    """``torch-<platform>:<device name>:<count>`` of the device this
    package's entry points run on by default: the CUDA card when there is
    one (``torch-cuda:NVIDIA_H100_80GB_HBM3:1``), else ``torch-cpu:cpu:1``.

    The tuned knobs are measurements of this hardware and of this
    package's kernels: a plan resolved elsewhere (another card, another
    count, the reference's ``gpu:...``/``cpu:...`` fingerprints) misses
    the cache and keeps the defaults.
    """
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        return f"torch-cuda:{name}:{torch.cuda.device_count()}".replace(" ", "_")
    return "torch-cpu:cpu:1"


def geometry_key(dims: Sequence[tuple[int, int]]) -> str:
    """Canonical ``in_dim x hidden`` chain, e.g. ``1x32,32x8,8x8``."""
    return ",".join(f"{a}x{b}" for a, b in dims)


def entry_key(dims: Sequence[tuple[int, int]], impl: str,
              weight_dtype: str | None, fingerprint: str | None = None) -> str:
    fp = device_fingerprint() if fingerprint is None else fingerprint
    return f"{impl}|wd={weight_dtype or 'native'}|{geometry_key(dims)}|{fp}"


def _clean_knobs(knobs: Mapping[str, Any]) -> dict[str, Any]:
    unknown = set(knobs) - set(KNOB_NAMES)
    if unknown:
        raise ValueError(
            f"unknown tuned knob(s) {sorted(unknown)}; the cache only "
            f"stores {KNOB_NAMES}"
        )
    return {k: v for k, v in knobs.items() if v is not None}


def _entry_unreachable(key: str, knobs: Mapping[str, Any]) -> bool:
    """True iff no plan request can ever resolve to this entry's key.

    Mixed-plan entries key on a *per-layer* weight-dtype signature
    (``wd=int8+int8+fp32+fp32``) whose layer count must match the geometry
    key's — a stale file from before a depth change would otherwise carry
    entries every lookup misses forever (the unreachable-entry bug class:
    a dead entry reads as "tuned" in audits while plans silently run
    defaults).  Same rule for a recorded ``split`` outside [0, layers]:
    ``plan_stack`` would ignore it, so the entry can never take effect.
    """
    parts = key.split("|")
    if len(parts) != 4 or not parts[1].startswith("wd="):
        return False  # unknown key shape: leave it to lookup misses
    wd, geom = parts[1][3:], parts[2]
    n_layers = len(geom.split(",")) if geom else 0
    if "+" in wd and len(wd.split("+")) != n_layers:
        return True
    split = knobs.get("split")
    if split is not None and not 0 <= int(split) <= n_layers:
        return True
    return False


class TunedPlanCache:
    """The tuned-config store: load, lookup, put, save.

    Entries are plain dicts (JSON round-trippable): ``{"knobs": {...},
    "meta": {...}}`` keyed by ``entry_key``.  ``meta`` is free-form
    provenance (measured/default microseconds, batch, sweep id) that the
    executor never reads — only operators and benches do.
    """

    def __init__(self, entries: dict[str, dict] | None = None,
                 path: str | None = None) -> None:
        self.entries: dict[str, dict] = dict(entries or {})
        self.path = path

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, path: str = DEFAULT_CACHE_PATH) -> "TunedPlanCache":
        """Read a cache file; a missing file or a version/format mismatch
        yields an *empty* cache (tuned knobs are an optimization, never a
        requirement)."""
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return cls(path=path)
        if not isinstance(payload, dict) or payload.get("version") != CACHE_VERSION:
            return cls(path=path)
        entries = payload.get("entries")
        if not isinstance(entries, dict):
            return cls(path=path)
        ok = {}
        for key, ent in entries.items():
            if not (isinstance(ent, dict) and isinstance(ent.get("knobs"), dict)):
                continue
            try:
                knobs = _clean_knobs(ent["knobs"])
            except ValueError:
                continue  # future-format entry: ignore, don't crash
            if _entry_unreachable(key, knobs):
                continue  # per-layer signature no longer matches: drop
            ok[key] = {"knobs": knobs, "meta": ent.get("meta", {})}
        return cls(ok, path=path)

    def save(self, path: str | None = None) -> str:
        """Atomic write (tmp + rename): a crashed tune run can truncate its
        own temp file but never the live cache a server is reading."""
        path = path or self.path or DEFAULT_CACHE_PATH
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"version": CACHE_VERSION, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path
        return path

    # -- entries ------------------------------------------------------------

    def put(self, dims: Sequence[tuple[int, int]], impl: str,
            weight_dtype: str | None, knobs: Mapping[str, Any],
            meta: Mapping[str, Any] | None = None,
            fingerprint: str | None = None) -> str:
        key = entry_key(dims, impl, weight_dtype, fingerprint)
        self.entries[key] = {
            "knobs": _clean_knobs(knobs), "meta": dict(meta or {}),
        }
        return key

    def lookup(self, dims: Sequence[tuple[int, int]], impl: str,
               weight_dtype: str | None,
               fingerprint: str | None = None) -> dict[str, Any] | None:
        """Tuned knob assignment for this (geometry, backend, dtype) on the
        *current* device, or None (→ caller falls back to defaults)."""
        ent = self.entries.get(entry_key(dims, impl, weight_dtype, fingerprint))
        return dict(ent["knobs"]) if ent else None

    def entry_meta(self, dims: Sequence[tuple[int, int]], impl: str,
                   weight_dtype: str | None,
                   fingerprint: str | None = None) -> dict[str, Any] | None:
        ent = self.entries.get(entry_key(dims, impl, weight_dtype, fingerprint))
        return dict(ent["meta"]) if ent else None

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"TunedPlanCache({len(self.entries)} entries, "
                f"path={self.path!r})")


#: process-default cache, lazily loaded from DEFAULT_CACHE_PATH on the
#: first ``plan_stack(tune="cached")``; ``set_cache`` swaps it (tests, the
#: tune CLI after a sweep)
_DEFAULT: TunedPlanCache | None = None


def get_cache(reload: bool = False) -> TunedPlanCache:
    global _DEFAULT
    if _DEFAULT is None or reload:
        _DEFAULT = TunedPlanCache.load(DEFAULT_CACHE_PATH)
    return _DEFAULT


def set_cache(cache: TunedPlanCache | None) -> TunedPlanCache | None:
    """Install (or clear, with None) the process-default cache; returns the
    previous one so tests can restore it."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, cache
    return old


def mixed_signature(dtypes: Sequence[str]) -> str:
    """Canonical per-layer dtype signature, e.g. ``int8+int8+fp32+fp32`` —
    the ``wd=`` key component mixed-plan entries store and look up under."""
    return "+".join(dtypes)


def canonical_weight_dtype(cfgs, weight_dtype=None) -> str | None:
    """The storage dtype a plan request actually resolves to, exactly like
    ``plan_stack``: explicit argument first, then the cfgs' own
    ``weight_dtype``, then the native storage of the cfg dtype.  Both ends
    of the cache — ``lookup_tuned`` at plan time and the tune CLI at store
    time — key through here, so ``weight_dtype=None`` and its resolved
    spelling (e.g. ``"fp32"``) land on the same entry.

    A per-layer sequence (mixed plans) canonicalizes to the
    ``mixed_signature`` with each ``None`` entry resolved per-cfg — the
    request's signature, so heterogeneous sweeps and lookups share keys.
    """
    from repro_torch.core.quant import native_weight_dtype

    def resolve_one(cfg, wd):
        if wd is not None:
            return wd
        if cfg.weight_dtype is not None:
            return cfg.weight_dtype
        return native_weight_dtype(cfg.dtype) or "?"

    if isinstance(weight_dtype, (tuple, list)):
        return mixed_signature([resolve_one(c, wd) for c, wd in zip(cfgs, weight_dtype)])
    wd = weight_dtype
    if wd is None and cfgs:
        wd = cfgs[0].weight_dtype
    if wd is None and cfgs:
        wd = native_weight_dtype(cfgs[0].dtype)
    return wd


def lookup_tuned(cfgs, impl: str,
                 weight_dtype=None) -> dict[str, Any] | None:
    """The executor's entry point: tuned knobs for a plan request, or None.

    The weight-dtype key is canonicalized via ``canonical_weight_dtype``,
    so a sweep stored under ``int8`` is found by both spellings of an int8
    plan request (and a native-dtype sweep by a ``weight_dtype=None``
    request).
    """
    wd = canonical_weight_dtype(cfgs, weight_dtype)
    dims = tuple((c.in_dim, c.hidden) for c in cfgs)
    return get_cache().lookup(dims, impl, wd)
