"""Atomic checkpoints of tensor trees in the reference's on-disk format.

A checkpoint is ``step_%010d/`` holding ``arrays.npz`` (each leaf as the
full array, keyed by its ``/``-joined sorted dict path: ``params/lstm_0/w_x``,
``opt/m/...``, ``opt/step``; ``tree.flatten``'s scheme) and
``manifest.json`` (``step``, ``time``, ``metrics``, ``keys``, ``shapes``,
``dtypes``).  The reference's ``repro.train.checkpoint`` reads what this
module writes and the other way round.

* Atomicity: a write goes to ``step_N.tmp-<random>/`` and is renamed into
  place after ``os.sync``; a killed writer leaves a ``.tmp-`` directory
  that is never listed.
* Async: ``save_async`` copies the leaves to the host at once (ordered on
  the current stream after the work that wrote them) and writes on a
  thread, never two at a time.
* Retention: the newest ``keep`` checkpoints stay.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.convert import dtype_name, to_numpy, to_tensor, unflatten
from repro_torch.device import resolve_device
from repro_torch.tree import flatten

MANIFEST = "manifest.json"


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- write ----------------------------------------------------------
    def save(self, step: int, tree: dict, metrics: dict | None = None) -> Path:
        return self._write(step, self._to_host(tree), metrics or {})

    def save_async(self, step: int, tree: dict, metrics: dict | None = None) -> None:
        """Copy to the host now; write on a background thread."""
        self.wait()  # never two writers at once
        host = self._to_host(tree)

        def write():
            try:
                self._write(step, host, metrics or {})
            except BaseException as exc:  # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _to_host(tree: dict) -> dict:
        return {k: (to_numpy(v), dtype_name(v.dtype)) for k, v in flatten(tree).items()}

    def _write(self, step: int, host: dict, metrics: dict) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = Path(tempfile.mkdtemp(prefix=f"{final.name}.tmp-", dir=self.dir))
        try:
            np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
            manifest = {
                "step": step, "time": time.time(), "metrics": metrics,
                "keys": list(host),
                "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
                "dtypes": {k: name for k, (_, name) in host.items()},
            }
            (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
            os.sync()
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / MANIFEST).exists() and ".tmp-" not in p.name:
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _dir(self, step: int | None) -> Path:
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return self.dir / f"step_{step:010d}"

    def restore(self, like: dict, step: int | None = None,
                device: str | torch.device | None = None) -> dict:
        """A new tree in ``like``'s structure with the checkpoint's values,
        each leaf at its ``like`` leaf's dtype, on ``device`` (default: the
        ``like`` leaf's device)."""
        d = self._dir(step)
        dev = None if device is None else resolve_device(device)
        out = {}
        with np.load(d / "arrays.npz") as data:
            for key, leaf in flatten(like).items():
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                t = to_tensor(data[key])
                out[key] = t.to(leaf.dtype).to(leaf.device if dev is None else dev)
        return unflatten(out, prefix="")

    def manifest(self, step: int | None = None) -> dict:
        return json.loads((self._dir(step) / MANIFEST).read_text())
