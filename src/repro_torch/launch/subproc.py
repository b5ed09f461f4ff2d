"""Child-process environment for ranks spawned on the CPU: the port of
``repro/launch/subproc.py``.

Tests that need several ranks (a gloo process group on the CPU) spawn one
child process per rank, from the repo root.  The child gets a minimal
environment: ``PYTHONPATH``, ``PATH`` and ``HOME``, plus the variables in
``PASS_THROUGH`` where the parent has them: the temporary directory, the
cards the parent may use, and the CUDA toolkit location that
``kernels/_build.py`` reads.  One helper, so every spawning site threads
the same variables.
"""

from __future__ import annotations

import os

#: variables that must survive into a child rank
PASS_THROUGH = ("TMPDIR", "CUDA_VISIBLE_DEVICES", "CUDA_HOME", "CUDA_PATH")


def child_env(pythonpath: str = "src") -> dict[str, str]:
    """Minimal environment for a rank's subprocess run from the repo root."""
    env = {
        "PYTHONPATH": pythonpath,
        "PATH": "/usr/bin:/bin",
        "HOME": os.environ.get("HOME", "/root"),
    }
    for var in PASS_THROUGH:
        if var in os.environ:
            env[var] = os.environ[var]
    return env
