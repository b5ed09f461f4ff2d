"""The port stands alone: it never imports jax nor anything of ``repro``.

A subprocess imports ``repro_torch`` and every submodule and reports which
modules got loaded; a static scan of the sources backs it up (an import
inside a function body would not show in the subprocess).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("repro_torch.serve.engine", "repro_torch.kernels.lstm_stack.step",
                 "repro_torch.convert", "repro_torch.configs.gw",
                 "repro_torch.kernels.lstm_scan.lstm_scan", "repro_torch.kernels.lstm_scan.ops",
                 "repro_torch.serve.server", "repro_torch.serve.health",
                 "repro_torch.serve.latency", "repro_torch.data.gw",
                 "repro_torch.launch.serve", "repro_torch.configs.registry",
                 "repro_torch.configs.base", "repro_torch.configs.smollm_360m",
                 "repro_torch.configs.mamba2_130m", "repro_torch.data.lm",
                 "repro_torch.models.layers", "repro_torch.models.flash_attention",
                 "repro_torch.models.transformer", "repro_torch.models.ssm",
                 "repro_torch.models.moe", "repro_torch.models.hybrid", "repro_torch.models.encdec",
                 "repro_torch.models.api", "repro_torch.kernels.decode_attn.decode_attn",
                 "repro_torch.kernels.decode_attn.ops", "repro_torch.kernels.decode_attn.ref",
                 "repro_torch.kernels.ssd_scan.ssd_scan", "repro_torch.kernels.ssd_scan.ops",
                 "repro_torch.kernels.ssd_scan.ref", "repro_torch.tree",
                 "repro_torch.train.optimizer", "repro_torch.train.step",
                 "repro_torch.train.checkpoint", "repro_torch.train.trainer",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
                 "repro_torch.launch.subproc", "repro_torch.analysis.costs"):
        assert name in report["modules"]


_SERVER_PROBE = """
import json, sys
import repro_torch.serve.server, repro_torch.launch.serve
print(json.dumps(sorted(m for m in sys.modules if m.startswith("repro_torch.kernels"))))
"""


def test_server_does_not_depend_on_the_scan_kernel():
    """The server and its CLI import no kernel module: the scan kernel
    only loads when a plan selects ``impl="kernel"``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _SERVER_PROBE], env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_source_has_no_jax_or_reference_import(path):
    assert not _FORBIDDEN.findall(path.read_text())
