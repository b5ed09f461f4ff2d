"""Build the CUDA sources with ``nvcc`` at first use and load them with ctypes.

Each library is one ``csrc/*.cu`` file with a plain C interface (no PyTorch
headers, so a build takes seconds).  The sources include the shared cell
body from ``kernels/csrc/`` (``INCLUDE_DIR``).  A library is compiled for
``sm_90a`` into ``<repo>/build/kernels/`` under a name keyed on a hash of
the source, every shared header and the flags, so a changed source or
header rebuilds and an unchanged one loads the existing library.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

#: where the libraries go (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: the headers every kernel source may include (the shared cell body)
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float   # compile time; 0.0 when an existing build was loaded
    log: str         # nvcc/ptxas output (registers, shared memory, spills), kept
                     # beside the library and read back when it is loaded


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _flags(defines: tuple, split: bool = False) -> tuple:
    return (NVCC_FLAGS + (("--split-compile=0",) if split else ())
            + tuple(f"-D{d}" for d in defines))


def source_digest(source: Path, defines: tuple = (), split: bool = False) -> str:
    """Hash of what a build depends on: the source, every shared header and
    the flags (an edit to the shared cell body must not load a stale
    library)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(defines, split)).encode())
    return h.hexdigest()[:16]


def build(source: Path, defines: tuple = (), split: bool = False) -> Built:
    """Compile ``source`` (if its keyed library is missing) and load it.
    ``defines`` are macros passed as ``-D`` (the wrappers pass none;
    ``KERNEL_PROBE`` turns on the clock stamps of ``csrc/probe.cuh``).
    ``split`` compiles the source's kernels on every CPU at once (nvcc's
    ``--split-compile=0``), for a source of many large kernels: only K1's,
    whose row-thread kernels unroll whole rows (24 s of nvcc against 57 s on
    the H100's host).  The other sources build unsplit: their build takes
    seconds, and their kernels' times and their bit-equality tests were
    taken from unsplit builds, which the split may change."""
    digest = source_digest(source, defines, split)
    out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    log_path = out.with_suffix(".log")
    seconds, log = 0.0, log_path.read_text() if log_path.exists() else ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(defines, split), "-I", str(INCLUDE_DIR), "-o", tmp, str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source.name}:\n{log}"
            )
        log_path.write_text(log)
        os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


def ptxas_report(log: str) -> list:
    """Registers, stack frame and spills of each kernel in an ``nvcc -Xptxas
    -v`` log (a ``Built.log``): [{"kernel", "registers", "stack_frame",
    "spill_stores", "spill_loads"}] (bytes), names demangled where
    ``c++filt`` is installed."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = {"kernel": line.split("'")[1], "registers": None, "stack_frame": None,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
        elif cur is not None and "bytes spill stores" in line:
            words = line.replace(",", "").split()
            cur["stack_frame"] = int(words[0])
            cur["spill_stores"] = int(words[words.index("spill") - 2])
            cur["spill_loads"] = int(words[-4])
        elif cur is not None and "Used " in line:
            cur["registers"] = int(line.split("Used ")[1].split()[0])
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(k["kernel"] for k in out),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for k, name in zip(out, names):
                k["kernel"] = name.replace("(anonymous namespace)::", "")
    return out
