"""Build and load the port's hand-written CUDA kernels.

Each source ``cnsn_tpu_torch/csrc/<name>.cu`` exports a plain C interface.
It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
and loaded with ``ctypes``; no PyTorch headers are involved, so a build
takes seconds.  The library is built at first use into
``cnsn_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
the source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The compiler's ``-Xptxas=-v`` report (registers,
shared memory, spills) is kept beside the library as ``<lib>.log``.

A failed build raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["LAUNCHES", "WATCHERS", "build", "load", "library_path", "watch"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launch counts, by kernel wrapper name.  A wrapper adds one where it
# launches its kernel and nowhere else; callers clear() it to count a run.
LAUNCHES: collections.Counter = collections.Counter()

# Callables given (wrapper name, outputs) after each counted launch: the
# kernels write their outputs through ctypes, where no torch op (and so
# no dispatch mode, ``utils/debug.py::checked``) sees the values.
WATCHERS: list = []


def watch(name: str, *outputs) -> None:
    """Hand a launch's outputs to the ``WATCHERS``."""
    for watcher in WATCHERS:
        watcher(name, outputs)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in filter(None, (os.environ.get("CUDA_HOME"), "/usr/local/cuda")):
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
