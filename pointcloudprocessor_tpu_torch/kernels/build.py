"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take raw
device pointers and a ``cudaStream_t`` and return ``cudaGetLastError()``. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``kernels/_build/`` (git-ignored), named by a hash of the
source, the headers it includes and the flags, and loaded with ctypes. A
rebuild happens only when one of them changes. A failed build raises with
nvcc's output: there is no fallback.

Usage: ``library("nid_hist")`` returns the loaded ``ctypes.CDLL``;
``build("nid_hist")`` returns a :class:`Build` record (path, seconds spent
compiling in this process, ptxas report). Different libraries may be built
from different threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "kernels", "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class Build:
    name: str
    path: str
    seconds: float  # compile time spent by this process (0.0 if reused)
    ptxas: str  # nvcc/ptxas report (registers, shared memory, spills)


# One lock per library, so that two libraries build concurrently (one nvcc
# each) while a second caller of the same library waits for its build.
_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, tuple[Build, ctypes.CDLL]] = {}

# Launches of the kernels that take a (K, N) batch of keyframes, keyed by
# (kernel, N), N the points a keyframe, so that a run splits its launches by
# shape: K1/K2 (ops/nid_hist), P1/P2 (ops/nid_project) and G1
# (ops/tap_gather) record here.
launch_shapes: Counter = Counter()


def reset_launch_shapes(names) -> None:
    """Drop the entries of the kernels ``names``."""
    for key in [key for key in launch_shapes if key[0] in names]:
        del launch_shapes[key]


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of pointcloudprocessor_tpu_torch are built at first use and "
        "need the CUDA toolkit"
    )


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: list[str]) -> list[str]:
    """``path`` and the files it includes with quotes (from its directory),
    each once, in the order first met."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _digest(name: str) -> str:
    """Hash of the source, of every header it includes with quotes (such as
    ``csrc/cell_window.cuh``) and of the flags: a library is rebuilt when
    any of them changes."""
    h = hashlib.sha256()
    for path in _sources(_source(name), []):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str) -> Build:
    out = os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")
    log = out + ".log"
    if os.path.exists(out):
        with open(log) as f:
            return Build(name, out, 0.0, f.read())
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {_source(name)} (exit {r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}"
            )
        with open(log, "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(name, out, time.perf_counter() - t0, r.stdout + r.stderr)


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` if needed and load it; the Build record."""
    return _load(name)[0]


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it at first use,
    with ``signatures`` ({function: (argtypes, restype)}) declared."""
    lib = _load(name)[1]
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    return lib


def _load(name: str):
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            b = _compile(name)
            _loaded[name] = (b, ctypes.CDLL(b.path))
        return _loaded[name]
