"""ctypes bindings for the native host-IO codec (native/pcd_codec.cpp).

Auto-builds ``native/libpcdcodec.so`` with ``make`` on first use (g++ only,
no external deps; without OpenMP where g++ cannot link it) and degrades
gracefully: every entry point returns None /
falls back when the library is unavailable, so the pure-Python path keeps
working on machines without a toolchain.

A copy of `pointcloudprocessor_tpu/io/native.py`, binding the same
repository-level ``native/`` codec (importing the JAX package's copy imports
jax).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpcdcodec.so"))

_lock = threading.Lock()
_lib = None
_tried = False

# The Makefile's flags without -fopenmp, for a g++ that cannot link OpenMP
# (no libgomp): the codec guards every OpenMP use with _OPENMP, so it builds
# and runs serially, still far faster than the numpy fallback.
_SERIAL_MAKE_VARS = (
    "CXXFLAGS=-O3 -march=native -std=c++17 -fPIC -Wall",
    "LDFLAGS=-shared",
)


def _build() -> bool:
    for make_vars in ((), _SERIAL_MAKE_VARS):
        try:
            r = subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR), *make_vars],
                capture_output=True, text=True, timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"pcd codec build unavailable: {e}", file=sys.stderr)
            return False
        kind = "without OpenMP" if make_vars else "with OpenMP"
        if r.returncode == 0:
            if make_vars:
                print(f"pcd codec built {kind}", file=sys.stderr)
            return True
        print(f"pcd codec build {kind} failed:\n{r.stderr[-2000:]}", file=sys.stderr)
    return False


def load():
    """The cdll handle, building if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print(f"pcd codec load failed: {e}", file=sys.stderr)
            return None
        lib.pcd_parse_ascii.restype = ctypes.c_long
        lib.pcd_parse_ascii.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.pcd_format_ascii.restype = ctypes.c_long
        lib.pcd_format_ascii.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_long,
        ]
        lib.pcd_lzf_decompress.restype = ctypes.c_long
        lib.pcd_lzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.pcd_lzf_compress.restype = ctypes.c_long
        lib.pcd_lzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def parse_ascii_table(body: bytes, ncols: int, max_rows: int) -> np.ndarray | None:
    """(rows, ncols) float64 table from whitespace-separated ASCII, or None."""
    lib = load()
    if lib is None:
        return None
    out = np.empty((max_rows, ncols), np.float64)
    n = lib.pcd_parse_ascii(
        body, len(body), ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows,
    )
    if n < 0:
        return None
    return out[:n]


def format_ascii_table(table: np.ndarray, is_int) -> bytes | None:
    """ASCII bytes ('%.8g' floats / '%d' ints per column), or None."""
    lib = load()
    if lib is None:
        return None
    table = np.ascontiguousarray(table, np.float64)
    nrows, ncols = table.shape
    flags = np.asarray(is_int, np.int32)
    cap = max(nrows * ncols * 32 + 1024, 1 << 16)
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        n = lib.pcd_format_ascii(
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nrows, ncols,
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            buf, cap,
        )
        if n >= 0:
            return buf.raw[:n]
        cap = -n + 1024
    return None


def lzf_decompress(data: bytes, expected_size: int) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(expected_size)
    n = lib.pcd_lzf_decompress(data, len(data), out, expected_size)
    if n != expected_size:
        return None
    return out.raw


def lzf_compress(data: bytes) -> bytes | None:
    """Compressed bytes, or None if unavailable/incompressible."""
    lib = load()
    if lib is None:
        return None
    cap = len(data) + len(data) // 16 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.pcd_lzf_compress(data, len(data), out, cap)
    if n <= 0:
        return None
    return out.raw[:n]
