"""Binary frame-directory codec (host side, numpy).

Format-compatible rebuild of `FrameCPU::load` / the `points(_compact).bin`
directory layout (`PointCloudProcessor/src/vlcal/common/frame_cpu.cpp:149-290`):

full precision                      compact
--------------------------------    ---------------------------------
points.bin       float64 (N,4)      points_compact.bin      float32 (N,3)
times.bin        float64 (N,)       times_compact.bin       float32 (N,)
normals.bin      float64 (N,4)      normals_compact.bin     float32 (N,3)
covs.bin         float64 (N,4,4)    covs_compact.bin        float32 (N,6)
                                    (upper-triangular x3 block, expanded
                                     symmetric on load, :236-249)
intensities.bin  float64 (N,)       intensities_compact.bin float32 (N,)
aux_<name>.bin   raw bytes, elem_size inferred as bytes // N  (:262-288)

`points.bin` takes precedence over `points_compact.bin` when both exist
(:152,191), mirroring the reference's branch order. Homogeneous coordinates
are normalized on load: points -> w=1, normals -> w=0 (:203,227).

Note: the reference's compact-intensity branch reads `sizeof(Vector4f)*N`
bytes into a float[N] buffer (:256) — a 4x over-read; the obviously
intended float32[N] layout is implemented here.

A numpy copy of `pointcloudprocessor_tpu/io/frame_bin.py`: the files
written by either package are byte-equal.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class FrameBin:
    """Host-side SoA frame mirroring `vlcal::Frame` (`frame.hpp:63-72`)."""

    points: np.ndarray  # (N, 3) float64
    times: Optional[np.ndarray] = None  # (N,)
    normals: Optional[np.ndarray] = None  # (N, 3)
    covs: Optional[np.ndarray] = None  # (N, 3, 3)
    intensities: Optional[np.ndarray] = None  # (N,)
    aux: Dict[str, np.ndarray] = field(default_factory=dict)  # raw uint8 (N, elem)

    @property
    def size(self) -> int:
        return len(self.points)


def _read(path, dtype, cols=None):
    a = np.fromfile(path, dtype=dtype)
    return a.reshape(-1, cols) if cols else a


def _expand_cov6(c6: np.ndarray) -> np.ndarray:
    """(N, 6) upper-triangular -> (N, 3, 3) symmetric (frame_cpu.cpp:238-247)."""
    n = len(c6)
    cov = np.zeros((n, 3, 3), c6.dtype)
    cov[:, 0, 0] = c6[:, 0]
    cov[:, 0, 1] = cov[:, 1, 0] = c6[:, 1]
    cov[:, 0, 2] = cov[:, 2, 0] = c6[:, 2]
    cov[:, 1, 1] = c6[:, 3]
    cov[:, 1, 2] = cov[:, 2, 1] = c6[:, 4]
    cov[:, 2, 2] = c6[:, 5]
    return cov


def _compress_cov(cov: np.ndarray) -> np.ndarray:
    return np.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
        axis=-1,
    )


def take(frame: FrameBin, indices: np.ndarray) -> FrameBin:
    """Reorder/subset every attribute by ``indices`` — `sample`
    (frame_cpu.cpp:294-343) as one fancy-index."""
    pick = lambda a: None if a is None else a[indices]
    return FrameBin(
        points=frame.points[indices],
        times=pick(frame.times),
        normals=pick(frame.normals),
        covs=pick(frame.covs),
        intensities=pick(frame.intensities),
        aux={k: v[indices] for k, v in frame.aux.items()},
    )


def sort_by_time(frame: FrameBin) -> FrameBin:
    """Stable time-ordering of all attributes — `sort_by_time`
    (frame_cpu.hpp:193-196)."""
    if frame.times is None:
        return frame
    return take(frame, np.argsort(frame.times, kind="stable"))


def load(path: str) -> FrameBin:
    """Load a frame directory; raises FileNotFoundError when neither
    points.bin nor points_compact.bin exists (frame_cpu.cpp:258-260)."""
    j = lambda name: os.path.join(path, name)
    if os.path.exists(j("points.bin")):
        frame = FrameBin(points=_read(j("points.bin"), np.float64, 4)[:, :3].copy())
        n = frame.size
        if os.path.exists(j("times.bin")):
            frame.times = _read(j("times.bin"), np.float64)[:n]
        if os.path.exists(j("normals.bin")):
            frame.normals = _read(j("normals.bin"), np.float64, 4)[:, :3].copy()
        if os.path.exists(j("covs.bin")):
            frame.covs = _read(j("covs.bin"), np.float64).reshape(-1, 4, 4)[:, :3, :3].copy()
        if os.path.exists(j("intensities.bin")):
            frame.intensities = _read(j("intensities.bin"), np.float64)[:n]
    elif os.path.exists(j("points_compact.bin")):
        frame = FrameBin(
            points=_read(j("points_compact.bin"), np.float32, 3).astype(np.float64)
        )
        if os.path.exists(j("times_compact.bin")):
            frame.times = _read(j("times_compact.bin"), np.float32).astype(np.float64)
        if os.path.exists(j("normals_compact.bin")):
            frame.normals = _read(j("normals_compact.bin"), np.float32, 3).astype(np.float64)
        if os.path.exists(j("covs_compact.bin")):
            frame.covs = _expand_cov6(_read(j("covs_compact.bin"), np.float32, 6)).astype(
                np.float64
            )
        if os.path.exists(j("intensities_compact.bin")):
            frame.intensities = _read(j("intensities_compact.bin"), np.float32).astype(
                np.float64
            )
    else:
        raise FileNotFoundError(f"{path} does not contain points(_compact).bin")

    aux_re = re.compile(r"^aux_([^_].*)\.bin$")
    for name in sorted(os.listdir(path)):
        m = aux_re.match(name)
        if not m:
            continue
        raw = np.fromfile(j(name), dtype=np.uint8)
        elem = len(raw) // max(frame.size, 1)
        frame.aux[m.group(1)] = raw[: elem * frame.size].reshape(frame.size, elem)
    return frame


def save(path: str, frame: FrameBin, compact: bool = True) -> None:
    """Write a frame directory in the reference's on-disk layout."""
    os.makedirs(path, exist_ok=True)
    j = lambda name: os.path.join(path, name)
    n = frame.size
    if compact:
        frame.points.astype(np.float32).tofile(j("points_compact.bin"))
        if frame.times is not None:
            frame.times.astype(np.float32).tofile(j("times_compact.bin"))
        if frame.normals is not None:
            frame.normals.astype(np.float32).tofile(j("normals_compact.bin"))
        if frame.covs is not None:
            _compress_cov(frame.covs).astype(np.float32).tofile(j("covs_compact.bin"))
        if frame.intensities is not None:
            frame.intensities.astype(np.float32).tofile(j("intensities_compact.bin"))
    else:
        np.c_[frame.points, np.ones(n)].astype(np.float64).tofile(j("points.bin"))
        if frame.times is not None:
            frame.times.astype(np.float64).tofile(j("times.bin"))
        if frame.normals is not None:
            np.c_[frame.normals, np.zeros(n)].astype(np.float64).tofile(j("normals.bin"))
        if frame.covs is not None:
            cov4 = np.zeros((n, 4, 4))
            cov4[:, :3, :3] = frame.covs
            cov4.astype(np.float64).tofile(j("covs.bin"))
        if frame.intensities is not None:
            frame.intensities.astype(np.float64).tofile(j("intensities.bin"))
    for name, data in frame.aux.items():
        np.ascontiguousarray(data, dtype=np.uint8).tofile(j(f"aux_{name}.bin"))
