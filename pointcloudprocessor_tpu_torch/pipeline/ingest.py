"""Dataset ingest: bind odometry poses to image (and mask) files.

Port of `pointcloudprocessor_tpu/pipeline/ingest.py` (semantics of
`PointCloudProcessor::loadImagesAndOdometry`,
`PointCloudProcessor.cpp:965-1005`): for each odometry line, look for
``<ts>.jpg`` in the images folder, skipping frames whose image is missing;
with a mask folder, bind ``<ts>.png``. Timestamps are formatted like C++
``std::to_string`` (6 fixed decimals). Host-side numpy only.

Also hosts the mask-timestamp matcher, the job of
`src/extractMaskImg.py:14-43` (copy each mask PNG to the nearest odometry
timestamp within 0.5 s).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..io import odometry as odom_io
from ..io.odometry import Trajectory


@dataclass
class FrameRecord:
    """Host-side per-frame record; analogue of ``FrameData``
    (`include/FrameData.hpp:89-126`)."""

    timestamp: float
    image_path: str
    position: np.ndarray
    quat_wxyz: np.ndarray
    mask_path: Optional[str] = None


def cpp_timestamp(ts: float) -> str:
    """C++ ``std::to_string(double)`` formatting: fixed, 6 decimals."""
    return f"{ts:.6f}"


def load_frames(
    odometry_path: str,
    images_folder: str,
    mask_folder: str = "",
    image_ext: str = ".jpg",
    mask_ext: str = ".png",
) -> List[FrameRecord]:
    traj = odom_io.read(odometry_path)
    frames: List[FrameRecord] = []
    for i in range(len(traj)):
        ts = float(traj.times[i])
        img = os.path.join(images_folder, cpp_timestamp(ts) + image_ext)
        if not os.path.exists(img):
            continue  # reference skips silently (:984-987)
        mask = None
        if mask_folder:
            # Bound unconditionally, as the reference does (:776-781).
            mask = os.path.join(mask_folder, cpp_timestamp(ts) + mask_ext)
        frames.append(
            FrameRecord(
                timestamp=ts,
                image_path=img,
                position=np.asarray(traj.positions[i]),
                quat_wxyz=np.asarray(traj.quats_wxyz[i]),
                mask_path=mask,
            )
        )
    return frames


def frames_trajectory(frames: List[FrameRecord]) -> Trajectory:
    return Trajectory(
        times=np.asarray([f.timestamp for f in frames]),
        positions=np.stack([f.position for f in frames]).astype(np.float32),
        quats_wxyz=np.stack([f.quat_wxyz for f in frames]).astype(np.float32),
    )


def match_masks_to_timestamps(
    mask_folder: str,
    odometry_path: str,
    output_folder: str,
    tolerance: float = 0.5,
) -> int:
    """Copy mask PNGs to the nearest odometry timestamp within ``tolerance``
    seconds, named ``<ts>.png`` (`src/extractMaskImg.py:14-43`). Returns the
    number of masks matched."""
    traj = odom_io.read(odometry_path)
    times = np.asarray(traj.times, np.float64)
    os.makedirs(output_folder, exist_ok=True)
    matched = 0
    for name in sorted(os.listdir(mask_folder)):
        stem, ext = os.path.splitext(name)
        if ext.lower() != ".png":
            continue
        try:
            ts = float(stem)
        except ValueError:
            continue
        j = int(np.argmin(np.abs(times - ts)))
        if abs(times[j] - ts) <= tolerance:
            dst = os.path.join(output_folder, cpp_timestamp(float(times[j])) + ".png")
            shutil.copyfile(os.path.join(mask_folder, name), dst)
            matched += 1
    return matched
