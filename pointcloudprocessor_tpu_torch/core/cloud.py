"""Structure-of-arrays point cloud with fixed capacity + validity mask.

PyTorch port of `pointcloudprocessor_tpu/core/cloud.py` (reference SoA
container `include/vlcal/common/frame.hpp:63-72`). Filters return the same
capacity with an updated ``valid`` mask; compaction happens at host I/O
boundaries. The shapes stay fixed so both packages agree index for index.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class PointCloud:
    """A (possibly padded) point cloud.

    Attributes:
        points: (N, 3) float32 positions.
        intensity: (N,) float32. Zeros if the source had none.
        valid: (N,) bool. Padding / filtered-out entries are False.
        rgb: optional (N, 3) float32 colors in [0, 255].
        mask_label: optional (N,) int32 segmentation label.
        normals: optional (N, 3) float32.
    """

    points: torch.Tensor
    intensity: torch.Tensor
    valid: torch.Tensor
    rgb: Optional[torch.Tensor] = None
    mask_label: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None

    def count(self) -> int:
        return int(self.valid.sum())

    def replace(self, **changes) -> "PointCloud":
        return dataclasses.replace(self, **changes)


def make(points, device, intensity=None, rgb=None, mask_label=None, normals=None,
         capacity: Optional[int] = None) -> PointCloud:
    """Build a :class:`PointCloud` on ``device`` from host arrays, padding to
    ``capacity`` (padding points at the origin with ``valid=False``)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")

    def pad(arr, dtype):
        arr = np.asarray(arr, dtype=dtype)
        out = np.zeros((cap,) + arr.shape[1:], dtype=dtype)
        out[:n] = arr
        return torch.from_numpy(out).to(device)

    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    return PointCloud(
        points=pad(points, np.float32),
        intensity=pad(
            intensity if intensity is not None else np.zeros((n,), np.float32),
            np.float32,
        ),
        valid=torch.from_numpy(valid).to(device),
        rgb=None if rgb is None else pad(rgb, np.float32),
        mask_label=None if mask_label is None else pad(mask_label, np.int32),
        normals=None if normals is None else pad(normals, np.float32),
    )


def and_valid(cloud: PointCloud, mask: torch.Tensor) -> PointCloud:
    """Narrow the validity mask."""
    return cloud.replace(valid=cloud.valid & mask)


def crop_box(cloud: PointCloud, min_pt: torch.Tensor, max_pt: torch.Tensor) -> PointCloud:
    """Axis-aligned box crop (`pcl::CropBox` at `PointCloudProcessor.cpp:120-125`)."""
    inside = torch.all((cloud.points >= min_pt) & (cloud.points <= max_pt), dim=-1)
    return and_valid(cloud, inside)


def trajectory_crop(cloud: PointCloud, traj_positions: torch.Tensor,
                    padding: float = 2.0) -> PointCloud:
    """Crop to the trajectory bounding box inflated by ``padding`` metres
    (`PointCloudProcessor.cpp:94-125`)."""
    mn = torch.amin(traj_positions, dim=0) - padding
    mx = torch.amax(traj_positions, dim=0) + padding
    return crop_box(cloud, mn, mx)


def normalize_intensity(cloud: PointCloud) -> PointCloud:
    """Min-max normalize intensities of valid points to [0, 1]
    (`visual_lidar_data.cpp:87-96`)."""
    big = torch.tensor(float("inf"), dtype=cloud.intensity.dtype, device=cloud.intensity.device)
    mn = torch.amin(torch.where(cloud.valid, cloud.intensity, big))
    mx = torch.amax(torch.where(cloud.valid, cloud.intensity, -big))
    rng = torch.clamp(mx - mn, min=1e-12)
    return cloud.replace(intensity=torch.clamp((cloud.intensity - mn) / rng, 0.0, 1.0))


def compact(cloud: PointCloud) -> PointCloud:
    """Drop invalid rows (on the cloud's device; use at I/O boundaries)."""
    idx = torch.nonzero(cloud.valid, as_tuple=True)[0]

    def take(a):
        return None if a is None else a[idx]

    return PointCloud(
        points=take(cloud.points),
        intensity=take(cloud.intensity),
        valid=torch.ones((idx.numel(),), dtype=torch.bool, device=cloud.valid.device),
        rgb=take(cloud.rgb),
        mask_label=take(cloud.mask_label),
        normals=take(cloud.normals),
    )
