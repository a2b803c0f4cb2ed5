"""Occlusion culling as a scatter-min z-buffer — fixed shapes, mask output.

Port of `pointcloudprocessor_tpu/ops/zbuffer.py`, the reference's z-buffer
depth-culling design (`view_culling.cpp:52-174`: 14x downsampled cells at
:63, 0.05 m depth epsilon at :157). It returns a mask over the ORIGINAL
point indices, which removes the reference's kd-tree re-association.

The JAX package leaves this to XLA (no Pallas kernel); here it is plain
torch: ``scatter_reduce_(..., "amin")`` into a (W/ds)*(H/ds)+1 buffer whose
last cell is a sink for invalid points.
"""

from __future__ import annotations

import torch

from ..core import se3
from ..models import camera as cam
from ..utils.numeric import to_int32


def cull_mask_uv(
    camera: cam.PinholeCamera,
    u: torch.Tensor,  # (N,) pixel u of each point
    v: torch.Tensor,  # (N,) pixel v
    z: torch.Tensor,  # (N,) camera-frame depth
    rng: torch.Tensor,  # (N,) camera-frame range |p|
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> torch.Tensor:
    """Visibility mask from per-point projections (`view_culling.cpp:52-174`):
    z > 0 (:76-80), in image (:90-94), then keep points whose range is within
    ``depth_epsilon`` of their cell's minimum (:100-171)."""
    ds = int(downsample_factor)
    grid_w = camera.width // ds
    grid_h = camera.height // ds

    ok = valid & (z > 0.0) & cam.in_image_uv(camera, u, v)
    ui = torch.clamp(to_int32(u / ds), 0, grid_w - 1)
    vi = torch.clamp(to_int32(v / ds), 0, grid_h - 1)
    cell = vi * grid_w + ui

    big = torch.finfo(rng.dtype).max
    rng_masked = torch.where(ok, rng, big)
    # Invalid points scatter to a sink cell so they never shadow real ones.
    cell_masked = torch.where(ok, cell, grid_w * grid_h).long()

    zmin = torch.full((grid_w * grid_h + 1,), big, dtype=rng.dtype, device=rng.device)
    zmin.scatter_reduce_(0, cell_masked, rng_masked, reduce="amin", include_self=True)
    cell_min = zmin[cell_masked]
    return ok & (rng <= cell_min + depth_epsilon)


def cull_mask(
    camera: cam.PinholeCamera,
    points_camera: torch.Tensor,
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> torch.Tensor:
    """Visibility mask for camera-frame points (N, 3) (see :func:`cull_mask_uv`)."""
    u, v = cam.project_uv(camera, points_camera)
    x, y, z = points_camera.unbind(-1)
    rng = torch.sqrt(x * x + y * y + z * z)
    return cull_mask_uv(camera, u, v, z, rng, valid, downsample_factor, depth_epsilon)


def cull_world_points(
    camera: cam.PinholeCamera,
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform world points into the camera frame and cull; returns
    (points_camera, visibility_mask) (`PointCloudProcessor.cpp:186-207`)."""
    pts_cam = se3.transform_points(T_camera_world, points_world)
    mask = cull_mask(camera, pts_cam, valid, downsample_factor, depth_epsilon)
    return pts_cam, mask
