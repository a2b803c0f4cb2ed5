"""Pinhole + plumb_bob camera projection on torch tensors.

PyTorch port of `pointcloudprocessor_tpu/models/camera.py` (reference:
`include/camera/pinhole.hpp:11-67`, `create_camera.cpp:33-49`). Only the
"pinhole" model exists, as in the reference's factory. Projection is an
ordinary differentiable function, so autograd replaces Ceres Jets.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PinholeCamera:
    """Pinhole intrinsics + plumb_bob distortion.

    Attributes:
        intrinsic: (4,) f32 [fx, fy, cx, cy] (`PointCloudProcessor.cpp:62`).
        distortion: (5,) f32 [k1, k2, p1, p2, k3] (`pinhole.hpp:14-19`).
        width, height: image size in pixels.
    """

    intrinsic: torch.Tensor
    distortion: torch.Tensor
    width: int
    height: int


def create_camera(model: str, intrinsic, distortion, width: int, height: int,
                  device) -> PinholeCamera:
    """Factory; parity with `camera::create_camera`."""
    if model != "pinhole":
        raise ValueError(
            f"camera model '{model}' not supported (reference supports only 'pinhole', "
            "create_camera.cpp:33-49)"
        )
    return PinholeCamera(
        intrinsic=torch.as_tensor(intrinsic, dtype=torch.float32, device=device),
        distortion=torch.as_tensor(distortion, dtype=torch.float32, device=device),
        width=int(width),
        height=int(height),
    )


def distort(camera: PinholeCamera, pt: torch.Tensor) -> torch.Tensor:
    """plumb_bob distortion of normalized image coords (..., 2)
    (`pinhole.hpp:13-38`)."""
    k1, k2, p1, p2, k3 = camera.distortion.unbind(0)
    x, y = pt[..., 0], pt[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    t1 = 2.0 * xy
    t2 = r2 + 2.0 * x2
    t3 = r2 + 2.0 * y2
    xd = r_coeff * x + p1 * t1 + p2 * t2
    yd = r_coeff * y + p1 * t3 + p2 * t1
    return torch.stack([xd, yd], dim=-1)


def project_xyz(camera: PinholeCamera, px: torch.Tensor, py: torch.Tensor,
                pz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points given as separate coordinate arrays to
    pixel coordinate arrays ``(u, v)``: divide, distort, apply K. Points
    with z ≈ 0 are guarded against division blow-up; callers gate on z > 0
    (`PointCloudProcessor.cpp:748`)."""
    tiny = torch.where(pz < 0, -1e-9, 1e-9)
    safe_z = torch.where(torch.abs(pz) < 1e-9, tiny, pz)
    x = px / safe_z
    y = py / safe_z
    k1, k2, p1, p2, k3 = camera.distortion.unbind(0)
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = r_coeff * x + p1 * (2.0 * xy) + p2 * (r2 + 2.0 * x2)
    yd = r_coeff * y + p1 * (r2 + 2.0 * y2) + p2 * (2.0 * xy)
    fx, fy, cx, cy = camera.intrinsic.unbind(0)
    return fx * xd + cx, fy * yd + cy


def project_uv(camera: PinholeCamera, points: torch.Tensor):
    """Project camera-frame points (..., 3) to pixel coordinate arrays."""
    return project_xyz(camera, points[..., 0], points[..., 1], points[..., 2])


def project(camera: PinholeCamera, points: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2)
    (`pinhole.hpp:40-51`)."""
    u, v = project_uv(camera, points)
    return torch.stack([u, v], dim=-1)


def in_image_uv(camera: PinholeCamera, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bounds mask with the reference's integer-truncation convention
    (`view_culling.cpp:284-288`)."""
    uf = torch.floor(u)
    vf = torch.floor(v)
    return (uf >= 0) & (uf < camera.width) & (vf >= 0) & (vf < camera.height)
