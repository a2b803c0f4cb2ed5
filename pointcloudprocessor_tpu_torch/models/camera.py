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


def in_image(camera: PinholeCamera, pixels: torch.Tensor) -> torch.Tensor:
    """Bounds mask of pixels (..., 2) with the reference's integer-truncation
    convention (`view_culling.cpp:284-288`; JAX `camera.py:147`)."""
    return in_image_uv(camera, pixels[..., 0], pixels[..., 1])


def undistort(camera: PinholeCamera, pt_d: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Invert plumb_bob distortion of normalized coords (..., 2) by a fixed
    number of fixed-point steps, x <- (x_d - tangential(x)) / radial(x)
    (JAX `camera.py:153-173`; the reference inverts the projection with
    Nelder-Mead, `estimate_fov.cpp:17-34`)."""
    k1, k2, p1, p2, k3 = camera.distortion.unbind(0)
    x = pt_d
    for _ in range(iterations):
        xx, yy = x[..., 0], x[..., 1]
        x2, y2, xy = xx * xx, yy * yy, xx * yy
        r2 = x2 + y2
        r_coeff = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x2)
        dy = p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xy
        x = torch.stack([(pt_d[..., 0] - dx) / r_coeff, (pt_d[..., 1] - dy) / r_coeff], dim=-1)
    return x


def bearing(camera: PinholeCamera, pixels: torch.Tensor) -> torch.Tensor:
    """Unit bearing vectors of pixels (..., 2) (JAX `camera.py:176-183`; the
    reference's `vlcal::estimate_direction`, `estimate_fov.cpp:17-34`)."""
    fx, fy, cx, cy = camera.intrinsic.unbind(0)
    pt_d = torch.stack([(pixels[..., 0] - cx) / fx, (pixels[..., 1] - cy) / fy], dim=-1)
    pt_n = undistort(camera, pt_d)
    d = torch.cat([pt_n, torch.ones_like(pt_n[..., :1])], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def fov(camera: PinholeCamera) -> torch.Tensor:
    """The largest view angle over the probes (0, 0), (W/2, 0), (0, H/2)
    (JAX `camera.py:186-193`, `vlcal::estimate_camera_fov`,
    `estimate_fov.cpp:36-51`)."""
    corners = torch.tensor(
        [[0.0, 0.0], [camera.width / 2.0, 0.0], [0.0, camera.height / 2.0]],
        dtype=torch.float32, device=camera.intrinsic.device,
    )
    dirs = bearing(camera, corners)
    return torch.max(torch.arccos(torch.clamp(dirs[..., 2], -1.0, 1.0)))
