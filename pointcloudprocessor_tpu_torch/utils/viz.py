"""Headless visualization: LiDAR-image overlays and cloud renders.

Port of `pointcloudprocessor_tpu/utils/viz.py`, the rebuild of the
reference's L7 viewer stack for display-less hosts:

- :func:`overlay_intensity` — the `PointsColorUpdater` live recoloring
  (`PointCloudProcessor/src/vlcal/common/points_color_updater.cpp:37-61`:
  project each point with the current transform, color by
  TURBO(intensity), alpha-blend over the camera image) as torch ops on the
  device of its inputs; any pose or blend renders as one call.
- :func:`render_cloud` — `PointCloudProcessor::visualizePointCloud`
  (`src/PointCloudProcessor.cpp:1077-1102`, an interactive PCL viewer) as a
  matplotlib scatter snapshot (host code).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..models import camera as cam
from ..utils.numeric import to_int32
from . import colormap


def overlay_intensity(
    camera: cam.PinholeCamera,
    image_rgb: torch.Tensor,  # (H, W, 3) uint8/float
    points: torch.Tensor,  # (N, 3)
    intensity: torch.Tensor,  # (N,) in [0, 1]
    valid: torch.Tensor,  # (N,)
    T_camera_points: Optional[se3.SE3] = None,
    blend: float = 0.65,
    point_radius: int = 1,
) -> torch.Tensor:
    """Blend TURBO-colored projected points over the image; returns (H, W, 3)
    float32 in [0, 255] on the inputs' device. ``blend`` is the slider of the
    reference GUI (`visual_lidar_visualizer.cpp:39-78`).

    Each offset of the point footprint (``point_radius``) blends every
    point's color over the image as it stands before that offset, and
    writes it at the point's pixel. Where points share a pixel, the one of
    largest index wins: the JAX package's ``.at[idx].set`` keeps the last
    update of a duplicate index on the CPU, while ``index_put_`` on CUDA
    keeps an unspecified one, so the winners are chosen explicitly
    (``scatter_reduce`` amax of the point index) and only they are written.
    The blend weights are Python floats, ``1 - blend`` taken in f64 and
    rounded to f32 with the tensor op, as the JAX function computes them run
    op by op (under ``jax.jit`` XLA contracts the blend and TURBO's
    polynomial into fused multiply-adds, a few f32 ulps away)."""
    if T_camera_points is not None:
        points = se3.transform_points(T_camera_points, points)
    dev = points.device
    h, w = camera.height, camera.width
    px = cam.project(camera, points)
    ok = valid & (points[..., 2] > 0) & cam.in_image(camera, px)
    u = torch.clamp(to_int32(px[:, 0]), 0, w - 1).long()
    v = torch.clamp(to_int32(px[:, 1]), 0, h - 1).long()
    color = colormap.turbo(intensity) * 255.0

    hw = h * w
    out = image_rgb.to(torch.float32).reshape(hw, 3).clone()
    order = torch.arange(points.shape[0], dtype=torch.int64, device=dev)
    for dy in range(-point_radius + 1, point_radius):
        for dx in range(-point_radius + 1, point_radius):
            uu = torch.clamp(u + dx, 0, w - 1)
            vv = torch.clamp(v + dy, 0, h - 1)
            idx = torch.where(ok, vv * w + uu, hw)
            base = out[torch.clamp(idx, max=hw - 1)]
            blended = base * (1.0 - blend) + color * blend
            winner = torch.full((hw + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
                0, idx, order, reduce="amax")
            wins = ok & (winner[idx] == order)
            out[idx[wins]] = blended[wins]
    return out.reshape(h, w, 3)


def save_overlay_png(path: str, overlay) -> None:
    import cv2

    arr = np.clip(np.asarray(overlay.cpu() if torch.is_tensor(overlay) else overlay),
                  0, 255).astype(np.uint8)
    cv2.imwrite(path, arr[:, :, ::-1])  # RGB -> BGR


def render_cloud(
    path: str,
    points: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    intensity: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    max_points: int = 300_000,
    views=(("top (x-y)", 0, 1), ("front (x-z)", 0, 2)),
) -> None:
    """Scatter-render the cloud to PNG (colored by RGB, else TURBO
    intensity, else depth). Host code."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    if valid is not None:
        keep = np.asarray(valid)
        pts = pts[keep]
        rgb = None if rgb is None else np.asarray(rgb)[keep]
        intensity = None if intensity is None else np.asarray(intensity)[keep]
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
        rgb = None if rgb is None else rgb[sel]
        intensity = None if intensity is None else intensity[sel]

    if rgb is not None:
        c = np.clip(np.asarray(rgb) / 255.0, 0, 1)
    elif intensity is not None:
        c = colormap.turbo(torch.as_tensor(np.asarray(intensity), dtype=torch.float32)).numpy()
    else:
        z = pts[:, 2]
        rng = max(z.max() - z.min(), 1e-9)
        c = colormap.turbo(torch.as_tensor((z - z.min()) / rng, dtype=torch.float32)).numpy()

    fig, axes = plt.subplots(1, len(views), figsize=(7 * len(views), 6))
    axes = np.atleast_1d(axes)
    for ax, (title, i, j) in zip(axes, views):
        ax.scatter(pts[:, i], pts[:, j], s=0.2, c=c, rasterized=True)
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
