"""Projective colorization + multi-view fusion.

Port of `pointcloudprocessor_tpu/pipeline/colorize.py`, itself a rebuild of
`pcdColorizationAndSmooth` (`PointCloudProcessor.cpp:474-631`): per
keyframe, transform the map into the camera, z-buffer cull, sample the
packed image (and the mask label), score, and update the per-point top-K
registers. The JAX package's `lax.scan` over keyframes is a Python loop
here; the registers (and, with masks, the best score and its label) are the
only state carried from one keyframe to the next.

``culling_method`` selects the visibility test as the refine path's
`CullingConfig.method` does: the reference colorizes through the same
`ViewCulling::cull` (`PointCloudProcessor.cpp:527`), qhull HPR on its active
path, so with "hpr" each keyframe's mask is the HPR mask (`ops/hpr.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..models import camera as cam
from ..ops import fusion, hpr, zbuffer
from ..utils.numeric import to_int32


class KeyframeObservation(NamedTuple):
    """Per-point observation of one keyframe, aligned with the map cloud."""

    points_camera: torch.Tensor  # (N, 3)
    pixels: torch.Tensor  # (N, 2)
    visible: torch.Tensor  # (N,) bool
    rgb_packed: torch.Tensor  # (N,) int32 0xRRGGBB
    score: torch.Tensor  # (N,) finalScore
    label: Optional[torch.Tensor] = None  # (N,) int32 mask label


def observe_keyframe(
    camera: cam.PinholeCamera,
    image_rgb: torch.Tensor,  # (H, W, 3) uint8
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    mask_image: Optional[torch.Tensor] = None,  # (H, W) int32
    camera_position_world: Optional[torch.Tensor] = None,
    *,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
) -> KeyframeObservation:
    """Project the map into one keyframe: cull (the z-buffer, or HPR with
    ``culling_method="hpr"``), sample colors (and the mask label), score
    (`PointCloudProcessor.cpp:495-591`). The HPR branch gates on the
    unfloored pixel coordinates, as the JAX package's does
    (colorize.py:95-109)."""
    x, y, z = se3.transform_xyz(
        T_camera_world, points_world[:, 0], points_world[:, 1], points_world[:, 2]
    )
    rng = torch.sqrt(x * x + y * y + z * z)
    u, v = cam.project_xyz(camera, x, y, z)
    if culling_method == "hpr":
        gate = (valid & (z > 0.0) & (u >= 0) & (u < camera.width)
                & (v >= 0) & (v < camera.height))
        vis = hpr.mask(torch.stack([x, y, z], dim=-1), gate, hpr_radius, hpr_tolerance,
                       hpr_impl, hpr_dense_cutoff)
    elif culling_method == "zbuffer":
        vis = zbuffer.cull_mask_uv(
            camera, u, v, z, rng, valid,
            downsample_factor=downsample_factor, depth_epsilon=depth_epsilon,
        )
    else:
        raise ValueError(f"culling.method must be 'zbuffer' or 'hpr', got {culling_method!r}")

    h, w = image_rgb.shape[0], image_rgb.shape[1]
    ui = torch.clamp(to_int32(u), 0, w - 1)
    vi = torch.clamp(to_int32(v), 0, h - 1)
    flat = (vi * w + ui).long()
    # Nearest sampling commutes with the per-pixel HSV map, so the samples
    # are adjusted, not the image (12x fewer values at 4096x3000 / 1M pts).
    rgb_packed = fusion.pack_image_rgb(image_rgb)[flat]
    if saturation_scale != 1.0 or brightness_scale != 1.0:
        rgb_packed = fusion.pack_rgb(
            fusion.hsv_adjust(
                fusion.unpack_rgb(rgb_packed), saturation_scale, brightness_scale
            )
        )
    score = fusion.final_score_xyz(
        x, y, z, rng,
        camera_position_world,
        optimal_distance=optimal_distance,
        score_floor=score_floor,
        reference_compat=reference_compat_orientation,
    )
    label = None
    if mask_image is not None:
        label = mask_image.reshape(-1)[flat].to(torch.int32)
    pixels = torch.stack([u, v], dim=-1)
    pts_cam = torch.stack([x, y, z], dim=-1)
    return KeyframeObservation(pts_cam, pixels, vis, rgb_packed, score, label)


@torch.no_grad()
def keyframe_rgb_mask(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    image_rgb: torch.Tensor,  # (H, W, 3) uint8
    mask_image: torch.Tensor,  # (H, W) int32
    kf_pose: se3.SE3,  # camera->world
    T_correction: se3.SE3,
    *,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    mask_highlight_value: int = 255,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
):
    """One keyframe's colored + mask-labelled view for the artifact dumps.

    Rebuilds `generateColorMap` + `generateSegmentMap`
    (`PointCloudProcessor.cpp:705-816`) for the per-keyframe
    ``<ts>_rgb-mask.pcd`` files written at :539-546: camera-frame points,
    sampled rgb (label == ``mask_highlight_value`` painted red, :806-811),
    mask label. Returns ``(points_camera (N,3), rgb (N,3), label (N,),
    visible (N,))`` at full map capacity; the caller compacts with
    ``visible``."""
    T_c2w = se3.compose(kf_pose, T_correction)
    obs = observe_keyframe(
        camera,
        image_rgb,
        se3.inverse(T_c2w),
        points_world,
        valid,
        mask_image=mask_image,
        camera_position_world=kf_pose.t,
        downsample_factor=downsample_factor,
        depth_epsilon=depth_epsilon,
        saturation_scale=saturation_scale,
        brightness_scale=brightness_scale,
        culling_method=culling_method,
        hpr_radius=hpr_radius,
        hpr_tolerance=hpr_tolerance,
        hpr_impl=hpr_impl,
        hpr_dense_cutoff=hpr_dense_cutoff,
    )
    rgb = fusion.unpack_rgb(obs.rgb_packed)
    highlight = obs.label == mask_highlight_value
    red = torch.tensor([255.0, 0.0, 0.0], dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(highlight[:, None], red, rgb)
    return obs.points_camera, rgb, obs.label, obs.visible


class FusionResult(NamedTuple):
    rgb: torch.Tensor  # (N, 3) blended color [0,255]
    colored: torch.Tensor  # (N,) bool
    best_label: Optional[torch.Tensor]  # (N,) int32 label of the best observation
    observation_count: torch.Tensor  # (N,) int32


@torch.no_grad()
def fuse(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    images: torch.Tensor,  # (K, H, W, 3) uint8
    kf_poses: se3.SE3,  # batched (K,) camera->world
    T_correction: se3.SE3,  # scalar correction (NID), identity if none
    mask_images: Optional[torch.Tensor] = None,  # (K, H, W) int32
    *,
    top_k: int = 5,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
) -> FusionResult:
    """Colorize the map from all keyframes and blend the top-K observations.

    The correction composes as ``T_c2w_optimized = T_c2w * T_correction``
    (`PointCloudProcessor.cpp:507,516`). ``images`` (and ``mask_images``)
    may live on the host: each keyframe's image is moved to the map's device
    as it is used. With masks, each point keeps the label of its visible
    observation of strictly highest score (`best_label`)."""
    n = points_world.shape[0]
    device = points_world.device
    labelled = mask_images is not None
    topk = fusion.init_topk(n, device, top_k)
    count = torch.zeros((n,), dtype=torch.int32, device=device)
    best_s = torch.full((n,), -torch.inf, dtype=torch.float32, device=device)
    best_l = torch.zeros((n,), dtype=torch.int32, device=device)
    for j in range(images.shape[0]):
        T_c2w = se3.compose(se3.SE3(kf_poses.q[j], kf_poses.t[j]), T_correction)
        obs = observe_keyframe(
            camera,
            images[j].to(device),
            se3.inverse(T_c2w),
            points_world,
            valid,
            mask_image=mask_images[j].to(device) if labelled else None,
            camera_position_world=kf_poses.t[j],
            downsample_factor=downsample_factor,
            depth_epsilon=depth_epsilon,
            optimal_distance=optimal_distance,
            score_floor=score_floor,
            saturation_scale=saturation_scale,
            brightness_scale=brightness_scale,
            reference_compat_orientation=reference_compat_orientation,
            culling_method=culling_method,
            hpr_radius=hpr_radius,
            hpr_tolerance=hpr_tolerance,
            hpr_impl=hpr_impl,
            hpr_dense_cutoff=hpr_dense_cutoff,
        )
        topk = fusion.update_topk(topk, obs.score, obs.rgb_packed, obs.visible)
        if labelled:
            s = torch.where(obs.visible, obs.score, -torch.inf)
            better = s > best_s
            best_s = torch.where(better, s, best_s)
            best_l = torch.where(better, obs.label, best_l)
        count = count + obs.visible.to(torch.int32)
    rgb, colored = fusion.blend_topk(topk)
    return FusionResult(
        rgb=rgb,
        colored=colored & valid,
        best_label=best_l if labelled else None,
        observation_count=count,
    )
