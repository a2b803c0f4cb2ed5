"""2D-3D pose estimation: batched-RANSAC rotation + robust reprojection LSQ.

Port of `pointcloudprocessor_tpu/opt/pnp.py`, the rebuild of
`PoseEstimation::estimate` (`src/vlcal/common/estimate_pose.cpp:20-177`):

1. a rotation-only RANSAC: every hypothesis (two bearing pairs aligned by
   the TRIAD construction) scored in one batch on the device, the best
   taken by ``argmax`` (the reference runs 8192 hypotheses on OpenMP
   threads, :91-131);
2. an SE(3) refinement of the Cauchy-robust reprojection error by IRLS
   Gauss-Newton on the 6-dof left tangent (Ceres in the reference,
   :148-177).

The correspondences number in the tens, so both stages are bound by the
host and its launches; the stage runs once a keyframe that has picks. The
hypothesis pairs come from a ``torch.Generator`` (the JAX package draws them
with ``jax.random``: the two give different pairs from one seed), or as an
explicit (iterations, 2) index array. The residual Jacobian comes from
reverse passes (``torch.func.jacrev``), where JAX takes ``jacfwd``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..models import camera as cam


class PoseEstimationResult(NamedTuple):
    T_camera_target: se3.SE3  # maps target (LiDAR) frame points into the camera
    inliers: torch.Tensor  # (N,) bool from the RANSAC stage
    num_inliers: torch.Tensor  # () int
    final_error: torch.Tensor  # () mean robust reprojection error (px) at the optimum


def _rotation_from_two_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotations R with R @ b_i ~ a_i for the two unit-vector pairs of each
    (..., 2, 3) ``a`` and ``b``: TRIAD alignment (JAX `pnp.py:39-56`, in
    place of the reference's 2-point Umeyama SVD, `estimate_pose.cpp:
    55-83`). Returns (..., 3, 3)."""

    def triad(v):
        t1 = v[..., 0, :]
        t2 = torch.linalg.cross(v[..., 0, :], v[..., 1, :])
        t2 = t2 / torch.clamp(torch.linalg.vector_norm(t2, dim=-1, keepdim=True), min=1e-12)
        t3 = torch.linalg.cross(t1, t2)
        return torch.stack([t1, t2, t3], dim=-1)  # columns

    return triad(a) @ triad(b).transpose(-1, -2)


def _inliers(camera, R, dirs, pixels, valid, error_thresh_px):
    """(..., N) inlier masks of rotations R (..., 3, 3): valid, in front of
    the camera and reprojected within the threshold."""
    rot = dirs @ R.transpose(-1, -2)  # (..., N, 3) camera-frame directions
    err = torch.linalg.vector_norm(cam.project(camera, rot) - pixels, dim=-1)
    return valid & (rot[..., 2] > 0) & (err < error_thresh_px)


def estimate_rotation_ransac(
    camera: cam.PinholeCamera,
    pixels: torch.Tensor,
    points_3d: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_iterations: int = 8192,
    error_thresh_px: float = 5.0,
    pairs: Optional[torch.Tensor] = None,
) -> tuple[se3.SE3, torch.Tensor]:
    """Rotation-only RANSAC over bearing pairs (`estimate_pose.cpp:40-145`,
    JAX `pnp.py:59-104`): (rotation as an SE3 with t = 0, its inlier mask).

    ``pairs`` (iterations, 2) are the hypotheses' correspondence indices;
    None draws ``num_iterations`` of them uniformly from ``generator`` (a
    CPU generator). Pairs on invalid rows are re-mapped to index 0, and
    invalid correspondences never vote. All hypotheses are scored in one
    batch; the first of the best scores wins, as under ``jnp.argmax``."""
    n = pixels.shape[0]
    device = pixels.device
    bearings = cam.bearing(camera, pixels)  # (N, 3)
    dirs = points_3d / torch.clamp(
        torch.linalg.vector_norm(points_3d, dim=-1, keepdim=True), min=1e-12)
    if pairs is None:
        pairs = torch.randint(0, n, (num_iterations, 2), generator=generator)
    idx = pairs.to(device=device, dtype=torch.int64)
    idx = torch.where(valid[idx], idx, 0)
    Rs = _rotation_from_two_pairs(bearings[idx], dirs[idx])  # (I, 3, 3)
    scores = torch.sum(_inliers(camera, Rs, dirs, pixels, valid, error_thresh_px), dim=-1)
    R_best = Rs[torch.argmax(scores)]
    inliers = _inliers(camera, R_best, dirs, pixels, valid, error_thresh_px)
    return se3.SE3(se3.matrix_to_quat(R_best), torch.zeros(3, dtype=pixels.dtype,
                                                           device=device)), inliers


def _reprojection_residuals(tangent, T0: se3.SE3, camera, pixels, points_3d):
    T = se3.compose(se3.exp(tangent), T0)
    return cam.project(camera, se3.transform_points(T, points_3d)) - pixels  # (N, 2)


def estimate_pose_lsq(
    camera: cam.PinholeCamera,
    pixels: torch.Tensor,
    points_3d: torch.Tensor,
    valid: torch.Tensor,
    T_init: se3.SE3,
    cauchy_kernel: float = 10.0,
    iterations: int = 20,
) -> tuple[se3.SE3, torch.Tensor]:
    """Full 6-dof robust reprojection refinement (`estimate_pose.cpp:148-177`,
    JAX `pnp.py:107-157`): ``iterations`` IRLS Gauss-Newton steps on
    T = exp(xi) ∘ T_init with Cauchy weights w = 1 / (1 + |r|^2 / k^2).
    Returns (pose, the weighted mean squared error of the last step)."""
    w_valid = valid.to(pixels.dtype)
    eye6 = torch.eye(6, dtype=pixels.dtype, device=pixels.device)
    tangent = torch.zeros(6, dtype=pixels.dtype, device=pixels.device)
    err = torch.zeros((), dtype=pixels.dtype, device=pixels.device)

    def residuals(x):
        return _reprojection_residuals(x, T_init, camera, pixels, points_3d)

    jacobian = torch.func.jacrev(residuals)  # (N, 2, 6): a reverse pass a row, batched
    for _ in range(iterations):
        res = residuals(tangent)
        s2 = torch.sum(res * res, dim=-1)
        w = w_valid / (1.0 + s2 / (cauchy_kernel * cauchy_kernel))
        Jf = jacobian(tangent).reshape(-1, 6)
        wf = torch.repeat_interleave(w, 2)
        H = Jf.T @ (Jf * wf[:, None]) + 1e-6 * eye6
        g = Jf.T @ (res.reshape(-1) * wf)
        delta = torch.linalg.solve(H, -g)
        err = torch.sum(w * s2) / torch.clamp(torch.sum(w_valid), min=1.0)
        tangent = tangent + delta
    return se3.compose(se3.exp(tangent), T_init), err


def estimate_pose(
    camera: cam.PinholeCamera,
    pixels,
    points_3d,
    valid: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_ransac_iterations: int = 8192,
    error_thresh_px: float = 5.0,
    cauchy_kernel: float = 10.0,
    lsq_iterations: int = 20,
    pairs: Optional[torch.Tensor] = None,
) -> PoseEstimationResult:
    """RANSAC init + LSQ refine, `PoseEstimation::estimate`
    (`estimate_pose.cpp:20-38`, JAX `pnp.py:160-192`), on the camera's
    device. Needs >= 3 correspondences (the GUI's gate,
    `initial_guess_manual.hpp:61-72`). ``generator`` None seeds one with
    8192, the JAX package's default key's seed."""
    device = camera.intrinsic.device
    pixels, points_3d = (
        torch.as_tensor(x if isinstance(x, torch.Tensor) else np.array(x, np.float32),
                        dtype=torch.float32, device=device).reshape(-1, c)
        for x, c in ((pixels, 2), (points_3d, 3)))
    if valid is None:
        valid = torch.ones(pixels.shape[0], dtype=torch.bool, device=device)
    if generator is None and pairs is None:
        generator = torch.Generator().manual_seed(8192)
    T_rot, inliers = estimate_rotation_ransac(
        camera, pixels, points_3d, valid, generator, num_iterations=num_ransac_iterations,
        error_thresh_px=error_thresh_px, pairs=pairs,
    )
    T, err = estimate_pose_lsq(camera, pixels, points_3d, inliers, T_rot,
                               cauchy_kernel=cauchy_kernel, iterations=lsq_iterations)
    return PoseEstimationResult(T_camera_target=T, inliers=inliers,
                                num_inliers=torch.sum(inliers.to(torch.int32)), final_error=err)
