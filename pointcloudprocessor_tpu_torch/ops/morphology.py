"""2D binary morphology for the crack-analytics layer.

Provides the image-processing primitives the reference pulls from
scipy/skimage/plantcv in `PointCloudProcessor/scripts/genNormAndDistanceMask.py`:
Euclidean distance transform (:166-169 uses `scipy.ndimage.distance_transform_edt`),
skeletonization (:175-177 uses `plantcv.morphology.skeletonize`), and the
structure-tensor principal direction of a skeleton neighborhood (:814-872).
plantcv/skimage are not available here, so skeletonization is an in-repo
vectorised Zhang-Suen thinning; EDT delegates to scipy; the structure tensor
is evaluated for ALL query points in one batch instead of per-point crops.

A numpy + scipy copy of `pointcloudprocessor_tpu/ops/morphology.py` (host
code, no device).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """Euclidean distance transform of a binary mask (pixels > 0)."""
    return ndimage.distance_transform_edt(mask > 0)


def _zs_neighbors(img: np.ndarray):
    """P2..P9 neighborhoods (clockwise from north) via padded slicing."""
    p = np.pad(img, 1, mode="constant")
    P2 = p[:-2, 1:-1]
    P3 = p[:-2, 2:]
    P4 = p[1:-1, 2:]
    P5 = p[2:, 2:]
    P6 = p[2:, 1:-1]
    P7 = p[2:, :-2]
    P8 = p[1:-1, :-2]
    P9 = p[:-2, :-2]
    return P2, P3, P4, P5, P6, P7, P8, P9


def skeletonize(mask: np.ndarray, max_iterations: int = 10_000) -> np.ndarray:
    """Zhang-Suen thinning to a 1-px-wide skeleton (uint8 0/255).

    Vectorised: each subiteration evaluates the deletion conditions for every
    pixel at once (the classical formulation; plantcv's `skeletonize` wraps
    skimage's equivalent thinning).
    """
    img = (mask > 0).astype(np.uint8)
    for _ in range(max_iterations):
        changed = False
        for phase in (0, 1):
            P = _zs_neighbors(img)
            B = sum(p.astype(np.int32) for p in P)
            ring = list(P) + [P[0]]
            A = sum(
                ((ring[i] == 0) & (ring[i + 1] == 1)).astype(np.int32)
                for i in range(8)
            )
            P2, P3, P4, P5, P6, P7, P8, P9 = P
            if phase == 0:
                c1 = (P2 * P4 * P6) == 0
                c2 = (P4 * P6 * P8) == 0
            else:
                c1 = (P2 * P4 * P8) == 0
                c2 = (P2 * P6 * P8) == 0
            remove = (img == 1) & (B >= 2) & (B <= 6) & (A == 1) & c1 & c2
            if remove.any():
                img[remove] = 0
                changed = True
        if not changed:
            break
    return img * np.uint8(255)


def gaussian_blur(image: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Gaussian smoothing of a mask/skeleton image — the standalone
    experiment in `scripts/evalSkeletonDirection.py:5-19` (there via
    `cv2.GaussianBlur`) and the pre-smoothing step of
    :func:`structure_tensor_directions`."""
    return ndimage.gaussian_filter(image.astype(np.float64), sigma=sigma)


def structure_tensor_directions(
    image: np.ndarray,
    points_xy: np.ndarray,
    radius: int = 4,
    sigma: float = 3.0,
) -> np.ndarray:
    """Principal-direction normals of ``image`` structure at query pixels.

    Replicates `compute_skeleton_direction`
    (`genNormAndDistanceMask.py:814-872`): Gaussian smooth, Sobel gradients,
    average the structure tensor over a (2r+1)^2 window, take the dominant
    eigenvector, rotate 90 deg. Here gradients and window sums are computed
    once for the whole image (uniform_filter) and gathered at the queries.

    Args:
        points_xy: (M, 2) integer pixel coordinates (x, y).
    Returns:
        (M, 2) unit direction vectors (tangent along the ridge).
    """
    sm = ndimage.gaussian_filter(image.astype(np.float64), sigma=sigma)
    gx = ndimage.sobel(sm, axis=1)
    gy = ndimage.sobel(sm, axis=0)
    size = 2 * radius + 1
    Jxx = ndimage.uniform_filter(gx * gx, size=size)
    Jxy = ndimage.uniform_filter(gx * gy, size=size)
    Jyy = ndimage.uniform_filter(gy * gy, size=size)

    x = np.clip(points_xy[:, 0].astype(np.int64), 0, image.shape[1] - 1)
    y = np.clip(points_xy[:, 1].astype(np.int64), 0, image.shape[0] - 1)
    jxx, jxy, jyy = Jxx[y, x], Jxy[y, x], Jyy[y, x]

    # Dominant eigenvector of [[jxx, jxy], [jxy, jyy]] in closed form.
    diff = jxx - jyy
    disc = np.sqrt(diff * diff + 4.0 * jxy * jxy)
    lam = 0.5 * (jxx + jyy + disc)  # largest eigenvalue
    # Off-diagonal: eigenvector (jxy, lam - jxx). Diagonal tensor: the
    # dominant axis directly. Flat/isotropic: fall back to +x.
    diag = np.abs(jxy) <= 1e-12
    vx = np.where(diag, np.where(jxx >= jyy, 1.0, 0.0), jxy)
    vy = np.where(diag, np.where(jxx >= jyy, 0.0, 1.0), lam - jxx)
    norm = np.hypot(vx, vy)
    vx = np.where(norm > 1e-12, vx / np.maximum(norm, 1e-12), 1.0)
    vy = np.where(norm > 1e-12, vy / np.maximum(norm, 1e-12), 0.0)
    # The reference rotates the principal (gradient) direction by 90 deg to
    # get the ridge tangent (:869-870).
    return np.stack([-vy, vx], axis=-1)


def trace_edges(
    mask: np.ndarray,
    starts_xy: np.ndarray,
    directions: np.ndarray,
    max_steps: int = 4096,
    backoff: int = 3,
) -> np.ndarray:
    """March from each start along its direction until leaving the mask,
    then step ``backoff`` back — `trace_edge`
    (`genNormAndDistanceMask.py:724-762`), batched over all starts.

    Returns (M, 2) integer pixel coordinates.
    """
    h, w = mask.shape
    pos = starts_xy.astype(np.float64).copy()
    d = directions.astype(np.float64)
    active = np.ones(len(pos), bool)
    for _ in range(max_steps):
        xi = np.clip(pos[:, 0].astype(np.int64), 0, w - 1)
        yi = np.clip(pos[:, 1].astype(np.int64), 0, h - 1)
        inside = (
            (pos[:, 0] >= 0) & (pos[:, 0] < w) & (pos[:, 1] >= 0) & (pos[:, 1] < h)
            & (mask[yi, xi] > 0)
        )
        active &= inside
        if not active.any():
            break
        pos[active] += d[active]
    pos -= d * backoff
    return np.clip(pos, [0, 0], [w - 1, h - 1]).astype(np.int64)
