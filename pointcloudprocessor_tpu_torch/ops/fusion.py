"""Multi-view scored color fusion ops (vectorised, fixed shapes).

Port of `pointcloudprocessor_tpu/ops/fusion.py`: the reference's
observation scoring + top-5 blend (`PointCloudProcessor.cpp:557-629`,
`include/PointCloudProcessor.hpp:205-236`). Each point carries a fixed
top-K register (scores + 0xRRGGBB-packed int32 colors, slot axis first)
updated with a replace-min as keyframes stream through. Also the
observation scores, nearest-pixel sampling and the post-fusion local color
smoothing (`smoothColorsWithLocalRegion`), whose search and blend run as
the N1 kernel on the card (`ops/knn.smooth_local_cuda`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.numeric import to_int32


class TopKColors(NamedTuple):
    """Per-point running best-K color observations.

    scores: (K, N) finalScore per slot; empty slots hold -inf.
    rgb:    (K, N) packed int32 colors.
    """

    scores: torch.Tensor
    rgb: torch.Tensor


def pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3) [0,255] colors into 0xRRGGBB int32 (...,)."""
    c = torch.clamp(rgb, 0, 255).to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack 0xRRGGBB int32 (...,) to (..., 3) colors."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(dtype)


def pack_image_rgb(image: torch.Tensor) -> torch.Tensor:
    """Pack an (H, W, 3) uint8 image into a flat (H*W,) 0xRRGGBB int32 array,
    so each per-point color gather fetches one word."""
    im = image.to(torch.int32)
    return ((im[..., 0] << 16) | (im[..., 1] << 8) | im[..., 2]).reshape(-1)


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device: torch divides a CUDA
    tensor by a Python number as a product with its reciprocal (as
    ``ops/zbuffer.cells`` notes), which rounds otherwise than the CPU, the
    JAX package op by op and the C1 kernel."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def init_topk(num_points: int, device, k: int = 5, dtype=torch.float32) -> TopKColors:
    return TopKColors(
        scores=torch.full((k, num_points), float("-inf"), dtype=dtype, device=device),
        rgb=torch.zeros((k, num_points), dtype=torch.int32, device=device),
    )


def update_topk(state: TopKColors, score: torch.Tensor, rgb: torch.Tensor,
                valid: torch.Tensor) -> TopKColors:
    """Insert one candidate observation per point: replace the current min
    slot if the candidate beats it. O(K) vector ops, no sort.

    The slot replaced is the FIRST minimal one, as `jnp.argmin` picks it
    (all slots start at -inf, so ties are the common case): the index is
    taken as the smallest slot number among the minima rather than relying
    on an argmin's tie order."""
    if rgb.ndim == score.ndim + 1:
        rgb = pack_rgb(rgb)
    cand = torch.where(valid, score, float("-inf"))
    k = state.scores.shape[0]
    min_val = torch.amin(state.scores, dim=0)  # (N,)
    slots = torch.arange(k, device=score.device)[:, None]
    min_idx = torch.amin(torch.where(state.scores == min_val, slots, k), dim=0)
    do = cand > min_val
    onehot = (slots == min_idx[None, :]) & do[None, :]
    new_scores = torch.where(onehot, cand[None, :], state.scores)
    new_rgb = torch.where(onehot, rgb[None, :], state.rgb)
    return TopKColors(new_scores, new_rgb)


def blend_topk(state: TopKColors) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-weighted average of the stored top-K observations
    (`smoothColors`, `PointCloudProcessor.cpp:604-631`).

    Returns (rgb (N, 3) in [0, 255], colored (N,) bool)."""
    w = torch.where(torch.isfinite(state.scores), state.scores, 0.0)  # (K, N)
    total = torch.sum(w, dim=0)
    colored = total > 0.0
    inv = 1.0 / torch.clamp(total, min=1e-12)
    r = torch.sum(((state.rgb >> 16) & 0xFF).to(w.dtype) * w, dim=0) * inv
    g = torch.sum(((state.rgb >> 8) & 0xFF).to(w.dtype) * w, dim=0) * inv
    b = torch.sum((state.rgb & 0xFF).to(w.dtype) * w, dim=0) * inv
    return torch.stack([r, g, b], dim=-1), colored


def orientation_score(
    points_camera: torch.Tensor,
    camera_position_world: torch.Tensor | None = None,
    score_floor: float = 0.2,
    reference_compat: bool = False,
) -> torch.Tensor:
    """Viewing-angle score in [floor, 1] (`PointCloudProcessor.hpp:205-220`):
    the cosine of the angle between the viewing ray and the optical axis,
    mapped affinely to [floor, 1]. ``reference_compat`` subtracts the
    world-frame camera position from the camera-frame point, as the
    reference's arithmetic does."""
    if reference_compat and camera_position_world is not None:
        view = points_camera - camera_position_world
    else:
        view = points_camera
    cos = view[..., 2] / torch.clamp(torch.linalg.vector_norm(view, dim=-1), min=1e-12)
    s = (cos + 1.0) * 0.5
    return score_floor + (1.0 - score_floor) * s


def distance_score(points_camera: torch.Tensor, optimal_distance: float = 2.0,
                   score_floor: float = 0.2) -> torch.Tensor:
    """Distance-to-optimum score in [floor, 1] (`PointCloudProcessor.hpp:222-236`:
    |d - 2| / 2, clamped)."""
    d = torch.linalg.vector_norm(points_camera, dim=-1)
    diff = torch.clamp(torch.abs(d - optimal_distance) / optimal_distance, max=1.0)
    return score_floor + (1.0 - score_floor) * (1.0 - diff)


def final_score(points_camera, camera_position_world=None, *, optimal_distance=2.0,
                score_floor=0.2, reference_compat=False) -> torch.Tensor:
    """(orientation + distance) / 2 (`PointCloudProcessor.cpp:588`)."""
    o = orientation_score(points_camera, camera_position_world, score_floor, reference_compat)
    d = distance_score(points_camera, optimal_distance, score_floor)
    return 0.5 * (o + d)


def final_score_xyz(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    rng: torch.Tensor,  # |p| precomputed (shared with the z-buffer cull)
    camera_position_world: torch.Tensor | None = None,
    *,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    reference_compat: bool = False,
) -> torch.Tensor:
    """(orientation + distance) / 2 (`PointCloudProcessor.cpp:588`,
    hpp:205-236). ``reference_compat`` replicates the reference's frame
    mix-up (a world-frame camera position subtracted from a camera-frame
    point)."""
    if reference_compat and camera_position_world is not None:
        vx = x - camera_position_world[0]
        vy = y - camera_position_world[1]
        vz = z - camera_position_world[2]
        vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
        cos = vz / torch.clamp(vn, min=1e-12)
    else:
        cos = z / torch.clamp(rng, min=1e-12)
    o = score_floor + (1.0 - score_floor) * ((cos + 1.0) * 0.5)
    diff = torch.clamp(_divide(torch.abs(rng - optimal_distance), optimal_distance), max=1.0)
    d = score_floor + (1.0 - score_floor) * (1.0 - diff)
    return 0.5 * (o + d)


def gaussian_distance_score(points_camera: torch.Tensor, ideal_distance: float = 2.0,
                            sigma: float = 1.0) -> torch.Tensor:
    """``exp(-(d - ideal)^2 / (2 sigma^2))``, the scoring of the reference's
    secondary colorizer (`src/vlcal/pointColorization.cpp:17-20`)."""
    d = torch.linalg.vector_norm(points_camera, dim=-1)
    return torch.exp(-((d - ideal_distance) ** 2) / (2.0 * sigma * sigma))


def smooth_colors_local_plain(
    points: torch.Tensor,
    rgb: torch.Tensor,
    colored: torch.Tensor,
    radius: float,
    max_neighbors: int = 32,
    bucket_capacity: int = 32,
    chunk_size: int = 65536,
    order: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of :func:`smooth_colors_local`, the JAX package's
    form (fusion.py:196-226): the hash grid, the (N, K) radius search in
    chunks, and the weighted blend. With ``order`` (an (N,) permutation) the
    queries go through the search in that order, chunk by chunk, and their
    colors back to their points: each point's color does not depend on it."""
    from . import knn

    n = points.shape[0]
    grid = knn.build(points, colored, radius, max(2 * n, 1024), bucket_capacity)
    perm = None if order is None else order.long()
    queries = points if perm is None else points[perm]
    idx, dist, ok = knn.chunked_radius_neighbors(
        grid, points, queries, radius, max_neighbors, chunk_size=chunk_size)
    w = torch.where(ok, 1.0 / (1.0 + dist * dist), 0.0)
    neigh_rgb = rgb[torch.clamp(idx, min=0).long()]  # (N, K, 3)
    total = torch.sum(w, dim=1)
    blended = torch.sum(neigh_rgb * w[..., None], dim=1) / torch.clamp(total, min=1e-12)[:, None]
    if perm is not None:
        total = torch.empty_like(total).index_copy_(0, perm, total)
        blended = torch.empty_like(blended).index_copy_(0, perm, blended)
    return torch.where((colored & (total > 0))[:, None], blended, rgb)


def smooth_colors_local(
    points: torch.Tensor,
    rgb: torch.Tensor,
    colored: torch.Tensor,
    radius: float,
    max_neighbors: int = 32,
    bucket_capacity: int = 32,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """Inverse-distance-weighted color smoothing over spatial neighborhoods
    (`smoothColorsWithLocalRegion`, `PointCloudProcessor.cpp:634-703`):
    every colored point becomes the ``1 / (1 + d^2)``-weighted mean of the
    colors of its ``max_neighbors`` nearest colored points within
    ``radius``, itself included at full weight; other points keep their
    color. Returns the new (N, 3) colors.

    CPU tensors take :func:`smooth_colors_local_plain`; CUDA tensors build
    the hash grid with torch ops, its order listing the colored points first
    (``knn.build(valid_first=True)``), and run the search and blend as the N1
    kernel over that schedule (``knn.smooth_local_cuda``, one launch, no
    (N, K) tensor; ``max_neighbors`` at most 32; the colors agree up to f32
    summation order). Any other device raises."""
    from . import knn

    dev = points.device.type
    if dev == "cpu":
        return smooth_colors_local_plain(points, rgb, colored, radius, max_neighbors,
                                         bucket_capacity, chunk_size)
    if dev == "cuda":
        n = points.shape[0]
        grid = knn.build(points, colored, radius, max(2 * n, 1024), bucket_capacity,
                         valid_first=True)
        return knn.smooth_local_cuda(grid, points.contiguous(), rgb.contiguous(), colored,
                                     radius, max_neighbors, grid.order)
    raise NotImplementedError(f"smooth_colors_local: no kernel for device {points.device}")


def sample_nearest(image: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) or (H, W) image at pixel coords with the
    reference's integer truncation (`PointCloudProcessor.cpp:752-753`);
    out-of-range pixels clamp, callers mask."""
    h, w = image.shape[0], image.shape[1]
    u = torch.clamp(to_int32(pixels[..., 0]), 0, w - 1).long()
    v = torch.clamp(to_int32(pixels[..., 1]), 0, h - 1).long()
    return image[v, u]


def hsv_adjust(rgb: torch.Tensor, saturation_scale: float = 1.0,
               brightness_scale: float = 1.0) -> torch.Tensor:
    """Scale HSV saturation/value of RGB [0,255] colors
    (`PointCloudProcessor.cpp:722-741`); the identity at the default scales."""
    if saturation_scale == 1.0 and brightness_scale == 1.0:
        return rgb
    x = _divide(rgb, 255.0)
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    delta = mx - mn
    s = torch.where(mx > 0, delta / torch.clamp(mx, min=1e-12), 0.0)
    s2 = torch.clamp(s * saturation_scale, 0.0, 1.0)
    v2 = torch.clamp(mx * brightness_scale, 0.0, 1.0)
    # Rebuild: each channel = v2 * (1 - s2 * (1 - orig_channel_ratio)).
    ratio = torch.where(
        delta[..., None] > 0,
        (mx[..., None] - x) / torch.clamp(delta[..., None], min=1e-12),
        0.0,
    )
    out = v2[..., None] * (1.0 - s2[..., None] * ratio)
    return torch.clamp(out * 255.0, 0.0, 255.0)
