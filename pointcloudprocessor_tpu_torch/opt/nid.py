"""Normalized Information Distance (NID) photometric objective — the exact
(gather-every-evaluation) objective.

Port of `pointcloudprocessor_tpu/opt/nid.py`, a differentiable rebuild of
the reference's NID cost (`include/vlcal/costs/nid_cost.hpp:24-126`) summed
over keyframes (`visual_camera_calibration.cpp:86-129`). Per evaluation:
project every keyframe's points, gather each point's 4x4 window of image
bins as ONE nibble-packed row of a per-pixel tap table, build the joint
histogram from cubic B-spline weights (`ops/nid_hist`: CUDA kernels K1/K2
on the card, the plain twin on the CPU), then entropies -> NID.

Gradients flow only through the fractional offsets ``s``: knots, image
bins, the point histogram and the inlier gate are detached, the
differentiability structure of the reference (knots via `get_real`,
hpp:61; `hist_points` a plain vector, hpp:49).

The JAX package's `vmap` over keyframes is a written-out leading K
dimension. Its frozen-tap cache (`TapCache`), grouped/streamed gathers and
raster sort are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core import se3
from ..models import camera as cam
from ..ops import nid_hist
from ..ops.nid_hist import spline_weights, unpack_tap_nibbles  # noqa: F401 (API)
from ..utils.numeric import to_int32


def quantize_image(image_gray01: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """Per-pixel intensity bin map (int32), computed once per keyframe."""
    b = torch.clamp(to_int32(image_gray01 * bins), max=bins - 1)
    return torch.clamp(b, min=0)


@dataclass
class NIDKeyframe:
    """Per-keyframe data for the NID objective, batched over a leading
    keyframe axis K on every field.

    points/intensity/valid are fixed-capacity (padded); intensities are
    normalized to [0, 1] (`visual_lidar_data.cpp:87-96`). ``tap_rows`` is the
    (K, H*W, 2) int32 table of :func:`build_tap_table`, built once per solve
    by :func:`prepare_keyframes`.
    """

    points: torch.Tensor  # (K, N, 3) in the keyframe CAMERA frame (pre-correction)
    intensity: torch.Tensor  # (K, N)
    valid: torch.Tensor  # (K, N) bool
    bin_image: torch.Tensor  # (K, H, W) int32
    tap_rows: Optional[torch.Tensor] = None  # (K, H*W, 2) int32 packed nibbles


def _to_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> the int32 with the same bits."""
    w = w & 0xFFFFFFFF
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pack_tap_nibbles(taps: torch.Tensor) -> torch.Tensor:
    """(N, 16) tap values in [0, 16) -> (N, 2) int32, nibble t of word t//8
    at bit 4*(t%8). Requires bins <= 16."""
    t = taps.to(torch.int64)
    words = []
    for c in range(2):
        w = torch.zeros(taps.shape[0], dtype=torch.int64, device=taps.device)
        for j in range(8):
            w = w | (t[:, c * 8 + j] << (4 * j))
        words.append(_to_int32_bits(w))
    return torch.stack(words, dim=-1)


def _tap_word_planes(bin_image: torch.Tensor):
    """(H, W) bin image -> two (H, W) int32 nibble-packed word planes (words
    0/1 of each pixel's 4x4 B-spline window; taps dy=-1..2 outer, dx=-1..2
    inner, edges clamped). 16 shifted ORs, no (H*W, 16) intermediate."""
    h, w = bin_image.shape
    dev = bin_image.device
    rows = torch.clamp(torch.arange(-1, h + 2, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 2, device=dev), 0, w - 1)
    p = bin_image.to(torch.int64)[rows][:, cols]  # edge-padded (H+3, W+3)
    words = [torch.zeros((h, w), dtype=torch.int64, device=dev) for _ in range(2)]
    for t in range(16):
        dy, dx = t // 4 - 1, t % 4 - 1
        tap = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        words[t // 8] = words[t // 8] | (tap << (4 * (t % 8)))
    return _to_int32_bits(words[0]), _to_int32_bits(words[1])


def build_tap_table(bin_image: torch.Tensor) -> torch.Tensor:
    """(H, W) bin image -> (H*W, 2) int32 nibble-packed tap-row table."""
    w0, w1 = _tap_word_planes(bin_image)
    return torch.stack([w0.reshape(-1), w1.reshape(-1)], dim=-1)


def prepare_keyframes(kfs: NIDKeyframe) -> NIDKeyframe:
    """Attach the pose-independent tap tables (one per keyframe). Idempotent;
    called by the optimizer at solve entry."""
    if kfs.tap_rows is not None:
        return kfs
    return replace(
        kfs, tap_rows=torch.stack([build_tap_table(b) for b in kfs.bin_image])
    )


def _project_all(camera: cam.PinholeCamera, T: se3.SE3, kfs: NIDKeyframe):
    """Batched projection over keyframes: (proj (K,N,2), knot (K,N,2) int32,
    inlier (K,N) bool). Knots and gates are pose-constant (detached)."""
    pts_cam = se3.transform_points(T, kfs.points)
    proj = cam.project(camera, pts_cam)
    knot = to_int32(torch.floor(proj.detach()))
    inl = (
        kfs.valid
        & (knot[..., 0] >= 0)
        & (knot[..., 0] < camera.width)
        & (knot[..., 1] >= 0)
        & (knot[..., 1] < camera.height)
        & (pts_cam[..., 2].detach() > 0)
    )
    return proj, knot, inl


def _gather_taps(camera: cam.PinholeCamera, kfs: NIDKeyframe, knot: torch.Tensor):
    """(K, N, 2) knots -> (K, N, 2) packed tap rows: the direct per-point
    row take (`nid.py:513-516`), anchors clipped into the image exactly as
    the JAX package clips them (`nid.py:508-510`)."""
    anchor = torch.clamp(knot[..., 1], 0, camera.height - 1) * camera.width + torch.clamp(
        knot[..., 0], 0, camera.width - 1
    )
    k = kfs.tap_rows.shape[0]
    kf_idx = torch.arange(k, device=anchor.device)[:, None]
    return kfs.tap_rows[kf_idx, anchor.long()]


def _histograms_from_taps(taps, s, bin_pts, inlier_f, bins: int):
    """(hist_joint (K,bins,bins) [point_bin, image_bin], hist_image (K,bins),
    hist_points (K,bins), num (K,)) from already-gathered tap rows — the
    kernel branch of `nid.py:321-333`: the image marginal is the per-point-
    bin sum of the joint, so its pose gradient stays exact."""
    inlier_f = inlier_f.detach()
    hist_joint = nid_hist.joint_histogram(taps, s, bin_pts, inlier_f, bins)
    levels = torch.arange(bins, device=s.device)
    hist_points = torch.sum(
        (bin_pts[..., None] == levels).to(s.dtype) * inlier_f[..., None], dim=-2
    )
    hist_image = torch.sum(hist_joint, dim=-2)
    num = torch.sum(inlier_f, dim=-1)
    return hist_joint, hist_image, hist_points, num


def nid_from_histograms(hist_joint, hist_image, hist_points, num):
    """Entropies -> NID per keyframe (`nid_cost.hpp:95-105`, log(p + 1e-6)).

    Probabilities are clamped to >= 0 with where(p < 0) (`nid.py:882-906`):
    an identity in value and gradient for exact-path histograms, and the
    guard against NaN once the frozen-tap cache extrapolates spline weights.
    Batched over a leading K axis."""
    denom = torch.clamp(num, min=1.0)

    def clamp(p):
        return torch.where(p < 0, torch.zeros_like(p), p)

    pj = clamp(hist_joint / denom[..., None, None])
    pi = clamp(hist_image / denom[..., None])
    pp = clamp(hist_points / denom[..., None])
    H_image = -torch.sum(pi * torch.log(pi + 1e-6), dim=-1)
    H_points = -torch.sum(pp * torch.log(pp + 1e-6), dim=-1)
    H_joint = -torch.sum(pj * torch.log(pj + 1e-6), dim=(-2, -1))
    MI = H_image + H_points - H_joint
    return (H_joint - MI) / torch.clamp(H_joint, min=1e-12)


def multi_nid_loss(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                   kfs: NIDKeyframe, bins: int = 16) -> torch.Tensor:
    """Sum of per-keyframe NIDs — `MultiNIDCost::operator()`
    (`visual_camera_calibration.cpp:94-123`), `nid.py:922-960`."""
    kfs = prepare_keyframes(kfs)
    proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
    s = proj - knot.to(proj.dtype)
    taps = _gather_taps(camera, kfs, knot)
    bin_pts = torch.clamp(to_int32(kfs.intensity * bins), 0, bins - 1)
    losses = nid_from_histograms(
        *_histograms_from_taps(taps, s, bin_pts, inl.to(proj.dtype), bins)
    )
    return torch.sum(losses)
