"""The plain NID objective: the reference that judges a calibration solve.

The normalized information distance of `nid_cost.hpp:24-126`, summed over
keyframes as `visual_camera_calibration.cpp:86-129` sums it: each
keyframe's camera-frame points are moved by the candidate correction,
projected, and every point in the image adds the cubic B-spline weights of
its 4 x 4 pixel window (rows and columns -1..2 around the floored
projection, clamped into the image) to the joint histogram of (its own
intensity bin, each window pixel's image bin); the entropies of the joint
and the two marginals give NID = (H_joint - MI) / H_joint, with
p log(p + 1e-6) terms (`nid_cost.hpp:95-105`). The image marginal is the
joint's sum over point bins and the point marginal counts the points in
the image. Gradients flow through the fractional offsets only: knots,
bins and the gate are constant in the pose.

Every quantity is computed from the benchmark's inputs (camera-frame points,
intensities in [0, 1], validity and the per-pixel bin image), in blocks of
keyframes, in plain PyTorch. ``dtype`` float32 is the reference;
``torch.bfloat16`` is the control, the same arithmetic a precision lower.
"""

from __future__ import annotations

import torch

from . import geometry as g

_SPLINE = [
    [1.0, -3.0, 3.0, -1.0],
    [4.0, 0.0, -6.0, 3.0],
    [1.0, 3.0, 3.0, -3.0],
    [0.0, 0.0, 0.0, 1.0],
]


def spline_weights(s: torch.Tensor) -> torch.Tensor:
    """(...,) offsets in [0, 1) -> (..., 4) uniform cubic B-spline weights."""
    C = torch.tensor(_SPLINE, dtype=s.dtype, device=s.device) / 6.0
    powers = torch.stack([torch.ones_like(s), s, s * s, s * s * s], dim=-1)
    return (powers[..., None, :] * C).sum(-1)


def histograms(intrinsic, distortion, width: int, height: int, q, t, points, intensity, valid,
               bin_image, bins: int = 16, dtype=torch.float32):
    """(joint (K, bins, bins) [point bin, image bin], image marginal (K,
    bins), point marginal (K, bins), points in the image (K,)) of each
    keyframe at the correction (q, t), which may carry a gradient.
    ``points`` (K, N, 3) are in each keyframe's camera frame, ``bin_image``
    (K, H, W) integer bins in [0, bins)."""
    q, t = q.to(dtype), t.to(dtype)
    R = g.quat_to_matrix(q)
    p = points.to(dtype)
    x, y, z = g.transform_xyz(R, t, p[..., 0], p[..., 1], p[..., 2])
    u, v = g.project_xyz(intrinsic, distortion, x, y, z)
    ku = g.to_int32(torch.floor(u.detach())).to(torch.int64)
    kv = g.to_int32(torch.floor(v.detach())).to(torch.int64)
    inl = valid & (ku >= 0) & (ku < width) & (kv >= 0) & (kv < height) & (z.detach() > 0)
    f = inl.to(dtype)
    su = u - ku.to(dtype)
    sv = v - kv.to(dtype)
    bx, by = spline_weights(su), spline_weights(sv)  # (K, N, 4)
    cu = torch.clamp(ku, 0, width - 1)
    cv = torch.clamp(kv, 0, height - 1)
    pb = torch.clamp(g.to_int32(intensity.to(torch.float32) * bins), 0, bins - 1).to(torch.int64)
    k = points.shape[0]
    flat = bin_image.reshape(k, -1)
    # The float32 reference sums its weights in float64: a float32 running
    # sum of a keyframe's 4 million weights into 256 bins drops about 2e-4
    # of them (the port's kernel sums in blocks and drops ~1e-7). The
    # control sums in its own precision.
    acc = torch.float64 if dtype == torch.float32 else dtype
    joint = torch.zeros((k, bins * bins), dtype=acc, device=points.device)
    for dy in range(-1, 3):
        row = torch.clamp(cv + dy, 0, height - 1) * width
        for dx in range(-1, 3):
            col = torch.clamp(cu + dx, 0, width - 1)
            ib = torch.gather(flat, 1, row + col).to(torch.int64)
            w = by[..., dy + 1] * bx[..., dx + 1] * f
            joint = joint.scatter_add(1, pb * bins + ib, w.to(acc))
    joint = joint.reshape(k, bins, bins).to(dtype)  # [point bin, image bin]
    levels = torch.arange(bins, device=points.device)
    hist_points = ((pb[..., None] == levels).to(dtype) * f[..., None]).sum(1)
    return joint, joint.sum(1), hist_points, f.sum(1)


def keyframe_nids(intrinsic, distortion, width: int, height: int, q, t, points, intensity,
                  valid, bin_image, bins: int = 16, dtype=torch.float32) -> torch.Tensor:
    """(K,) NID of each keyframe at (q, t), arguments as :func:`histograms`."""
    joint, hist_image, hist_points, num = histograms(intrinsic, distortion, width, height, q, t,
                                                     points, intensity, valid, bin_image, bins,
                                                     dtype)
    num = torch.clamp(num, min=1.0)

    def entropy(h, dims):
        p = h / num.reshape((-1,) + (1,) * len(dims))
        p = torch.where(p < 0, torch.zeros_like(p), p)
        return -(p * torch.log(p + 1e-6)).sum(dim=dims)

    h_joint = entropy(joint, (1, 2))
    mi = entropy(hist_image, (1,)) + entropy(hist_points, (1,)) - h_joint
    return (h_joint - mi) / torch.clamp(h_joint, min=1e-12)


def nid_sum(intrinsic, distortion, width: int, height: int, q, t, points, intensity, valid,
            bin_image, bins: int = 16, dtype=torch.float32, block: int = 8) -> torch.Tensor:
    """The summed NID over keyframes at (q, t), ``block`` keyframes at a
    time; returned in float32."""
    parts = []
    for a in range(0, points.shape[0], block):
        s = slice(a, a + block)
        parts.append(keyframe_nids(intrinsic, distortion, width, height, q, t, points[s],
                                   intensity[s], valid[s], bin_image[s], bins, dtype).sum())
    return torch.stack(parts).sum().to(torch.float32)
