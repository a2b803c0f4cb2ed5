"""The plain multi-view colorization: the reference that judges a fuse.

`pcdColorizationAndSmooth` (`PointCloudProcessor.cpp:474-631`) written out
keyframe by keyframe in plain PyTorch. For each keyframe: the map moved into
the camera by the corrected pose (camera -> world pose o correction,
inverted; :507), its range and pixel; the cull, either

* the z-buffer of `view_culling.cpp:52-174`: points in front of the camera
  whose floored pixel is in the image fall into ds x ds cells; a point is
  visible where its range is at most its cell's least range plus the depth
  epsilon; or
* the grid form of the hidden-point removal the reference runs
  (`view_culling.cpp:266-334`): points in front of the camera with their
  unfloored pixel in the image go into a 512 x 512 grid of bearings; each
  cell keeps its least range, the grid is eroded by a parabola of curvature
  R along each axis over 16 cells, and a point is visible unless the eroded
  range lies more than the tolerance below its own;

then the nearest pixel's color, the score ((orientation + distance) / 2,
hpp:205-236, each mapped to [floor, 1]) and the top-K register update
(a candidate replaces the first slot holding the least score where it beats
it); at the end the score-weighted blend of the registers (:604-631). The
result is (rgb (N, 3), colored (N,), count (N,) of visible observations).

Divisions by a constant go through a 0-dim tensor, so they are IEEE
divisions on every device. ``dtype`` float32 is the reference;
``torch.bfloat16`` is the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry as g

GRID, WINDOW = 512, 16


def views(kf_q, kf_t, corr_q, corr_t):
    """(R (K, 3, 3), t (K, 3), camera positions (K, 3)) of the keyframes'
    world -> camera transforms after the correction."""
    q, t = g.inverse(g.compose((kf_q, kf_t), (corr_q, corr_t)))
    return g.quat_to_matrix(q), t, kf_t


def _hpr_grid(x, y, z, gate, radius: float, tolerance: float):
    """Visibility by the grid hull test of one view's camera-frame points."""
    dt, dev = x.dtype, x.device
    big = torch.finfo(dt).max
    r = torch.sqrt(x * x + y * y + z * z)
    ok = gate & (z > 1e-9) & (r > 1e-9)
    zz = torch.clamp(z, min=1e-9)
    ax = torch.where(ok, x / zz, 0.0)
    ay = torch.where(ok, y / zz, 0.0)
    lo_x = torch.amin(torch.where(ok, ax, torch.inf))
    hi_x = torch.amax(torch.where(ok, ax, -torch.inf))
    lo_y = torch.amin(torch.where(ok, ay, torch.inf))
    hi_y = torch.amax(torch.where(ok, ay, -torch.inf))
    g_t = torch.full((), GRID, dtype=dt, device=dev)
    cu = torch.clamp((hi_x - lo_x) / g_t, min=1e-9)
    cv = torch.clamp((hi_y - lo_y) / g_t, min=1e-9)
    iu = torch.clamp(g.to_int32((ax - lo_x) / cu), 0, GRID - 1)
    iv = torch.clamp(g.to_int32((ay - lo_y) / cv), 0, GRID - 1)
    cell = torch.where(ok, iv * GRID + iu, GRID * GRID)
    zmin = torch.full((GRID * GRID + 1,), big, dtype=dt, device=dev)
    zmin.scatter_reduce_(0, cell.long(), torch.where(ok, r, big), reduce="amin")
    m = zmin[: GRID * GRID].reshape(GRID, GRID)
    for axis, step in ((0, cv), (1, cu)):
        pad = (WINDOW, WINDOW, 0, 0) if axis == 1 else (0, 0, WINDOW, WINDOW)
        mp = F.pad(m, pad, value=big)
        best = torch.full_like(m, big)
        for k in range(2 * WINDOW + 1):
            off = (k - WINDOW) * step
            best = torch.minimum(best, mp.narrow(axis, k, m.shape[axis]) + radius * (off * off))
        m = best
    eroded = m.reshape(-1)[torch.clamp(cell, max=GRID * GRID - 1).long()]
    return ok & ~(eroded < r - tolerance)


def _zbuffer(width, height, u, v, z, rng, valid, ds: int, eps: float):
    """(visible, gated in) by the z-buffer of one view."""
    gw, gh = width // ds, height // ds
    uf, vf = torch.floor(u), torch.floor(v)
    ok = valid & (z > 0.0) & (uf >= 0) & (uf < width) & (vf >= 0) & (vf < height)
    div = torch.full((), ds, dtype=u.dtype, device=u.device)
    ui = torch.clamp(g.to_int32(u / div), 0, gw - 1)
    vi = torch.clamp(g.to_int32(v / div), 0, gh - 1)
    cell = torch.where(ok, vi * gw + ui, gw * gh).long()
    big = torch.finfo(rng.dtype).max
    buf = torch.full((gw * gh + 1,), big, dtype=rng.dtype, device=rng.device)
    buf.scatter_reduce_(0, cell, torch.where(ok, rng, big) + 0.0, reduce="amin")
    buf[gw * gh] = big
    return ok & (rng <= buf[cell] + eps), ok


def fuse(camera: dict, points, valid, images, kf_q, kf_t, corr_q, corr_t, fusion: dict,
         culling: dict, dtype=torch.float32, stats: list | None = None):
    """(rgb (N, 3), colored (N,), count (N,) int32) of the map ``points``
    (N, 3) colored from ``images`` (K, H, W, 3) uint8 at the camera ->
    world poses (kf_q, kf_t) (K,) with the correction (corr_q, corr_t).
    ``camera`` holds intrinsic (4,), distortion (5,), width and height;
    ``fusion`` top_k, optimal_distance, score_floor; ``culling`` method
    ("zbuffer" or "hpr"), downsample_factor, depth_epsilon,
    hidden_points_removal_max_z, hpr_tolerance. With ``stats`` a list,
    one dict a keyframe is appended: points valid and in front, gated in,
    visible, slots replaced and distinct pixels whose sample a slot took."""
    dev = points.device
    n = points.shape[0]
    w, h = camera["width"], camera["height"]
    R, t, _ = views(kf_q.to(dtype), kf_t.to(dtype), corr_q.to(dtype), corr_t.to(dtype))
    p = points.to(dtype)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    k_top = fusion["top_k"]
    sf, od = fusion["score_floor"], fusion["optimal_distance"]
    scores = torch.full((k_top, n), float("-inf"), dtype=dtype, device=dev)
    rgb_reg = torch.zeros((k_top, n), dtype=torch.int32, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    slots = torch.arange(k_top, device=dev)[:, None]
    for j in range(images.shape[0]):
        x, y, z = g.transform_xyz(R[j], t[j], px, py, pz)
        rng = torch.sqrt(x * x + y * y + z * z)
        u, v = g.project_xyz(camera["intrinsic"], camera["distortion"], x, y, z)
        if culling["method"] == "zbuffer":
            vis, gated = _zbuffer(w, h, u, v, z, rng, valid, culling["downsample_factor"],
                                  culling["depth_epsilon"])
        elif culling["method"] == "hpr":
            gated = valid & (z > 0.0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            vis = _hpr_grid(x, y, z, gated, culling["hidden_points_removal_max_z"],
                            culling["hpr_tolerance"])
        else:
            raise ValueError(f"culling method {culling['method']!r}")
        ui = torch.clamp(g.to_int32(u), 0, w - 1)
        vi = torch.clamp(g.to_int32(v), 0, h - 1)
        flat = (vi * w + ui).long()
        im = images[j].to(torch.int32)
        packed = ((im[..., 0] << 16) | (im[..., 1] << 8) | im[..., 2]).reshape(-1)[flat]
        cos = z / torch.clamp(rng, min=1e-12)
        o = sf + (1.0 - sf) * ((cos + 1.0) * 0.5)
        diff = torch.clamp(g.divide(torch.abs(rng - od), od), max=1.0)
        d = sf + (1.0 - sf) * (1.0 - diff)
        score = 0.5 * (o + d)
        cand = torch.where(vis, score, float("-inf"))
        min_val = torch.amin(scores, dim=0)
        min_idx = torch.amin(torch.where(scores == min_val, slots, k_top), dim=0)
        onehot = (slots == min_idx[None, :]) & (cand > min_val)[None, :]
        if stats is not None:
            took = onehot.any(0)
            stats.append({
                "front": int((valid & (z > 0)).sum()), "gated": int(gated.sum()),
                "visible": int(vis.sum()), "replaced": int(onehot.sum()),
                "pixels": int(torch.unique(flat[took]).numel())})
        scores = torch.where(onehot, cand[None, :], scores)
        rgb_reg = torch.where(onehot, packed[None, :], rgb_reg)
        count = count + vis.to(torch.int32)
    wgt = torch.where(torch.isfinite(scores), scores, 0.0)
    total = torch.sum(wgt, dim=0)
    inv = 1.0 / torch.clamp(total, min=1e-12)
    rgb = torch.stack([torch.sum(((rgb_reg >> s) & 0xFF).to(wgt.dtype) * wgt, dim=0) * inv
                       for s in (16, 8, 0)], dim=-1)
    return rgb.to(torch.float32), (total > 0.0) & valid, count
