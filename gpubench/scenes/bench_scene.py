"""The benchmark's scenes: bench.py's two synthetic scenes, widened to a
pass of many keyframes.

A frozen copy of the port's `tools/bench_scene.py` generator (itself
`bench.py:60-254`), kept here so that later changes to the program cannot
change the yardstick, and widened: the wall spans every keyframe's view,
however many there are, at bench.py's density.

Scene 1: a textured wall at z = 6 m and an occluding slab at z = 2.5 m
holding 1/8 of the points. Scene 2 slopes the wall in depth (z = 6 + 0.35 x),
gives it a broader texture, moves the occluder to z = 3 m on the left and
pitches the keyframes as well as yawing them. The keyframes step along +x
(``spacing_m`` apart) and yaw linearly from -``yaw_deg`` to ``yaw_deg``
(and pitch from -``pitch_deg`` to ``pitch_deg``).

The map and its intensities are drawn with numpy from the seed; the images
are ray-cast on the device; the calibration keyframes are culled
analytically as `bench.py:223-254` culls them, with priorities drawn on the
device from the seed. Everything is a function of (scene parameters, seed,
device), and repeats bit for bit on one device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..reference import geometry as g


def field_wall(mod, x, y):
    return mod.clip(0.5 + 0.25 * mod.sin(7.0 * x) + 0.25 * mod.cos(9.0 * y), 0.0, 1.0)


def field_occ(mod, x, y):
    return mod.clip(0.5 + 0.25 * mod.sin(13.0 * x + 1.0) + 0.25 * mod.cos(11.0 * y + 2.0),
                    0.0, 1.0)


def field_wall2(mod, x, y):
    return mod.clip(0.5 + 0.18 * mod.sin(5.2 * x + 0.7) + 0.12 * mod.cos(11.7 * y)
                    + 0.10 * mod.sin(23.0 * x + 3.0 * y) + 0.05 * mod.cos(41.0 * y + 1.0),
                    0.0, 1.0)


def field_occ2(mod, x, y):
    return mod.clip(0.5 + 0.2 * mod.sin(17.0 * x) + 0.2 * mod.cos(8.0 * y + 0.5), 0.0, 1.0)


class Geometry(NamedTuple):
    slope: float  # the wall's depth z = wall_z + slope * x
    wall_z: float
    occ_z: float
    occ_x: tuple
    occ_y: tuple
    field_wall: object
    field_occ: object


GEOMETRY = {
    1: Geometry(0.0, 6.0, 2.5, (0.3, 1.5), (-0.6, 0.6), field_wall, field_occ),
    2: Geometry(0.35, 6.0, 3.0, (-1.6, -0.4), (-0.5, 0.7), field_wall2, field_occ2),
}


def trajectory(sc: dict):
    """(quats (K, 4) wxyz, positions (K, 3)) f32 numpy: camera -> world
    poses stepping along +x, q = qy(yaw) qx(pitch) (`bench.py:137-148`)."""
    k = sc["keyframes"]
    x = (sc["spacing_m"] * np.arange(k)).astype(np.float32)
    yaw = np.radians(np.linspace(-sc["yaw_deg"], sc["yaw_deg"], k)).astype(np.float32)
    pitch = np.radians(np.linspace(-sc["pitch_deg"], sc["pitch_deg"], k)).astype(np.float32)
    cy_, sy_ = np.cos(yaw / 2), np.sin(yaw / 2)
    cx_, sx_ = np.cos(pitch / 2), np.sin(pitch / 2)
    quats = np.stack([cy_ * cx_, cy_ * sx_, sy_ * cx_, -sy_ * sx_], -1).astype(np.float32)
    positions = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    return quats, positions


def wall_extent(sc: dict):
    """(x0, x1, y0, y1): where the image corners' rays of every keyframe
    meet the wall, widened by the scene's margins."""
    geo = GEOMETRY[sc["kind"]]
    quats, positions = trajectory(sc)
    R = g.quat_to_matrix(torch.from_numpy(quats).double()).numpy()
    f, w, h = sc["focal_px"], sc["width"], sc["height"]
    corners = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [-w / 2, h / 2], [w / 2, h / 2]]) / f
    rays = np.concatenate([corners, np.ones((4, 1))], 1)  # camera frame
    d = np.einsum("kij,cj->kci", R, rays)  # (K, 4, 3) world directions
    o = positions.astype(np.float64)[:, None, :]
    s = (geo.wall_z + geo.slope * o[..., 0] - o[..., 2]) / (d[..., 2] - geo.slope * d[..., 0])
    hit = o + s[..., None] * d
    mx, my = sc["wall_margin_x_m"], sc["wall_margin_y_m"]
    return (float(hit[..., 0].min() - mx), float(hit[..., 0].max() + mx),
            float(hit[..., 1].min() - my), float(hit[..., 1].max() + my))


def scene_map(sc: dict, seed: int):
    """((N, 3) f32 points, (N,) f32 intensities in [0, 1]): 1 - occluder
    share on the wall, the rest on the occluder, uniform in area."""
    geo = GEOMETRY[sc["kind"]]
    rng = np.random.default_rng([seed, 0])
    n = sc["map_points"]
    n_occ = int(round(n * sc["occluder_share"]))
    n_wall = n - n_occ
    x0, x1, y0, y1 = wall_extent(sc)
    wx = rng.uniform(x0, x1, n_wall).astype(np.float32)
    wy = rng.uniform(y0, y1, n_wall).astype(np.float32)
    ox = rng.uniform(geo.occ_x[0], geo.occ_x[1], n_occ).astype(np.float32)
    oy = rng.uniform(geo.occ_y[0], geo.occ_y[1], n_occ).astype(np.float32)
    wz = (geo.wall_z + geo.slope * wx).astype(np.float32)
    points = np.concatenate([np.stack([wx, wy, wz], -1),
                             np.stack([ox, oy, np.full_like(ox, geo.occ_z)], -1)])
    inten = np.concatenate([geo.field_wall(np, wx, wy), geo.field_occ(np, ox, oy)])
    return points.astype(np.float32), inten.astype(np.float32)


def render_gray(sc: dict, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 image from the camera at (q, t), ray-cast off the
    occluder and the wall on q's device (`bench.py:180-206`)."""
    geo = GEOMETRY[sc["kind"]]
    w, h, f = sc["width"], sc["height"], sc["focal_px"]
    dev = q.device
    uu = ((torch.arange(w, dtype=torch.float32, device=dev) - w / 2.0) / f)[None, :]
    vv = ((torch.arange(h, dtype=torch.float32, device=dev) - h / 2.0) / f)[:, None]
    R = g.quat_to_matrix(q)
    dx = uu * R[0, 0] + vv * R[0, 1] + R[0, 2]
    dy = uu * R[1, 0] + vv * R[1, 1] + R[1, 2]
    dz = uu * R[2, 0] + vv * R[2, 1] + R[2, 2]
    s_occ = (geo.occ_z - t[2]) / dz
    hx, hy = t[0] + s_occ * dx, t[1] + s_occ * dy
    hit = (hx >= geo.occ_x[0]) & (hx <= geo.occ_x[1]) & (hy >= geo.occ_y[0]) & (hy <= geo.occ_y[1])
    s_wall = (geo.wall_z + geo.slope * t[0] - t[2]) / (dz - geo.slope * dx)
    gray = torch.where(hit, geo.field_occ(torch, hx, hy),
                       geo.field_wall(torch, t[0] + s_wall * dx, t[1] + s_wall * dy))
    return (gray * 255.0).to(torch.uint8)


class Scene(NamedTuple):
    camera: dict  # intrinsic (4,), distortion (5,) f32 on the device, width, height
    kf_q: torch.Tensor  # (K, 4) camera -> world, the true poses
    kf_t: torch.Tensor  # (K, 3)
    points: torch.Tensor  # (N, 3) f32 world
    intensity: torch.Tensor  # (N,) f32
    valid: torch.Tensor  # (N,) bool
    images: Optional[torch.Tensor]  # (K, H, W, 3) uint8 RGB, gray in all three
    bin_image: Optional[torch.Tensor]  # (K, H, W) int32 bins


def camera(sc: dict, device) -> dict:
    f, w, h = sc["focal_px"], sc["width"], sc["height"]
    return {"intrinsic": torch.tensor([f, f, w / 2.0, h / 2.0], dtype=torch.float32, device=device),
            "distortion": torch.zeros(5, dtype=torch.float32, device=device),
            "width": w, "height": h}


def build(sc: dict, seed: int, device, rgb: bool = False, bins: int = 0) -> Scene:
    """The scene on ``device``: the map from the seed, the K images
    rendered there, kept as RGB (``rgb``) and/or as ``bins`` intensity bins
    (``bins`` > 0: clamp(trunc(gray / 255 * bins), 0, bins - 1))."""
    points, inten = scene_map(sc, seed)
    quats, positions = trajectory(sc)
    q = torch.from_numpy(quats).to(device)
    t = torch.from_numpy(positions).to(device)
    k, h, w = sc["keyframes"], sc["height"], sc["width"]
    images = torch.empty((k, h, w, 3), dtype=torch.uint8, device=device) if rgb else None
    bin_image = torch.empty((k, h, w), dtype=torch.int32, device=device) if bins else None
    for i in range(k):
        gray = render_gray(sc, q[i], t[i])
        if rgb:
            images[i] = gray[..., None]
        if bins:
            scaled = gray.to(torch.float32) / torch.tensor(255.0, device=device) * bins
            bin_image[i] = torch.clamp(g.to_int32(scaled), 0, bins - 1)
    n = points.shape[0]
    return Scene(camera(sc, device), q, t, torch.from_numpy(points).to(device),
                 torch.from_numpy(inten).to(device), torch.ones(n, dtype=torch.bool, device=device),
                 images, bin_image)


def nid_keyframes(sc: dict, scene: Scene, n_cull: int, seed: int):
    """The calibration keyframes, culled as `bench.py:223-254` culls them:
    keyframe i's map in its camera frame at the true pose, visible where it
    projects into the image at z > 0 and, behind the occluder's plane, where
    its ray to the camera misses the occluder; then the ``n_cull`` points of
    highest (uniform priority + visible), ties to the lower index. Returns
    (points (K, n, 3) camera frame, intensity (K, n), valid (K, n))."""
    geo = GEOMETRY[sc["kind"]]
    pts, dev = scene.points, scene.points.device
    k, n_map = scene.kf_q.shape[0], pts.shape[0]
    f, w, h = sc["focal_px"], sc["width"], sc["height"]
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
    out_p = torch.empty((k, n_cull, 3), dtype=torch.float32, device=dev)
    out_i = torch.empty((k, n_cull), dtype=torch.float32, device=dev)
    for i in range(k):
        t = scene.kf_t[i]
        R = g.quat_to_matrix(scene.kf_q[i])
        pc = (pts - t[None, :]) @ R  # R^T applied to rows
        u = f * pc[:, 0] / pc[:, 2] + w / 2.0
        v = f * pc[:, 1] / pc[:, 2] + h / 2.0
        inb = (pc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        s = (geo.occ_z - t[2]) / (pts[:, 2] - t[2])
        cx = t[0] + s * (pts[:, 0] - t[0])
        cy = t[1] + s * (pts[:, 1] - t[1])
        shadowed = ((pts[:, 2] > geo.occ_z + 0.1) & (cx >= geo.occ_x[0]) & (cx <= geo.occ_x[1])
                    & (cy >= geo.occ_y[0]) & (cy <= geo.occ_y[1]))
        key = torch.rand((n_map,), generator=gen, device=dev) + (inb & ~shadowed).float()
        sel = torch.sort(-key, stable=True).indices[:n_cull]
        out_p[i] = pc[sel]
        out_i[i] = scene.intensity[sel]
    return out_p, out_i, torch.ones((k, n_cull), dtype=torch.bool, device=dev)


def draw_corrections(n: int, seed: int, stream: int, trans_m: tuple, rot_deg: tuple,
                     stratified: bool):
    """(q (n, 4), t (n, 3)) f32 on the host: corrections of translation
    ``trans_m`` [lo, hi] and rotation ``rot_deg`` [lo, hi] in random
    directions from the seed. ``stratified`` spreads the magnitudes of
    draws 0, 1, 2, ... evenly over [lo, hi] by a fixed golden-ratio
    sequence, the same for every seed; otherwise each is drawn uniformly in
    the ball (translation) and in [0, hi] (angle)."""
    rng = np.random.default_rng([seed, stream])
    dirs = rng.standard_normal((n, 2, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    if stratified:
        i = np.arange(n)
        ft = (i * 0.6180339887498949) % 1.0
        fr = (i * 0.7548776662466927) % 1.0
    else:
        ft = rng.uniform(0.0, 1.0, n) ** (1.0 / 3.0)
        fr = rng.uniform(0.0, 1.0, n)
    mt = trans_m[0] + (trans_m[1] - trans_m[0]) * ft
    mr = np.radians(rot_deg[0] + (rot_deg[1] - rot_deg[0]) * fr)
    tangent = torch.from_numpy(np.concatenate([dirs[:, 0] * mt[:, None],
                                               dirs[:, 1] * mr[:, None]], -1))
    q, t = g.exp(tangent)
    return q.float(), t.float()


def density(sc: dict) -> float:
    """Wall points a square metre (scene 1's flat wall; the sloped wall's
    area grows by its secant)."""
    x0, x1, y0, y1 = wall_extent(sc)
    area = (x1 - x0) * (y1 - y0) * math.hypot(1.0, GEOMETRY[sc["kind"]].slope)
    return sc["map_points"] * (1.0 - sc["occluder_share"]) / area
