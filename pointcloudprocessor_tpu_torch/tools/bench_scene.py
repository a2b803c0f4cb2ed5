"""The benchmark scenes of `bench.py:101-254`, for the port.

Scene 1: a textured wall at z = 6 m and an occluding slab at z = 2.5 m,
seen by K keyframes that step along +x and yaw from -4 to 4 degrees, with a
planted odometry error T0 (`bench.py:734-749`). Scene 2 (`bench.py:60-99`)
slopes the wall in depth (z = 6 + 0.35 x), gives it a broader texture, moves
the occluder to the left at z = 3 m and pitches the keyframes from -1.5 to
1.5 degrees as well. `bench.py` builds them with jax; this module builds
them without: the map and the trajectory are drawn with numpy from a seed
(so that `chip_smoke.py`'s on-disk scene and :func:`build` are one scene),
the keyframe images are ray-cast with torch on the device, and
:func:`nid_keyframes` culls each keyframe's points analytically as
`bench.py:223-254` does.

    scene = build(device="cuda")             # 4096x3000, 1M points, 8 keyframes
    scene = build(512, 384, 100_000, 4, "cpu", scene=2)
    kfs = nid_keyframes(scene, 262_144)      # opt/nid.NIDKeyframe, camera frame

:func:`mls_scene` is the MLS bench's hardened corner (`bench.py:553-578`),
:func:`e2e_config` the e2e pipeline config, MLS on or off (`bench.py:766-806`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..models import camera as cam

# The reference scale of bench.py and its scene-1 geometry.
WIDTH, HEIGHT, N_MAP, N_CULL, K = 4096, 3000, 1_000_000, 262_144, 8
F_PX = 4818.2  # focal length at 4096 px wide; smaller images keep the field of view
WALL_Z, OCC_Z = 6.0, 2.5
OCC_X, OCC_Y = (0.3, 1.5), (-0.6, 0.6)
T0_TANGENT = (0.02, -0.01, 0.01, 0.004, -0.002, 0.004)
SEED = 0
# Scene 2 (`bench.py:68-71`): the wall's depth slope, the occluder's depth
# and extent.
S2_SLOPE = 0.35
S2_OCC_Z = 3.0
S2_OCC_X = (-1.6, -0.4)
S2_OCC_Y = (-0.5, 0.7)


def focal(width: int) -> float:
    return F_PX * (width / 4096.0)


def field_wall(mod, x, y):
    """Wall texture in [0, 1]; ``mod`` is numpy or torch."""
    return mod.clip(0.5 + 0.25 * mod.sin(7.0 * x) + 0.25 * mod.cos(9.0 * y), 0.0, 1.0)


def field_occ(mod, x, y):
    """Occluder texture in [0, 1]; ``mod`` is numpy or torch."""
    return mod.clip(0.5 + 0.25 * mod.sin(13.0 * x + 1.0) + 0.25 * mod.cos(11.0 * y + 2.0), 0.0, 1.0)


def field_wall2(mod, x, y):
    """Scene 2's wall texture in [0, 1] (`bench.py:82-92`): three
    frequencies and a cross term; ``mod`` is numpy or torch."""
    return mod.clip(
        0.5
        + 0.18 * mod.sin(5.2 * x + 0.7)
        + 0.12 * mod.cos(11.7 * y)
        + 0.10 * mod.sin(23.0 * x + 3.0 * y)
        + 0.05 * mod.cos(41.0 * y + 1.0),
        0.0,
        1.0,
    )


def field_occ2(mod, x, y):
    """Scene 2's occluder texture in [0, 1] (`bench.py:95-98`)."""
    return mod.clip(0.5 + 0.2 * mod.sin(17.0 * x) + 0.2 * mod.cos(8.0 * y + 0.5), 0.0, 1.0)


class Geometry(NamedTuple):
    """What tells the scenes apart (`bench.py:121-126, 154-155`)."""

    slope: float  # the wall's depth z = WALL_Z + slope * x
    occ_z: float
    occ_x: tuple
    occ_y: tuple
    field_wall: object
    field_occ: object
    margin_y: float  # the wall's vertical margin past the view
    pitch_deg: float  # the keyframes pitch from -pitch_deg to pitch_deg


def geometry(scene: int) -> Geometry:
    if scene == 1:
        return Geometry(0.0, OCC_Z, OCC_X, OCC_Y, field_wall, field_occ, 0.2, 0.0)
    if scene == 2:
        return Geometry(S2_SLOPE, S2_OCC_Z, S2_OCC_X, S2_OCC_Y, field_wall2, field_occ2, 0.4, 1.5)
    raise ValueError(f"bench scene {scene}: 1 or 2")


def scene_map(n_map: int = N_MAP, width: int = WIDTH, height: int = HEIGHT, seed: int = SEED,
              scene: int = 1):
    """(n_map, 3) f32 points, 7/8 on the wall (spanning every keyframe's
    view with a margin) and 1/8 on the occluder, and their f32 intensities
    (the textures at the points)."""
    g = geometry(scene)
    rng = np.random.default_rng(seed)
    f_px = focal(width)
    n_occ = n_map // 8
    n_wall = n_map - n_occ
    half_x = (width / 2.0) / f_px * WALL_Z
    half_y = (height / 2.0) / f_px * WALL_Z
    wx = rng.uniform(-half_x - 0.6, half_x + 1.6, n_wall).astype(np.float32)
    wy = rng.uniform(-half_y - g.margin_y, half_y + g.margin_y, n_wall).astype(np.float32)
    ox = rng.uniform(g.occ_x[0], g.occ_x[1], n_occ).astype(np.float32)
    oy = rng.uniform(g.occ_y[0], g.occ_y[1], n_occ).astype(np.float32)
    wz = WALL_Z + g.slope * wx  # slope 0: exactly WALL_Z
    points = np.concatenate([
        np.stack([wx, wy, wz], -1),
        np.stack([ox, oy, np.full_like(ox, g.occ_z)], -1),
    ])
    inten = np.concatenate([g.field_wall(np, wx, wy), g.field_occ(np, ox, oy)]).astype(np.float32)
    return points, inten


def scene_trajectory(k: int = K, scene: int = 1):
    """Keyframe poses P_i (wxyz quaternions and positions, f32): +x
    translation of 0.12 m a keyframe, yaw about y from -4 to 4 degrees;
    scene 2 also pitches about x, q = qy(yaw) qx(pitch) (`bench.py:137-148`)."""
    kf_x = 0.12 * np.arange(k, dtype=np.float32)
    yaw = np.radians(np.linspace(-4.0, 4.0, k)).astype(np.float32)
    if scene == 1:
        quats = np.stack(
            [np.cos(yaw / 2), np.zeros_like(yaw), np.sin(yaw / 2), np.zeros_like(yaw)], -1
        ).astype(np.float32)
    else:
        span = geometry(scene).pitch_deg
        pitch = np.radians(np.linspace(-span, span, k)).astype(np.float32)
        cy_, sy_ = np.cos(yaw / 2), np.sin(yaw / 2)
        cx_, sx_ = np.cos(pitch / 2), np.sin(pitch / 2)
        quats = np.stack([cy_ * cx_, cy_ * sx_, sy_ * cx_, -sy_ * sx_], -1).astype(np.float32)
    positions = np.stack([kf_x, np.zeros_like(kf_x), np.zeros_like(kf_x)], -1)
    return quats, positions


def scene_odometry(k: int = K):
    """(T0, the odometry O_i = P_i ∘ T0 as an SE3 batch) on the CPU: the
    planted error of `bench.py:734-749`."""
    quats, positions = scene_trajectory(k)
    T0 = se3.exp(torch.tensor(T0_TANGENT, dtype=torch.float32))
    return T0, se3.compose(se3.SE3(torch.from_numpy(quats), torch.from_numpy(positions)), T0)


def render_gray(q: torch.Tensor, t: torch.Tensor, width: int, height: int,
                scene: int = 1) -> torch.Tensor:
    """(height, width) uint8 image of the scene from the camera at pose
    (q wxyz, t), ray-cast off the occluder and the wall, on q's device. The
    ray meets the wall z = WALL_Z + slope x at s = (WALL_Z + slope t_x -
    t_z) / (d_z - slope d_x) (`bench.py:180-206`; scene 1's slope 0 adds and
    subtracts exact zeros)."""
    g = geometry(scene)
    f_px = focal(width)
    dev = q.device
    uu = ((torch.arange(width, dtype=torch.float32, device=dev) - width / 2.0) / f_px)[None, :]
    vv = ((torch.arange(height, dtype=torch.float32, device=dev) - height / 2.0) / f_px)[:, None]
    R = se3.quat_to_matrix(q)
    dx = uu * R[0, 0] + vv * R[0, 1] + R[0, 2]
    dy = uu * R[1, 0] + vv * R[1, 1] + R[1, 2]
    dz = uu * R[2, 0] + vv * R[2, 1] + R[2, 2]
    s_occ = (g.occ_z - t[2]) / dz
    hx, hy = t[0] + s_occ * dx, t[1] + s_occ * dy
    hit = (hx >= g.occ_x[0]) & (hx <= g.occ_x[1]) & (hy >= g.occ_y[0]) & (hy <= g.occ_y[1])
    s_wall = (WALL_Z + g.slope * t[0] - t[2]) / (dz - g.slope * dx)
    gray = torch.where(hit, g.field_occ(torch, hx, hy),
                       g.field_wall(torch, t[0] + s_wall * dx, t[1] + s_wall * dy))
    return (gray * 255.0).to(torch.uint8)


class BenchScene(NamedTuple):
    camera: cam.PinholeCamera
    poses: se3.SE3  # (K,) camera -> world, the true keyframe poses
    points: torch.Tensor  # (N, 3) f32 world points
    intensity: torch.Tensor  # (N,) f32
    valid: torch.Tensor  # (N,) bool
    images: torch.Tensor  # (K, H, W, 3) uint8 RGB (gray in all three channels)
    T0: se3.SE3  # the planted odometry error
    scene: int = 1  # bench.py's scene number


def build(width: int = WIDTH, height: int = HEIGHT, n_map: int = N_MAP, k: int = K,
          device="cuda", seed: int = SEED, scene: int = 1) -> BenchScene:
    """Scene ``scene`` (1 or 2) on ``device``: the map and the true poses
    from the seed, the K images rendered there."""
    f_px = focal(width)
    camera = cam.create_camera("pinhole", (f_px, f_px, width / 2.0, height / 2.0), (0.0,) * 5,
                               width, height, device)
    points, inten = scene_map(n_map, width, height, seed, scene)
    quats, positions = scene_trajectory(k, scene)
    poses = se3.SE3(torch.from_numpy(quats).to(device), torch.from_numpy(positions).to(device))
    images = torch.stack([
        render_gray(poses.q[i], poses.t[i], width, height, scene)[..., None]
        .expand(height, width, 3) for i in range(k)
    ]).contiguous()
    T0, _ = scene_odometry(k)
    return BenchScene(
        camera=camera,
        poses=poses,
        points=torch.from_numpy(points).to(device),
        intensity=torch.from_numpy(inten).to(device),
        valid=torch.ones((n_map,), dtype=torch.bool, device=device),
        images=images,
        T0=se3.SE3(T0.q.to(device), T0.t.to(device)),
        scene=scene,
    )


def keyframe_rank(n_map: int, kf: int, seed: int = SEED) -> torch.Tensor:
    """(n_map,) f32 uniform draws in [0, 1) from a CPU generator seeded
    with ``seed + kf``: the cull's random priority (bench.py draws it from
    ``PRNGKey(kf)``)."""
    g = torch.Generator().manual_seed(seed + kf)
    return torch.rand((n_map,), generator=g, dtype=torch.float32)


def nid_keyframes(scene: BenchScene, n_cull: int = N_CULL, rank: torch.Tensor | None = None,
                  seed: int = SEED):
    """The NID solve's keyframes, culled analytically as `bench.py:223-254`
    culls them: for keyframe i, the map in its camera frame at the true
    pose, visible where it projects into the image at z > 0 and, for a
    point behind the occluder's plane, where its ray to the camera misses
    the occluder; then the ``n_cull`` points of highest ``rank + visible``
    (visible points first, ties to the lower index: a stable sort, as
    ``jnp.argsort``), in that order. ``rank`` (K, n_map) f32 in [0, 1)
    gives each keyframe's priorities (a test passes JAX's draws); None
    draws them with :func:`keyframe_rank`. Returns ``opt/nid.NIDKeyframe``
    with the camera-frame points, their intensities and the bin images of
    the rendered frames (16 bins), on the scene's device; a solve from
    ``scene.T0`` should return to the identity."""
    from ..opt import nid

    g = geometry(scene.scene)
    camera, pts, dev = scene.camera, scene.points, scene.points.device
    k, n_map = scene.images.shape[0], pts.shape[0]
    f_px, w, h = float(camera.intrinsic[0]), camera.width, camera.height
    kf_pts, kf_int = [], []
    for i in range(k):
        t = scene.poses.t[i]
        R = se3.quat_to_matrix(scene.poses.q[i])
        pc = (pts - t[None, :]) @ R  # R^T applied to rows
        u = f_px * pc[:, 0] / pc[:, 2] + w / 2.0
        v = f_px * pc[:, 1] / pc[:, 2] + h / 2.0
        inb = (pc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        s = (g.occ_z - t[2]) / (pts[:, 2] - t[2])
        cx = t[0] + s * (pts[:, 0] - t[0])
        cy = t[1] + s * (pts[:, 1] - t[1])
        shadowed = ((pts[:, 2] > g.occ_z + 0.1) & (cx >= g.occ_x[0]) & (cx <= g.occ_x[1])
                    & (cy >= g.occ_y[0]) & (cy <= g.occ_y[1]))
        r = keyframe_rank(n_map, i, seed) if rank is None else rank[i]
        key = r.to(dev) + (inb & ~shadowed).to(torch.float32)
        sel = torch.sort(-key, stable=True).indices[:n_cull]
        kf_pts.append(pc[sel])
        kf_int.append(scene.intensity[sel])
    gray = scene.images[..., 0].to(torch.float32)
    return nid.NIDKeyframe(
        points=torch.stack(kf_pts),
        intensity=torch.stack(kf_int),
        valid=torch.ones((k, n_cull), dtype=torch.bool, device=dev),
        bin_image=nid.quantize_image(gray / torch.tensor(255.0, device=dev), 16),
    )


def cull_edge_points(width: int = WIDTH, height: int = HEIGHT, ds: int = 14, n_bulk: int = 20_000,
                     seed: int = SEED) -> dict:
    """Cull inputs at the edges of the gate and the grid, as numpy arrays
    (u, v, z, rng f32; valid bool), shuffled into a random bulk: u in
    {0, -0, -1e-7, a cell edge and the float below it, W - 1e-3, W, NaN,
    +-inf} crossed with the like values of v and with z in {1, +-0, 1e-30,
    -1, NaN, +-inf}; ranges with ties, zeros and +inf; 600 points on one
    cell with equal ranges, a few exactly at and just past the depth test's
    edge (3.0 + 0.05); and ``n_bulk`` points spread a little past the image
    with ranges on a 1/64 grid (ties), 5% invalid."""
    rs = np.random.default_rng(seed)
    f32 = np.float32

    def edges(size):
        return np.asarray([0.0, -0.0, -1e-7, ds, np.nextafter(f32(ds), f32(0)), size - 1e-3,
                           size - 0.5, size, np.nan, np.inf, -np.inf], f32)

    zs = np.asarray([1.0, 0.0, -0.0, 1e-30, -1.0, np.nan, np.inf, -np.inf], f32)
    u, v, z = (a.reshape(-1) for a in np.meshgrid(edges(width), edges(height), zs, indexing="ij"))
    r = rs.choice(np.asarray([1.0, 1.0, 2.5, 0.0, -0.0, np.inf, 7.25], f32), u.size)
    # One crowded cell (cell (2, 2) at ds 14): equal ranges and the test's edge.
    m = 600
    cu = rs.uniform(2 * ds, 3 * ds, m).astype(f32)
    cv = rs.uniform(2 * ds, 3 * ds, m).astype(f32)
    cr = np.full(m, 3.0, f32)
    cr[:20] = f32(3.0) + f32(0.05)
    cr[20:40] = np.nextafter(f32(3.0) + f32(0.05), f32(4))
    bu = rs.uniform(-0.05 * width, 1.05 * width, n_bulk).astype(f32)
    bv = rs.uniform(-0.05 * height, 1.05 * height, n_bulk).astype(f32)
    bz = rs.uniform(-0.5, 10.0, n_bulk).astype(f32)
    br = (np.round(rs.uniform(0.5, 20.0, n_bulk) * 64) / 64).astype(f32)
    out = {
        "u": np.concatenate([u, cu, bu]),
        "v": np.concatenate([v, cv, bv]),
        "z": np.concatenate([z, np.ones(m, f32), bz]),
        "rng": np.concatenate([r, cr, br]),
    }
    n = out["u"].size
    out["valid"] = rs.uniform(size=n) > 0.05
    out["valid"][: u.size] = True
    order = rs.permutation(n)
    return {k: a[order] for k, a in out.items()}


def two_walls(n: int, seed: int = SEED, z_jitter: float = 0.0, invalid: float = 0.0):
    """The HPR bench's two-wall scene (`bench.py:665-697`) as numpy arrays:
    (points (n, 3) f32 in the camera frame, valid (n,) bool). Half the
    points on a wall at z = 5 m, half on one at z = 10 m, both x in [-2, 2],
    y in [-1.5, 1.5]: the near wall hides the far one's middle. Optional
    uniform z jitter of +-``z_jitter`` m and a share ``invalid`` of invalid
    points."""
    rs = np.random.default_rng(seed)
    n1 = n // 2
    x = rs.uniform(-2.0, 2.0, n)
    y = rs.uniform(-1.5, 1.5, n)
    z = np.where(np.arange(n) < n1, 5.0, 10.0) + rs.uniform(-z_jitter, z_jitter, n)
    valid = rs.uniform(size=n) >= invalid
    return np.stack([x, y, z], -1).astype(np.float32), valid


def hpr_edge_sets(seed: int = SEED, n_bulk: int = 4096) -> dict:
    """Inputs of the HPR grid cull at its edges, {name: (points (n, 3) f32,
    valid (n,) bool)}, each with a two-wall bulk of ``n_bulk`` points:
    "cell edges" (the gnomonic bounds pinned to [-1, 1] so cells are 1/256
    wide: points exactly on cell edges and the float below each, z at 0 and
    -0 and below, the origin); "tiny z" (z at 1e-9 and the float above it,
    a range under 1e-9); "non-finite" (NaN in x, y or z, +-inf in x or y,
    z = +inf); "NaN bearing" (x = z = +inf: x / z is NaN, so the bounds
    are); "all invalid"; "single valid"."""
    f32 = np.float32
    pts, valid = two_walls(n_bulk, seed, z_jitter=0.3, invalid=0.02)
    rs = np.random.default_rng(seed + 1)

    def with_bulk(extra):
        extra = np.asarray(extra, f32).reshape(-1, 3)
        p = np.concatenate([pts, extra])
        v = np.concatenate([valid, np.ones(len(extra), bool)])
        order = rs.permutation(len(p))
        return p[order], v[order]

    # The bounds: points at x / z = -1 and 1 (and y / z likewise) pin them.
    pins = [[-1, -1, 1], [1, 1, 1], [-5, -5, 5], [10, 10, 10]]
    k = np.arange(-249, 257, 7, dtype=f32) / f32(256)  # inside [-1, 1], below included
    below = np.nextafter(k, f32(-2))
    on_edges = [[a, b, 1.0] for a in np.concatenate([k, below]) for b in (k[3], below[5], 0.0)]
    behind = [[0.5, 0.5, 0.0], [0.5, 0.5, -0.0], [0.3, -0.2, -2.0], [0.0, 0.0, 0.0]]
    sets = {"cell edges": with_bulk(pins + on_edges + behind)}
    sets["tiny z"] = with_bulk([[0.5, 0.5, 1e-9], [0.5, 0.5, np.nextafter(f32(1e-9), f32(1))],
                                [1e-10, 0.0, 1e-10]])
    sets["non-finite"] = with_bulk([[np.nan, 0, 5], [0, np.nan, 5], [0, 0, np.nan],
                                    [np.inf, 0, 5], [0, -np.inf, 5], [0.1, 0.2, np.inf],
                                    [-np.inf, 0, 7]])
    sets["NaN bearing"] = with_bulk([[np.inf, 0.0, np.inf]])
    sets["all invalid"] = (pts, np.zeros(len(pts), bool))
    one = np.zeros(len(pts), bool)
    one[len(pts) // 3] = True
    sets["single valid"] = (pts, one)
    return sets


SMOOTH_EDGE_RADIUS = 0.02
SMOOTH_EDGE_STEP = 2.0 ** -7  # a lattice step whose coordinates, offsets and squares are exact in f32


def smooth_edge_clouds(seed: int = SEED) -> dict:
    """Inputs of the local color smoothing (N1) at its edges, {name: (points
    (n, 3) f32, colored (n,) bool, radius)}: "ties at the 32nd" (a lattice of
    step 2^-7 m: an interior point has 27 neighbors up to 3 steps^2 and 6 at
    exactly 4 steps^2 inside 0.02 m, so its 32nd nearest falls among 6 at one
    distance and the tie-break picks 5); "shared buckets" (300 points,
    ~300 occupied cells in a table of 1024: many 27-cell windows list a
    bucket twice); "over capacity" (60 colored points in one cell, more than
    a bucket's 32); "cell faces" (every coordinate on a face of the 0.25 m
    cells or a step past it); "all uncolored"; "all colored"; "ragged n"
    (1,001 points)."""
    rs = np.random.default_rng(seed + 5)
    f32, r = np.float32, SMOOTH_EDGE_RADIUS
    g = np.arange(9, dtype=f32) * f32(SMOOTH_EDGE_STEP)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    sets = {"ties at the 32nd": (lattice, np.ones(len(lattice), bool), r)}
    p = (rs.uniform(0, 1, (300, 3)) * 0.3).astype(f32)
    sets["shared buckets"] = (p, rs.uniform(size=300) > 0.1, r)
    p = np.concatenate([rs.uniform(0.001, 0.019, (60, 3)), rs.uniform(0, 0.1, (400, 3))])
    sets["over capacity"] = (p.astype(f32), np.ones(len(p), bool), r)
    p = (rs.integers(-6, 6, (2000, 3)) * 0.125 + rs.integers(0, 2, (2000, 3))
         * SMOOTH_EDGE_STEP).astype(f32)
    sets["cell faces"] = (p, rs.uniform(size=2000) > 0.2, 0.25)
    p = rs.uniform(0, 0.2, (800, 3)).astype(f32)
    sets["all uncolored"] = (p, np.zeros(800, bool), r)
    sets["all colored"] = (p, np.ones(800, bool), r)
    p = rs.uniform(0, 0.25, (1001, 3)).astype(f32)
    sets["ragged n"] = (p, rs.uniform(size=1001) > 0.3, r)
    return sets


def mls_scene(n_points: int, seed: int = 1) -> np.ndarray:
    """(n_points, 3) f32: the MLS bench's hardened corner (`bench.py:553-578`),
    drawn as it draws it. Three pieces with 5 mm surface noise: a dense wall
    at z = 6 m (~30k points/m^2, half the points), a perpendicular wall at
    x = 0 sharing its edge (a quarter), and a sparse extension of the first
    at ~3k points/m^2 (the rest)."""
    rng = np.random.default_rng(seed)
    n_a = n_points // 2
    n_b = n_points // 4
    n_c = n_points - n_a - n_b
    side_a = float(np.sqrt(n_a / 30000.0))
    side_b = float(np.sqrt(n_b / 30000.0))
    side_c = float(np.sqrt(n_c / 3000.0))

    def noise(n):
        return 0.005 * rng.standard_normal(n)

    a = np.stack([rng.uniform(0, side_a, n_a), rng.uniform(0, side_a, n_a),
                  6.0 + noise(n_a)], -1)
    b = np.stack([0.0 + noise(n_b), rng.uniform(0, side_b, n_b),
                  6.0 - rng.uniform(0, side_b, n_b)], -1)
    c = np.stack([rng.uniform(-side_c, 0, n_c), rng.uniform(0, side_c, n_c),
                  6.0 + noise(n_c)], -1)
    return np.concatenate([a, b, c]).astype(np.float32)


def e2e_config(root: str, nid, enable_mls: bool = False, width: int = WIDTH,
               height: int = HEIGHT, n_map: int = N_MAP, n_cull: int = N_CULL, k: int = K):
    """bench.py's e2e pipeline config (`bench.py:766-806`) over a scene
    written under ``root`` (``map.pcd``, ``vo_interpolated_odom.txt``,
    ``images/``; outputs to ``out/``), with the NIDConfig ``nid`` and the
    MLS stage (``MLSConfig(upsampling="none")``) on if ``enable_mls``."""
    import os

    from ..utils import config as cfg_mod

    f_px = focal(width)
    return cfg_mod.PipelineConfig(
        point_cloud_path=os.path.join(root, "map.pcd"),
        odometry_path=os.path.join(root, "vo_interpolated_odom.txt"),
        images_folder=os.path.join(root, "images"),
        output_path=os.path.join(root, "out"),
        enable_mls=enable_mls,
        enable_nid_optimize=True,
        crop_padding=12.0,  # keeps the z = 6 m wall inside the trajectory crop
        map_capacity=n_map,
        culled_capacity=n_cull,
        max_keyframes=k,
        camera=cfg_mod.CameraConfig(
            intrinsic=(f_px, f_px, width / 2.0, height / 2.0),
            distortion=(0.0,) * 5,
            width=width,
            height=height,
        ),
        mls=cfg_mod.MLSConfig(upsampling="none"),
        nid=nid,
    )


def nid_scene(width: int = WIDTH, height: int = HEIGHT, n_map: int = N_MAP,
              n_cull: int = N_CULL, k: int = K, device="cuda", scene: int = 1,
              seed: int = SEED):
    """(camera, keyframes with their packed bin tiles, T0): bench.py's
    ``build_bench_scene(...)[0, 6, 7]`` for the solve harnesses."""
    from ..opt import nid

    s = build(width, height, n_map, k, device, seed, scene)
    return s.camera, nid.prepare_keyframes(nid_keyframes(s, n_cull, seed=seed)), s.T0
