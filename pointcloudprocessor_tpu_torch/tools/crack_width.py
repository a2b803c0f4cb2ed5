"""3D crack-width measurement from culled clouds + crack masks.

Port of `pointcloudprocessor_tpu/tools/crack_width.py`, the rebuild of
`PointCloudProcessor/scripts/genNormAndDistanceMask.py:24-888` (the
downstream analytics consumer of the pipeline's `filtered_pcd/` dumps),
minus the interactive OpenCV picking UI (:326-391) — skeleton points are
auto-sampled along the skeleton (or supplied via JSON, the headless
equivalent of manual picks). Per frame:

1. threshold the crack mask, Euclidean distance transform, skeletonize
   (:166-177);
2. estimate cloud normals (radius/knn covariance — the o3d
   `estimate_normals` call at :213) and project every point through the
   distorted pinhole (cv2.projectPoints, :218-221) to build the
   normal / distance / xyz pixel masks (:200-266);
3. per skeleton point: ridge direction from the smoothed structure tensor
   (:814-872), left/right crack edges by marching the mask along the ridge
   normal (:706-762), a local SVD plane fit of the surrounding 3D points
   (:601-636);
4. the 3D edge point = intersection of the edge pixel's camera ray with the
   local plane. The reference approximates this by sampling a 600x600 grid
   of plane points and projecting them all to find the pixel-space nearest
   (`search_3d_edge_points`, :531-599); the ray-plane intersection is the
   closed form of that search and replaces it exactly;
5. crack width = ||left3d - right3d||, exported to
   ``crack_width_3d_results.json`` (:482-487) with annotated PNG overlays.

The normals (step 2) run on ``device``: the grid-hash radius search is
kernel S1 ``knn_select`` on the card (one launch a frame) and its plain
twin ``knn.chunked_radius_neighbors`` on the CPU; the projections and the
edge pixels' bearings use the port's camera model on the same device.
Everything after the normals is numpy, as in the JAX package::

    python -m pointcloudprocessor_tpu_torch.tools.crack_width --data_root run/ \
        --intrinsic FX FY CX CY --width W --height H --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ops import morphology


@dataclass
class CrackFrame:
    """Per-frame inputs/derived products — `CrackDataFrame` (:24-77)."""

    timestamp: str
    points: np.ndarray  # (N, 3) camera-frame
    crack_mask: np.ndarray  # (H, W) uint8
    raw_img: Optional[np.ndarray] = None  # (H, W, 3) BGR
    normals: Optional[np.ndarray] = None
    distance_transform: Optional[np.ndarray] = None
    skeleton: Optional[np.ndarray] = None
    norm_mask: Optional[np.ndarray] = None
    distance_mask: Optional[np.ndarray] = None
    points_3d_mask: Optional[np.ndarray] = None
    measurements: List[dict] = field(default_factory=list)


def neighbors(points, radius: float = 0.1, max_nn: int = 60):
    """(idx (N, K), ok (N, K)) of each point's ``max_nn`` nearest points
    within ``radius`` (itself included) on the points' device: the grid of
    JAX `crack_width.py:66-76` (cell = radius, table ``max(2n, 1024)``,
    capacity ``max(64, max_nn)``), searched by ``knn.radius_search`` (S1 on
    the card, in the grid's own order; ``chunked_radius_neighbors`` with
    chunks of 16,384 queries on the CPU)."""
    import torch

    from ..ops import knn

    n = points.shape[0]
    valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    grid = knn.build(points, valid, cell_size=radius, table_size=max(2 * n, 1024),
                     bucket_capacity=max(64, max_nn))
    idx, _, ok = knn.radius_search(grid, points, points, radius, max_nn, chunk_size=16384,
                                   order=grid.order)
    return idx, ok


def estimate_normals(points: np.ndarray, radius: float = 0.1, max_nn: int = 60,
                     device="cuda") -> np.ndarray:
    """Per-point normals as smallest covariance eigenvector of the radius
    neighborhood (o3d `KDTreeSearchParamHybrid(radius=0.1, max_nn=60)`
    semantics, :213), via the grid-hash neighbor search (:func:`neighbors`)
    on ``device``, oriented towards the camera at the origin."""
    import torch

    from ..ops.mls import _smallest_eigvec_3x3

    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32, device=device)
    idx, ok = neighbors(pts, radius, max_nn)
    npts = pts[torch.clamp(idx, min=0).long()]
    w = ok.to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mean = torch.sum(npts * w[..., None], dim=1) / cnt[:, None]  # a tensor divisor
    centered = (npts - mean[:, None, :]) * w[..., None]
    C = torch.einsum("mki,mkj->mij", centered, centered)
    normal = _smallest_eigvec_3x3(C)
    # Orient towards the camera (points are camera-frame; viewpoint origin).
    sgn = -torch.sign(torch.sum(normal * pts, dim=-1))
    normal = normal * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[:, None]
    return normal.cpu().numpy()


def project_points(camera, points: np.ndarray) -> np.ndarray:
    """Distorted pinhole projection (replaces cv2.projectPoints, :218-221),
    on the camera's device."""
    import torch

    from ..models import camera as cam

    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                          device=camera.intrinsic.device)
    return cam.project(camera, pts).cpu().numpy()


def build_pixel_masks(camera, frame: CrackFrame) -> None:
    """Scatter per-point normal / range / xyz into pixel masks (:200-266).
    Later points overwrite earlier at the same pixel, like the reference's
    serial loop."""
    h, w = frame.crack_mask.shape
    px = project_points(camera, frame.points).astype(np.int64)
    x, y = px[:, 0], px[:, 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (frame.points[:, 2] > 0)

    norm_mask = np.zeros((h, w, 3), np.float32)
    dist_mask = np.zeros((h, w), np.float32)
    xyz_mask = np.zeros((h, w, 3), np.float32)
    norm_mask[y[inb], x[inb]] = frame.normals[inb]
    dist_mask[y[inb], x[inb]] = np.linalg.norm(frame.points[inb], axis=-1)
    xyz_mask[y[inb], x[inb]] = frame.points[inb]
    frame.norm_mask = norm_mask
    frame.distance_mask = dist_mask
    frame.points_3d_mask = xyz_mask


def point_to_plane_distance(p1, normal, p2) -> float:
    """Distance from ``p2`` to the plane through ``p1`` with ``normal`` —
    `scripts/math_tools.py:3-18` (used by the crack edge search)."""
    p1, p2, n = np.asarray(p1, float), np.asarray(p2, float), np.asarray(normal, float)
    return float(abs(np.dot(n, p2 - p1)) / np.linalg.norm(n))


def local_plane(points_3d_mask: np.ndarray, x: int, y: int, radius: int = 150):
    """SVD plane fit of valid 3D points in a pixel window — `find_local_plane`
    (:601-636). Returns ((a,b,c,d), centroid) or None."""
    h, w = points_3d_mask.shape[:2]
    patch = points_3d_mask[
        max(0, y - radius): min(h, y + radius), max(0, x - radius): min(w, x + radius)
    ].reshape(-1, 3)
    pts = patch[np.any(patch != 0, axis=1)]
    if len(pts) < 3:
        return None
    centroid = pts.mean(axis=0)
    _, _, vh = np.linalg.svd(pts - centroid, full_matrices=False)
    normal = vh[2]
    d = -float(normal @ centroid)
    return np.append(normal, d), centroid


def ray_plane_edge_point(camera, plane, pixel_xy) -> Optional[np.ndarray]:
    """3D point on ``plane`` whose projection is ``pixel_xy`` — the closed
    form of `search_3d_edge_points` (:531-599). Camera at the origin: the
    pixel's bearing ray p = t*dir meets n.p + d = 0 at t = -d / (n.dir)."""
    import torch

    from ..models import camera as cam

    direction = cam.bearing(camera, torch.as_tensor(
        np.asarray(pixel_xy), dtype=torch.float32, device=camera.intrinsic.device)).cpu().numpy()
    n, d = plane[:3], plane[3]
    denom = float(n @ direction)
    if abs(denom) < 1e-9:
        return None
    t = -d / denom
    if t <= 0:
        return None
    return t * direction


def sample_skeleton_points(skeleton: np.ndarray, stride: int = 30) -> np.ndarray:
    """Every ``stride``-th skeleton pixel as (x, y) — the headless stand-in
    for the manual picker (the reference iterates
    `frame.manual_selected_skeleton_pts`, :417; its commented-out automatic
    path strides `np.argwhere(skeleton > 0)` the same way, :411-419)."""
    ys, xs = np.nonzero(skeleton > 0)
    sel = np.arange(0, len(xs), max(stride, 1))
    return np.stack([xs[sel], ys[sel]], axis=-1)


def measure_frame(
    camera,
    frame: CrackFrame,
    skeleton_stride: int = 30,
    picked_points: Optional[np.ndarray] = None,
    direction_radius: int = 4,
    plane_radius: int = 150,
) -> List[dict]:
    """Steps 3-5 for one frame; fills ``frame.measurements``."""
    binary = (frame.crack_mask > 0).astype(np.uint8) * 255
    frame.distance_transform = morphology.distance_transform(binary)
    frame.skeleton = morphology.skeletonize(binary)

    pts2d = (
        np.asarray(picked_points, np.int64)
        if picked_points is not None
        else sample_skeleton_points(frame.skeleton, skeleton_stride)
    )
    if len(pts2d) == 0:
        frame.measurements = []
        return []

    dirs = morphology.structure_tensor_directions(
        frame.skeleton, pts2d, radius=direction_radius
    )
    normals_2d = np.stack([-dirs[:, 1], dirs[:, 0]], axis=-1)  # ridge normal
    left2d = morphology.trace_edges(frame.crack_mask, pts2d, normals_2d)
    right2d = morphology.trace_edges(frame.crack_mask, pts2d, -normals_2d)

    out = []
    for k in range(len(pts2d)):
        x, y = int(pts2d[k, 0]), int(pts2d[k, 1])
        res = local_plane(frame.points_3d_mask, x, y, plane_radius)
        if res is None:
            continue
        plane, _centroid = res
        l3d = ray_plane_edge_point(camera, plane, left2d[k].astype(np.float64))
        r3d = ray_plane_edge_point(camera, plane, right2d[k].astype(np.float64))
        width = (
            float(np.linalg.norm(l3d - r3d)) if l3d is not None and r3d is not None else None
        )
        out.append(
            {
                "skeleton_pt": [x, y],
                "left_edge_pt2d": [int(left2d[k, 0]), int(left2d[k, 1])],
                "right_edge_pt2d": [int(right2d[k, 0]), int(right2d[k, 1])],
                "direction_2d": [float(dirs[k, 0]), float(dirs[k, 1])],
                "local_plane_3d": [float(v) for v in plane],
                "left_edge_3d_pt": None if l3d is None else [float(v) for v in l3d],
                "right_edge_3d_pt": None if r3d is None else [float(v) for v in r3d],
                "crack_width_m": width,
                "crack_width_mm": None if width is None else width * 1e3,
            }
        )
    frame.measurements = out
    return out


def visualize(frame: CrackFrame, path: str) -> None:
    """Annotated overlay (`visualize_skeleton_edge_pts`, :706-762 region)."""
    import cv2

    base = (
        frame.raw_img.copy()
        if frame.raw_img is not None
        else cv2.cvtColor(frame.crack_mask, cv2.COLOR_GRAY2BGR)
    )
    for m in frame.measurements:
        x, y = m["skeleton_pt"]
        cv2.circle(base, (x, y), 2, (0, 0, 255), -1)
        le, re = tuple(m["left_edge_pt2d"]), tuple(m["right_edge_pt2d"])
        cv2.circle(base, le, 2, (255, 0, 0), -1)
        cv2.circle(base, re, 2, (0, 255, 0), -1)
        cv2.arrowedLine(base, (x, y), le, (255, 0, 0), 1)
        cv2.arrowedLine(base, (x, y), re, (0, 255, 0), 1)
        if m["crack_width_mm"] is not None:
            cv2.putText(base, f"{m['crack_width_mm']:.2f}mm", (x, y - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1)
    cv2.imwrite(path, base)


def process(
    data_root: str,
    intrinsic,
    distortion,
    width: int,
    height: int,
    skeleton_stride: int = 30,
    picks_path: str = "",
    device="cuda",
) -> str:
    """Full `Crack.process()` (:134-149): read `filtered_pcd/` +
    `mask_select/` (+ optional `raw_images/`), measure every frame, write
    masks, overlays and ``crack_width_3d_results.json``. Returns the JSON
    path. The normals and projections run on ``device``."""
    import cv2

    from ..io import pcd
    from ..models import camera as cam

    camera = cam.create_camera("pinhole", intrinsic, distortion, width, height, device)
    pcd_dir = os.path.join(data_root, "filtered_pcd")
    mask_dir = os.path.join(data_root, "mask_select")
    raw_dir = os.path.join(data_root, "raw_images")
    out_norm = os.path.join(data_root, "norm_masks")
    out_dist = os.path.join(data_root, "distance_mask")
    out_skel = os.path.join(data_root, "edt_skeleton")
    for d in (out_norm, out_dist, out_skel):
        os.makedirs(d, exist_ok=True)

    picks = {}
    if picks_path:
        with open(picks_path) as f:
            picks = {k: np.asarray(v, np.int64) for k, v in json.load(f).items()}

    results = []
    for name in sorted(os.listdir(pcd_dir)):
        if not name.endswith(".pcd"):
            continue
        ts = name[:-4]
        mask_path = os.path.join(mask_dir, ts + ".png")
        if not os.path.exists(mask_path):
            print(f"mask not found for {ts}, skipping", file=sys.stderr)
            continue
        data = pcd.read(os.path.join(pcd_dir, name))
        frame = CrackFrame(
            timestamp=ts,
            points=np.asarray(data.points),
            crack_mask=cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE),
        )
        raw_path = os.path.join(raw_dir, ts + ".jpg")
        if os.path.exists(raw_path):
            frame.raw_img = cv2.imread(raw_path, cv2.IMREAD_COLOR)

        frame.normals = estimate_normals(frame.points, device=device)
        build_pixel_masks(camera, frame)
        measure_frame(camera, frame, skeleton_stride, picks.get(ts))

        cv2.imwrite(os.path.join(out_norm, f"{ts}_norm.png"),
                    ((frame.norm_mask * 0.5 + 0.5) * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(out_dist, f"{ts}_distance.png"),
                    frame.distance_mask)
        cv2.imwrite(os.path.join(out_skel, f"{ts}_edt.png"),
                    frame.distance_transform.astype(np.uint8))
        cv2.imwrite(os.path.join(out_skel, f"{ts}_skeleton.png"), frame.skeleton)
        visualize(frame, os.path.join(out_skel, f"{ts}_skeleton_edge_pts.png"))
        results.extend(frame.measurements)

    json_path = os.path.join(data_root, "crack_width_3d_results.json")
    with open(json_path, "w") as f:
        json.dump(results, f, indent=4)
    return json_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="3D crack width measurement")
    ap.add_argument("--data_root", required=True,
                    help="folder with filtered_pcd/ and mask_select/")
    ap.add_argument("--intrinsic", type=float, nargs=4, required=True,
                    metavar=("FX", "FY", "CX", "CY"))
    ap.add_argument("--distortion", type=float, nargs=5,
                    default=[0, 0, 0, 0, 0], metavar=("K1", "K2", "P1", "P2", "K3"))
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--skeleton-stride", type=int, default=30)
    ap.add_argument("--picks", default="",
                    help="JSON {ts: [[x,y],...]} of picked skeleton points "
                    "(replaces the reference's interactive picker)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    path = process(args.data_root, args.intrinsic, args.distortion,
                   args.width, args.height, args.skeleton_stride, args.picks, args.device)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
