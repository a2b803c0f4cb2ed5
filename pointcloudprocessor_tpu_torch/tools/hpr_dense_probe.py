"""Probe of the dense HPR cull (H1, ``hpr.hpr_mask``) on the card: its time,
the pairs its inputs need, and the dense / grid crossover.

Sets (all made from ``bench_scene``'s seed):

  two walls 100,000 / 262,144 : ``bench_scene.two_walls`` with 0.3 m of z
                                jitter and 2% invalid points, the HPR
                                bench's scene (`bench.py:665-697`)
  scene N                     : the colorize culls of ``bench_scene.
                                scene_map(N)`` seen by the scene's 8 true
                                keyframe poses (``hpr.view_points``: the
                                transform, projection and unfloored gate)

For each set: H1's device time (``median_ms(hide_host=True)``) and time a
call, the gated points, and the needed pairs: the pairs (i, j) of ok points
whose dot <f_j, u_i> is at least i's own minus ``2^-18 * 2R`` (0.69 m at R
= 90,000, half the skip rule's delta at s = 2R, ``ops/hpr.py``), counted on
the card by chunked f32 products ``u @ f.T`` (cuBLAS, TF32 off; within a
few ulp of the kernel's dot, which the margin covers). Where the module
counts the pairs and subtiles its kernel evaluates (``hpr.support_stats``),
those too. With
``--crossover``, H1 against H2 (``hpr_mask_grid``) on the scene's keyframe
0 and on the batch of 8 (``mask_batch`` / ``hpr_mask_grid_views``) at each
map size, with the mask bits that differ.

Usage (on the card; one JSON line at the end):
  python -m pointcloudprocessor_tpu_torch.tools.hpr_dense_probe [--crossover]
      [--sizes 100000,262144] [--scene 1000000] [--maps 100000,262144,500000,1000000]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core import se3
from ..models import camera as cam
from ..ops import hpr
from ..utils import profiling
from . import bench_scene as bs

MARGIN = 2.0 ** -18  # of 2R: half the skip rule's delta (ops/hpr.SKIP_DELTA) at s = 2R


def two_wall_set(n: int, device):
    p, v = bs.two_walls(n, bs.SEED, z_jitter=0.3, invalid=0.02)
    return torch.from_numpy(p).to(device), torch.from_numpy(v).to(device)


def scene_views(n_map: int, device, k: int = bs.K):
    """(points_camera (k, N, 3), gate (k, N)) of the colorize culls of
    ``scene_map(n_map)`` from the scene's k true keyframe poses."""
    points, _ = bs.scene_map(n_map)
    quats, positions = bs.scene_trajectory(k)
    w2c = se3.inverse(se3.SE3(torch.from_numpy(quats), torch.from_numpy(positions)))
    f = bs.focal(bs.WIDTH)
    camera = cam.create_camera("pinhole", (f, f, bs.WIDTH / 2.0, bs.HEIGHT / 2.0), (0.0,) * 5,
                               bs.WIDTH, bs.HEIGHT, device)
    R = se3.quat_to_matrix(w2c.q).to(device).contiguous()
    t = w2c.t.to(device).contiguous()
    pts = torch.from_numpy(points).to(device)
    valid = torch.ones(n_map, dtype=torch.bool, device=device)
    return camera, R, t, pts, valid


def needed_pairs(points: torch.Tensor, gate: torch.Tensor, radius: float = hpr.DEFAULT_RADIUS,
                 rows: int = 512) -> int:
    """Pairs (i, j) of ok points with <f_j, u_i> >= <f_i, u_i> - MARGIN * 2R."""
    r = torch.linalg.vector_norm(points, dim=-1)
    ok = gate & (r > 1e-9)
    u = (points / torch.clamp(r, min=1e-12)[:, None])[ok]
    f = u * (2.0 * radius - r[ok])[:, None]
    self_dot = (u * f).sum(-1) - MARGIN * 2.0 * radius
    ft = f.T.contiguous()
    total = 0
    for s in range(0, u.shape[0], rows):
        total += int((u[s: s + rows] @ ft >= self_dot[s: s + rows, None]).sum())
    return total


def _counts() -> dict:
    return {k: v for k, v in hpr.launch_counts.items() if k != "hpr_grid"}


def dense_record(label: str, points, gate, device) -> dict:
    n_ok = int((gate & (torch.linalg.vector_norm(points, dim=-1) > 1e-9)).sum())
    hpr.reset_launch_counts()
    counting = device == "cuda" and hasattr(hpr, "support_stats")
    if counting:  # the kernel's pairs evaluated and subtiles kept
        hpr.support_stats = torch.zeros(2, dtype=torch.int64, device=device)
    vis = hpr.hpr_mask(points, gate)
    counts = _counts()
    if counting:
        counts["pairs_evaluated"], counts["subtiles_kept"] = hpr.support_stats.tolist()
        hpr.support_stats = None
    dev_ms = profiling.median_ms(lambda: hpr.hpr_mask(points, gate), device, reps=10, warmup=2,
                                 hide_host=True)
    call_ms = profiling.median_ms(lambda: hpr.hpr_mask(points, gate), device, reps=10, warmup=1)
    need = needed_pairs(points, gate)
    rec = {"set": label, "n": points.shape[0], "ok": n_ok, "visible": int(vis.sum()),
           "ms": dev_ms, "call_ms": call_ms, "needed_pairs": need,
           "needed_share": need / max(n_ok, 1) ** 2, "counts": counts}
    print(json.dumps(rec))
    return rec


def crossover_record(n_map: int, device) -> dict:
    camera, R, t, pts, valid = scene_views(n_map, device)
    cams, gates = hpr.view_points(camera, R, t, pts, valid)

    def h1_one():
        return hpr.hpr_mask(cams[0], gates[0])

    def h1_batch():
        return hpr.mask_batch(cams, gates, hpr.DEFAULT_RADIUS, 0.05, impl="dense")

    def h2_one():
        return hpr.hpr_mask_grid(cams[0], gates[0])

    def h2_batch():
        return hpr.hpr_mask_grid_views(camera, R, t, pts, valid)

    dense, grid = h1_batch(), h2_batch()
    rec = {"n_map": n_map, "gated": [int(g.sum()) for g in gates],
           "bits_differ": [int((a != b).sum()) for a, b in zip(dense, grid)],
           "visible_dense": [int(a.sum()) for a in dense],
           "visible_grid": [int(b.sum()) for b in grid]}
    for name, fn in (("h1_one", h1_one), ("h1_batch8", h1_batch), ("h2_one", h2_one),
                     ("h2_batch8", h2_batch)):
        rec[f"{name}_ms"] = profiling.median_ms(fn, device, reps=5, warmup=1, hide_host=True)
        rec[f"{name}_call_ms"] = profiling.median_ms(fn, device, reps=5, warmup=1)
    print(json.dumps(rec))
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="100000,262144")
    ap.add_argument("--scene", type=int, default=bs.N_MAP)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--maps", default="100000,262144,500000,1000000")
    args = ap.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hpr_dense_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = profiling.card() if device == "cuda" else device
    print(f"card: {card}")
    out = {"card": card, "dense": [], "crossover": []}
    for n in (int(s) for s in args.sizes.split(",") if s):
        out["dense"].append(dense_record(f"two walls {n}", *two_wall_set(n, device), device))
    if args.scene:
        camera, R, t, pts, valid = scene_views(args.scene, device)
        cams, gates = hpr.view_points(camera, R[:1], t[:1], pts, valid)
        out["dense"].append(dense_record(f"scene {args.scene} keyframe 0", cams[0], gates[0],
                                         device))
    if args.crossover:
        for n in (int(s) for s in args.maps.split(",") if s):
            out["crossover"].append(crossover_record(n, device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
