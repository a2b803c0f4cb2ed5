"""Sweep the inner solves' function-decrease exit (ftol) of the headline's
frozen + coarse-to-fine schedule, on bench scenes 1 and 2, on the card.

Counterpart of `pointcloudprocessor_tpu/tools/solver_sweep.py`. ``ftol``
stops an inner BFGS when an accepted step improves the value by less than
ftol * |f| (Ceres' function_tolerance). On the TPU it was attacked for its
~39 evaluations a solve; on the card a solve's wall is set by the host
(12-17 ms of host an evaluation, PERF.md §5), so fewer evaluations pay here
too. Each row: ``refine_s`` (the median of ``--reps`` calls after the
row's own solve from T0, and each call, CUDA events), the exact final NID,
evaluations, gathers and the pose error against the scene's truth (the
identity) in cm and degrees, from the row's solve from T0. A median under
the physical floor (the evaluations' point bytes over 3.35 TB/s) is null.
The schedule: ``max_inner`` 20 (``--inner``), ``max_outer`` 1,
``coarse_outer`` 1, stride 16, frozen taps at guard 0.75. ``--guards``
sweeps the guard instead, ftol fixed to the first ``--ftols`` entry.

The best row is the fastest value whose pose error is under 1 cm and 1
degree on both scenes (:func:`best_row`).

Usage: python -m pointcloudprocessor_tpu_torch.tools.solver_sweep
           [--quick] [--ftols 0,1e-5,3e-5,1e-4,3e-4] [--guards ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..opt import refine
from ..utils import profiling
from . import bench_scene
from .zbuffer_probe import check_device, device_kind

QUICK = (512, 384, 100_000, 32_768, 4)  # width, height, map points, culled points, keyframes
FULL = (bench_scene.WIDTH, bench_scene.HEIGHT, bench_scene.N_MAP, bench_scene.N_CULL,
        bench_scene.K)
SCHEDULE = dict(max_outer_iterations=1, coarse_outer_iterations=1, coarse_stride=16,
                frozen_taps=True)


def pose_error(T: se3.SE3):
    """(cm, degrees) of ``T`` from the identity, the scene's truth."""
    T = se3.SE3(T.q.detach().cpu(), T.t.detach().cpu())
    dt, dr = se3.delta_magnitudes(T, se3.identity("cpu"))
    return float(dt) * 100.0, float(np.degrees(float(dr)))


def run_row(camera, kfs, T0, kw: dict, reps: int, device, label: str) -> dict:
    """One sweep row: ``refine_pose(camera, kfs, T0, **kw)`` once (the
    row's result and the warm-up), then ``reps`` timed calls."""
    with profiling.annotate(label):
        res = refine.refine_pose(camera, kfs, T0, **kw)
        n_pts = kfs.points.shape[0] * kfs.points.shape[1]
        floor = profiling.floor_ms(res.evaluations * n_pts * 16.0)
        t = profiling.repeat_ms(lambda: refine.refine_pose(camera, kfs, T0, **kw), device,
                                reps=reps, warmup=0, floor=floor)
    cm, deg = pose_error(res.T_camera_lidar)
    return {
        "refine_s": None if t["ms"] is None else t["ms"] / 1e3,
        "refine_s_calls": [c / 1e3 for c in t["calls_ms"]],
        "below_floor": t["below_floor"],
        "nid": float(res.nid),
        "evaluations": int(res.evaluations),
        "gathers": int(res.gathers),
        "pose_err_cm": cm,
        "pose_err_deg": deg,
    }


def best_row(results: list, axis: str) -> dict:
    """The summary line (`solver_sweep.py:157-182`): the swept value whose
    rows are under 1 cm and 1 degree on every scene, fastest by the sum of
    its rows' ``refine_s``; rows without a time count as slowest."""
    by = {}
    for r in results:
        by.setdefault(r[axis], []).append(r)
    ok = [f for f, rows in by.items()
          if all(r["pose_err_cm"] < 1.0 and r["pose_err_deg"] < 1.0 for r in rows)]
    metric = f"solver_{axis}_sweep_best"
    if not ok:
        return {"metric": metric, axis: None,
                "note": "no value met the 1 cm/1 deg bar on both scenes"}

    def cost(f):
        return sum(float("inf") if r["refine_s"] is None else r["refine_s"] for r in by[f])

    best = min(ok, key=cost)
    return {"metric": metric, axis: best, "rows": by[best]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="solver_sweep")
    ap.add_argument("--quick", action="store_true", help="512x384, 100,000 points, 4 x 32,768")
    ap.add_argument("--ftols", default="0,1e-5,3e-5,1e-4,3e-4")
    ap.add_argument("--guards", default="",
                    help="optional guard sweep (comma floats); ftol is then the first --ftols "
                         "entry and the guard the swept axis")
    ap.add_argument("--inner", type=int, default=20, help="max inner iterations")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    width, height, n_map, n_cull, k = QUICK if args.quick else FULL

    if args.guards:
        axis, sweep = "guard", [float(g) for g in args.guards.split(",")]
        fixed_ftol = float(args.ftols.split(",")[0])
    else:
        axis, sweep = "ftol", [float(f) for f in args.ftols.split(",")]
    results = []
    for scene in (1, 2):
        camera, kfs, T0 = bench_scene.nid_scene(width, height, n_map, n_cull, k, dev, scene,
                                                args.seed)
        print(f"# scene {scene} built", file=sys.stderr)
        for f in sweep:
            ftol, guard = (fixed_ftol, f) if axis == "guard" else (f, 0.75)
            kw = dict(SCHEDULE, max_inner_iterations=args.inner, ftol=ftol,
                      frozen_guard_frac=guard)
            row = {"scene": f"s{scene}", axis: f,
                   **run_row(camera, kfs, T0, kw, args.reps, dev, f"solver_sweep/s{scene}/{f}")}
            results.append(row)
            print(json.dumps(row))
        del kfs
    best = best_row(results, axis)
    best.update(device=device_kind(dev),
                card=profiling.card() if dev.type == "cuda" else "not measured",
                scale=f"{k}x{n_cull}@{width}x{height}, map {n_map}", inner=args.inner)
    print(json.dumps(best))
    return {"rows": results, "best": best}


if __name__ == "__main__":
    main()
