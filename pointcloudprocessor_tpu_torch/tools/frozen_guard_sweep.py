"""Sweep the frozen-tap cache's staleness guard on bench scene 1, on the
card.

Counterpart of `pointcloudprocessor_tpu/tools/frozen_guard_sweep.py`.
``frozen_guard_frac`` bounds how far a solve rides the frozen taps before it
re-gathers (the share of live points whose anchor drifted >= 1 px). On the
TPU a fresh gather cost ~20 ms, so the guard traded gathers against
surrogate error. On the card a gather is one G1 launch of ~0.05 ms, so the
question becomes what else a re-gather costs: the host syncs around it.
Each row: the guard, ``refine_s`` (the median of ``--reps`` calls after the
row's own solve, and each call, CUDA events), refine-only frames/s, the
exact final NID, evaluations and gathers, and from one ``torch.profiler``
capture of the solve its host syncs and launches, the re-gathers (gathers
after the first) and syncs per re-gather. Then :func:`regather_cost` puts
one guarded cached evaluation that re-gathers beside one that does not:
the difference is what a re-gather costs in wall, device time, launches
and syncs. The schedule: ``max_inner`` 10, ``max_outer`` 2, frozen taps.

Usage: python -m pointcloudprocessor_tpu_torch.tools.frozen_guard_sweep
           [--quick] [--guards 0.25,0.5,0.75,1.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from ..core import se3
from ..opt import nid, refine
from ..utils import profiling
from . import bench_scene
from .solver_sweep import FULL, QUICK, run_row
from .zbuffer_probe import check_device, device_kind

SCHEDULE = dict(max_inner_iterations=10, max_outer_iterations=2, frozen_taps=True)
DRIFT_PX = 3.0  # a drift past the guard's 1 px for every point


def solve_split(camera, kfs, T0, kw: dict, device) -> dict:
    """Syncs and launches of one solve (``profiling.eval_split``, one call)."""
    split = profiling.eval_split(lambda: refine.refine_pose(camera, kfs, T0, **kw), device,
                                 reps=1, warmup=0)
    return {"syncs": split["syncs"], "launches": split["launches"],
            "device_busy_s": None if split["device_busy_ms"] is None
            else split["device_busy_ms"] / 1e3, "idle_share": split["idle_share"]}


def regather_cost(camera, kfs, device, reps: int = 10) -> dict:
    """One guarded frozen evaluation (value+grad, guard 0.75) from a cache
    gathered at the identity: at the identity (no re-gather) and with the
    pose moved ``DRIFT_PX`` pixels (every point drifts: a re-gather),
    each a fresh cache, split by ``profiling.eval_split``."""
    ident = se3.identity(device)
    f_px = float(camera.intrinsic[0])
    moved = se3.SE3(ident.q, ident.t + torch.tensor([DRIFT_PX * 6.0 / f_px, 0.0, 0.0],
                                                    device=device))
    cache = nid.make_tap_cache(camera, ident, kfs)
    vg = refine._guarded_objective(
        0.2, 0.034907,
        lambda T, c: nid.multi_nid_loss_cached(camera, T, kfs, c, guard_frac=0.75))
    out = {}
    for name, T in (("frozen", ident), ("regather", moved)):
        xi = torch.zeros(6, dtype=torch.float32, device=device)
        refreshes = vg(xi, T, cache)[2].refreshes - cache.refreshes
        with profiling.span(f"frozen_guard_sweep/{name}_eval"):
            split = profiling.eval_split(lambda: vg(xi, T, cache), device, reps)
        out[name] = {"refreshes": refreshes, **split}
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="frozen_guard_sweep")
    ap.add_argument("--quick", action="store_true", help="512x384, 100,000 points, 4 x 32,768")
    ap.add_argument("--guards", default="0.25,0.5,0.75,1.0")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    width, height, n_map, n_cull, k = QUICK if args.quick else FULL

    camera, kfs, T0 = bench_scene.nid_scene(width, height, n_map, n_cull, k, dev, 1, args.seed)
    print("# scene built", file=sys.stderr)
    results = []
    for g in (float(x) for x in args.guards.split(",")):
        kw = dict(SCHEDULE, frozen_guard_frac=g)
        row = run_row(camera, kfs, T0, kw, args.reps, dev, f"frozen_guard_sweep/{g}")
        split = solve_split(camera, kfs, T0, kw, dev)
        regathers = row["gathers"] - 1
        row = {
            "guard": g, "refine_s": row["refine_s"], "refine_s_calls": row["refine_s_calls"],
            "frames_per_s_refine_only": None if row["refine_s"] is None else k / row["refine_s"],
            "nid": row["nid"], "evaluations": row["evaluations"], "gathers": row["gathers"],
            "regathers": regathers, **split,
            "syncs_per_regather": (None if split["syncs"] is None or regathers == 0
                                   else split["syncs"] / regathers),
            "pose_err_cm": row["pose_err_cm"], "pose_err_deg": row["pose_err_deg"],
            "below_floor": row["below_floor"],
        }
        results.append(row)
        print(json.dumps(row))
    cost = regather_cost(camera, kfs, dev)
    print(json.dumps({"probe": "regather_cost", **cost}))
    timed = [r for r in results if r["refine_s"] is not None]
    best = min(timed, key=lambda r: r["refine_s"]) if timed else {}
    summary = {"metric": "frozen_guard_sweep_best", **best,
               "device": device_kind(dev),
               "card": profiling.card() if dev.type == "cuda" else "not measured",
               "scale": f"{k}x{n_cull}@{width}x{height}, map {n_map}"}
    print(json.dumps(summary))
    return {"rows": results, "regather_cost": cost, "best": summary}


if __name__ == "__main__":
    main()
