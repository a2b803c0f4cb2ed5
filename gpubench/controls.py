"""The controls of the check: the plain reference put in the port's place,
computed a precision lower than the configuration states (bfloat16 for its
float32). A sound check reads each control as not correct.

* ``calib``: the solve runs the port's own solve loop (``runner._refine`` and
  ``opt/refine.refine_pose`` with every option of the config) over the
  reference's NID in bfloat16 instead of the port's objective, through
  ``refine_pose``'s ``loss_fn`` and ``frozen_impl`` hooks (the frozen phase
  evaluates the same objective afresh each time).
* ``colorize``: the reference's fuse in bfloat16 in place of
  ``pipeline/colorize.fuse``.

``install(kind)`` puts a control in place and returns a function that takes
it out again. ``python3 gpubench/controls.py --workload W --seeds a,b,c
--seconds S`` runs the cell with its control, seed by seed, in one process,
and prints each run's compared numbers; ``--program`` runs the port itself
the same way (the lower readings of the limits).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class _Cache(NamedTuple):
    refreshes: int
    partials: int
    drift_accum: torch.Tensor


def install(kind: str, dtype=torch.bfloat16):
    """Put the control of job kind ``kind`` in the port's place; returns
    the function that restores the port."""
    from gpubench.reference import colorize as ref_colorize
    from gpubench.reference import nid as ref_nid

    if kind == "calib":
        from pointcloudprocessor_tpu_torch.opt import refine

        original = refine.refine_pose

        def loss(camera, T, kfs, bins):
            return ref_nid.nid_sum(camera.intrinsic, camera.distortion, camera.width,
                                   camera.height, T.q, T.t, kfs.points, kfs.intensity, kfs.valid,
                                   kfs.bin_image, bins, dtype)

        def make_cache(camera, T, kfs):
            return _Cache(1, 0, torch.zeros((), device=kfs.points.device))

        def cached(camera, T, kfs, cache, bins, guard_frac=0.0):
            return loss(camera, T, kfs, bins), cache

        def control(*args, **kwargs):
            return original(*args, loss_fn=loss, frozen_impl=(make_cache, cached),
                            use_grouped_gather=None, **kwargs)

        refine.refine_pose = control
        return lambda: setattr(refine, "refine_pose", original)
    if kind == "colorize":
        from pointcloudprocessor_tpu_torch.pipeline import colorize

        original = colorize.fuse

        def control(camera, points, valid, images, kf_poses, T, mask_images=None, **kw):
            cam_d = {"intrinsic": camera.intrinsic, "distortion": camera.distortion,
                     "width": camera.width, "height": camera.height}
            fus = {k: kw[k] for k in ("top_k", "optimal_distance", "score_floor")}
            cul = {"method": kw["culling_method"], "downsample_factor": kw["downsample_factor"],
                   "depth_epsilon": kw["depth_epsilon"],
                   "hidden_points_removal_max_z": kw["hpr_radius"],
                   "hpr_tolerance": kw["hpr_tolerance"]}
            rgb, colored, count = ref_colorize.fuse(cam_d, points, valid, images, kf_poses.q,
                                                    kf_poses.t, T.q, T.t, fus, cul, dtype)
            return colorize.FusionResult(rgb=rgb, colored=colored, best_label=None,
                                         observation_count=count)

        colorize.fuse = control
        return lambda: setattr(colorize, "fuse", original)
    raise ValueError(f"no control for job kind {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control (or the port) over many seeds")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", action="store_true", help="run the port, not the control")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    from gpubench import harness

    kind = harness.load_cell(ROOT, args.workload).workload["job"]
    restore = None if args.program else install(kind)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            out = harness.execute(ROOT, args.workload, seed, args.seconds, False, "cuda")
            res = out["result"]
            row = {"workload": args.workload, "side": "program" if args.program else "control",
                   "seed": seed, "correct": res["correct"], "jobs": out["detail"]["jobs"],
                   "values": out["detail"]["check_values"],
                   "checked": out["detail"]["job_detail"].get("checked"),
                   "seconds": time.perf_counter() - t}
            print("READING " + json.dumps(row), flush=True)
    finally:
        if restore is not None:
            restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
