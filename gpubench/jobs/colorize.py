"""Job kind ``colorize``: one multi-view fuse of the map a job.

Each job is ``pipeline/colorize.fuse`` of the scene's K keyframes over the
whole map, with the culling and fusion options the port's runner passes
(``runner._culling_kwargs`` and the config's ``FusionConfig``), the RGB
images already on the device as the runner holds them after upload, and a
correction of its own: within ``params["trans_m"]`` and ``params["rot_deg"]``
of the truth, drawn from the seed.

The check runs the plain fuse (``reference/colorize.py``) on the inputs of
a few jobs drawn from the seed and compares the port's outputs with its:
``count_err`` is the share of visible observations the cull disagrees on
(the sum over points of the difference in each point's count of views that
see it, over the reference's total), ``colored_err`` the share of points
whose colored flag differs and ``rgb_err`` the share of points colored on
both sides whose blended color differs by more than 1e-3 in a channel.
"""

from __future__ import annotations

import json
import random
import time

import torch

from gpubench import harness
from gpubench.reference import colorize as ref_colorize
from gpubench.scenes import bench_scene
from pointcloudprocessor_tpu_torch.core import se3
from pointcloudprocessor_tpu_torch.models import camera as cam
from pointcloudprocessor_tpu_torch.ops import fusion
from pointcloudprocessor_tpu_torch.pipeline import colorize, runner
from pointcloudprocessor_tpu_torch.utils.config import PipelineConfig

POOL = 1024  # corrections drawn at set-up; job i takes i mod POOL


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    SPAN = "colorize.job"  # the span each job opens around itself

    def __init__(self, ctx):
        self.ctx = ctx
        self.sc = ctx.config["scene"]
        self.pcfg = PipelineConfig.from_json(json.dumps(ctx.config["pipeline"]))
        self.setup_split = {}
        # The jobs whose outputs the check reads: a sample of the window's
        # jobs drawn from the seed as they complete (reservoir sampling).
        self.sample_rng = random.Random(ctx.seed)
        self.kept = []

    def setup(self):
        ctx, sc, dev = self.ctx, self.sc, self.ctx.device
        t = time.perf_counter()
        self.scene = bench_scene.build(sc, ctx.seed, dev, rgb=True)
        _sync(dev)
        self.setup_split["scene_s"] = time.perf_counter() - t
        t = time.perf_counter()
        c = self.scene.camera
        self.camera = cam.create_camera("pinhole", c["intrinsic"].tolist(),
                                        c["distortion"].tolist(), sc["width"], sc["height"], dev)
        self.kf_poses = se3.SE3(self.scene.kf_q, self.scene.kf_t)
        p = ctx.params
        q, tt = bench_scene.draw_corrections(POOL + 1, ctx.seed, 1, tuple(p["trans_m"]),
                                             tuple(p["rot_deg"]), stratified=False)
        self.corrections = [(q[i].to(dev), tt[i].to(dev)) for i in range(POOL + 1)]
        f = self.pcfg.fusion
        self.kwargs = dict(top_k=f.top_k, optimal_distance=f.optimal_distance,
                           score_floor=f.score_floor, saturation_scale=f.saturation_scale,
                           brightness_scale=f.brightness_scale,
                           reference_compat_orientation=f.reference_compat_orientation,
                           **runner._culling_kwargs(self.pcfg))
        _sync(dev)
        self.setup_split["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.fuse(POOL)  # warm-up: builds and loads the kernels
        _sync(dev)
        self.setup_split["warm_fuse_s"] = time.perf_counter() - t

    def fuse(self, j):
        q, t = self.corrections[j]
        s = self.scene
        return colorize.fuse(self.camera, s.points, s.valid, s.images, self.kf_poses,
                             se3.SE3(q, t), **self.kwargs)

    def run(self, i):
        t = time.perf_counter()
        with torch.profiler.record_function("colorize.job"):
            out = self.fuse(i % POOL)
            _sync(self.ctx.device)
        wall = time.perf_counter() - t
        n_keep = self.ctx.params["check_jobs"]
        # "work": every fuse fuses the same views over the same map.
        rec = {"i": i, "work": 0, "wall": wall}
        if len(self.kept) < n_keep:
            self.kept.append((i, out))
        else:
            j = self.sample_rng.randrange(i + 1)
            if j < n_keep:
                self.kept[j] = (i, out)
        return rec

    def spans(self):
        return [(colorize, "depth_keys", "colorize.depth_keys"),
                (colorize, "hpr_masks", "colorize.hpr_masks"),
                (colorize, "fuse_keyframe", "colorize.fuse_keyframe"),
                (fusion, "blend_topk", "fusion.blend_topk")]

    def release(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, j, dtype=torch.float32, stats=None):
        """The plain fuse of job input ``j``: (rgb, colored, count)."""
        s, c = self.scene, self.pcfg
        q, t = self.corrections[j]
        fus = {"top_k": c.fusion.top_k, "optimal_distance": c.fusion.optimal_distance,
               "score_floor": c.fusion.score_floor}
        cul = {"method": c.culling.method, "downsample_factor": c.culling.downsample_factor,
               "depth_epsilon": c.culling.depth_epsilon,
               "hidden_points_removal_max_z": c.culling.hidden_points_removal_max_z,
               "hpr_tolerance": c.culling.hpr_tolerance}
        return ref_colorize.fuse(s.camera, s.points, s.valid, s.images, s.kf_q, s.kf_t, q, t,
                                 fus, cul, dtype, stats)

    def check(self, records):
        """Compares the outputs of the jobs kept as the window ran (a sample
        of ``params["check_jobs"]`` drawn from the seed)."""
        count = colored = rgb = 0.0
        self.checked = []
        with torch.no_grad():
            for i, out in self.kept:
                r_rgb, r_col, r_cnt = self.reference(i % POOL)
                diff_cnt = (out.observation_count.to(torch.int64) - r_cnt).abs().sum()
                row = {"i": i,
                       "count_err": float(diff_cnt) / max(1.0, float(r_cnt.sum())),
                       "colored_err": float((out.colored != r_col).float().mean())}
                both = out.colored & r_col
                bad = ((out.rgb - r_rgb).abs() > 1e-3).any(-1) & both
                row["rgb_err"] = float(bad.sum()) / max(1.0, float(both.sum()))
                self.checked.append(row)
                count = max(count, row["count_err"])
                colored = max(colored, row["colored_err"])
                rgb = max(rgb, row["rgb_err"])
        self.kept = []
        return {"count_err": count, "colored_err": colored, "rgb_err": rgb}

    def end_to_end(self, window_s, records):
        return {"colorize_s": window_s / len(records),
                "colorize_p95_s": harness.p95([r["wall"] for r in records])}

    def counts(self, traced):
        """What the rooflines read of the traced jobs: the views, the map,
        the z-buffer grid and, from the reference's fuse of the first
        traced job's input, each keyframe's points in front, gated in,
        visible, slots replaced and pixels sampled."""
        if not traced:
            return {}
        stats = []
        with torch.no_grad():
            self.reference(traced[0]["i"] % POOL, stats=stats)
        c = self.pcfg.culling
        w, h = self.sc["width"], self.sc["height"]
        return {"n": int(self.scene.points.shape[0]), "valid": int(self.scene.valid.sum()),
                "views": self.sc["keyframes"], "batch": colorize.SCATTER_VIEWS,
                "cells": (w // c.downsample_factor) * (h // c.downsample_factor),
                "method": c.method, "top_k": self.pcfg.fusion.top_k, "stats": stats,
                "jobs": len(traced)}

    def detail(self, records):
        walls = [r["wall"] for r in records]
        return {"walls": walls, "checked": getattr(self, "checked", [])}
