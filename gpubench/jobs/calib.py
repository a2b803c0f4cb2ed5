"""Job kind ``calib``: one calibration solve a job.

Each job is the NID solve of the port's runner: ``pipeline/runner._refine``
(``opt/refine.refine_pose`` with the options the config's ``NIDConfig``
gives) on the scene's K keyframes, from its own initial guess: the true
correction (the identity: the keyframes are culled at their true poses)
composed with an error of ``params["trans_m"]`` in translation and
``params["rot_deg"]`` in rotation, in a random direction, the magnitudes
spread evenly over their ranges. The set of guesses is the same for every
seed; the seed orders it. The keyframes are the unprepared batch the runner
hands over, so each solve packs its bin images (B1) itself.

The check runs the plain NID (``reference/nid.py``) at the returned
correction of ``params["check_jobs"]`` of the window's solves, drawn from
the seed: ``nid_gap`` is each solve's reported NID against the reference's
at its pose (relative), ``excess_left`` the share of its start's NID excess
(the reference NID above the truth's) left at its pose, which reads 1 for a
solve that returns its start unchanged, ``pose_cm`` / ``pose_deg`` its
distance from the truth, and ``nid_excess`` the reference NID at its pose
above the truth's. Each is the largest over the solves checked.
"""

from __future__ import annotations

import json
import random
import time

import torch

from gpubench.reference import geometry as g
from gpubench.reference import nid as ref_nid
from gpubench.rooflines import g1
from gpubench.scenes import bench_scene
from pointcloudprocessor_tpu_torch.core import se3
from pointcloudprocessor_tpu_torch.kernels import build as kbuild
from pointcloudprocessor_tpu_torch.models import camera as cam
from pointcloudprocessor_tpu_torch.opt import bfgs
from pointcloudprocessor_tpu_torch.opt import nid as nid_mod
from pointcloudprocessor_tpu_torch.pipeline import runner
from pointcloudprocessor_tpu_torch.utils.config import PipelineConfig

# The initial guesses: one set for every seed, drawn from seed 0, taken in
# an order drawn from the run's seed (job i takes order[i mod POOL]), so
# that runs with different seeds solve the same problems.
POOL = 16
SHAPE_KERNELS = ("nid_hist_fwd", "nid_hist_bwd", "tap_take")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    SPAN = "calib.solve"  # the span each job opens around itself

    def __init__(self, ctx):
        self.ctx = ctx
        self.sc = ctx.config["scene"]
        self.pcfg = PipelineConfig.from_json(json.dumps(ctx.config["pipeline"]))
        self.setup_split = {}

    def setup(self):
        ctx, sc, dev = self.ctx, self.sc, self.ctx.device
        t = time.perf_counter()
        scene = bench_scene.build(sc, ctx.seed, dev, bins=self.pcfg.nid.bins)
        _sync(dev)
        self.setup_split["scene_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pts, inten, valid = bench_scene.nid_keyframes(sc, scene, self.pcfg.culled_capacity,
                                                      ctx.seed)
        self.inputs = {"points": pts, "intensity": inten, "valid": valid,
                       "bin_image": scene.bin_image}
        self.camera_ref = scene.camera
        del scene
        self.kfs = nid_mod.NIDKeyframe(points=pts, intensity=inten, valid=valid,
                                       bin_image=self.inputs["bin_image"])
        c = self.camera_ref
        self.camera = cam.create_camera("pinhole", c["intrinsic"].tolist(),
                                        c["distortion"].tolist(), sc["width"], sc["height"], dev)
        p = ctx.params
        q, tt = bench_scene.draw_corrections(POOL + 1, 0, 1, tuple(p["trans_m"]),
                                             tuple(p["rot_deg"]), stratified=True)
        self.starts = [se3.SE3(q[i].to(dev), tt[i].to(dev)) for i in range(POOL + 1)]
        self.order = random.Random(ctx.seed).sample(range(POOL), POOL)
        _sync(dev)
        self.setup_split["keyframes_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.solve(self.starts[POOL])  # warm-up: builds and loads the kernels
        _sync(dev)
        self.setup_split["warm_solve_s"] = time.perf_counter() - t

    def solve(self, T0):
        return runner._refine(self.pcfg, self.camera, self.kfs, T0,
                              self.pcfg.nid.max_outer_iterations)

    def start(self, i):
        return self.starts[self.order[i % POOL]]

    def run(self, i):
        T0 = self.start(i)
        if self.ctx.trace:
            kbuild.reset_launch_shapes(SHAPE_KERNELS)
        t = time.perf_counter()
        with torch.profiler.record_function("calib.solve"):
            res = self.solve(T0)
            nid = float(res.nid)  # waits for the solve's last evaluation
        wall = time.perf_counter() - t
        # "work": the start; solves from one start do the same work.
        rec = {"i": i, "work": self.order[i % POOL], "wall": wall, "nid": nid,
               "evaluations": int(res.evaluations),
               "gathers": int(res.gathers), "converged": bool(res.converged),
               "outer": int(res.outer_iterations),
               "q": res.T_camera_lidar.q.detach(), "t": res.T_camera_lidar.t.detach()}
        if self.ctx.trace:
            rec["shapes"] = {f"{k}:{n}": c for (k, n), c in kbuild.launch_shapes.items()
                             if k in SHAPE_KERNELS}
        return rec

    def spans(self):
        # torch.autograd.grad is wrapped for the traced solves alone: the
        # objective's backward runs inside it (opt/refine's value_and_grad).
        return [(bfgs, "minimize_cached", "bfgs.minimize_cached"),
                (torch.autograd, "grad", "refine.backward"),
                (nid_mod, "prepare_keyframes", "nid.prepare_keyframes"),
                (nid_mod, "make_tap_cache", "nid.make_tap_cache"),
                (nid_mod, "multi_nid_loss", "nid.multi_nid_loss"),
                (nid_mod, "multi_nid_loss_cached", "nid.multi_nid_loss_cached"),
                (nid_mod, "_project_all", "nid.project"),
                (nid_mod, "_gather_taps", "nid.gather_taps"),
                (nid_mod, "_histograms_from_taps", "nid.histograms"),
                (nid_mod, "nid_from_histograms", "nid.entropies")]

    def release(self):
        self.kfs = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ref(self, q, t, dtype=torch.float32):
        c, s, x = self.camera_ref, self.sc, self.inputs
        return float(ref_nid.nid_sum(c["intrinsic"], c["distortion"], s["width"], s["height"], q, t,
                                     x["points"], x["intensity"], x["valid"], x["bin_image"],
                                     self.pcfg.nid.bins, dtype))

    def check(self, records):
        """Judges ``params["check_jobs"]`` of the window's solves, drawn
        from the seed."""
        dev = self.ctx.device
        rng = random.Random(self.ctx.seed)
        n = min(len(records), self.ctx.params["check_jobs"])
        records = [records[j] for j in sorted(rng.sample(range(len(records)), n))]
        with torch.no_grad():
            truth = self._ref(torch.tensor([1.0, 0, 0, 0], device=dev), torch.zeros(3, device=dev))
            gap = left = excess = cm = deg = 0.0
            self.checked = []
            for r in records:
                at = self._ref(r["q"], r["t"])
                c, d = g.pose_error(r["q"], r["t"])
                T0 = self.start(r["i"])
                start = self._ref(T0.q, T0.t)
                row = {"i": r["i"], "nid": r["nid"], "nid_ref": at, "pose_cm": c, "pose_deg": d,
                       "start_nid_ref": start, "start_cm_deg": g.pose_error(T0.q, T0.t)}
                self.checked.append(row)
                gap = max(gap, abs(r["nid"] - at) / abs(at))
                # Every start lies centimetres off, far above the truth's NID.
                left = max(left, (at - truth) / (start - truth))
                excess = max(excess, at - truth)
                cm, deg = max(cm, c), max(deg, d)
        self.truth_nid = truth
        return {"nid_gap": gap, "excess_left": left, "pose_cm": cm, "pose_deg": deg,
                "nid_excess": excess}

    def end_to_end(self, window_s, records):
        return {"calib_s": window_s / len(records)}

    def counts(self, traced):
        """What the rooflines read of the traced solves: the launches by
        shape and the distinct window pixels of G1 at each shape, counted
        at the first traced solve's start (coarse) and end (fine)."""
        if not traced:
            return {}
        s, c = self.sc, self.camera_ref
        nidc = self.pcfg.nid
        shapes = {}
        for r in traced:
            for key, n in r["shapes"].items():
                shapes[key] = shapes.get(key, 0) + n
        r = traced[0]
        T0 = self.start(r["i"])
        x = self.inputs
        pixels = {}
        with torch.no_grad():
            for label, (q, t, stride) in {
                    "coarse": (T0.q, T0.t, max(1, nidc.coarse_stride)),
                    "fine": (r["q"], r["t"], 1)}.items():
                p = x["points"][:, ::stride]
                R = g.quat_to_matrix(q)
                px, py, pz = g.transform_xyz(R, t, p[..., 0], p[..., 1], p[..., 2])
                u, v = g.project_xyz(c["intrinsic"], c["distortion"], px, py, pz)
                knot = torch.stack([g.to_int32(torch.floor(u)), g.to_int32(torch.floor(v))], -1)
                pixels[p.shape[1]] = g1.window_pixels(knot, s["width"], s["height"])
        return {"k": s["keyframes"], "width": s["width"], "height": s["height"],
                "shapes": shapes, "window_pixels": pixels, "solves": len(traced),
                "evaluations": sum(t["evaluations"] for t in traced)}

    def detail(self, records):
        return {"solves": [{k: v for k, v in r.items() if k not in ("q", "t")} for r in records],
                "checked": getattr(self, "checked", []),
                "truth_nid": getattr(self, "truth_nid", None)}
