"""Colorize / fusion cost anatomy on the card.

Counterpart of `pointcloudprocessor_tpu/tools/colorize_anatomy.py`. It times
nested prefixes of the eager colorize (`pipeline/colorize.observe_keyframe`,
the plain twin of C1) over the bench scene's keyframes
(`tools/bench_scene.py`), and beside them the production path, each the
median of ``--reps`` CUDA-event timings of all K keyframes, taken in rounds
that time every stage in turn:

  project    : SE3 transform + projection + score (elementwise)
  cull       : + the z-buffer cull, production ``cull_mask_uv`` (the
               ``zmin`` + ``zbuffer_visible`` kernels on the card)
  cull_plain : project + the cull's plain twin ``cull_mask_uv_plain`` on
               the card (the JAX tool's XLA ``cull`` vs Pallas
               ``cull_pallas`` pair, turned round: production is the kernel)
  pack       : cull + image pack to one int32 a pixel
  sample     : pack + the per-point color gather packed[flat]
  fuse_plain : ``colorize.fuse(plain=True)``, every keyframe through the
               twin (+ top-K update + blend): the eager path C1 replaced
  fuse       : the pipeline's whole ``colorize.fuse``, production (on the
               card C1: a memset and one pass (a) launch for all the
               keyframes, one pass (b) launch a keyframe, + the blend)

Successive differences attribute the cost, in ms per frame; ``full`` is
the production fuse a frame, ``full_plain`` the eager one. A stage time
below its physical floor (half the time to move its least bytes once at the
card's DRAM bandwidth) is printed as null and named under ``below_floor``,
as is a difference under the floor of the bytes its stage adds (a negative
one included); a difference that needs a refused stage is null. The run
ends with an exactness check
on every keyframe: the kernel's mask, the twin's, and the mask of
`zbuffer_probe.zmin_tiles` over the JAX tool's sink-cell and
2048-padding construction (`colorize_anatomy.py:88-103`) are bit-equal,
and so are the production and the eager fuse.

Usage:
  python -m pointcloudprocessor_tpu_torch.tools.colorize_anatomy [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import se3
from ..models import camera as cam
from ..ops import fusion, zbuffer
from ..pipeline import colorize
from ..utils import profiling
from ..utils.numeric import to_int32
from . import bench_scene
from .zbuffer_probe import BLK, FILL, check_device, device_kind, floor_ms, refuse_below_floor, zmin_tiles

DS, EPS = 14, 0.05
STAGES = ("project", "cull", "cull_plain", "pack", "sample", "fuse_plain", "fuse")
# Least bytes each stage moves once: per point (xyz in; the cull's cell and
# range; the sample's packed word; the top-K registers, 5 x (score, rgb)
# read and written) and per pixel (3 B in, 4 B out for the pack, which C1
# does not make).
_POINT_BYTES = {"project": 12, "cull": 20, "cull_plain": 20, "pack": 20, "sample": 24,
                "fuse_plain": 104, "fuse": 104}
_PIXEL_BYTES = {"pack": 7, "sample": 7, "fuse_plain": 7}


def tiles_inputs(camera, u, v, z, rng, valid, ds: int = DS):
    """The JAX tool's construction for the tile form (`colorize_anatomy.py:
    88-97`): (ok, cell with the sink gw*gh for a gated point, cell and range
    padded to a multiple of 2048 with the sink and 3.0e38, n_cells + 1)."""
    ok, cell, n_cells = zbuffer.cells(camera, u, v, z, valid, ds)
    rng_m = torch.where(ok, rng, FILL)
    npad = (-cell.shape[0]) % BLK
    cell_p = F.pad(cell, (0, npad), value=n_cells)
    rng_p = F.pad(rng_m, (0, npad), value=FILL)
    return ok, cell, cell_p, rng_p, n_cells + 1


def tiles_cull(camera, u, v, z, rng, valid, ds: int = DS, eps: float = EPS):
    """The cull through ``zmin_tiles`` (`colorize_anatomy.py:88-104`)."""
    ok, cell, cell_p, rng_p, n_slots = tiles_inputs(camera, u, v, z, rng, valid, ds)
    buf = zmin_tiles(cell_p, rng_p, n_slots)
    return ok & (rng <= buf.reshape(-1)[cell.long()] + eps)


def _project(scene, j):
    T_w2c = se3.inverse(se3.SE3(scene.poses.q[j], scene.poses.t[j]))
    p = scene.points
    x, y, z = se3.transform_xyz(T_w2c, p[:, 0], p[:, 1], p[:, 2])
    rng = torch.sqrt(x * x + y * y + z * z)
    u, v = cam.project_xyz(scene.camera, x, y, z)
    return x, y, z, rng, u, v


def run_stage(scene, stage: str) -> torch.Tensor:
    """One pass of ``stage`` over all keyframes; a scalar that consumes
    every output, so nothing is skipped."""
    camera = scene.camera
    if stage in ("fuse", "fuse_plain"):
        fz = colorize.fuse(camera, scene.points, scene.valid, scene.images, scene.poses,
                           se3.identity(scene.points.device), plain=stage == "fuse_plain")
        return fz.rgb.sum() + fz.colored.sum()
    acc = torch.zeros((), dtype=torch.float32, device=scene.points.device)
    for j in range(scene.images.shape[0]):
        x, y, z, rng, u, v = _project(scene, j)
        score = fusion.final_score_xyz(x, y, z, rng, scene.poses.t[j])
        acc = acc + score.sum() + u.sum() + v.sum()
        if stage == "project":
            continue
        cull = zbuffer.cull_mask_uv_plain if stage == "cull_plain" else zbuffer.cull_mask_uv
        acc = acc + cull(camera, u, v, z, rng, scene.valid, DS, EPS).sum()
        if stage in ("pack", "sample"):
            packed = fusion.pack_image_rgb(scene.images[j])
            acc = acc + packed[0].to(torch.float32)
        if stage == "sample":
            w, h = camera.width, camera.height
            ui = torch.clamp(to_int32(u), 0, w - 1)
            vi = torch.clamp(to_int32(v), 0, h - 1)
            acc = acc + (packed[(vi * w + ui).long()] & 0xFF).sum()
    return acc


def exact_masks(scene) -> bool:
    """Kernel, twin and tile-form masks bit-equal on every keyframe."""
    for j in range(scene.images.shape[0]):
        _, _, z, rng, u, v = _project(scene, j)
        args = (scene.camera, u, v, z, rng, scene.valid)
        got = zbuffer.cull_mask_uv(*args, DS, EPS)
        if not (torch.equal(got, zbuffer.cull_mask_uv_plain(*args, DS, EPS))
                and torch.equal(got, tiles_cull(*args))):
            return False
    return True


def exact_fuse(scene) -> bool:
    """The production fuse and the eager one bit-equal: colors, colored
    mask and observation counts."""
    args = (scene.camera, scene.points, scene.valid, scene.images, scene.poses,
            se3.identity(scene.points.device))
    got, want = colorize.fuse(*args), colorize.fuse(*args, plain=True)
    return (torch.equal(got.rgb.view(torch.int32), want.rgb.view(torch.int32))
            and torch.equal(got.colored, want.colored)
            and torch.equal(got.observation_count, want.observation_count))


def time_stages(scene, dev, reps: int) -> dict:
    """Median ms of each stage over ``reps`` rounds, after one round of
    warm-up. A round times every stage once, in turn, so that drift over
    the run (clocks, the shared host) falls on all stages alike and the
    differences of nested stages stay positive. None off the card, where
    each stage runs once."""
    if dev.type != "cuda":
        return {s: profiling.median_ms(lambda s=s: run_stage(scene, s), dev) for s in STAGES}
    runs = {s: [] for s in STAGES}
    for r in range(reps + 1):
        for s in STAGES:
            t = profiling.median_ms(lambda s=s: run_stage(scene, s), dev, reps=1, warmup=0)
            if r:
                runs[s].append(t)
    return {s: statistics.median(ts) for s, ts in runs.items()}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="colorize_anatomy")
    ap.add_argument("--quick", action="store_true", help="512x384, 100,000 points, 4 keyframes")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    if args.quick:
        width, height, n_map, k = 512, 384, 100_000, 4
    else:
        width, height, n_map, k = (bench_scene.WIDTH, bench_scene.HEIGHT, bench_scene.N_MAP,
                                   bench_scene.K)
    scene = bench_scene.build(width, height, n_map, k, dev)

    with torch.no_grad():
        times = time_stages(scene, dev, args.reps)
        for s, t in times.items():
            print(f"# {s}: {'not measured' if t is None else f'{t:.4f} ms for {k} frames'}",
                  file=sys.stderr)
        floors = {s: floor_ms(n_map * k, _POINT_BYTES[s])
                  + floor_ms(width * height * k, _PIXEL_BYTES.get(s, 0)) for s in STAGES}
        times, below = refuse_below_floor(times, floors)
        exact = exact_masks(scene) and exact_fuse(scene)

    def per_frame(name, a, b=None):
        """ms per frame of stage a, less stage b; None where either was
        refused, or (named under below_floor) where the difference is under
        the floor of the bytes stage a adds to stage b."""
        if times[a] is None or (b is not None and times[b] is None):
            return None
        if b is None:
            return times[a] / k
        if times[a] - times[b] < floors[a] - floors[b]:
            below.append(name)
            return None
        return (times[a] - times[b]) / k

    parts = {
        "project": per_frame("project", "project"),
        "zbuffer_scatter": per_frame("zbuffer_scatter", "cull", "project"),
        "zbuffer_scatter_plain": per_frame("zbuffer_scatter_plain", "cull_plain", "project"),
        "image_pack": per_frame("image_pack", "pack", "cull"),
        "sample_gather": per_frame("sample_gather", "sample", "pack"),
        "topk_blend": per_frame("topk_blend", "fuse_plain", "sample"),
        "full_plain": per_frame("full_plain", "fuse_plain"),
        "full": per_frame("full", "fuse"),
    }
    out = {
        "tool": "colorize_anatomy",
        "metric": "colorize_anatomy_ms_per_frame",
        "device": device_kind(dev),
        "card": profiling.card() if dev.type == "cuda" else "not measured",
        "k": k, "n_map": n_map, "width": width, "height": height,
        **parts,
        "below_floor": below,
        "exact": exact,
    }
    print(json.dumps(out))
    if not exact:
        raise AssertionError("colorize_anatomy: the masks or the fuses differ")
    return out


if __name__ == "__main__":
    main()
