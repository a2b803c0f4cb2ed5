"""Multi-device scaling of the sharded NID solve and the sharded fuse.

Counterpart of `pointcloudprocessor_tpu/tools/scaling_bench.py`, over the
port's ``parallel/`` on a (kf, pt) mesh of ``torch.distributed`` ranks.
:func:`run_once` builds a wall scene (every keyframe the same 8 x N points
at z = 5 m, a planted correction), then times one
``nid_shard.refine_pose_sharded`` + ``fusion_shard.fuse_sharded`` step
after a warm-up step, on whatever world the process group holds. At a world
of 1 it also runs the serial ``refine.refine_pose`` and ``colorize.fuse``
on the same inputs and says whether they are the same bits.

Where it runs:

- ``python -m pointcloudprocessor_tpu_torch.tools.scaling_bench`` on the
  card: a world of 1 over NCCL (``mesh.init_distributed`` without
  torchrun's environment). Cross-card scaling is not measured there: the
  machine holds one H100. Under ``torchrun --nproc-per-node N`` each rank
  takes its card and the row is a world of N.
- ``--virtual N``: JAX's virtual CPU devices become N Gloo ranks on the
  CPU, spawned as subprocesses (a file store in a temporary directory, one
  torch thread a rank), with a world of 1 beside them. That checks the
  sharded path end to end (collectives, convergence), not speed: the ranks
  share the host's cores.

Prints one JSON object a world and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import se3
from ..models import camera as cam
from ..opt import nid, refine
from ..parallel import fusion_shard, nid_shard
from ..parallel import mesh as mesh_lib
from ..pipeline import colorize
from ..utils import profiling
from .zbuffer_probe import check_device, device_kind

T0_TANGENT = (0.02, -0.01, 0.01, 0.004, -0.002, 0.004)
WALL_Z = 5.0
FUSE_KW = dict(downsample_factor=4, depth_epsilon=0.25)
UNMEASURED = ("cross-card scaling unmeasured: one H100 in this machine; the row is a world of "
              "1 over NCCL")
VIRTUAL_NOTE = ("Gloo ranks on one host's CPU: checks the sharded path, meaningful only on real "
                "chips")


def wall_scene(k: int, n_points: int, width: int, height: int, device, draws=None,
               seed: int = 0):
    """(camera, keyframes, images, poses, T0, map points) of
    `scaling_bench.py:42-83`, whole (unsharded): every keyframe sees the
    same N points on a wall at z = 5 m from the identity pose. ``draws``
    (u, v), each (N,) f32 pixels, as JAX's; None draws them with numpy."""
    f_px = width / 2.0
    camera = cam.create_camera("pinhole", (f_px, f_px, width / 2.0, height / 2.0), (0.0,) * 5,
                               width, height, device)
    if draws is None:
        rs = np.random.default_rng(seed)
        draws = (rs.uniform(2.0, width - 2.0, n_points), rs.uniform(2.0, height - 2.0, n_points))
    u, v = (torch.as_tensor(np.asarray(a, np.float32), device=device) for a in draws)
    f = torch.tensor(f_px, dtype=torch.float32, device=device)  # exact division on the card too
    x = (u - width / 2.0) / f * WALL_Z
    y = (v - height / 2.0) / f * WALL_Z
    pts = torch.stack([x, y, torch.full_like(x, WALL_Z)], -1)
    inten = torch.clamp(0.5 + 0.25 * torch.sin(7 * x) + 0.25 * torch.cos(9 * y), 0, 1)
    uu = (torch.arange(width, dtype=torch.float32, device=device) - width / 2.0) / f * WALL_Z
    vv = (torch.arange(height, dtype=torch.float32, device=device) - height / 2.0) / f * WALL_Z
    gray = torch.clamp(0.5 + 0.25 * torch.sin(7 * uu[None]) + 0.25 * torch.cos(9 * vv[:, None]),
                       0, 1)
    kfs = nid.NIDKeyframe(
        points=pts.expand(k, n_points, 3).contiguous(),
        intensity=inten.expand(k, n_points).contiguous(),
        valid=torch.ones((k, n_points), dtype=torch.bool, device=device),
        bin_image=nid.quantize_image(gray, 16).expand(k, height, width).contiguous(),
    )
    images = (gray[..., None] * 255).to(torch.uint8).expand(k, height, width, 3).contiguous()
    poses = se3.identity(device, batch_shape=(k,))
    T0 = se3.exp(torch.tensor(T0_TANGENT, dtype=torch.float32, device=device))
    return camera, kfs, images, poses, T0, pts


def run_once(k: int, n_points: int, width: int, height: int, inner: int, outer: int,
             kf_ax: Optional[int] = None, frozen: bool = False, c2f: bool = False,
             device="cuda", draws=None) -> dict:
    """One row over the default process group's world (which must be up:
    ``mesh.init_distributed``): the mesh (kf = the largest divisor of the
    world up to K by default, pt the rest), a warm-up step, then one timed
    sharded solve + fuse (`scaling_bench.py:22-115`). ``--frozen`` runs the
    frozen-tap objective, ``--c2f`` the coarse-to-fine schedule (1 coarse
    outer iteration, stride 2). The same on every rank."""
    n_dev = dist.get_world_size()
    if kf_ax is None:
        kf_ax = min(k, n_dev)
        while n_dev % kf_ax:
            kf_ax -= 1
    pt_ax = n_dev // kf_ax
    mesh = mesh_lib.make_mesh(kf=kf_ax, pt=pt_ax)
    camera, kfs, images, poses, T0, pts = wall_scene(k, n_points, width, height, device, draws)
    valid = torch.ones((n_points,), dtype=torch.bool, device=device)
    local = mesh_lib.shard_keyframes(mesh, kfs)
    map_pts, map_valid = mesh_lib.shard_pt(mesh, pts), mesh_lib.shard_pt(mesh, valid)
    kf_images, kf_poses = mesh_lib.shard_kf(mesh, images), se3.SE3(
        mesh_lib.shard_kf(mesh, poses.q), mesh_lib.shard_kf(mesh, poses.t))
    solve_kw = dict(max_inner_iterations=inner, max_outer_iterations=outer, frozen_taps=frozen,
                    coarse_outer_iterations=1 if c2f else 0, coarse_stride=2)

    def step():
        with profiling.span("scaling_bench/step"):
            res = nid_shard.refine_pose_sharded(camera, local, T0, mesh, **solve_kw)
            fused = fusion_shard.fuse_sharded(camera, map_pts, map_valid, kf_images, kf_poses,
                                              res.T_camera_lidar, mesh, **FUSE_KW)
        return res, fused

    step()
    profiling.synchronize(device)
    t0 = time.perf_counter()
    res, fused = step()
    profiling.synchronize(device)
    dt = time.perf_counter() - t0
    colored = mesh_lib.gather_pt(mesh, fused.colored.to(torch.int32))
    row = {
        "devices": n_dev,
        "mesh": {"kf": kf_ax, "pt": pt_ax},
        "backend": dist.get_backend(),
        "seconds": dt if torch.device(device).type == "cuda" else None,
        "frames_per_s": k / dt if torch.device(device).type == "cuda" else None,
        "nid": float(res.nid),
        "colored": int(colored.sum()),
        "evaluations": int(res.evaluations),
    }
    if n_dev == 1:
        serial = refine.refine_pose(camera, kfs, T0, **solve_kw)
        fz = colorize.fuse(camera, pts, valid, images, poses, serial.T_camera_lidar, **FUSE_KW)
        row["serial_equal"] = bool(
            torch.equal(serial.T_camera_lidar.q, res.T_camera_lidar.q)
            and torch.equal(serial.T_camera_lidar.t, res.T_camera_lidar.t)
            and torch.equal(serial.nid, res.nid) and torch.equal(fz.rgb, fused.rgb)
            and torch.equal(fz.colored, fused.colored))
    return row


def _rank_main(args) -> None:
    """One Gloo rank of ``--virtual``: join through the file store, run,
    rank 0 writes the row."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(args.store, 'store')}",
                            rank=args.rank, world_size=args.world)
    try:
        draws = None
        path = os.path.join(args.store, "draws.npz")
        if os.path.exists(path):
            d = np.load(path)
            draws = (d["u"], d["v"])
        row = run_once(args.keyframes, args.points, args.width, args.height, args.inner,
                       args.outer, kf_ax=args.kf, frozen=args.frozen, c2f=args.c2f,
                       device="cpu", draws=draws)
        if args.rank == 0:
            with open(os.path.join(args.store, "row.json"), "w") as f:
                json.dump(row, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_virtual(world: int, k: int, n_points: int, width: int, height: int, inner: int,
                outer: int, kf_ax: Optional[int] = None, frozen: bool = False,
                c2f: bool = False, draws=None, timeout: float = 600.0) -> dict:
    """:func:`run_once` on ``world`` Gloo CPU ranks, each a subprocess;
    returns rank 0's row. A rank that fails or hangs past ``timeout``
    seconds raises, and every rank still alive is killed."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {key: v for key, v in os.environ.items()
           if key not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory() as store:
        if draws is not None:
            np.savez(os.path.join(store, "draws.npz"), u=draws[0], v=draws[1])
        argv = ["--keyframes", str(k), "--points", str(n_points), "--width", str(width),
                "--height", str(height), "--inner", str(inner), "--outer", str(outer),
                "--world", str(world), "--store", store] + ["--frozen"] * frozen + ["--c2f"] * c2f
        if kf_ax is not None:
            argv += ["--kf", str(kf_ax)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pointcloudprocessor_tpu_torch.tools.scaling_bench",
             "--rank", str(r), *argv], env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise RuntimeError("a virtual rank failed:\n" + "\n".join(outs))
        with open(os.path.join(store, "row.json")) as f:
            return json.load(f)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_bench", description="multi-device scaling")
    ap.add_argument("--virtual", type=int, default=0,
                    help="N Gloo ranks on the CPU (checks the sharded path, not speedup)")
    ap.add_argument("--keyframes", type=int, default=8)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--outer", type=int, default=2)
    ap.add_argument("--frozen", action="store_true", help="the frozen-tap objective")
    ap.add_argument("--c2f", action="store_true", help="coarse-to-fine (1 coarse outer, stride 2)")
    ap.add_argument("--sweep-shapes", action="store_true",
                    help="also run every (kf x pt) mesh factorization of the largest world "
                         "(--virtual) and require the NIDs within 1e-3")
    ap.add_argument("--device", default="cuda")
    # One rank of --virtual (internal).
    ap.add_argument("--kf", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    shape = (args.keyframes, args.points, args.width, args.height, args.inner, args.outer)
    if args.virtual:
        rows = [run_virtual(w, *shape, frozen=args.frozen, c2f=args.c2f)
                for w in sorted({1, args.virtual})]
        note = VIRTUAL_NOTE
    else:
        check_device(args.device)
        mesh_lib.init_distributed()
        try:
            rows = [run_once(*shape, frozen=args.frozen, c2f=args.c2f, device=args.device)]
        finally:
            dist.destroy_process_group()
        note = UNMEASURED if rows[0]["devices"] == 1 else ""
    for r in rows:
        print(json.dumps(r))
    last = rows[-1]
    eff = None
    if len(rows) > 1 and rows[0]["frames_per_s"] and last["frames_per_s"]:
        eff = last["frames_per_s"] / (rows[0]["frames_per_s"] * last["devices"])
    summary = {"metric": "scaling_efficiency", "devices": last["devices"], "value": eff,
               "note": note,
               "device": device_kind(args.device) if not args.virtual else "cpu",
               "card": profiling.card() if not args.virtual else "not measured"}
    print(json.dumps(summary))
    ok = all(r.get("serial_equal", True) for r in rows)
    if args.sweep_shapes and args.virtual:
        # Every (kf x pt) factorization of the world (`scaling_bench.py:172-196`):
        # the same f32 all-reduce tree a keyframe, so the NIDs agree.
        n = args.virtual
        shapes = [run_virtual(n, *shape, kf_ax=kf, frozen=args.frozen, c2f=args.c2f)
                  for kf in range(1, n + 1) if n % kf == 0 and kf <= args.keyframes]
        for r in shapes:
            print(json.dumps(r))
        nids = [r["nid"] for r in shapes]
        spread = max(nids) - min(nids)
        print(json.dumps({"metric": "mesh_shape_nid_spread", "devices": n,
                          "shapes": [f"{r['mesh']['kf']}x{r['mesh']['pt']}" for r in shapes],
                          "value": spread, "equal": spread < 1e-3}))
        ok = ok and spread < 1e-3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
