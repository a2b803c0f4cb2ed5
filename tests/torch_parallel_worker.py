"""One rank of the port's sharded paths on Gloo CPU ranks (see
tests/test_torch_parallel.py, test_torch_parallel_mesh8.py and
test_torch_parallel_failover.py).

    python torch_parallel_worker.py <mode> <rank> <world> <workdir>

Reads ``<workdir>/inputs.npz`` (written by the test from a numpy seed), joins
the world through a file store in ``<workdir>``, runs the mode's checks on
the port's ``parallel`` package and writes every result to
``<workdir>/rank<r>.npz``; prints RANK_OK at the end. Imports torch and the
port only: the JAX references run in the test process.
"""

import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pointcloudprocessor_tpu_torch.core import se3  # noqa: E402
from pointcloudprocessor_tpu_torch.opt import nid, pose_graph, refine  # noqa: E402
from pointcloudprocessor_tpu_torch.parallel import fusion_shard, nid_shard  # noqa: E402
from pointcloudprocessor_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from pointcloudprocessor_tpu_torch.parallel import pose_graph_shard  # noqa: E402
from pointcloudprocessor_tpu_torch.pipeline import colorize  # noqa: E402
from pointcloudprocessor_tpu_torch.utils import interop  # noqa: E402

CPU = "cpu"
TIMEOUT = timedelta(seconds=60)


class Run:
    def __init__(self, rank, world, workdir):
        self.rank, self.world, self.workdir = rank, world, workdir
        self.inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        self.out = {}

    def get(self, name):
        return self.inputs[name]

    def camera(self, prefix):
        return interop.camera(self.get(prefix + "intr"), self.get(prefix + "dist"),
                              int(self.get(prefix + "wh")[0]), int(self.get(prefix + "wh")[1]),
                              CPU)

    def keyframes(self, prefix):
        return interop.nid_keyframes(self.get(prefix + "pts"), self.get(prefix + "inten"),
                                     self.get(prefix + "valid"), self.get(prefix + "bins"), CPU)

    def pose(self, name):
        return interop.pose(self.get(name + "_q"), self.get(name + "_t"), CPU)

    def put(self, name, value):
        if isinstance(value, se3.SE3):
            self.put(name + "_q", value.q)
            self.put(name + "_t", value.t)
            return
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.out[name] = np.asarray(value)

    def put_result(self, name, res):
        self.put(name + "_T", res.T_camera_lidar)
        for field in ("nid", "outer_iterations", "converged", "evaluations", "gathers",
                      "partial_gathers", "gather_drift"):
            self.put(f"{name}_{field}", getattr(res, field))

    def save(self):
        np.savez(os.path.join(self.workdir, f"rank{self.rank}.npz"), **self.out)


def _value_and_grad(fn, xi):
    x = torch.tensor(xi, dtype=torch.float32).requires_grad_(True)
    value = fn(se3.exp(x))
    (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc:
        return True
    return False


def check_mesh(run, mesh, kf, pt):
    """Coordinates, groups, the shard / gather round trips, the refusals."""
    run.put("coordinate", mesh_lib.coordinate(mesh))
    run.put("kf_group", dist.get_process_group_ranks(mesh.get_group(mesh_lib.KF_AXIS)))
    run.put("pt_group", dist.get_process_group_ranks(mesh.get_group(mesh_lib.PT_AXIS)))
    full = torch.arange(4 * kf * 6 * pt, dtype=torch.float32).reshape(2 * kf, 3 * pt, 4)
    rows = mesh_lib.shard_kf(mesh, full)
    cols = mesh_lib.shard_pt(mesh, full.transpose(0, 1)).transpose(0, 1)
    run.put("roundtrip_kf", mesh_lib.gather_kf(mesh, rows).equal(full))
    run.put("roundtrip_pt", mesh_lib.gather_pt(mesh, cols, dim=1).equal(full))
    run.put("kf_rows", mesh_lib.keyframe_rows(mesh, 2 * kf).start)
    run.put("pt_rows", mesh_lib.point_rows(mesh, 3 * pt).start)
    # A tensor no backend here carries raises before any collective; so
    # does a shape the mesh does not divide.
    meta = torch.empty(3, device="meta")
    run.put("refuses_meta", _raises(lambda: mesh_lib.all_reduce(meta, dist.group.WORLD)))
    run.put("refuses_uneven", _raises(lambda: mesh_lib.point_rows(mesh, 3 * pt + 1)))
    mesh_lib.init_distributed()  # a no-op where a group is up
    run.put("world_after_init", dist.get_world_size())


def check_loss(run, mesh):
    """(a): the sharded loss and its gradient, and the serial port's."""
    camera, kfs = run.camera("a_"), run.keyframes("a_")
    local = mesh_lib.shard_keyframes(mesh, kfs)
    for j, xi in enumerate(run.get("a_xi")):
        v, g = _value_and_grad(lambda T: nid_shard.sharded_multi_nid_loss(camera, T, local, mesh),
                               xi)
        run.put(f"a_value{j}", v)
        run.put(f"a_grad{j}", g)
        if run.rank == 0:
            v, g = _value_and_grad(lambda T: nid.multi_nid_loss(camera, T, kfs), xi)
            run.put(f"a_serial_value{j}", v)
            run.put(f"a_serial_grad{j}", g)


def check_frozen(run, mesh):
    """(b): the sharded frozen cache through a forced refresh."""
    camera = run.camera("b_")
    Ta = run.pose("b_Ta")
    for case in ("m0_both", "m0_mixed", "m2_both", "m2_mixed"):
        margin = int(case[1])
        kfs = run.keyframes(f"b_{case}_")
        local = nid.prepare_keyframes(mesh_lib.shard_keyframes(mesh, kfs), wide_margin=margin)
        make_cache, cached_loss = nid_shard.make_sharded_frozen(mesh, partial_frac=0.25)
        cache = make_cache(camera, Ta, local)
        with torch.no_grad():
            loss, cache = cached_loss(camera, run.pose(f"b_Tb{margin}"), local, cache, 16,
                                      guard_frac=0.25)
        run.put(f"b_{case}_loss", loss)
        for field in ("taps", "knot", "inlier", "refreshes", "partials", "drift_accum"):
            run.put(f"b_{case}_{field}", getattr(cache, field))


# The (kf 2 x pt 2) solves' iteration caps (tests/test_torch_parallel.py's
# JAX references use the same).
C_INNER, C_OUTER = 30, 4
SOLVES = {
    "plain": dict(),
    "frozen": dict(frozen_taps=True),
    "c2f": dict(frozen_taps=True, coarse_outer_iterations=1, coarse_stride=2),
    "wide": dict(frozen_taps=True, frozen_margin=2, frozen_partial_frac=0.5,
                 coarse_outer_iterations=1, coarse_stride=2),
}


def check_solves(run, mesh, prefix, solves, inner, outer):
    """(c): the sharded solves; rank r also runs the serial port's solve of
    the r-th schedule (mod the count)."""
    camera, kfs = run.camera(prefix), run.keyframes(prefix)
    local = mesh_lib.shard_keyframes(mesh, kfs)
    T0 = run.pose(prefix + "T0")
    names = list(solves)
    for name in names:
        kw = dict(dict(max_inner_iterations=inner, max_outer_iterations=outer), **solves[name])
        run.put_result(f"{prefix}sharded_{name}",
                       nid_shard.refine_pose_sharded(camera, local, T0, mesh, **kw))
    name = names[run.rank % len(names)]
    if run.rank < len(names):
        kw = dict(dict(max_inner_iterations=inner, max_outer_iterations=outer), **solves[name])
        run.put_result(f"{prefix}serial_{name}", refine.refine_pose(camera, kfs, T0, **kw))


def check_refusals(run, mesh):
    camera, kfs = run.camera("c_"), run.keyframes("c_")
    local = mesh_lib.shard_keyframes(mesh, kfs)
    T0 = run.pose("c_T0")
    run.put("refuses_grouped", _raises(lambda: nid_shard.refine_pose_sharded(
        camera, local, T0, mesh, use_grouped_gather=True)))
    # 1800 points a shard: stride 7 would not take the global subsample.
    run.put("refuses_stride", _raises(lambda: nid_shard.refine_pose_sharded(
        camera, local, T0, mesh, coarse_outer_iterations=1, coarse_stride=7)))


def check_fuse(run, mesh, prefix):
    """(d): the sharded fuse, gathered whole; rank 0 runs the serial fuse."""
    camera = run.camera(prefix)
    pts = interop.tensor(run.get(prefix + "points"), CPU)
    valid = interop.tensor(run.get(prefix + "valid_map"), CPU)
    images = interop.tensor(run.get(prefix + "images"), CPU)
    masks = interop.tensor(run.get(prefix + "masks"), CPU) if prefix + "masks" in run.inputs \
        else None
    poses, T = run.pose(prefix + "poses"), run.pose(prefix + "T")
    kw = dict(downsample_factor=int(run.get(prefix + "ds")),
              depth_epsilon=float(run.get(prefix + "eps")))
    shard = mesh_lib.shard_kf
    T_local = T if T.q.ndim == 1 else se3.SE3(shard(mesh, T.q), shard(mesh, T.t))
    got = fusion_shard.fuse_sharded(
        camera, mesh_lib.shard_pt(mesh, pts), mesh_lib.shard_pt(mesh, valid),
        shard(mesh, images), se3.SE3(shard(mesh, poses.q), shard(mesh, poses.t)), T_local, mesh,
        None if masks is None else shard(mesh, masks), **kw)
    for field in ("rgb", "colored", "best_label", "observation_count"):
        value = getattr(got, field)
        if value is not None:
            run.put(f"{prefix}sharded_{field}", mesh_lib.gather_pt(mesh, value))
    if run.rank == 0:
        want = colorize.fuse(camera, pts, valid, images, poses, T, masks, **kw)
        for field in ("rgb", "colored", "best_label", "observation_count"):
            value = getattr(want, field)
            if value is not None:
                run.put(f"{prefix}serial_{field}", value)


def check_per_keyframe(run, mesh, prefix, inner, outer):
    """(e): the per-keyframe solve over ``kf``; rank 1 runs the serial
    lockstep solve over every keyframe."""
    camera, kfs = run.camera(prefix), run.keyframes(prefix)
    T0 = run.pose(prefix + "T0")
    kw = dict(max_inner_iterations=inner, max_outer_iterations=outer)
    local = mesh_lib.shard_keyframes(mesh, kfs, split_points=False)
    res = nid_shard.refine_per_keyframe_sharded(camera, local, T0, mesh, **kw)
    run.put_result(prefix + "sharded_pk", res)
    run.put(prefix + "sharded_pk_lockstep", res.lockstep_evaluations)
    if run.rank == 1 % run.world:
        serial = refine.refine_pose_per_keyframe(camera, kfs, T0, **kw)
        run.put_result(prefix + "serial_pk", serial)
        run.put(prefix + "serial_pk_lockstep", serial.lockstep_evaluations)


def check_pose_graph(run, mesh):
    """(f): the sharded pose graph; rank 2 runs the serial one."""
    c2w, odo, meas = run.pose("f_c2w"), run.pose("f_odo"), run.pose("f_meas")
    w = interop.tensor(run.get("f_w"), CPU)
    kw = dict(abs_weight=w, iterations=4)
    got = pose_graph_shard.optimize_sharded(mesh, c2w, odo, meas, **kw)
    run.put("f_sharded_poses", got.poses)
    run.put("f_sharded_res", torch.stack([got.residual_norm, got.initial_residual_norm]))
    H, b = pose_graph_shard.absolute_blocks_sharded(mesh, c2w, meas, w)
    Hs, bs = pose_graph.absolute_blocks(c2w, meas, w)
    run.put("f_blocks_equal", H.equal(Hs) and b.equal(bs))
    if run.rank == 2 % run.world:
        want = pose_graph.optimize(c2w, odo, meas, **kw)
        run.put("f_serial_poses", want.poses)
        run.put("f_serial_res", torch.stack([want.residual_norm, want.initial_residual_norm]))


def timed(run, fn, *args):
    t0 = time.perf_counter()
    fn(run, *args)
    print(f"rank {run.rank}: {fn.__name__}{args[1:]} {time.perf_counter() - t0:.2f} s",
          flush=True)


def mode_mesh4(run):
    mesh = mesh_lib.make_mesh(kf=2, pt=2)
    timed(run, check_mesh, mesh, 2, 2)
    timed(run, check_loss, mesh)
    timed(run, check_frozen, mesh)
    timed(run, check_solves, mesh, "c_", {k: SOLVES[k] for k in ("plain", "frozen", "c2f")},
          C_INNER, C_OUTER)
    timed(run, check_refusals, mesh)
    timed(run, check_fuse, mesh, "d_")
    timed(run, check_fuse, mesh, "o_")
    timed(run, check_fuse, mesh, "k_")
    timed(run, check_per_keyframe, mesh, "e_", 10, 2)
    timed(run, check_pose_graph, mesh)


def mode_mesh8(run):
    mesh = mesh_lib.make_mesh(kf=2, pt=4)
    timed(run, check_mesh, mesh, 2, 4)
    timed(run, check_solves, mesh, "g_", SOLVES, 5, 2)
    timed(run, check_fuse, mesh, "h_")
    timed(run, check_per_keyframe, mesh, "g_", 3, 1)


def mode_world1(run):
    """A process with no torchrun environment: ``init_distributed`` gives a
    world of 1, and every sharded path equals its serial one bit for bit."""
    mesh = mesh_lib.make_mesh()
    run.put("world1", [dist.get_world_size(), *mesh_lib.coordinate(mesh), mesh.size(0),
                       mesh.size(1)])
    run.put("backend", dist.get_backend() == "gloo")
    camera, kfs = run.camera("a_"), run.keyframes("a_")
    xi = run.get("a_xi")[0]
    v, g = _value_and_grad(lambda T: nid_shard.sharded_multi_nid_loss(camera, T, kfs, mesh), xi)
    vs, gs = _value_and_grad(lambda T: nid.multi_nid_loss(camera, T, kfs), xi)
    run.put("loss_equal", v.equal(vs) and g.equal(gs))
    T0 = se3.exp(torch.tensor(xi, dtype=torch.float32))
    for name in ("plain", "c2f", "wide"):
        kw = dict(dict(max_inner_iterations=8, max_outer_iterations=2), **SOLVES[name])
        got = nid_shard.refine_pose_sharded(camera, kfs, T0, mesh, **kw)
        # The sharded solve never raster-sorts (a partial fraction sorts the
        # serial one by default).
        want = refine.refine_pose(camera, kfs, T0, sort_points=False, **kw)
        run.put(f"{name}_equal", got.T_camera_lidar.q.equal(want.T_camera_lidar.q)
                and got.T_camera_lidar.t.equal(want.T_camera_lidar.t) and got.nid.equal(want.nid)
                and got.evaluations == want.evaluations and got.gathers == want.gathers)
    kw = dict(max_inner_iterations=5, max_outer_iterations=2)
    got = nid_shard.refine_per_keyframe_sharded(camera, kfs, T0, mesh, **kw)
    want = refine.refine_pose_per_keyframe(camera, kfs, T0, **kw)
    run.put("pk_equal", got.T_camera_lidar.t.equal(want.T_camera_lidar.t)
            and got.nid.equal(want.nid) and got.evaluations.equal(want.evaluations))


def mode_failover(run):
    """The peer-death drill: rank 1 dies between two evaluations (no
    handshake); rank 0's next collective must raise, not hang."""
    mesh = mesh_lib.make_mesh(kf=2, pt=1)
    camera, kfs = run.camera("a_"), run.keyframes("a_")
    local = mesh_lib.shard_keyframes(mesh, kfs)
    T = se3.exp(torch.tensor(run.get("a_xi")[0], dtype=torch.float32))
    for it in range(4):
        if run.rank == 1 and it == 2:
            print("rank 1: dying between evaluations", flush=True)
            os._exit(42)
        try:
            value = float(nid_shard.sharded_multi_nid_loss(camera, T, local, mesh))
            print(f"rank {run.rank}: iteration {it} nid {value:.6f}", flush=True)
        except (RuntimeError, dist.DistBackendError) as e:
            print(f"rank {run.rank}: FAILURE_DETECTED at iteration {it}: "
                  f"{type(e).__name__}: {str(e)[:300]}", flush=True)
            os._exit(0)
    print(f"rank {run.rank}: NO_FAILURE_DETECTED", flush=True)
    sys.exit(1 if run.rank == 0 else 0)


def spawn(mode, world, workdir, timeout, during=None):
    """Run the ``mode`` ranks as subprocesses (one torch thread each) while
    ``during()`` runs in the calling process. A hang fails at ``timeout``
    seconds, and every rank still alive is killed on the way out. Returns
    ``([(return code, output) a rank], during's result)``."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(world), str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        extra = during() if during is not None else None
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)], extra


def load_ranks(workdir, world):
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(world)]


def main():
    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    if mode != "world1":
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
    run = Run(rank, world, workdir)
    {"mesh4": mode_mesh4, "mesh8": mode_mesh8, "failover": mode_failover,
     "world1": mode_world1}[mode](run)
    run.save()
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: RANK_OK", flush=True)


if __name__ == "__main__":
    main()
