"""PyTorch port vs the JAX package: the harnesses' helpers and shared
scene — `utils/profiling.span`, `io/odometry.poses` and `resample`'s
device, `tools/bench_scene`'s scene 2 and analytic keyframe cull against
`bench.py`, and `tools/scaling_bench.run_once` on a world of 1 and on 2 Gloo
CPU ranks against JAX's `run_once(1, ...)`, on the CPU.

Tolerance classes: bit-equal poses, textures, images, picks and bins;
camera-frame points within 1e-6 m (the cull's (N, 3) x (3, 3) product sums
in another order); the sharded solve at the objective level (NID within
1e-3) and the fused cloud's colored count equal."""

import inspect
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from pointcloudprocessor_tpu.io import odometry as jodom
from pointcloudprocessor_tpu.tools import scaling_bench as jscaling
from pointcloudprocessor_tpu_torch.io import odometry as todom
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.tools import scaling_bench as tscaling
from pointcloudprocessor_tpu_torch.utils import profiling

CPU = "cpu"
# bench.py's scene at a small size, as the JAX tools build it.
W, H, N_MAP, N_CULL, K = 64, 48, 2_000, 512, 2
# Pixels of the port's ray-cast images one LSB from bench.py's, a scene
# (measured 0 on both at this size: the same f32 ops in the same order).
MAX_LSB_PIXELS = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_annotate_names_a_region_in_a_cpu_trace(tmp_path):
    """The tools' stage labels are ``profiling.span``s: recorded under any
    capture, and a region of the trace inside ``profiling.trace``."""
    profiling.reset_trace()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("harness/stage_a"):
            torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert "harness/stage_a" in names
    assert [r.name for r in profiling.span_records()] == ["harness/stage_a"]
    # Outside a capture the region records nothing and costs no error.
    profiling.reset_trace()
    with profiling.span("harness/outside"):
        pass
    assert profiling.span_records() == []


def test_timers_measure_nothing_off_the_card():
    """``repeat_ms`` and ``eval_split`` run a CPU call once and report no
    time (a CPU run gives no device time); the floor is bytes over 3.35
    TB/s."""
    calls = []
    t = profiling.repeat_ms(lambda: calls.append(1), CPU, reps=3)
    assert t == {"ms": None, "calls_ms": [], "spread_ms": None, "below_floor": False}
    split = profiling.eval_split(lambda: calls.append(1), CPU, reps=5)
    assert set(split) == {"wall_ms", "host_ms", "device_busy_ms", "idle_share", "launches",
                          "syncs"} and all(v is None for v in split.values())
    assert len(calls) == 2
    assert profiling.floor_ms(3.35e9) == pytest.approx(1.0)


def _track(m=17, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, 4)).astype(np.float32) * 2.5  # unnormalized on purpose
    return todom.Trajectory(
        times=np.linspace(100.0, 104.0, m),
        positions=rng.uniform(-5, 5, (m, 3)).astype(np.float32),
        quats_wxyz=q,
    )


def test_odometry_poses_bit_equal_to_jax():
    traj = _track()
    got = todom.poses(traj, device=CPU)
    want = jodom.poses(jodom.Trajectory(*traj))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_odometry_entry_points_default_to_the_card():
    for fn in (todom.resample, todom.poses):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("field", ["wall", "occ"])
def test_scene2_fields_bit_equal_to_bench(field):
    rs = np.random.default_rng(5)
    x = rs.uniform(-4, 4, 10_000).astype(np.float32)
    y = rs.uniform(-3, 3, 10_000).astype(np.float32)
    got = getattr(bench_scene, f"field_{field}2")(np, x, y)
    want = getattr(bench, f"_field_{field}2")(np, x, y)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_scenes():
    """bench.py's build_bench_scene at 64x48, 2,000 map points, 2 x 512,
    for scenes 1 and 2, with the culls' uniform ranks."""
    out = {}
    for scene in (1, 2):
        built = bench.build_bench_scene(W, H, N_MAP, N_CULL, K, scene=scene)
        rank = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(jnp.uint32(i)),
                                                       (N_MAP,))) for i in range(K)])
        out[scene] = (built, rank)
    return out


@pytest.mark.parametrize("scene", [1, 2])
def test_bench_scene_images_match_bench(jax_scenes, scene):
    """The trajectory bit for bit; the ray-cast images equal but for at
    most MAX_LSB_PIXELS pixels one LSB apart."""
    built, _ = jax_scenes[scene]
    poses, images = built[1], built[5]
    s = bench_scene.build(W, H, N_MAP, K, CPU, scene=scene)
    np.testing.assert_array_equal(s.poses.q.numpy(), np.asarray(poses.q))
    np.testing.assert_array_equal(s.poses.t.numpy(), np.asarray(poses.t))
    d = np.abs(s.images.numpy().astype(np.int32) - np.asarray(images).astype(np.int32))
    assert d.max() <= 1
    assert int((d[..., 0] > 0).sum()) <= MAX_LSB_PIXELS


@pytest.mark.parametrize("scene", [1, 2])
def test_nid_keyframes_pick_bench_points(jax_scenes, scene):
    """Fed bench.py's map and its PRNGKey(kf) ranks, the analytic cull
    picks bench.py's points in bench.py's order (intensities bit-equal),
    their camera-frame coordinates within 1e-6 m, and the same bins."""
    built, rank = jax_scenes[scene]
    _, _, points, inten, _, _, kfs, _ = built
    s = bench_scene.build(W, H, N_MAP, K, CPU, scene=scene)
    s = s._replace(points=torch.from_numpy(np.array(points)),
                   intensity=torch.from_numpy(np.array(inten)))
    got = bench_scene.nid_keyframes(s, N_CULL, rank=torch.from_numpy(rank))
    np.testing.assert_array_equal(got.intensity.numpy(), np.asarray(kfs.intensity))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(kfs.points), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.bin_image.numpy(), np.asarray(kfs.bin_image))
    assert got.valid.all()


def test_nid_keyframes_default_rank_is_seeded():
    s = bench_scene.build(W, H, N_MAP, K, CPU, scene=2)
    a = bench_scene.nid_keyframes(s, N_CULL)
    b = bench_scene.nid_keyframes(s, N_CULL)
    assert a.points.shape == (K, N_CULL, 3)
    assert torch.equal(a.points, b.points) and torch.equal(a.intensity, b.intensity)


# ---------------------------------------------------------------------------
# scaling_bench
# ---------------------------------------------------------------------------

# JAX's run_once(1, ...) at a small size: keyframes, points, width, height,
# inner and outer iterations.
SCALING = (2, 2048, 128, 96, 3, 1)


@pytest.fixture(scope="module")
def jax_scaling():
    k, n, w, h, inner, outer = SCALING
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    draws = (np.asarray(jax.random.uniform(k1, (n,), jnp.float32, 2.0, w - 2.0)),
             np.asarray(jax.random.uniform(k2, (n,), jnp.float32, 2.0, h - 2.0)))
    return jscaling.run_once(1, k, n, w, h, inner, outer), draws


@pytest.mark.parametrize("world,kf", [(1, None), (2, None), (2, 1)])
def test_scaling_run_once_matches_jax(jax_scaling, world, kf):
    """The sharded solve + fuse on ``world`` Gloo ranks (kf 2 x pt 1, and
    with ``kf`` 1 the point-sharded 1 x 2 of ``--sweep-shapes``) against
    JAX's world of 1 on the same draws: NID within 1e-3, the colored count
    equal; at a world of 1 the port's sharded step is its serial one, bit
    for bit."""
    want, draws = jax_scaling
    t0 = time.perf_counter()
    got = tscaling.run_virtual(world, *SCALING, kf_ax=kf, draws=draws, timeout=240)
    assert time.perf_counter() - t0 < 240
    assert got["devices"] == world and got["backend"] == "gloo"
    assert got["mesh"]["kf"] * got["mesh"]["pt"] == world
    assert kf is None or got["mesh"]["kf"] == kf
    assert abs(got["nid"] - want["nid"]) <= 1e-3, (got, want)
    assert got["colored"] == want["colored"], (got, want)
    assert got["seconds"] is None  # a CPU run gives no device time
    if world == 1:
        assert got["serial_equal"], got


# ---------------------------------------------------------------------------
# The harnesses' imports and device
# ---------------------------------------------------------------------------

HARNESSES = ("nid_bisect", "nid_locality", "solver_sweep", "frozen_guard_sweep", "mls_anatomy",
             "mls_dedup_probe", "scaling_bench", "tap_cache_probe", "slab_gather_probe")


def test_harnesses_import_no_jax_nor_bench():
    """Importing the nine harnesses leaves jax, bench.py and the JAX
    package out of sys.modules (a fresh interpreter: this one has them)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "".join(f"import pointcloudprocessor_tpu_torch.tools.{m}\n" for m in HARNESSES) + (
        "import sys\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bench', 'pointcloudprocessor_tpu')\n"
        "       or m.startswith(('jax.', 'pointcloudprocessor_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", HARNESSES)
def test_harness_device_defaults_to_the_card(name, monkeypatch):
    """With no arguments a harness asks for the card and, where there is
    none, raises instead of falling back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"pointcloudprocessor_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
