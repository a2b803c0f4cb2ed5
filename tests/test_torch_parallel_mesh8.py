"""PyTorch port vs the JAX package: the sharded paths of ``parallel/`` on
eight Gloo CPU ranks, the (kf 2 x pt 4) mesh of `__graft_entry__.
dryrun_multichip(8)`.

One spawn of eight ranks (tests/torch_parallel_worker.py, mode "mesh8") runs
the dry run's inputs (`__graft_entry__._synthetic`: 4 keyframes of 2,048
points, 128x96 with distortion) through every sharded solve schedule, the
fuse and the per-keyframe solve; the JAX serial refine runs here meanwhile.
`MULTICHIP_r05.json` recorded the JAX package's sharded NID on these inputs
as 0.8464. Solves compare at the objective level (1e-3), the fuse and the
per-keyframe lanes bit for bit with the port's serial paths."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu.opt import refine as jrefine

import torch_parallel_worker as worker
from test_torch_parallel import _camera_arrays, _kf_arrays, _pose_arrays

WORLD, KF, PT = 8, 2, 4
NID_TOL = 1e-3
RECORDED_NID = 0.8464  # MULTICHIP_r05.json, rounded to 4 places
XI0 = (0.01, -0.005, 0.0, 0.002, 0.0, -0.003)


def build_inputs():
    camera = graft._camera()
    points, intensity, valid, images, gray = graft._synthetic(camera, n_points=512 * PT, k=2 * KF)
    bins = jax.vmap(lambda g: jnid.quantize_image(g, 16))(gray)
    kfs = jnid.NIDKeyframe(points, intensity, valid, bins)
    T0 = jse3.exp(jnp.asarray(XI0, jnp.float32))
    k = points.shape[0]
    poses = jse3.SE3(jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (k, 1)),
                     jnp.zeros((k, 3), jnp.float32))
    inputs = {**_camera_arrays("g_", camera), **_kf_arrays("g_", kfs),
              **_pose_arrays("g_T0", T0), **_camera_arrays("h_", camera),
              **_pose_arrays("h_poses", poses), **_pose_arrays("h_T", jse3.identity()),
              "h_points": np.asarray(points[0]), "h_valid_map": np.asarray(valid[0]),
              "h_images": np.asarray(images), "h_ds": np.asarray(4), "h_eps": np.asarray(0.25)}
    return camera, kfs, T0, inputs


@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_parallel_mesh8")
    camera, kfs, T0, inputs = build_inputs()
    np.savez(work / "inputs.npz", **inputs)

    def serial():
        res = jrefine.refine_pose(camera, kfs, T0, max_inner_iterations=5, max_outer_iterations=2)
        return float(res.nid)

    results, jax_nid = worker.spawn("mesh8", WORLD, work, timeout=300, during=serial)
    for r, (rc, out) in enumerate(results):
        assert rc == 0 and "RANK_OK" in out, f"rank {r} failed (rc {rc}):\n{out}"
    return worker.load_ranks(work, WORLD), jax_nid


def test_mesh8_coordinates(mesh8):
    ranks, _ = mesh8
    for r, got in enumerate(ranks):
        assert tuple(got["coordinate"]) == (r // PT, r % PT)
        assert list(got["kf_group"]) == [r % PT, PT + r % PT]
        assert list(got["pt_group"]) == list(range(r // PT * PT, r // PT * PT + PT))
        assert got["roundtrip_kf"] and got["roundtrip_pt"]


def test_dryrun_sharded_solve_matches_jax_serial(mesh8):
    ranks, jax_nid = mesh8
    got = float(ranks[0]["g_sharded_plain_nid"])
    assert abs(got - jax_nid) < NID_TOL, (got, jax_nid)
    assert abs(got - RECORDED_NID) < NID_TOL + 5e-5, got
    assert int(ranks[0]["g_sharded_plain_outer_iterations"]) >= 1


@pytest.mark.parametrize("name", ("plain", "frozen", "c2f", "wide"))
def test_dryrun_sharded_schedules_match_serial(mesh8, name):
    ranks, _ = mesh8
    got = float(ranks[0][f"g_sharded_{name}_nid"])
    serial = float(next(r[f"g_serial_{name}_nid"] for r in ranks if f"g_serial_{name}_nid" in r))
    assert abs(got - serial) < NID_TOL, (got, serial)


def test_dryrun_sharded_fuse_matches_serial(mesh8):
    ranks, _ = mesh8
    got = ranks[0]
    assert int(got["h_sharded_colored"].sum()) == 512 * PT
    for field in ("colored", "observation_count"):
        np.testing.assert_array_equal(got[f"h_sharded_{field}"], got[f"h_serial_{field}"])
    np.testing.assert_allclose(got["h_sharded_rgb"], got["h_serial_rgb"], atol=1e-3)


def test_dryrun_per_keyframe_lanes_bit_equal_serial(mesh8):
    ranks, _ = mesh8
    got, want = ranks[0], ranks[1]
    for field in ("T_q", "T_t", "nid", "outer_iterations", "converged", "evaluations"):
        np.testing.assert_array_equal(got[f"g_sharded_pk_{field}"], want[f"g_serial_pk_{field}"],
                                      err_msg=field)


def test_mesh8_identical_bits_on_every_rank(mesh8):
    ranks, _ = mesh8
    keys = [k for k in ranks[0] if k.startswith(("g_sharded_", "h_sharded_"))]
    assert len(keys) > 30
    for r in range(1, WORLD):
        for key in keys:
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r} {key}")
