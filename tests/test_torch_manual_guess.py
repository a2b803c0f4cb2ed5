"""PyTorch port vs the JAX package: the headless manual initial guess
(camera bearings, PnP, `pipeline/manual_guess`) and the runner with it and
with the frozen-tap cache's wide window and partial refresh.

Tolerance classes: camera functions within 1e-6 (XLA fuses the JAX loop's
f32 steps); PnP on JAX's own hypothesis draw: the RANSAC rotation within
1e-5, its inliers equal, the LSQ pose within 1e-4 (the Jacobians come from
reverse passes here, forward mode there: the same fixed point, other
roundings); the runner at the objective level (NIDs within 1e-3, colored
points within 1%), the manual poses within 1e-4."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.opt import pnp as jpnp
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu_torch import cli
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.opt import pnp as tpnp
from pointcloudprocessor_tpu_torch.pipeline import manual_guess as tmg
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import simple_camera
from test_pipeline_e2e import F, H, W, small_config, write_dataset
from test_pnp import _scene
from test_torch_pipeline import NID_TOL, OFFSET, POSE_BOUND_M, POSE_BOUND_RAD, ROT_OFFSET, _truth

CPU = "cpu"
DISTORTED = (0.05, -0.01, 0.001, -0.002, 0.003)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_cameras(distortion=None):
    cj = simple_camera(w=640, h=480, f=400.0, distortion=distortion)
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion), cj.width,
                        cj.height, CPU)
    return cj, ct


@pytest.mark.parametrize("distortion", [None, DISTORTED], ids=["pinhole", "plumb_bob"])
def test_camera_bearing_undistort_fov_in_image_match_jax(distortion):
    cj, ct = _both_cameras(distortion)
    rs = np.random.default_rng(0)
    px = np.concatenate([rs.uniform(-20, 660, (500, 2)),
                         [[0, 0], [639.999, 479.999], [640, 0], [-0.001, 3]]]).astype(np.float32)
    np.testing.assert_allclose(tcam.bearing(ct, torch.from_numpy(px)).numpy(),
                               np.asarray(jcam.bearing(cj, jnp.asarray(px))), atol=1e-6)
    pt_d = (px - 320.0) / 400.0
    np.testing.assert_allclose(tcam.undistort(ct, torch.from_numpy(pt_d)).numpy(),
                               np.asarray(jcam.undistort(cj, jnp.asarray(pt_d))), atol=1e-6)
    np.testing.assert_allclose(float(tcam.fov(ct)), float(jcam.fov(cj)), atol=1e-6)
    np.testing.assert_array_equal(tcam.in_image(ct, torch.from_numpy(px)).numpy(),
                                  np.asarray(jcam.in_image(cj, jnp.asarray(px))))


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, n=60, outlier_frac=0.35),
                                  dict(seed=2, distorted=True)],
                         ids=["clean", "outliers", "distorted"])
def test_pnp_matches_jax_on_jax_draw(case):
    """`tests/test_pnp.py`'s scenes: RANSAC on JAX's hypothesis pairs gives
    JAX's rotation and inliers; the LSQ refine JAX's pose; the pose is the
    planted one (the JAX test's bounds)."""
    case = dict(case)
    distorted = case.pop("distorted", False)
    camera, px, pts, T_true, n_out = _scene(**case)
    if distorted:
        camera = simple_camera(w=640, h=480, f=400.0, distortion=DISTORTED)
        px = np.asarray(camera.project(jse3.transform_points(T_true, jnp.asarray(pts))))
    ct = interop.camera(np.asarray(camera.intrinsic), np.asarray(camera.distortion),
                        camera.width, camera.height, CPU)
    iters = 2048
    key = jax.random.PRNGKey(case["seed"])
    pairs = np.asarray(jax.random.randint(key, (iters, 2), 0, px.shape[0]))
    valid = np.ones(px.shape[0], bool)
    Rj, inl_j = jpnp.estimate_rotation_ransac(camera, jnp.asarray(px), jnp.asarray(pts),
                                              jnp.asarray(valid), key, num_iterations=iters)
    Rt, inl_t = tpnp.estimate_rotation_ransac(ct, torch.tensor(px), torch.tensor(pts),
                                              torch.tensor(valid), pairs=torch.tensor(pairs))
    np.testing.assert_allclose(Rt.q.numpy(), np.asarray(Rj.q), atol=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    rj = jpnp.estimate_pose(camera, px, pts, key=key, num_ransac_iterations=iters)
    rt = tpnp.estimate_pose(ct, px, pts, pairs=torch.tensor(pairs))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(rt.T_camera_target.q.numpy(), np.asarray(rj.T_camera_target.q),
                               atol=1e-4)
    np.testing.assert_allclose(rt.T_camera_target.t.numpy(), np.asarray(rj.T_camera_target.t),
                               atol=1e-4)
    np.testing.assert_allclose(float(rt.final_error), float(rj.final_error), rtol=1e-3, atol=1e-4)
    dt, dr = tse3.delta_magnitudes(
        rt.T_camera_target, interop.pose(np.asarray(T_true.q), np.asarray(T_true.t), CPU))
    assert float(dt) < 0.08 and np.degrees(float(dr)) < 0.3
    if n_out:
        assert rt.inliers.numpy()[:n_out].sum() <= 2


def test_pnp_generator_draw_and_lsq_alone():
    """The port's own draw (a generator seeded like the JAX key) finds the
    planted pose, and the LSQ alone refines a perturbed start as JAX's
    (`tests/test_pnp.py:75-87`)."""
    camera, px, pts, T_true, _ = _scene(seed=3)
    ct = interop.camera(np.asarray(camera.intrinsic), np.asarray(camera.distortion),
                        camera.width, camera.height, CPU)
    truth = interop.pose(np.asarray(T_true.q), np.asarray(T_true.t), CPU)
    rt = tpnp.estimate_pose(ct, px, pts, generator=torch.Generator().manual_seed(3),
                            num_ransac_iterations=1024)
    dt, dr = tse3.delta_magnitudes(rt.T_camera_target, truth)
    assert float(dt) < 0.05 and np.degrees(float(dr)) < 0.2
    xi = np.asarray([0.02, -0.01, 0.03, 0.01, -0.015, 0.02], np.float32)
    Tj0 = jse3.compose(jse3.exp(jnp.asarray(xi)), T_true)
    Tt0 = interop.pose(np.asarray(Tj0.q), np.asarray(Tj0.t), CPU)
    valid = np.ones(px.shape[0], bool)
    Tj, ej = jpnp.estimate_pose_lsq(camera, jnp.asarray(px), jnp.asarray(pts),
                                    jnp.asarray(valid), Tj0)
    Tt, et = tpnp.estimate_pose_lsq(ct, torch.tensor(px), torch.tensor(pts),
                                    torch.tensor(valid), Tt0)
    np.testing.assert_allclose(Tt.q.numpy(), np.asarray(Tj.q), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    assert float(et) < 1.0
    dt, dr = tse3.delta_magnitudes(Tt, truth)
    assert float(dt) < 0.02 and float(dr) < 0.05


# Picks for keyframes 0 and 2 (12 pairs each), projected through the planted
# correction; keyframe 1 has 2 pairs (under the GUI's gate of 3), keyframe 3
# none: both keep the NID correction.
PICKED = {"100.000000": 12, "100.500000": 2, "101.000000": 12}


def _write_picks(path, q, t, seed=7):
    rs = np.random.default_rng(seed)
    T = jse3.SE3(jnp.asarray(q), jnp.asarray(t))
    picks = {}
    for ts, n in PICKED.items():
        u, v = rs.uniform(10, W - 10, n), rs.uniform(10, H - 10, n)
        z = rs.uniform(4.0, 6.0, n)
        pts = np.stack([(u - W / 2) / F * z, (v - H / 2) / F * z, z], -1).astype(np.float32)
        cam_pts = jse3.transform_points(T, jnp.asarray(pts))
        f, c = jnp.asarray([F, F]), jnp.asarray([W / 2, H / 2])
        pix = np.asarray(cam_pts[:, :2] / cam_pts[:, 2:] * f + c)
        picks[ts] = {"pixels": pix.tolist(), "points": pts.tolist()}
    path.write_text(json.dumps(picks))
    return picks


@pytest.fixture(scope="module")
def manual_runs(tmp_path_factory):
    """The planted-offset dataset through both runners with NID refinement
    under the frozen-tap cache's margin 2 and partial refresh 0.25, and the
    manual guess on picks for two of the four keyframes."""
    root = tmp_path_factory.mktemp("manual")
    write_dataset(root, n_frames=4, odom_offset=OFFSET, odom_rot_offset=ROT_OFFSET,
                  wall_slope=0.15, occluder=True)
    q, t = _truth()
    _write_picks(root / "picks.json", q, t)
    cfg = small_config(root, enable_nid_optimize=True, enable_manual_guess=True,
                       correspondences_path=str(root / "picks.json"))
    cfg.map_capacity = 12288
    cfg.nid.max_outer_iterations = 2
    cfg.nid.max_inner_iterations = 12
    cfg.nid.frozen_taps = True
    cfg.nid.frozen_margin = 2
    cfg.nid.frozen_partial_frac = 0.25
    res_j = jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    res_t = trunner.process(cfg_t, CPU)
    return root, cfg, cfg_t, res_j, res_t


def _saved(cfg):
    with open(os.path.join(cfg.output_path, "manual_poses.json")) as f:
        return json.load(f)


def test_runner_manual_poses_match_jax(manual_runs):
    """manual_poses.json holds the two keyframes with >= 3 picks, each
    within 1e-4 of JAX's and within 1 cm / 1 deg of the planted correction;
    the stage is timed."""
    _, cfg, cfg_t, _, res_t = manual_runs
    saved_j, saved_t = _saved(cfg), _saved(cfg_t)
    assert sorted(saved_t) == sorted(saved_j) == ["100.000000", "101.000000"]
    q, t = _truth()
    for ts in saved_t:
        qt, tt = (np.asarray(saved_t[ts][k]) for k in ("quat_wxyz", "translation"))
        np.testing.assert_allclose(qt, saved_j[ts]["quat_wxyz"], atol=1e-4)
        np.testing.assert_allclose(tt, saved_j[ts]["translation"], atol=1e-4)
        dt, dr = tse3.delta_magnitudes(interop.pose(qt, tt, CPU), interop.pose(q, t, CPU))
        assert float(dt) < 0.01 and np.degrees(float(dr)) < 1.0
    assert res_t.timings["manual_guess"] > 0


def test_runner_cache_options_and_manual_guess_match_jax(manual_runs):
    """The NID correction (margin 2, partial 0.25) at the objective level
    against JAX's and within the bound of the truth, and the colored points
    of the overridden correction within 1% of JAX's."""
    _, _, _, res_j, res_t = manual_runs
    assert abs(res_t.nid_value - res_j.nid_value) <= NID_TOL
    q, t = _truth()
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, interop.pose(q, t, CPU))
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD
    assert res_t.T_correction.q.shape == (4,)  # the NID correction, as JAX's result holds it
    assert abs(res_t.num_colored_points - res_j.num_colored_points) <= (
        0.01 * res_j.num_colored_points)
    assert res_t.num_colored_points > 3000


def test_estimate_keyframe_corrections_identity_without_picks(manual_runs):
    """Keyframes without an entry or under 3 pairs get the identity and no
    flag; the estimates sit on the camera's device."""
    root, _, cfg_t, _, _ = manual_runs
    from pointcloudprocessor_tpu_torch.pipeline import ingest

    frames = ingest.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    camera = trunner._make_camera(cfg_t, CPU)
    T, have = tmg.estimate_keyframe_corrections(camera, frames, [0, 1, 2, 3],
                                                str(root / "picks.json"), cfg_t.pnp)
    assert have == [True, False, True, False]
    assert T.q.shape == (4, 4)
    np.testing.assert_array_equal(T.q[[1, 3]].numpy(), [[1, 0, 0, 0]] * 2)
    np.testing.assert_array_equal(T.t[[1, 3]].numpy(), np.zeros((2, 3)))


def test_load_correspondences_refuses_a_count_mismatch(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"1.000000": {"pixels": [[1, 2]] * 3, "points": [[0, 0, 1]] * 4}}))
    with pytest.raises(ValueError, match="mismatch"):
        tmg.load_correspondences(str(path))


def test_cli_manual_guess_flags(tmp_path, capsys):
    """--enableInitialGuessManual and --correspondences drive the manual
    guess through the port's CLI (JAX `cli.py:30-41, 71-72`)."""
    write_dataset(tmp_path)
    q = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    _write_picks(tmp_path / "picks.json", q, np.zeros(3, np.float32), seed=11)
    (tmp_path / "config.json").write_text(small_config(tmp_path).to_json())
    args = cli.build_parser().parse_args(["--enableInitialGuessManual", "--correspondences",
                                          "p.json"])
    cfg = cli.config_from_args(args)
    assert cfg.enable_manual_guess and cfg.correspondences_path == "p.json"
    rc = cli.main(["--config", str(tmp_path / "config.json"), "--enableInitialGuessManual",
                   "--correspondences", str(tmp_path / "picks.json"), "--device", CPU])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["colored_points"] > 3000 and "manual_guess" in summary["timings_s"]
    saved = json.loads((tmp_path / "out" / "manual_poses.json").read_text())
    assert sorted(saved) == ["100.000000", "101.000000"]
    for pose in saved.values():
        dt, dr = tse3.delta_magnitudes(
            interop.pose(pose["quat_wxyz"], pose["translation"], CPU), tse3.identity(CPU))
        assert float(dt) < 0.02 and np.degrees(float(dr)) < 0.5
