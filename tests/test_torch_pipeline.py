"""PyTorch port vs the JAX package: refine_pose and the whole slice
(`runner.process` with NID refinement, MLS off) on a planted-offset
dataset.

Solves are held at the objective level (CLAUDE.md "Sharded vs unsharded
BFGS"): the NID surface has a plateau (~2e-4 NID over ~2 cm), so two f32
solvers may stop at different points of it. Final NIDs agree within 1e-3,
each is at most the planted truth's NID + 1e-3 (at least as deep as the
truth), poses sit inside a loose bound around the truth, and colored point
counts agree within 1%."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu.opt import refine as jrefine
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.opt import refine as trefine
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from test_nid import nid_scene
from test_pipeline_e2e import small_config, write_dataset

CPU = "cpu"
OFFSET = (0.03, -0.02, 0.01)  # metres
ROT_OFFSET = (0.004, -0.006, 0.003)  # rotation vector, radians
NID_TOL = 1e-3
POSE_BOUND_M, POSE_BOUND_RAD = 0.03, np.radians(1.0)


def _truth():
    """The planted correction T_camera_lidar = (R_off, +offset)."""
    rv = np.asarray(ROT_OFFSET, np.float64)
    th = np.linalg.norm(rv)
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * rv / th]).astype(np.float32)
    return q, np.asarray(OFFSET, np.float32)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """One dataset; the JAX runner and the port's runner (on the CPU) each
    run it once with NID refinement."""
    root = tmp_path_factory.mktemp("slice")
    write_dataset(root, n_frames=4, odom_offset=OFFSET, odom_rot_offset=ROT_OFFSET,
                  wall_slope=0.15, occluder=True)
    cfg = small_config(root, enable_nid_optimize=True)
    cfg.map_capacity = 12288  # wall + occluder
    cfg.nid.max_outer_iterations = 3
    cfg.nid.max_inner_iterations = 20
    res_j = jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    res_t = trunner.process(cfg_t, CPU)
    return root, cfg, cfg_t, res_j, res_t


def _nid_at(cfg_t, root, T):
    """The port's exact objective at correction T on the port's keyframes."""
    camera = trunner._make_camera(cfg_t, CPU)
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.pipeline import ingest

    cloud = pcd.read_cloud(os.path.join(cfg_t.output_path, "scans-crop.pcd"), CPU,
                           capacity=cfg_t.map_capacity)
    frames = ingest.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    kfs = trunner.build_nid_keyframes(camera, cloud, frames, list(range(len(frames))), cfg_t)
    with torch.no_grad():
        return float(tnid.multi_nid_loss(camera, T, kfs, cfg_t.nid.bins))


def test_slice_nid_parity_and_depth(slice_runs):
    root, cfg, cfg_t, res_j, res_t = slice_runs
    assert res_t.num_keyframes == res_j.num_keyframes == 4
    assert np.isfinite(res_t.nid_value) and np.isfinite(res_j.nid_value)
    assert abs(res_t.nid_value - res_j.nid_value) <= NID_TOL
    q, t = _truth()
    nid_truth = _nid_at(cfg_t, root, interop.pose(q, t, CPU))
    assert res_t.nid_value <= nid_truth + NID_TOL
    assert res_j.nid_value <= nid_truth + NID_TOL
    assert res_t.nid_evaluations > 0


def test_slice_pose_within_bound_of_truth(slice_runs):
    _, _, _, res_j, res_t = slice_runs
    q, t = _truth()
    truth = interop.pose(q, t, CPU)
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, truth)
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD
    jt = interop.pose(np.asarray(res_j.T_correction.q), np.asarray(res_j.T_correction.t), CPU)
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, jt)
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD


def test_slice_colored_output_matches(slice_runs):
    _, _, cfg_t, res_j, res_t = slice_runs
    assert res_t.num_colored_points > 3000
    assert abs(res_t.num_colored_points - res_j.num_colored_points) <= 0.01 * res_j.num_colored_points
    out = jpcd.read(res_t.colored_cloud_path)
    assert len(out.points) == res_t.num_colored_points
    assert out.rgb.min() >= 0 and out.rgb.max() <= 255
    # The artifacts of the reference's stages exist.
    assert os.path.exists(os.path.join(cfg_t.output_path, "scans-crop.pcd"))
    assert os.path.exists(os.path.join(cfg_t.output_path, "nid_correction.json"))
    dumps = os.listdir(os.path.join(cfg_t.output_path, "filtered_pcd"))
    assert len([d for d in dumps if d.endswith("_beforeNID.pcd")]) == 4


def test_refine_pose_matches_jax(slice_runs):
    """refine_pose alone on identical keyframes (the JAX runner's, handed
    over through interop), from identity: objective-level parity."""
    root, cfg, _, _, _ = slice_runs
    camera_j = jrunner._make_camera(cfg)
    cloud = jpcd.read_cloud(os.path.join(cfg.output_path, "scans-crop.pcd"),
                            capacity=cfg.map_capacity)
    frames = jrunner.ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    kfs_j = jrunner.build_nid_keyframes(camera_j, cloud, frames, list(range(4)), cfg)
    kw = dict(
        bins=cfg.nid.bins,
        max_outer_iterations=cfg.nid.max_outer_iterations,
        max_inner_iterations=cfg.nid.max_inner_iterations,
        delta_trans_thresh=cfg.nid.delta_trans_thresh,
        delta_rot_thresh=np.radians(cfg.nid.delta_rot_thresh_deg),
        trust_region_trans=cfg.nid.trust_region_trans,
        trust_region_rot=np.radians(cfg.nid.trust_region_rot_deg),
    )
    rj = jrefine.refine_pose(camera_j, kfs_j, jse3.identity(), **kw)

    camera_t = interop.camera(np.asarray(camera_j.intrinsic), np.asarray(camera_j.distortion),
                              camera_j.width, camera_j.height, CPU)
    kfs_t = interop.nid_keyframes(np.asarray(kfs_j.points), np.asarray(kfs_j.intensity),
                                  np.asarray(kfs_j.valid), np.asarray(kfs_j.bin_image), CPU)
    kw = {k: float(v) if not isinstance(v, int) else v for k, v in kw.items()}
    rt = trefine.refine_pose(camera_t, kfs_t, tse3.identity(CPU), **kw)

    assert abs(float(rt.nid) - float(rj.nid)) <= NID_TOL
    q, t = _truth()
    kfs_jp = jnid.prepare_keyframes(kfs_j, build_slabs=False)
    nid_truth = float(jnid.multi_nid_loss(camera_j, jse3.SE3(jnp.asarray(q), jnp.asarray(t)),
                                          kfs_jp, 16, use_pallas=False, use_grouped=False))
    assert float(rt.nid) <= nid_truth + NID_TOL
    dt, dr = tse3.delta_magnitudes(rt.T_camera_lidar, interop.pose(q, t, CPU))
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD
    assert 1 <= rt.outer_iterations <= cfg.nid.max_outer_iterations
    assert rt.evaluations >= rt.outer_iterations


def test_refine_unported_options_raise():
    """The frozen-tap cache's options that raised until they were ported run
    now: partial refresh and wide window with frozen taps, and inert
    without them, as in the JAX package; a margin outside 0..2 under frozen
    taps still raises, as ValueError (JAX asserts 1 <= m <= 2,
    `nid.py:154`)."""
    cj = jrunner.cam.PinholeCamera(jnp.asarray([60.0, 60.0, 32.0, 24.0]), jnp.zeros(5), 64, 48)
    pts, inten, img = nid_scene(cj, n_side=16)  # 256 points: two refresh blocks
    bins = np.asarray(jnid.quantize_image(jnp.asarray(img), 16))
    kfs = interop.nid_keyframes(pts[None], inten[None], np.ones((1, 256), bool), bins[None], CPU)
    camera = interop.camera((60.0, 60.0, 32.0, 24.0), (0.0,) * 5, 64, 48, CPU)
    T0 = tse3.exp(torch.tensor([0.01, -0.01, 0.0, 0.0, 0.002, 0.0]))
    for kw in (dict(frozen_taps=True, frozen_partial_frac=0.25),
               dict(frozen_taps=True, frozen_margin=1),
               dict(frozen_partial_frac=0.25), dict(frozen_margin=2)):
        res = trefine.refine_pose(camera, kfs, T0, max_outer_iterations=1,
                                  max_inner_iterations=4, **kw)
        assert np.isfinite(float(res.nid)) and res.partial_gathers <= res.gathers
        assert (res.gathers >= 1) == ("frozen_taps" in kw)
    with pytest.raises(ValueError, match="margin"):
        trefine.refine_pose(camera, kfs, T0, frozen_taps=True, frozen_margin=3)


def test_resume_reuses_artifacts_and_traces(slice_runs, tmp_path):
    """--resume: the crop and the saved correction are reused (no refine
    stage) and give the same correction; a profiler trace is written."""
    _, _, cfg_t, _, res_t = slice_runs
    cfg = tcfg.PipelineConfig.from_json(cfg_t.to_json())
    cfg.resume = True
    cfg.profile_trace_dir = str(tmp_path / "trace")
    cfg.metrics_path = ""
    res = trunner.process(cfg, CPU)
    assert "nid_refine" not in res.timings
    np.testing.assert_allclose(res.T_correction.q.numpy(), res_t.T_correction.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(res.T_correction.t.numpy(), res_t.T_correction.t.numpy(), atol=1e-6)
    assert res.num_colored_points == res_t.num_colored_points
    assert os.path.exists(tmp_path / "trace" / "trace.json")
