"""PyTorch port vs the JAX package: ``runner.process`` with HPR culling and
local color smoothing on the golden occluded dataset.

The dataset and the config are tests/test_golden_occluded.py's (a
foreground slab at z = 2 whose shadow HPR must remove, planted translation
and rotation errors, a sharp texture, a sloped wall, 5 x 30 NID
iterations, the reference's orientation arithmetic), with
``fusion.local_smoothing_radius`` on. Both runners run on the CPU; the
8,500-point map takes the dense HPR cull (``hpr_impl="auto"``, under the
100,000-point cutoff). Held at the objective level, as
tests/test_torch_pipeline.py holds the z-buffer slice: final NIDs within
1e-3 and the port's at least as deep as the planted truth's; poses inside
the bound around the truth; colored-point counts equal.

Colors: the JAX runner jits `fuse`, and XLA fuses its f32 transform, so
camera-frame points move by an ulp; an HPR decision whose support margin
lies within an ulp of 2R (0.0156 m at R = 90,000) can then flip, and the
smoothing spreads that point's color to its neighbors. The functions are
held bit for bit in tests/test_torch_hpr.py and the smoothing within 1e-3
in tests/test_torch_knn_smoothing.py; here the port re-runs at the JAX
runner's correction (``resume``) and its colors must be within 1e-3 of
the JAX output on all but 0.5% of the colored points."""

import json
import os

import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.io import pcd as tpcd
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.pipeline import ingest as ting
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from test_pipeline_e2e import small_config, write_dataset
from test_reference_oracle import sharp_field

CPU = "cpu"
OFFSET = (0.04, -0.02, 0.0)
ROT_OFFSET = (0.004, -0.006, 0.008)
NID_TOL = 1e-3
POSE_BOUND_M, POSE_BOUND_RAD = 0.03, np.radians(1.0)
SMOOTHING_RADIUS = 0.15  # ~11 wall neighbors, >32 on the slab



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: the suite runs several
    workers on the machine's cores, and under that load a pool of threads
    over many small ops runs ~50x slower (and slows its neighbours)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _truth(tz=0.0):
    rv = np.asarray(ROT_OFFSET, np.float64)
    th = np.linalg.norm(rv)
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * rv / th]).astype(np.float32)
    return interop.pose(q, np.asarray(OFFSET[:2] + (tz,), np.float32), CPU)


@pytest.fixture(scope="module")
def hpr_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden_occ_torch")
    write_dataset(root, odom_offset=OFFSET, odom_rot_offset=ROT_OFFSET, field=sharp_field,
                  wall_slope=0.25, occluder=True)
    cfg = small_config(root, enable_nid_optimize=True)
    cfg.map_capacity = 16384  # the occluded map has 8500 points
    cfg.culled_capacity = 16384
    cfg.culling.method = "hpr"
    cfg.fusion.reference_compat_orientation = True
    cfg.fusion.local_smoothing_radius = SMOOTHING_RADIUS
    cfg.nid.max_inner_iterations = 30
    cfg.nid.max_outer_iterations = 5
    res_j = jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    res_t = trunner.process(cfg_t, CPU)
    return root, cfg, cfg_t, res_j, res_t


def test_hpr_runner_nid_parity_and_depth(hpr_runs):
    _, _, cfg_t, res_j, res_t = hpr_runs
    assert res_t.num_keyframes == res_j.num_keyframes == 3
    assert np.isfinite(res_t.nid_value) and abs(res_t.nid_value - res_j.nid_value) <= NID_TOL
    camera = trunner._make_camera(cfg_t, CPU)
    cloud = tpcd.read_cloud(os.path.join(cfg_t.output_path, "scans-crop.pcd"), CPU,
                            capacity=cfg_t.map_capacity)
    frames = ting.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    kfs = trunner.build_nid_keyframes(camera, cloud, frames, [0, 1, 2], cfg_t)
    with torch.no_grad():
        # At t_z = 0 exactly the objective is NaN in both packages: the
        # keyframes' zero padding points then sit at z = 0 (ROADMAP.md §3).
        assert np.isnan(float(tnid.multi_nid_loss(camera, _truth(), kfs, cfg_t.nid.bins)))
        nid_truth = float(tnid.multi_nid_loss(camera, _truth(tz=1e-6), kfs, cfg_t.nid.bins))
    assert res_t.nid_value <= nid_truth + NID_TOL
    # The HPR cull removes the slab's shadow from the NID keyframes.
    assert 0 < int(kfs.valid.sum()) < 3 * 8500


def test_hpr_runner_pose_within_bound_of_truth(hpr_runs):
    _, _, _, res_j, res_t = hpr_runs
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, _truth())
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD
    jt = interop.pose(np.asarray(res_j.T_correction.q), np.asarray(res_j.T_correction.t), CPU)
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, jt)
    assert float(dt) < POSE_BOUND_M and float(dr) < POSE_BOUND_RAD


def test_hpr_runner_smoothed_output_matches(hpr_runs):
    root, cfg, cfg_t, res_j, res_t = hpr_runs
    assert "local_smoothing" in res_t.timings
    assert res_t.num_colored_points == res_j.num_colored_points > 3000
    out_j = jpcd.read(res_j.colored_cloud_path)
    # The port at the JAX runner's correction: the saved correction resumed.
    cfg_r = tcfg.PipelineConfig.from_json(cfg_t.to_json())
    cfg_r.output_path = str(root / "out_torch_at_jax") + os.sep
    cfg_r.resume = True
    os.makedirs(cfg_r.output_path)
    with open(os.path.join(cfg_r.output_path, "nid_correction.json"), "w") as f:
        json.dump({"quat_wxyz": np.asarray(res_j.T_correction.q).tolist(),
                   "translation": np.asarray(res_j.T_correction.t).tolist(),
                   "nid": res_j.nid_value}, f)
    res_r = trunner.process(cfg_r, CPU)
    assert "nid_refine" not in res_r.timings and "local_smoothing" in res_r.timings
    assert res_r.num_colored_points == res_j.num_colored_points
    out_r = jpcd.read(res_r.colored_cloud_path)
    np.testing.assert_array_equal(out_r.points, out_j.points)
    diff = np.abs(out_r.rgb - out_j.rgb).max(axis=1)
    assert (diff > 1e-3).sum() <= 0.005 * len(diff), (diff > 1e-3).sum()
    assert diff.mean() < 0.01
