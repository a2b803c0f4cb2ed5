"""PyTorch port vs the JAX package: ``runner.process`` with the MLS map
stage (``enable_mls``: SOR -> MLS -> SOR) on the golden occluded dataset.

The dataset and the solve are tests/test_torch_hpr_pipeline.py's (a
foreground slab at z = 2, planted translation and rotation errors, a sharp
texture, a sloped wall, 5 x 30 NID iterations), culled by the default
z-buffer. The MLS parameters are scaled to the map's density (~160 points
a square metre on the wall, ~3,700 on the slab): a 0.2 m search radius
(~20 wall neighbors) with sqr_gauss = r^2 and 64 points a bucket; the SOR
keeps the reference's k = 60 and 0.7 sigma (over 0.8 m cells).

Held as tests/test_torch_hpr_pipeline.py holds its runner: final NIDs
within 1e-3 and the port's at least as deep as the planted truth's; the
``scans-crop_mls.pcd`` each writes equal in count (so in the SOR masks)
with positions within 2e-6 m; colored-point counts equal; and a resumed
run reads the smoothed map back instead of smoothing again."""

import os

import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.pipeline import runner as jrunner
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
POS_TOL = 2e-6  # m



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: the suite runs several
    workers on the machine's cores, and under that load a pool of threads
    over many small ops runs ~50x slower (and slows its neighbours)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _truth(tz=1e-6):
    """The planted correction; t_z = 1 um, not 0 (the objective is NaN at
    exactly 0 in both packages, ROADMAP.md §3)."""
    rv = np.asarray(ROT_OFFSET, np.float64)
    th = np.linalg.norm(rv)
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * rv / th]).astype(np.float32)
    return interop.pose(q, np.asarray(OFFSET[:2] + (tz,), np.float32), CPU)


@pytest.fixture(scope="module")
def mls_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden_occ_mls")
    write_dataset(root, odom_offset=OFFSET, odom_rot_offset=ROT_OFFSET, field=sharp_field,
                  wall_slope=0.25, occluder=True)
    cfg = small_config(root, enable_nid_optimize=True, enable_mls=True)
    cfg.map_capacity = 16384  # the occluded map has 8500 points
    cfg.culled_capacity = 16384
    cfg.fusion.reference_compat_orientation = True
    cfg.mls.search_radius = 0.2
    cfg.mls.sqr_gauss_param = 0.04
    cfg.mls.bucket_capacity = 64
    cfg.mls.upsampling = "none"
    cfg.nid.max_inner_iterations = 30
    cfg.nid.max_outer_iterations = 5
    res_j = jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    res_t = trunner.process(cfg_t, CPU)
    return root, cfg, cfg_t, res_j, res_t


def test_mls_runner_nid_parity_and_depth(mls_runs):
    _, _, cfg_t, res_j, res_t = mls_runs
    assert res_t.num_keyframes == res_j.num_keyframes == 3
    assert np.isfinite(res_t.nid_value) and abs(res_t.nid_value - res_j.nid_value) <= NID_TOL
    camera = trunner._make_camera(cfg_t, CPU)
    cloud = tpcd.read_cloud(os.path.join(cfg_t.output_path, "scans-crop_mls.pcd"), CPU,
                            capacity=cfg_t.map_capacity)
    frames = ting.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    kfs = trunner.build_nid_keyframes(camera, cloud, frames, [0, 1, 2], cfg_t)
    with torch.no_grad():
        nid_truth = float(tnid.multi_nid_loss(camera, _truth(), kfs, cfg_t.nid.bins))
    assert res_t.nid_value <= nid_truth + NID_TOL


def test_mls_runner_smoothed_map_matches(mls_runs):
    """The written MLS maps: the same points survive both SORs and the fit
    (equal counts, the crop order kept), positions within 2e-6 m; the
    smoothing moved points and the SOR removed some."""
    root, cfg, cfg_t, res_j, res_t = mls_runs
    assert "mls" in res_t.timings and "mls" in res_j.timings
    for stage in ("mls_sor1", "mls_fit", "mls_sor2", "mls_write"):
        assert stage in res_t.timings
    mj = jpcd.read(os.path.join(cfg.output_path, "scans-crop_mls.pcd"))
    mt = jpcd.read(os.path.join(cfg_t.output_path, "scans-crop_mls.pcd"))
    crop = jpcd.read(os.path.join(cfg_t.output_path, "scans-crop.pcd"))
    assert len(mt.points) == len(mj.points)
    assert 0.5 * len(crop.points) < len(mt.points) < len(crop.points)
    assert np.abs(mt.points - mj.points).max() <= POS_TOL
    np.testing.assert_array_equal(mt.intensity, mj.intensity)


def test_mls_runner_colored_points_and_resume(mls_runs):
    root, cfg, cfg_t, res_j, res_t = mls_runs
    assert res_t.num_colored_points == res_j.num_colored_points > 2000
    # A resumed run reads scans-crop_mls.pcd and the saved correction.
    cfg_r = tcfg.PipelineConfig.from_json(cfg_t.to_json())
    cfg_r.resume = True
    res_r = trunner.process(cfg_r, CPU)
    assert "mls" not in res_r.timings and "nid_refine" not in res_r.timings
    assert res_r.num_colored_points == res_t.num_colored_points
