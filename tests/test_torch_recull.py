"""PyTorch port vs the JAX package: the NID stage's per-keyframe, re-cull
and pose-graph branches of ``runner.process``, and the re-culled keyframes
of ``build_nid_keyframes``, on the planted-offset dataset of
tests/test_torch_pipeline.py (4 frames, a tilted wall and an occluder) with
a left-half mask a keyframe.

Three runs of both runners:
(a) ``nid.per_keyframe`` + ``nid.smooth_trajectory`` with the mask folder;
(b) ``nid.recull_every_outer_iter`` on the shared correction;
(c) ``nid.recull_every_outer_iter`` + ``nid.per_keyframe``.
Solves are held at the objective level (CLAUDE.md): the NID sums within
1e-3 of each other and at most the planted truth's + 1e-3, corrections
within 3 cm / 1 degree of each other. The re-culled keyframes pick JAX's
points bit for bit (coordinates within f32 rounding). The mask dumps of a per-keyframe correction are held byte for
byte to the JAX runner's, both resumed from the JAX run's
``nid_correction.json`` so that both dump at the same corrections."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.io import images as timg
from pointcloudprocessor_tpu_torch.io import pcd as tpcd
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.pipeline import ingest as ting
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from test_pipeline_e2e import small_config, write_dataset
from test_torch_masks import _dumps
from test_torch_pipeline import OFFSET, ROT_OFFSET, _truth

CPU = "cpu"
NID_TOL = 1e-3
POSE_BOUND_M, POSE_BOUND_RAD = 0.03, np.radians(1.0)
K = 4
RUNS = {
    # (a) one outer iteration a keyframe: the JAX solve then compiles once
    # for (a) and for (c)'s one-outer-iteration passes. 20 inner iterations:
    # with 10, each keyframe's solve stops ~0.02 above the truth's NID.
    "a": dict(per_keyframe=True, smooth_trajectory=True, max_outer_iterations=1),
    "b": dict(recull_every_outer_iter=True),
    "c": dict(recull_every_outer_iter=True, per_keyframe=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: a torch thread pool under the tier-1 run's xdist
    workers slows every worker (tests/test_torch_hpr_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("recull")
    write_dataset(root, with_masks=True, n_frames=K, odom_offset=OFFSET,
                  odom_rot_offset=ROT_OFFSET, wall_slope=0.15, occluder=True)
    return root


def _configs(root, name):
    cfg = small_config(root, enable_nid_optimize=True)
    cfg.map_capacity = 12288  # wall + occluder
    cfg.culled_capacity = 4096
    cfg.output_path = str(root / f"jax_{name}") + os.sep
    cfg.nid.max_outer_iterations = 2
    cfg.nid.max_inner_iterations = 20
    for key, value in RUNS[name].items():
        setattr(cfg.nid, key, value)
    if name == "a":
        cfg.mask_image_folder = str(root / "masks") + os.sep
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / f"torch_{name}") + os.sep
    return cfg, cfg_t


@pytest.fixture(scope="module")
def runs(dataset):
    """Each run by both runners (the port on the CPU), with the JPEG decodes
    of the port's NID keyframes counted."""
    out = {}
    for name in RUNS:
        cfg, cfg_t = _configs(dataset, name)
        res_j = jrunner.process(cfg)
        decodes, packs = [], []
        load, pack = timg.load_gray_normalized, tnid.tap_gather.pack_bins
        trunner.img_io.load_gray_normalized = lambda p: decodes.append(p) or load(p)
        tnid.tap_gather.pack_bins = lambda b: packs.append(b.shape) or pack(b)
        try:
            res_t = trunner.process(cfg_t, CPU)
        finally:
            trunner.img_io.load_gray_normalized = load
            tnid.tap_gather.pack_bins = pack
        out[name] = (cfg, cfg_t, res_j, res_t, (len(decodes), len(packs)))
    return out


def _json(cfg):
    with open(os.path.join(cfg.output_path, "nid_correction.json")) as f:
        return json.load(f)


def _events(cfg, name):
    with open(os.path.join(cfg.output_path, "metrics.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == name]


def _nid_at_truth(cfg_t):
    """The port's exact objective at the planted correction, summed over the
    port's keyframes: those of the first build, or with a re-cull those
    culled at the truth (a re-culled solve's last pass sees the points
    visible near it)."""
    camera = trunner._make_camera(cfg_t, CPU)
    cloud = tpcd.read_cloud(os.path.join(cfg_t.output_path, "scans-crop.pcd"), CPU,
                            capacity=cfg_t.map_capacity)
    frames = ting.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    truth = interop.pose(*_truth(), CPU)
    kfs = trunner.build_nid_keyframes(
        camera, cloud, frames, list(range(K)), cfg_t,
        T_correction=truth if cfg_t.nid.recull_every_outer_iter else None)
    with torch.no_grad():
        return float(tnid.multi_nid_loss(camera, truth, kfs, cfg_t.nid.bins))


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_nid_parity_and_depth(runs, name):
    cfg, cfg_t, res_j, res_t, _ = runs[name]
    assert res_t.num_keyframes == res_j.num_keyframes == K
    assert np.isfinite(res_t.nid_value) and np.isfinite(res_j.nid_value)
    assert abs(res_t.nid_value - res_j.nid_value) <= NID_TOL
    truth = _nid_at_truth(cfg_t)
    assert res_t.nid_value <= truth + NID_TOL
    assert res_j.nid_value <= truth + NID_TOL
    assert res_t.nid_evaluations > 0 and "nid_refine" in res_t.timings


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_corrections_match_jax(runs, name):
    """Each correction (a keyframe's own under per_keyframe; the smoothed
    ones in (a)) within the pose bound of JAX's, and the refined ones of
    the truth."""
    cfg, _, res_j, res_t, _ = runs[name]
    shape = (K,) if cfg.nid.per_keyframe else ()
    assert tuple(res_t.T_correction.q.shape) == shape + (4,)
    jt = interop.pose(np.asarray(res_j.T_correction.q), np.asarray(res_j.T_correction.t), CPU)
    dt, dr = tse3.delta_magnitudes(res_t.T_correction, jt)
    assert float(dt.max()) < POSE_BOUND_M and float(dr.max()) < POSE_BOUND_RAD
    if not cfg.nid.smooth_trajectory:
        q, t = _truth()
        dt, dr = tse3.delta_magnitudes(res_t.T_correction, interop.pose(q, t, CPU))
        assert float(dt.max()) < POSE_BOUND_M and float(dr.max()) < POSE_BOUND_RAD


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_correction_json_and_events(runs, name):
    """``nid_correction.json`` has JAX's keys, flags and list lengths; the
    metrics carry JAX's events: the re-cull passes and the smoothing."""
    cfg, cfg_t, _, _, _ = runs[name]
    got, want = _json(cfg_t), _json(cfg)
    assert set(got) == set(want)
    assert got["per_keyframe"] is want["per_keyframe"] is bool(cfg.nid.per_keyframe)
    for key in ("quat_wxyz", "translation", "outer_iterations", "converged"):
        assert np.shape(got[key]) == np.shape(want[key]), key
    if cfg.nid.per_keyframe:
        assert np.shape(got["quat_wxyz"]) == (K, 4) and np.shape(got["translation"]) == (K, 3)
    recull_t, recull_j = _events(cfg_t, "nid_recull_outer"), _events(cfg, "nid_recull_outer")
    assert [e["outer"] for e in recull_t] == [e["outer"] for e in recull_j]
    assert (len(recull_t) > 0) == cfg.nid.recull_every_outer_iter
    assert got["outer_iterations"] == len(recull_t) or not recull_t
    for a, b in zip(recull_t, recull_j):
        assert abs(a["max_dt"] - b["max_dt"]) < POSE_BOUND_M
    smoothed_t, smoothed_j = _events(cfg_t, "pose_graph_smoothed"), _events(cfg, "pose_graph_smoothed")
    assert len(smoothed_t) == len(smoothed_j) == (1 if cfg.nid.smooth_trajectory else 0)
    for e in smoothed_t:
        assert e["residual_norm"] <= e["initial_residual_norm"]


@pytest.mark.parametrize("name", ["b", "c"])
def test_recull_reuses_the_bins(runs, name):
    """A re-cull decodes no JPEG and packs no bin tiles: the bins of the
    first build serve every pass (the port's runner decoded one image a
    keyframe and packed them once, as bin_pack launches once on the card)."""
    cfg, cfg_t, _, _, (decodes, packs) = runs[name]
    assert len(_events(cfg_t, "nid_recull_outer")) >= 2
    assert decodes == K and packs == 1
    assert "nid_recull" in runs[name][3].timings


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_resumes_its_correction(runs, name):
    """--resume reads the saved correction back, (K,) per keyframe: the
    same correction, no refine stage."""
    _, cfg_t, _, res_t, _ = runs[name]
    cfg = tcfg.PipelineConfig.from_json(cfg_t.to_json())
    cfg.resume = True
    cfg.metrics_path = ""
    cfg.mask_image_folder = ""
    res = trunner.process(cfg, CPU)
    assert "nid_refine" not in res.timings
    assert res.T_correction.q.shape == res_t.T_correction.q.shape
    np.testing.assert_allclose(res.T_correction.q.numpy(), res_t.T_correction.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(res.T_correction.t.numpy(), res_t.T_correction.t.numpy(), atol=1e-6)
    assert res.nid_value == res_t.nid_value


def test_per_keyframe_mask_dumps_match_jax(runs, tmp_path, monkeypatch):
    """The mask dumps at a per-keyframe correction: keyframe j's
    ``<ts>_rgb-mask.pcd`` is composed with its own row of the correction,
    as the JAX runner composes it, byte-equal in size with equal points and
    labels; the accumulated cloud equal. Both runners resume from the JAX
    run (a)'s crop and correction."""
    cfg, cfg_t, _, _, _ = runs["a"]
    # The JAX dumps op by op: under jit XLA's fused f32 math moves
    # camera-frame points by an ulp (ROADMAP §3, "HPR and masks in the
    # jitted runner"); the port matches the JAX function op by op.
    rgb_mask = jrunner.colorize.keyframe_rgb_mask

    def rgb_mask_op_by_op(*args, **kw):
        with jax.disable_jit():
            return rgb_mask(*args, **kw)

    monkeypatch.setattr(jrunner.colorize, "keyframe_rgb_mask", rgb_mask_op_by_op)
    resumed = []
    for pkg_cfg, runner, out in ((cfg, jrunner, "jax_resumed"), (cfg_t, trunner, "torch_resumed")):
        c = type(pkg_cfg).from_json(pkg_cfg.to_json())
        c.output_path = str(tmp_path / out) + os.sep
        os.makedirs(c.output_path)
        for name in ("scans-crop.pcd", "nid_correction.json"):
            shutil.copy(os.path.join(cfg.output_path, name), c.output_path)
        c.resume = True
        if runner is jrunner:
            res = runner.process(c)
        else:
            res = runner.process(c, CPU)
        resumed.append((c, res))
    (cj, rj), (ct, rt) = resumed
    assert tuple(rt.T_correction.q.shape) == (K, 4)
    np.testing.assert_array_equal(rt.T_correction.q.numpy(), np.asarray(rj.T_correction.q))
    np.testing.assert_array_equal(rt.T_correction.t.numpy(), np.asarray(rj.T_correction.t))
    dumps_t, dumps_j = _dumps(ct.output_path), _dumps(cj.output_path)
    assert [os.path.basename(d) for d in dumps_t] == [os.path.basename(d) for d in dumps_j]
    assert len(dumps_t) == K
    for dt, dj in zip(dumps_t, dumps_j):
        assert os.path.getsize(dt) == os.path.getsize(dj)
        a, b = jpcd.read(dt), jpcd.read(dj)
        assert len(a.points) > 500
        np.testing.assert_array_equal(a.mask_label, b.mask_label)
        np.testing.assert_array_equal(a.points, b.points)
    got, want = jpcd.read(rt.mask_cloud_path), jpcd.read(rj.mask_cloud_path)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.mask_label, want.mask_label)


@pytest.mark.parametrize("per_keyframe", [False, True], ids=["scalar", "batched"])
def test_recull_keyframes_match_jax(dataset, per_keyframe):
    """``build_nid_keyframes(T_correction=...)``: the culls at the corrected
    poses, the points in the raw keyframe frames; valid mask, intensity and
    bins bit-equal to the JAX runner's, points within 1e-6 m, with a scalar
    correction (the planted truth) and a (K,) one (the truth moved a little
    a keyframe). ``bins_of`` hands the first build's bins on unchanged."""
    cfg, cfg_t = _configs(dataset, "b")
    q, t = _truth()
    rng = np.random.default_rng(0)
    if per_keyframe:
        xi = rng.normal(0, 0.004, (K, 6)).astype(np.float32)
        corr_t = tse3.compose(interop.pose(q, t, CPU), tse3.exp(torch.from_numpy(xi)))
    else:
        corr_t = interop.pose(q, t, CPU)
    corr_j = jse3.SE3(corr_t.q.numpy(), corr_t.t.numpy())
    camera_j = jrunner._make_camera(cfg)
    cloud_j = jpcd.read_cloud(cfg.point_cloud_path, capacity=cfg.map_capacity)
    frames = jrunner.ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    want = jrunner.build_nid_keyframes(camera_j, cloud_j, frames, list(range(K)), cfg,
                                       T_correction=corr_j)

    camera_t = trunner._make_camera(cfg_t, CPU)
    cloud_t = tpcd.read_cloud(cfg_t.point_cloud_path, CPU, capacity=cfg_t.map_capacity)
    frames_t = ting.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    first = tnid.prepare_keyframes(
        trunner.build_nid_keyframes(camera_t, cloud_t, frames_t, list(range(K)), cfg_t))
    got = trunner.build_nid_keyframes(camera_t, cloud_t, frames_t, list(range(K)), cfg_t,
                                      T_correction=corr_t, bins_of=first)
    assert not torch.equal(got.points, first.points)  # the correction moved the visibility
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.intensity.numpy(), np.asarray(want.intensity))
    np.testing.assert_array_equal(got.bin_image.numpy(), np.asarray(want.bin_image))
    assert got.bin_image is first.bin_image and got.bin_tiles is first.bin_tiles
    # The same points within f32 rounding: 0.6% of the coordinates differ,
    # by at most 4.8e-7 m (0.4% against JAX run op by op), because torch's
    # CPU cross product rounds a*b - c*d as fma(a, b, -(c*d)) inside
    # quat_rotate (ROADMAP §3), and XLA fuses the jitted transform's math.
    pts, pts_j = got.points.numpy(), np.asarray(want.points)
    np.testing.assert_allclose(pts, pts_j, rtol=0, atol=1e-6)
    assert (pts != pts_j).mean() < 0.01
