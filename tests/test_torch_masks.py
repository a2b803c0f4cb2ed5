"""PyTorch port vs the JAX package: the mask path — colormaps, mask loading
and timestamp matching, labels in the per-keyframe observation and the
``<ts>_rgb-mask.pcd`` view, best-label fusion, and ``runner.process`` with a
mask folder — plus CPU smoke runs of the z-buffer tools.

Tolerance classes: labels, masks, points, packed colors and file sizes
bit-exact; colormaps within 1e-6 (f32 polynomial and lerp). The JAX
package jits `keyframe_rgb_mask` and `fuse`, and XLA fuses their f32
arithmetic (camera-frame points move by an ulp, so a near-tie of two
scores can flip); the port is held bit for bit against the same JAX
functions run op by op (``jax.disable_jit``), and the runner's outputs
against the jitted JAX runner."""

import json
import os

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.io import images as jimg
from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu.pipeline import ingest as jing
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu.utils import colormap as jcmap
from pointcloudprocessor_tpu_torch import cli as tcli
from pointcloudprocessor_tpu_torch.io import images as timg
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.pipeline import ingest as ting
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.tools import colorize_anatomy as tanat
from pointcloudprocessor_tpu_torch.tools import zbuffer_probe as tprobe
from pointcloudprocessor_tpu_torch.utils import colormap as tcmap
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import gradient_image, simple_camera, wall_scene
from test_pipeline_e2e import small_config, write_dataset

CPU = "cpu"


def _cams():
    cj = simple_camera()
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion),
                        cj.width, cj.height, CPU)
    return cj, ct


@pytest.mark.parametrize("name", ["jet", "turbo"])
def test_colormap_matches_jax(name):
    values = np.random.default_rng(0).uniform(-0.2, 1.2, 2000).astype(np.float32)
    values[:4] = (0.0, 1.0, 1.0 / 3.0, 2.0 / 3.0)  # the stops
    want = np.asarray(getattr(jcmap, name)(jnp.asarray(values)))
    got = getattr(tcmap, name)(torch.from_numpy(values)).numpy()
    assert got.shape == want.shape == (2000, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_load_mask_matches_jax(tmp_path):
    labels = np.random.default_rng(1).integers(0, 256, (37, 53)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    cv2.imwrite(path, labels)
    got, want = timg.load_mask(path), jimg.load_mask(path)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, labels)
    with pytest.raises(FileNotFoundError):
        timg.load_mask(str(tmp_path / "missing.png"))


def test_match_masks_to_timestamps_matches_jax(tmp_path):
    """Masks within 0.5 s of an odometry stamp are copied under its name;
    far ones, non-PNGs and non-numeric names are skipped."""
    times = 100.0 + 0.5 * np.arange(6)
    (tmp_path / "odom.txt").write_text(
        "".join(f"{t:.6f} 0 0 0 1 0 0 0\n" for t in times))
    masks = tmp_path / "raw"
    masks.mkdir()
    rs = np.random.default_rng(2)
    for ts in (99.9, 100.26, 101.04, 102.7, 104.9):
        cv2.imwrite(str(masks / f"{ts:.3f}.png"), rs.integers(0, 256, (4, 5)).astype(np.uint8))
    (masks / "notes.txt").write_text("x")
    cv2.imwrite(str(masks / "label.png"), np.zeros((4, 5), np.uint8))
    odom = str(tmp_path / "odom.txt")
    n_t = ting.match_masks_to_timestamps(str(masks), odom, str(tmp_path / "out_t"))
    n_j = jing.match_masks_to_timestamps(str(masks), odom, str(tmp_path / "out_j"))
    assert n_t == n_j == 4
    files = sorted(os.listdir(tmp_path / "out_t"))
    assert files == sorted(os.listdir(tmp_path / "out_j"))
    for f in files:
        assert (tmp_path / "out_t" / f).read_bytes() == (tmp_path / "out_j" / f).read_bytes()


def _keyframe_inputs():
    cj, ct = _cams()
    pts, _, _ = wall_scene(cj)
    rs = np.random.default_rng(3)
    valid = rs.uniform(size=len(pts)) > 0.05
    image = gradient_image()
    mask = rs.integers(0, 4, (cj.height, cj.width)).astype(np.int32) * 85  # 0, 85, 170, 255
    xi = np.asarray([0.05, -0.03, 0.1, 0.01, 0.02, -0.015], np.float32)
    T = jse3.exp(jnp.asarray(xi))
    return cj, ct, pts, valid, image, mask, T


def test_observe_keyframe_labels_match_jax():
    cj, ct, pts, valid, image, mask, T = _keyframe_inputs()
    oj = jcol.observe_keyframe(cj, jnp.asarray(image), T, jnp.asarray(pts), jnp.asarray(valid),
                               mask_image=jnp.asarray(mask), downsample_factor=4,
                               depth_epsilon=0.25)
    ot = tcol.observe_keyframe(ct, torch.from_numpy(image),
                               interop.pose(np.asarray(T.q), np.asarray(T.t), CPU),
                               torch.from_numpy(pts), torch.from_numpy(valid),
                               mask_image=torch.from_numpy(mask), downsample_factor=4,
                               depth_epsilon=0.25)
    np.testing.assert_array_equal(ot.visible.numpy(), np.asarray(oj.visible))
    np.testing.assert_array_equal(ot.label.numpy(), np.asarray(oj.label))
    np.testing.assert_array_equal(ot.rgb_packed.numpy(), np.asarray(oj.rgb_packed))
    np.testing.assert_array_equal(ot.points_camera.numpy(), np.asarray(oj.points_camera))
    np.testing.assert_array_equal(ot.pixels.numpy(), np.asarray(oj.pixels))
    assert len(np.unique(ot.label.numpy()[ot.visible.numpy()])) == 4
    no_mask = tcol.observe_keyframe(ct, torch.from_numpy(image), interop.pose(
        np.asarray(T.q), np.asarray(T.t), CPU), torch.from_numpy(pts), torch.from_numpy(valid))
    assert no_mask.label is None


@pytest.mark.parametrize("hsv", [(1.0, 1.0), (1.3, 0.8)])
def test_keyframe_rgb_mask_matches_jax(hsv):
    cj, ct, pts, valid, image, mask, T = _keyframe_inputs()
    pose_q = np.asarray([0.9998, 0.01, -0.015, 0.005], np.float32)
    pose_q /= np.linalg.norm(pose_q)
    pose_t = np.asarray([0.1, -0.05, 0.02], np.float32)
    kw = dict(downsample_factor=4, depth_epsilon=0.25, saturation_scale=hsv[0],
              brightness_scale=hsv[1], mask_highlight_value=170)
    with jax.disable_jit():
        want = jcol.keyframe_rgb_mask(cj, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(image),
                                      jnp.asarray(mask),
                                      jse3.SE3(jnp.asarray(pose_q), jnp.asarray(pose_t)), T, **kw)
    got = tcol.keyframe_rgb_mask(ct, torch.from_numpy(pts), torch.from_numpy(valid),
                                 torch.from_numpy(image), torch.from_numpy(mask),
                                 interop.pose(pose_q, pose_t, CPU),
                                 interop.pose(np.asarray(T.q), np.asarray(T.t), CPU), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rgb, label, vis = got[1].numpy(), got[2].numpy(), got[3].numpy()
    assert vis.sum() > 500
    assert (rgb[label == 170] == (255.0, 0.0, 0.0)).all()


@pytest.mark.parametrize("case", ["left_half_one_keyframe", "random_three_keyframes"])
def test_fuse_best_label_matches_jax(case):
    """`fuse(mask_images=...)` keeps the label of the visible observation of
    strictly highest score: equal to the JAX package's, and on a left-half
    mask seen from the origin it follows the image side
    (`tests/test_culling_fusion.py:137-162`)."""
    cj, ct = _cams()
    pts, _, _ = wall_scene(cj)
    n = len(pts)
    if case == "left_half_one_keyframe":
        masks = np.zeros((1, cj.height, cj.width), np.int32)
        masks[:, :, : cj.width // 2] = 255
        q = np.asarray([[1.0, 0, 0, 0]], np.float32)
        t = np.zeros((1, 3), np.float32)
        images = np.zeros((1, cj.height, cj.width, 3), np.uint8)
    else:
        rs = np.random.default_rng(5)
        masks = rs.integers(0, 256, (3, cj.height, cj.width)).astype(np.int32)
        q = np.asarray([[1, 0, 0, 0], [0.9998, 0.0, 0.02, 0.0], [0.9995, 0.01, -0.03, 0.0]],
                       np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = np.asarray([[0, 0, 0], [0.2, 0.0, 0.1], [-0.15, 0.05, 0.0]], np.float32)
        images = np.stack([np.roll(gradient_image(), 5 * i, axis=1) for i in range(3)])
    kw = dict(downsample_factor=4, depth_epsilon=0.25)
    with jax.disable_jit():
        fj = jcol.fuse(cj, jnp.asarray(pts), jnp.ones(n, bool), jnp.asarray(images),
                       jse3.SE3(jnp.asarray(q), jnp.asarray(t)), jse3.identity(),
                       mask_images=jnp.asarray(masks), with_masks=True, **kw)
    ft = tcol.fuse(ct, torch.from_numpy(pts), torch.ones(n, dtype=torch.bool),
                   torch.from_numpy(images), interop.pose(q, t, CPU), interop.pose(
                       np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), CPU),
                   mask_images=torch.from_numpy(masks), **kw)
    np.testing.assert_array_equal(ft.best_label.numpy(), np.asarray(fj.best_label))
    np.testing.assert_array_equal(ft.colored.numpy(), np.asarray(fj.colored))
    labels, colored = ft.best_label.numpy(), ft.colored.numpy()
    if case == "left_half_one_keyframe":
        u = pts[:, 0] / pts[:, 2] * float(cj.intrinsic[0]) + float(cj.intrinsic[2])
        left = u < cj.width // 2
        assert (labels[colored & left] == 255).all() and (labels[colored & ~left] == 0).all()
    else:
        assert len(np.unique(labels[colored])) > 100
    no_masks = tcol.fuse(ct, torch.from_numpy(pts), torch.ones(n, dtype=torch.bool),
                         torch.from_numpy(images), interop.pose(q, t, CPU), interop.pose(
                             np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), CPU),
                         downsample_factor=4, depth_epsilon=0.25)
    assert no_masks.best_label is None


@pytest.fixture(scope="module")
def mask_runs(tmp_path_factory):
    """One masked dataset (`write_dataset(with_masks=True)`); the JAX runner
    and the port's runner (on the CPU) each run it once."""
    root = tmp_path_factory.mktemp("masks")
    write_dataset(root, with_masks=True)
    cfg = small_config(root, mask_image_folder=str(root / "masks") + os.sep)
    res_j = jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    res_t = trunner.process(cfg_t, CPU)
    return root, cfg, cfg_t, res_j, res_t


def _dumps(out_dir):
    d = os.path.join(out_dir, "filtered_pcd")
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith("_rgb-mask.pcd")]


def test_runner_mask_outputs_match_jax(mask_runs):
    """The mask cloud's points and labels, and each per-keyframe dump, equal
    the JAX runner's; the jet-mapped cloud matches within one color level."""
    root, cfg, cfg_t, res_j, res_t = mask_runs
    got, want = jpcd.read(res_t.mask_cloud_path), jpcd.read(res_j.mask_cloud_path)
    assert len(got.points) == len(want.points) > 3000
    np.testing.assert_array_equal(got.mask_label, want.mask_label)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    dumps_t, dumps_j = _dumps(cfg_t.output_path), _dumps(cfg.output_path)
    assert [os.path.basename(d) for d in dumps_t] == [os.path.basename(d) for d in dumps_j]
    assert len(dumps_t) == res_t.num_keyframes == 3
    for dt, dj in zip(dumps_t, dumps_j):
        assert os.path.getsize(dt) == os.path.getsize(dj)
        a, b = jpcd.read(dt), jpcd.read(dj)
        np.testing.assert_array_equal(a.mask_label, b.mask_label)
        np.testing.assert_array_equal(a.points, b.points)
    name = "cloudInWorldWithMaskAndMappedColor.pcd"
    mt = jpcd.read(os.path.join(cfg_t.output_path, name))
    mj = jpcd.read(os.path.join(cfg.output_path, name))
    np.testing.assert_array_equal(mt.points, mj.points)
    np.testing.assert_allclose(mt.rgb, mj.rgb, atol=1.0)


def test_runner_with_masks_e2e_assertions(mask_runs):
    """`tests/test_pipeline_e2e.py::test_e2e_with_masks`'s assertions on the
    port's outputs."""
    root, _, cfg_t, _, res = mask_runs
    out_dir = cfg_t.output_path
    assert res.mask_cloud_path and os.path.exists(res.mask_cloud_path)
    out = jpcd.read(res.mask_cloud_path)
    labels = out.mask_label
    assert labels is not None
    assert (labels[out.points[:, 0] < -0.5] == 255).mean() > 0.9
    assert (labels[out.points[:, 0] > 1.5] == 0).mean() > 0.9
    red = out.rgb[labels == 255]
    assert (red[:, 0] == 255).all() and (red[:, 1] == 0).all()
    assert os.path.exists(os.path.join(out_dir, "cloudInWorldWithMaskAndMappedColor.pcd"))
    dumps = _dumps(out_dir)
    assert len(dumps) == res.num_keyframes
    kf = jpcd.read(dumps[0])
    assert kf.mask_label is not None and len(kf.points) > 500
    assert (kf.mask_label[kf.points[:, 0] < -0.3] == 255).mean() > 0.9
    assert (kf.mask_label[kf.points[:, 0] > 0.3] == 0).mean() > 0.9
    assert len(out.points) == sum(len(jpcd.read(d).points) for d in dumps)


def test_runner_missing_mask_gives_zero_labels(tmp_path):
    """A keyframe whose PNG is missing gets a zero mask, as in the JAX
    runner (`runner.py:517-526`); the run goes on."""
    write_dataset(tmp_path, with_masks=True)
    first = sorted(os.listdir(tmp_path / "masks"))[0]
    os.remove(tmp_path / "masks" / first)
    cfg = tcfg.PipelineConfig.from_json(
        small_config(tmp_path, mask_image_folder=str(tmp_path / "masks") + os.sep).to_json())
    res = trunner.process(cfg, CPU)
    kf = jpcd.read(os.path.join(cfg.output_path, "filtered_pcd",
                                first.replace(".png", "_rgb-mask.pcd")))
    assert len(kf.points) > 500 and (kf.mask_label == 0).all()
    assert res.mask_cloud_path


def test_cli_prints_mask_cloud(mask_runs, tmp_path, capsys):
    root, _, cfg_t, _, _ = mask_runs
    rc = tcli.main([
        "--point_cloud_path", cfg_t.point_cloud_path, "--odometry_path", cfg_t.odometry_path,
        "--images_folder", cfg_t.images_folder, "--mask_image_folder", cfg_t.mask_image_folder,
        "--output_path", str(tmp_path / "cli_out"), "--device", CPU,
        "--config", _config_file(cfg_t, tmp_path),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["mask_cloud"] == str(tmp_path / "cli_out" / "cloudInWorldWithRGBandMask.pcd")
    assert os.path.exists(summary["mask_cloud"])


def _config_file(cfg, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_zbuffer_probe_runs_on_cpu():
    """The probe's --quick path with the twins (no device time on the CPU)."""
    out = tprobe.main(["--quick", "--device", CPU, "--reps", "2"])
    assert out["exact"] is True and out["device"] == "cpu"
    assert out["n_points"] == 65_536 and out["n_cells"] == 64 * 48
    assert out["kernel_ms"] is None and out["plain_ms"] is None and out["below_floor"] == []


def test_colorize_anatomy_runs_on_cpu():
    """The anatomy's --quick path with the twins (no device time on the CPU)."""
    out = tanat.main(["--quick", "--device", CPU, "--reps", "2"])
    assert out["exact"] is True and out["k"] == 4 and out["n_map"] == 100_000
    assert out["zbuffer_scatter"] is None and out["full"] is None


def test_colorize_anatomy_refuses_a_negative_difference(monkeypatch):
    """A stage that timed faster than its prefix gives no number: the
    difference is null and named, the other parts stay."""
    fake = {"project": 8.0, "cull": 7.0, "cull_plain": 10.0, "pack": 11.0, "sample": 12.0,
            "fuse_plain": 20.0, "fuse": 20.0}
    monkeypatch.setattr(tanat, "time_stages", lambda scene, dev, reps: dict(fake))
    out = tanat.main(["--quick", "--device", CPU])
    assert out["zbuffer_scatter"] is None and out["below_floor"] == ["zbuffer_scatter"]
    assert out["project"] == 2.0 and out["zbuffer_scatter_plain"] == 0.5
    assert out["image_pack"] == 1.0 and out["full"] == 5.0 and out["exact"] is True


def test_tools_refuse_times_below_the_floor():
    """A time under the physical floor becomes null and is named, never
    printed as a number."""
    times, below = tprobe.refuse_below_floor({"kernel": 1e-4, "plain": 0.3, "none": None},
                                             {"kernel": 1e-3, "plain": 1e-3, "none": 1e-3})
    assert times == {"kernel": None, "plain": 0.3, "none": None} and below == ["kernel"]
    assert tprobe.floor_ms(999_424, 8.0) == pytest.approx(0.5 * 999_424 * 8 / 3.35e12 * 1e3)


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprobe.main(["--quick"])
