"""PyTorch port vs the JAX package: the grid HPR cull (H2) for a batch of
keyframes, and its callers, `pipeline/colorize.fuse` and
`runner.build_nid_keyframes` under ``culling.method="hpr"``.

On the card H2 culls K keyframes in one memset and four launches; its plain
version loops over the one-keyframe twin. Tolerance class: masks bit-exact
against the JAX package's `hpr_mask_grid` on every keyframe of the batch
(the grid twin is its op-for-op port); the callers' keyframes, counts and
labels bit-exact, fused colors within 1e-3, camera-frame points within f32
rounding (the JAX package jits its cull; it runs op by op here,
``jax.disable_jit``, as tests/test_torch_hpr.py holds `fuse`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.io import pcd as jpcd
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.ops import hpr as jhpr
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.io import pcd as tpcd
from pointcloudprocessor_tpu_torch.ops import hpr as thpr
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.pipeline import ingest as ting
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import interop

from test_pipeline_e2e import small_config, write_dataset
from test_torch_hpr import _fuse_inputs

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keyframes(k, n=6000, seed=0):
    """K camera-frame views of the two-wall scene (z jitter, 2% invalid),
    each moved by its own small rigid motion: (points (K, N, 3), gates (K,
    N)). From three keyframes on, one keyframe gates no point and one holds
    NaN and +-inf coordinates among its gated points."""
    rs = np.random.default_rng(seed)
    base, valid = bs.two_walls(n, seed=seed, z_jitter=0.3, invalid=0.02)
    pts, gates = [], []
    for j in range(k):
        th = rs.normal(scale=0.03, size=3)
        c, s = np.cos(th), np.sin(th)
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        p = (base @ (rz @ ry).T + rs.normal(scale=0.1, size=3)).astype(np.float32)
        g = valid & (rs.uniform(size=n) > 0.05)
        pts.append(p)
        gates.append(g)
    if k >= 3:
        gates[1][:] = False
        pts[2][:5] = [[np.nan, 0, 5], [np.inf, 0, 5], [0, -np.inf, 5], [0, 0, np.inf],
                      [1e30, 1e30, 1e-20]]
        gates[2][:5] = True
    return np.stack(pts), np.stack(gates)


def _jax_rows(pts, gates):
    with np.errstate(invalid="ignore", over="ignore"):
        return [np.asarray(jhpr.hpr_mask_grid(jnp.asarray(p), jnp.asarray(g)))
                for p, g in zip(pts, gates)]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_batch_equals_jax_on_every_keyframe(k):
    """The batched plain version gives each keyframe JAX's mask bit for bit:
    K = 1, 3 and 8, with a keyframe that gates no point and one with NaN
    and infinite coordinates."""
    pts, gates = _keyframes(k, seed=k)
    got = thpr.hpr_mask_grid_batch(torch.from_numpy(pts), torch.from_numpy(gates))
    assert got.shape == (k, pts.shape[1]) and got.dtype == torch.bool
    for j, want in enumerate(_jax_rows(pts, gates)):
        np.testing.assert_array_equal(got[j].numpy(), want)
    if k >= 3:
        assert not got[1].any()
    assert got[0].sum() > 0.2 * pts.shape[1]


@pytest.mark.parametrize("name", list(bs.hpr_edge_sets(n_bulk=64)))
def test_batch_edge_sets(name):
    """Each edge set of ``bench_scene.hpr_edge_sets`` in a batch of three
    (as it is, reversed, and with no point gated), against JAX per row."""
    p, v = bs.hpr_edge_sets()[name]
    pts = np.stack([p, p[::-1], p])
    gates = np.stack([v, v[::-1], np.zeros_like(v)])
    got = thpr.hpr_mask_grid_batch(torch.from_numpy(pts.copy()), torch.from_numpy(gates.copy()))
    for j, want in enumerate(_jax_rows(pts, gates)):
        np.testing.assert_array_equal(got[j].numpy(), want)
    assert not got[2].any()


def test_batch_shapes_and_devices():
    """Empty batches and empty keyframes; the wrappers refuse what they do
    not take."""
    assert thpr.hpr_mask_grid_batch(torch.zeros((0, 5, 3)),
                                    torch.zeros((0, 5), dtype=torch.bool)).shape == (0, 5)
    assert thpr.hpr_mask_grid_batch(torch.zeros((2, 0, 3)),
                                    torch.zeros((2, 0), dtype=torch.bool)).shape == (2, 0)
    pts, gates = torch.ones((2, 4, 3)), torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        thpr.hpr_mask_grid_batch_cuda(pts, gates)
    meta = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(NotImplementedError):
        thpr.hpr_mask_grid_batch(meta, torch.ones((2, 4), dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("impl", ["grid", "dense"])
def test_cull_world_points_batch(impl):
    """The batched cull gives each keyframe the points and mask of its own
    ``cull_world_points`` call bit for bit, and JAX's mask (its points
    within f32 rounding); ``mask_batch`` loops the dense cull."""
    camera = interop.camera((100.0, 100.0, 64.0, 48.0), (0.0,) * 5, 128, 96, CPU)
    cj = jcam.PinholeCamera(intrinsic=jnp.asarray([100.0, 100.0, 64.0, 48.0]),
                            distortion=jnp.zeros(5), width=128, height=96)
    pts, _ = bs.two_walls(3000, seed=4)
    pts[::50, 2] *= -1.0
    valid = np.ones(len(pts), bool)
    valid[::37] = False
    rs = np.random.default_rng(2)
    xi = rs.normal(scale=0.02, size=(4, 6)).astype(np.float32)
    T = [jse3.exp(jnp.asarray(x)) for x in xi]
    Tt = tse3.SE3(torch.from_numpy(np.stack([np.asarray(t.q) for t in T])),
                  torch.from_numpy(np.stack([np.asarray(t.t) for t in T])))
    pb, mb = thpr.cull_world_points_batch(camera, Tt, torch.from_numpy(pts),
                                          torch.from_numpy(valid), impl=impl)
    assert pb.shape == (4, len(pts), 3) and mb.shape == (4, len(pts))
    for j in range(4):
        p1, m1 = thpr.cull_world_points(camera, tse3.SE3(Tt.q[j], Tt.t[j]),
                                        torch.from_numpy(pts), torch.from_numpy(valid), impl=impl)
        assert torch.equal(pb[j], p1) and torch.equal(mb[j], m1)
        pj, mj = jhpr.cull_world_points(cj, T[j], jnp.asarray(pts), jnp.asarray(valid), impl=impl)
        np.testing.assert_array_equal(mb[j].numpy(), np.asarray(mj))
        np.testing.assert_allclose(pb[j].numpy(), np.asarray(pj), atol=1e-5)
    assert 0 < int(mb.sum()) < mb.numel()


@pytest.mark.parametrize("impl", ["grid", "dense"])
def test_mask_views_equals_one_view_at_a_time(impl):
    """The colorize culls of world points seen by a batch of views (what
    ``fuse`` takes under HPR; on the card one H2 call that transforms the
    points itself): ``view_points`` gives each view the camera-frame points
    of ``se3.transform_xyz`` and the unfloored gate bit for bit, and each
    mask equals JAX's ``hpr_mask_grid`` (the grid) or the port's dense cull
    of that view."""
    _, ct, p, valid, *_ = _fuse_inputs()
    rs = np.random.default_rng(3)
    xi = rs.normal(scale=0.05, size=(5, 6)).astype(np.float32)
    T = tse3.exp(torch.from_numpy(xi))
    R = tse3.quat_to_matrix(T.q)
    pw, vw = torch.from_numpy(p), torch.from_numpy(valid)
    pts, gate = thpr.view_points(ct, R, T.t, pw, vw)
    got = thpr.mask_views(ct, R, T.t, pw, vw, 90000.0, 0.05, impl)
    assert got.shape == (5, len(p))
    for j in range(5):
        x, y, z = tse3.transform_xyz(tse3.SE3(T.q[j], T.t[j]), pw[:, 0], pw[:, 1], pw[:, 2])
        assert torch.equal(pts[j], torch.stack([x, y, z], dim=-1))
        u, v = thpr.cam.project_xyz(ct, x, y, z)
        assert torch.equal(gate[j], thpr.colorize_gate(ct, z, u, v, vw))
        if impl == "grid":
            want = np.asarray(jhpr.hpr_mask_grid(jnp.asarray(pts[j].numpy()),
                                                 jnp.asarray(gate[j].numpy())))
            np.testing.assert_array_equal(got[j].numpy(), want)
        else:
            assert torch.equal(got[j], thpr.hpr_mask(pts[j], gate[j]))
    assert 0 < int(got.sum()) < int(gate.sum())
    with pytest.raises(ValueError, match="CUDA"):
        thpr.hpr_mask_grid_views_cuda(ct, R, T.t, pw, vw)


def _count(monkeypatch, name, arg):
    """Records, for each call of ``hpr.<name>``, the batch: the length of
    its positional argument ``arg``."""
    calls = []
    real = getattr(thpr, name)

    def counted(*args, **kw):
        calls.append(args[arg].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(thpr, name, counted)
    return calls


def test_fuse_hpr_batch_matches_jax_at_fixed_correction(monkeypatch):
    """``fuse`` under HPR culls its three keyframes in one batch
    (``hpr.mask_views``: on the card one H2 call over the world points) and gives
    JAX's colored mask, counts and labels bit for bit at a fixed
    correction, the blend within 1e-3, and the per-keyframe twin path
    (``plain=True``, each keyframe its own cull) bit for bit."""
    cj, ct, p, valid, images, masks, q, t, corr = _fuse_inputs()
    kw = dict(top_k=5, culling_method="hpr", hpr_impl="grid", hpr_tolerance=0.05)
    with jax.disable_jit():
        fj = jcol.fuse(cj, jnp.asarray(p), jnp.asarray(valid), jnp.asarray(images),
                       jse3.SE3(jnp.asarray(q), jnp.asarray(t)), corr,
                       mask_images=jnp.asarray(masks), with_masks=True, **kw)
    args = (ct, torch.from_numpy(p), torch.from_numpy(valid), torch.from_numpy(images),
            interop.pose(q, t, CPU), interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU))
    calls = _count(monkeypatch, "mask_views", 1)  # R (V, 3, 3)
    ft = tcol.fuse(*args, mask_images=torch.from_numpy(masks), **kw)
    assert calls == [3]
    np.testing.assert_array_equal(ft.colored.numpy(), np.asarray(fj.colored))
    np.testing.assert_array_equal(ft.observation_count.numpy(), np.asarray(fj.observation_count))
    np.testing.assert_array_equal(ft.best_label.numpy(), np.asarray(fj.best_label))
    np.testing.assert_allclose(ft.rgb.numpy(), np.asarray(fj.rgb), atol=1e-3)
    fp = tcol.fuse(*args, mask_images=torch.from_numpy(masks), plain=True, **kw)
    assert calls == [3]  # the twin path culls a keyframe at a time
    for a, b in zip(ft, fp):
        assert torch.equal(a, b)
    assert ft.colored.sum() > 1000


@pytest.fixture(scope="module")
def occluded_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpr_batch")
    write_dataset(root, n_frames=4, odom_offset=(0.02, -0.01, 0.0), wall_slope=0.2,
                  occluder=True)
    return root


@pytest.mark.parametrize("impl", ["grid", "dense"])
def test_build_nid_keyframes_hpr_batch_matches_jax(occluded_dataset, impl, monkeypatch):
    """``runner.build_nid_keyframes`` under HPR culls its four keyframes in
    one batch and assembles the JAX runner's keyframes: the same points
    (within f32 rounding), valid flags, intensities and bin images."""
    root = occluded_dataset
    cfg = small_config(root)
    cfg.map_capacity = cfg.culled_capacity = 12288
    cfg.culling.method = "hpr"
    cfg.culling.hpr_impl = impl
    cloud_j = jpcd.read_cloud(cfg.point_cloud_path, capacity=cfg.map_capacity)
    frames_j = jrunner.ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    # The grid cull op by op; the dense one jitted (its twin matches XLA's
    # blocked product, tests/test_torch_hpr.py::test_dense_mask_bit_equal).
    with jax.disable_jit(impl == "grid"):
        kj = jrunner.build_nid_keyframes(jrunner._make_camera(cfg), cloud_j, frames_j,
                                         list(range(4)), cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cloud_t = tpcd.read_cloud(cfg_t.point_cloud_path, CPU, capacity=cfg_t.map_capacity)
    frames_t = ting.load_frames(cfg_t.odometry_path, cfg_t.images_folder)
    calls = _count(monkeypatch, "mask_batch", 0)  # points (K, N, 3)
    kt = trunner.build_nid_keyframes(trunner._make_camera(cfg_t, CPU), cloud_t, frames_t,
                                     list(range(4)), cfg_t)
    assert calls == [4]
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.intensity.numpy(), np.asarray(kj.intensity))
    np.testing.assert_array_equal(kt.bin_image.numpy(), np.asarray(kj.bin_image))
    np.testing.assert_allclose(kt.points.numpy(), np.asarray(kj.points), atol=1e-5)
    n_vis = kt.valid.sum(1)
    assert bool((n_vis > 1000).all()), n_vis
