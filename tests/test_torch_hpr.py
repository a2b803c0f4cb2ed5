"""PyTorch port vs the JAX package: hidden-point removal (`ops/hpr.py`) and
colorize with ``culling_method="hpr"``.

Tolerance classes: masks bit-exact (the grid cull against the jitted JAX
`hpr_mask_grid`, the dense cull's matmul twin against the jitted
`hpr_mask`), camera-frame points and flips within f32 rounding, fused
colors within 1e-3. The JAX package jits `fuse` and `keyframe_rgb_mask`,
and XLA fuses their f32 arithmetic; the port is held bit for bit against
them run op by op (``jax.disable_jit``), as the mask path's tests do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.ops import hpr as jhpr
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.ops import hpr as thpr
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import gradient_image, simple_camera, wall_scene

CPU = "cpu"


def _both(points, valid):
    return (jnp.asarray(points), jnp.asarray(valid)), (torch.from_numpy(points),
                                                       torch.from_numpy(valid))


def test_spherical_flip_matches_jax():
    pts = np.random.default_rng(1).normal(size=(256, 3)).astype(np.float32) * 10
    pts[0] = 0.0  # the origin maps to the origin
    want = np.asarray(jhpr.spherical_flip(jnp.asarray(pts), 100.0))
    got = thpr.spherical_flip(torch.from_numpy(pts), 100.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("n", [4096, 8192])
def test_dense_mask_bit_equal(n):
    """The dense cull's twin (chunked f32 ``d @ f.T``, ``amax``) gives the
    jitted JAX mask bit for bit, on the two-wall scene with z jitter and
    invalid points."""
    pts, valid = bs.two_walls(n, seed=n, z_jitter=0.3, invalid=0.02)
    (pj, vj), (pt, vt) = _both(pts, valid)
    want = np.asarray(jhpr.hpr_mask(pj, vj))
    got = thpr.hpr_mask(pt, vt).numpy()
    np.testing.assert_array_equal(got, want)
    # The near wall hides the far wall's middle.
    assert 0.3 * n < got.sum() < 0.9 * n
    # The support pieces: no gated point beats its own support by the tolerance.
    ok, support, self_support = thpr.hpr_support_plain(pt, vt)
    assert torch.all(support[ok] >= self_support[ok] - 0.05)


def test_grid_mask_bit_equal_two_walls():
    """The grid cull's twin gives the jitted JAX mask bit for bit at 65,536
    points of the HPR bench's scene (z jitter, 2% invalid)."""
    pts, valid = bs.two_walls(65_536, seed=0, z_jitter=0.3, invalid=0.02)
    (pj, vj), (pt, vt) = _both(pts, valid)
    want = np.asarray(jhpr.hpr_mask_grid(pj, vj))
    got = thpr.hpr_mask_grid(pt, vt).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 * len(pts) < got.sum() < 0.7 * len(pts)


@pytest.mark.parametrize("name", list(bs.hpr_edge_sets(n_bulk=64)))
def test_grid_mask_bit_equal_edge_sets(name):
    """NaN and +-inf coordinates, z <= 0, tiny z and range, the origin,
    points on cell edges (the bounds pinned so cells are 1/256 wide), an
    all-invalid set and a single valid point: bit-equal to JAX."""
    pts, valid = bs.hpr_edge_sets()[name]
    (pj, vj), (pt, vt) = _both(pts, valid)
    with np.errstate(invalid="ignore", over="ignore"):
        want = np.asarray(jhpr.hpr_mask_grid(pj, vj))
    got = thpr.hpr_mask_grid(pt, vt).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "all invalid":
        assert not got.any()
    if name == "single valid":
        assert got.sum() == 1


def test_empty_and_unknown_device():
    empty = torch.zeros((0, 3))
    none = torch.zeros((0,), dtype=torch.bool)
    assert thpr.hpr_mask_grid(empty, none).shape == (0,)
    assert thpr.hpr_mask(empty, none).shape == (0,)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(NotImplementedError):
        thpr.hpr_mask_grid(meta, torch.ones((4,), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        thpr.hpr_mask_grid_cuda(torch.ones((4, 3)), torch.ones((4,), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        thpr.hpr_mask_cuda(torch.ones((4, 3)), torch.ones((4,), dtype=torch.bool))


def _frustum_cams():
    cj = jcam.PinholeCamera(intrinsic=jnp.asarray([100.0, 100.0, 64.0, 48.0]),
                            distortion=jnp.zeros(5), width=128, height=96)
    ct = interop.camera((100.0, 100.0, 64.0, 48.0), (0.0,) * 5, 128, 96, CPU)
    return cj, ct


@pytest.mark.parametrize("impl, cutoff, picked", [
    ("dense", 100_000, "dense"), ("grid", 100_000, "grid"),
    ("auto", 100, "grid"), ("auto", 10**6, "dense"),
])
def test_cull_world_points_impl_selection(impl, cutoff, picked):
    """``auto`` is the grid above ``dense_cutoff`` points and dense at or
    below it; each impl's mask and points match the JAX cull."""
    cj, ct = _frustum_cams()
    pts, _ = bs.two_walls(3000, seed=9)
    pts[::50, 2] *= -1.0  # behind the camera
    valid = np.ones(len(pts), bool)
    valid[::37] = False
    xi = np.asarray([0.02, -0.01, 0.03, 0.01, 0.02, -0.01], np.float32)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = interop.pose(np.asarray(Tj.q), np.asarray(Tj.t), CPU)
    pj, mj = jhpr.cull_world_points(cj, Tj, jnp.asarray(pts), jnp.asarray(valid), impl=impl,
                                    dense_cutoff=cutoff)
    pt, mt = thpr.cull_world_points(ct, Tt, torch.from_numpy(pts), torch.from_numpy(valid),
                                    impl=impl, dense_cutoff=cutoff)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert thpr.select_impl(impl, len(pts), cutoff) == picked
    fn = thpr.hpr_mask_grid if picked == "grid" else thpr.hpr_mask
    u, v = thpr.cam.project_uv(ct, pt)
    gate = torch.from_numpy(valid) & (pt[:, 2] > 0) & thpr.cam.in_image_uv(ct, u, v)
    assert torch.equal(mt, fn(pt, gate))
    n1 = 1500
    assert mt[:n1].sum() > 0.5 * n1 and mt[n1:].sum() < 0.6 * n1


def test_cull_world_points_gates_to_frustum():
    _, ct = _frustum_cams()
    pts = torch.tensor([[0, 0, 5.0], [0, 0, -5.0], [50.0, 0, 5.0]])
    _, mask = thpr.cull_world_points(ct, tse3.identity(CPU), pts, torch.ones(3, dtype=torch.bool))
    assert mask.tolist() == [True, False, False]
    with pytest.raises(ValueError, match="hpr_impl"):
        thpr.select_impl("qhull", 10, 100)


def _fuse_inputs():
    cj = simple_camera()
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion), cj.width,
                        cj.height, CPU)
    pts, _, _ = wall_scene(cj)
    n = len(pts)
    p = np.zeros((n + 100, 3), np.float32)
    p[:n] = pts
    valid = np.zeros(n + 100, bool)
    valid[:n] = True
    base = gradient_image()
    images = np.stack([np.roll(base, 7 * i, axis=1) for i in range(3)])
    masks = np.zeros((3, cj.height, cj.width), np.int32)
    masks[:, :, : cj.width // 2] = 255
    masks[1, :20] = 7
    q = np.asarray([[1, 0, 0, 0], [0.9998, 0.0, 0.02, 0.0], [0.9995, 0.01, -0.03, 0.0]],
                   np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.asarray([[0, 0, 0], [0.2, 0.0, 0.1], [-0.15, 0.05, 0.0]], np.float32)
    corr = jse3.exp(jnp.asarray([0.01, -0.02, 0.015, 0.003, -0.002, 0.004], jnp.float32))
    return cj, ct, p, valid, images, masks, q, t, corr


@pytest.mark.parametrize("impl", ["dense", "grid"])
def test_fuse_hpr_matches_jax_at_fixed_correction(impl):
    """Three keyframes of the occluder scene, HPR culling, a fixed
    non-identity correction, mask labels on: colored mask, observation
    counts and best labels bit-exact, top-K blend within 1e-3."""
    cj, ct, p, valid, images, masks, q, t, corr = _fuse_inputs()
    kw = dict(top_k=5, culling_method="hpr", hpr_impl=impl, hpr_tolerance=0.05)
    with jax.disable_jit():
        fj = jcol.fuse(cj, jnp.asarray(p), jnp.asarray(valid), jnp.asarray(images),
                       jse3.SE3(jnp.asarray(q), jnp.asarray(t)), corr,
                       mask_images=jnp.asarray(masks), with_masks=True, **kw)
    ft = tcol.fuse(ct, torch.from_numpy(p), torch.from_numpy(valid), torch.from_numpy(images),
                   interop.pose(q, t, CPU),
                   interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU),
                   mask_images=torch.from_numpy(masks), **kw)
    np.testing.assert_array_equal(ft.colored.numpy(), np.asarray(fj.colored))
    np.testing.assert_array_equal(ft.observation_count.numpy(), np.asarray(fj.observation_count))
    np.testing.assert_array_equal(ft.best_label.numpy(), np.asarray(fj.best_label))
    np.testing.assert_allclose(ft.rgb.numpy(), np.asarray(fj.rgb), atol=1e-3)
    assert ft.colored.sum() > 1000
    # HPR hides points the z-buffer at ds 1 would keep, and vice versa: the
    # two culls are different tests.
    fz = tcol.fuse(ct, torch.from_numpy(p), torch.from_numpy(valid), torch.from_numpy(images),
                   interop.pose(q, t, CPU),
                   interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU),
                   top_k=5, downsample_factor=1)
    assert not torch.equal(fz.observation_count, ft.observation_count)


def test_keyframe_rgb_mask_hpr_matches_jax():
    cj, ct, p, valid, images, masks, q, t, corr = _fuse_inputs()
    kw = dict(culling_method="hpr", hpr_impl="grid")
    with jax.disable_jit():
        want = jcol.keyframe_rgb_mask(cj, jnp.asarray(p), jnp.asarray(valid),
                                      jnp.asarray(images[1]), jnp.asarray(masks[1]),
                                      jse3.SE3(jnp.asarray(q[1]), jnp.asarray(t[1])), corr, **kw)
    got = tcol.keyframe_rgb_mask(ct, torch.from_numpy(p), torch.from_numpy(valid),
                                 torch.from_numpy(images[1]), torch.from_numpy(masks[1]),
                                 interop.pose(q[1], t[1], CPU),
                                 interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].sum() > 500
