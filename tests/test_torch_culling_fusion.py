"""PyTorch port vs the JAX package: z-buffer culling, top-K fusion and the
colorize scan.

Tolerance classes: masks, packed colors and top-K slot choices bit-exact;
blended colors within 1e-3 (f32 weighted averages of 0..255 values);
scores within f32 rounding (1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.ops import fusion as jfus
from pointcloudprocessor_tpu.ops import zbuffer as jzb
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu_torch.ops import fusion as tfus
from pointcloudprocessor_tpu_torch.ops import zbuffer as tzb
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import gradient_image, simple_camera, wall_scene

CPU = "cpu"


def _cams(**kw):
    cj = simple_camera(**kw)
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion),
                        cj.width, cj.height, CPU)
    return cj, ct


@pytest.mark.parametrize("ds, eps", [(14, 0.05), (4, 0.3), (1, 0.05)])
def test_zbuffer_mask_bit_exact_on_occluder_scene(ds, eps):
    cj, ct = _cams()
    pts, _, hidden = wall_scene(cj)
    rng = np.random.default_rng(0)
    # Off-image, behind-camera and invalid points exercise every gate.
    extra = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    pts = np.concatenate([pts, extra])
    valid = rng.uniform(size=len(pts)) > 0.05
    want = np.asarray(jzb.cull_mask(cj, jnp.asarray(pts), jnp.asarray(valid), ds, eps))
    got = tzb.cull_mask(ct, torch.from_numpy(pts), torch.from_numpy(valid), ds, eps)
    np.testing.assert_array_equal(got.numpy(), want)
    if ds == 4:
        # The occluder really hides the wall behind it.
        assert not got.numpy()[: len(hidden)][hidden].any()


def test_cull_world_points_matches_jax():
    cj, ct = _cams()
    pts, _, _ = wall_scene(cj)
    xi = np.asarray([0.1, -0.05, 0.2, 0.01, 0.02, -0.01], np.float32)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = interop.pose(np.asarray(Tj.q), np.asarray(Tj.t), CPU)
    valid = np.ones(len(pts), bool)
    pj, mj = jzb.cull_world_points(cj, Tj, jnp.asarray(pts), jnp.asarray(valid), 4, 0.3)
    pt, mt = tzb.cull_world_points(ct, Tt, torch.from_numpy(pts), torch.from_numpy(valid), 4, 0.3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_update_topk_ties_take_first_min_slot():
    """All slots start at -inf; equal scores tie again later. The first
    minimal slot is replaced, as jnp.argmin picks it — slot by slot equal
    to the JAX registers after every update."""
    n, k = 64, 5
    rng = np.random.default_rng(1)
    sj, st = jfus.init_topk(n, k), tfus.init_topk(n, CPU, k)
    for step in range(9):
        score = rng.choice([0.3, 0.5, 0.5, 0.7], n).astype(np.float32)
        rgb = rng.integers(0, 1 << 24, n).astype(np.int32)
        valid = rng.uniform(size=n) > 0.2
        sj = jfus.update_topk(sj, jnp.asarray(score), jnp.asarray(rgb), jnp.asarray(valid))
        st = tfus.update_topk(st, torch.from_numpy(score), torch.from_numpy(rgb),
                              torch.from_numpy(valid))
        np.testing.assert_array_equal(st.scores.numpy(), np.asarray(sj.scores))
        np.testing.assert_array_equal(st.rgb.numpy(), np.asarray(sj.rgb))
    # After the first update every live point filled slot 0 first.
    s0 = tfus.update_topk(tfus.init_topk(4, CPU, k), torch.full((4,), 0.5),
                          torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    assert torch.isfinite(s0.scores[0]).all() and torch.isinf(s0.scores[1:]).all()
    rj, cj = jfus.blend_topk(sj)
    rt, ct = tfus.blend_topk(st)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)


def test_color_packing_and_scores_match_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tfus.pack_image_rgb(torch.from_numpy(img)).numpy(),
        np.asarray(jfus.pack_image_rgb(jnp.asarray(img))),
    )
    rgb = rng.uniform(-10, 270, (50, 3)).astype(np.float32)
    pt = tfus.pack_rgb(torch.from_numpy(rgb))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jfus.pack_rgb(jnp.asarray(rgb))))
    np.testing.assert_array_equal(tfus.unpack_rgb(pt).numpy(),
                                  np.asarray(jfus.unpack_rgb(jnp.asarray(pt.numpy()))))
    xyz = rng.uniform(-3, 6, (3, 200)).astype(np.float32)
    r = np.sqrt((xyz ** 2).sum(0)).astype(np.float32)
    cam_pos = np.asarray([0.3, -0.2, 0.1], np.float32)
    for compat in (False, True):
        sj = jfus.final_score_xyz(*(jnp.asarray(a) for a in (*xyz, r)), jnp.asarray(cam_pos),
                                  reference_compat=compat)
        st = tfus.final_score_xyz(*(torch.from_numpy(a) for a in (*xyz, r)),
                                  torch.from_numpy(cam_pos), reference_compat=compat)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    colors = rng.uniform(0, 255, (100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfus.hsv_adjust(torch.from_numpy(colors), 1.3, 0.8).numpy(),
        np.asarray(jfus.hsv_adjust(jnp.asarray(colors), 1.3, 0.8)), atol=1e-3,
    )


@pytest.mark.parametrize("hsv", [(1.0, 1.0), (1.2, 0.9)])
def test_fuse_matches_jax_at_fixed_correction(hsv):
    """Three keyframes over the occluder scene at a fixed, non-identity
    correction: colored mask and observation counts bit-exact, fused RGB
    within 1e-3. With an HSV map, sampled colors are truncated back to 8
    bits after f32 math that XLA rearranges under jit (the port matches
    eager JAX bit for bit), so a channel may land one level apart: the
    blend then agrees within one level (1.0 + 1e-3)."""
    cj, ct = _cams()
    pts, _, _ = wall_scene(cj)
    n = len(pts)
    cap = n + 100
    p = np.zeros((cap, 3), np.float32)
    p[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    base = gradient_image()
    images = np.stack([np.roll(base, 7 * i, axis=1) for i in range(3)])
    q = np.asarray([[1, 0, 0, 0], [0.9998, 0.0, 0.02, 0.0], [0.9995, 0.01, -0.03, 0.0]],
                   np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.asarray([[0, 0, 0], [0.2, 0.0, 0.1], [-0.15, 0.05, 0.0]], np.float32)
    corr = jse3.exp(jnp.asarray([0.01, -0.02, 0.015, 0.003, -0.002, 0.004], jnp.float32))
    kw = dict(top_k=5, downsample_factor=4, depth_epsilon=0.3,
              saturation_scale=hsv[0], brightness_scale=hsv[1])
    fj = jcol.fuse(cj, jnp.asarray(p), jnp.asarray(valid), jnp.asarray(images),
                   jse3.SE3(jnp.asarray(q), jnp.asarray(t)), corr, **kw)
    ft = tcol.fuse(ct, torch.from_numpy(p), torch.from_numpy(valid), torch.from_numpy(images),
                   interop.pose(q, t, CPU), interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU),
                   **kw)
    np.testing.assert_array_equal(ft.colored.numpy(), np.asarray(fj.colored))
    np.testing.assert_array_equal(ft.observation_count.numpy(), np.asarray(fj.observation_count))
    assert ft.colored.sum() > 1000
    atol = 1e-3 if hsv == (1.0, 1.0) else 1.0 + 1e-3
    np.testing.assert_allclose(ft.rgb.numpy(), np.asarray(fj.rgb), atol=atol)
