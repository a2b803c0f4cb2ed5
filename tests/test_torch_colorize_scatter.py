"""PyTorch port vs the JAX package: C1's pass (a) for a batch of keyframes
(`pipeline/colorize.depth_keys`, one ``colorize_scatter`` launch on the
card) through its plain twin ``depth_keys_plain``, and `fuse` in the two
steps the card runs (pass (a) for all keyframes, then pass (b) a keyframe
against its keys).

The JAX reference is `observe_keyframe`'s transform, range and projection
with the gate, cell and scatter-min of `ops/zbuffer.py:57-70`, op by op
(`jax.disable_jit()`), its cell minima read off the buffer before the depth
test. Tolerance class: cell minima bit for bit where both sides round the
range's square root correctly. torch's CPU `sqrt` (its AVX512 path) is not
correctly rounded on some inputs (ROADMAP §3), so with it a few cells sit
one ulp from JAX's; with a correctly rounded square root in its place every
cell is bit-equal. Fusion states: visibility, color slots, counts and best
labels bit for bit, scores within 1e-6 (tests/test_torch_colorize_kernel.py
states why). The kernel runs only on the card, where `chip_smoke.py` holds
it to this twin and to one launch a keyframe on every key."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.ops import fusion as jfus
from pointcloudprocessor_tpu.ops import zbuffer as jzb
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.kernels import build as kbuild
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import gradient_image, simple_camera, wall_scene

CPU = "cpu"
DISTORTION = (-0.05, 0.012, 0.001, -0.0005, 0.002)
N_KF = 4
TOP_K = 3  # fewer slots than keyframes, so the registers fill and replace
EPS = 0.3
F32_MAX = np.finfo(np.float32).max


def _scene(distorted=False):
    """The occluder wall with random points around it, points on and near
    the image's and the cells' edges in keyframe 0's view, behind and on its
    image plane, NaN and infinite points and invalid ones, 2,709 in all (a
    ragged count); four keyframes' poses, images and masks and a
    non-identity correction."""
    cj = simple_camera(distortion=DISTORTION if distorted else None)
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion), cj.width,
                        cj.height, CPU)
    q = np.asarray([[1, 0, 0, 0], [0.9998, 0.0, 0.02, 0.0], [0.9995, 0.01, -0.03, 0.0],
                    [0.9997, -0.02, 0.0, 0.01]], np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.asarray([[0, 0, 0], [0.2, 0.0, 0.1], [-0.15, 0.05, 0.0], [0.05, -0.1, 0.3]],
                   np.float32)
    corr = jse3.exp(jnp.asarray([0.01, -0.02, 0.015, 0.003, -0.002, 0.004], jnp.float32))
    rs = np.random.default_rng(5)
    wall, _, _ = wall_scene(cj)
    extra = rs.uniform(-8, 8, (300, 3)).astype(np.float32)
    # Keyframe 0's camera frame: pixels on the image's edges and on cell
    # edges (multiples of 4 and 7), a hair inside and outside, at 3 depths;
    # points behind the camera and on its plane.
    f, cx, cy = 120.0, cj.width / 2.0, cj.height / 2.0
    us = np.asarray([0, 1e-3, 4, 7, 8, 14, 28, 63.999, 64, cj.width - 1e-3, cj.width, -1e-3])
    vs = np.asarray([0, 1e-3, 4, 7, 21, 48, 56, cj.height - 1e-3, cj.height, -1e-3])
    uu, vv, zz = np.meshgrid(us, vs, [1.5, 4.0, 6.0])
    cam_pts = np.stack([(uu - cx) / f * zz, (vv - cy) / f * zz, zz], -1).reshape(-1, 3)
    cam_pts = np.concatenate([cam_pts, [[0.1, 0.1, 0.0], [0.0, 0.0, -2.0], [1.0, -1.0, -0.5]]])
    with jax.disable_jit():
        T0 = jse3.inverse(jse3.compose(jse3.SE3(jnp.asarray(q[0]), jnp.asarray(t[0])), corr))
        edge = np.asarray(jse3.transform_points(jse3.inverse(T0),
                                                jnp.asarray(cam_pts, jnp.float32)))
    odd = np.asarray([[np.nan, 0, 5], [0, np.inf, 5], [0, 0, np.inf], [np.nan] * 3,
                      [0, 0, -np.inf]], np.float32)
    pts = np.concatenate([wall, extra, edge, odd]).astype(np.float32)
    pts = np.concatenate([pts, np.zeros((41, 3), np.float32)])
    valid = rs.uniform(size=len(pts)) > 0.05
    valid[-40:] = False
    images = np.stack([np.roll(gradient_image(), 7 * i, axis=1) for i in range(N_KF)])
    images[..., 1] = rs.integers(0, 256, images.shape[:3])
    masks = rs.integers(0, 256, (N_KF, cj.height, cj.width)).astype(np.int32)
    return cj, ct, pts, valid, images, masks, q, t, corr


def _jax_views(q, t, corr):
    """Each keyframe's T_camera_world as the JAX package's fuse forms it."""
    with jax.disable_jit():
        return [jse3.inverse(jse3.compose(jse3.SE3(jnp.asarray(q[j]), jnp.asarray(t[j])), corr))
                for j in range(len(q))]


def _port_views(jviews, t):
    """The JAX views handed over as they are, as one batch, so that both
    sides round alike."""
    T = interop.pose(np.stack([np.asarray(v.q) for v in jviews]),
                     np.stack([np.asarray(v.t) for v in jviews]), CPU)
    return tcol.KeyframePose(T, tse3.quat_to_matrix(T.q), torch.from_numpy(t))


def _jax_cell_minima(cj, T_cw, pts, valid, ds):
    """JAX's z-buffer of one keyframe, op by op: observe_keyframe's
    transform, range and projection, then `ops/zbuffer.py:57-70`'s gate,
    cell and scatter-min; the buffer without its sink cell. Asserts that
    its depth test is `jzb.cull_mask_uv`'s mask."""
    with jax.disable_jit():
        p = jnp.asarray(pts)
        x, y, z = jse3.transform_xyz(T_cw, p[:, 0], p[:, 1], p[:, 2])
        rng = jnp.sqrt(x * x + y * y + z * z)
        u, v = jcam.project_xyz(cj, x, y, z)
        gw, gh = cj.width // ds, cj.height // ds
        ok = jnp.asarray(valid) & (z > 0.0) & jcam.in_image_uv(cj, u, v)
        ui = jnp.clip((u / ds).astype(jnp.int32), 0, gw - 1)
        vi = jnp.clip((v / ds).astype(jnp.int32), 0, gh - 1)
        big = jnp.asarray(jnp.finfo(rng.dtype).max, rng.dtype)
        cell = jnp.where(ok, vi * gw + ui, gw * gh)
        zmin = jnp.full((gw * gh + 1,), big, rng.dtype).at[cell].min(
            jnp.where(ok, rng, big), mode="drop")
        vis = ok & (rng <= zmin[cell] + EPS)
        want = jzb.cull_mask_uv(cj, u, v, z, rng, jnp.asarray(valid), ds, EPS)
        np.testing.assert_array_equal(np.asarray(vis), np.asarray(want))
        return np.asarray(zmin[:-1])


def _correct_sqrt(x):
    """A correctly rounded f32 square root: in f64, then one rounding."""
    return _TORCH_SQRT(x.double()).to(x.dtype) if x.dtype == torch.float32 else _TORCH_SQRT(x)


_TORCH_SQRT = torch.sqrt


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("ds", [4, 7])
def test_depth_keys_twin_matches_jax_cull(distorted, ds, monkeypatch):
    """Each keyframe's row of the batched twin is JAX's cell minima: bit
    for bit with a correctly rounded square root; with torch's own, every
    cell within one ulp, and those that move are few (4-8 of 936-3,072 here)."""
    cj, ct, pts, valid, _, _, q, t, corr = _scene(distorted)
    jviews = _jax_views(q, t, corr)
    batch = _port_views(jviews, t)
    want = np.stack([_jax_cell_minima(cj, T, pts, valid, ds) for T in jviews])
    args = (ct, batch, torch.from_numpy(pts), torch.from_numpy(valid), ds)
    got = tcol.depth_keys(*args).numpy()
    assert got.shape == (N_KF, (cj.width // ds) * (cj.height // ds)) and got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= got.size // 100, np.argwhere(ulps > 0)
    monkeypatch.setattr(torch, "sqrt", _correct_sqrt)
    np.testing.assert_array_equal(tcol.depth_keys(*args).numpy().view(np.int32),
                                  want.view(np.int32))
    # Every keyframe sees some of the map, and some cells stay empty.
    assert ((want < F32_MAX).sum(1) > 20).all() and (want == F32_MAX).any()


def test_depth_keys_batch_is_each_keyframe_alone():
    """A batch's rows are what each keyframe gives alone, and the twin's
    empty map leaves every cell at f32 max."""
    cj, ct, pts, valid, _, _, q, t, corr = _scene()
    batch = tcol.keyframe_pose(interop.pose(q, t, CPU),
                               interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU))
    p, v = torch.from_numpy(pts), torch.from_numpy(valid)
    keys = tcol.depth_keys(ct, batch, p, v, 4)
    for j in range(N_KF):
        one = tcol.depth_keys(ct, batch.at(j).batch(), p, v, 4)
        assert torch.equal(keys[j].view(torch.int32), one[0].view(torch.int32))
    part = tcol.depth_keys(ct, batch.at(slice(1, 3)), p, v, 4)
    assert torch.equal(part.view(torch.int32), keys[1:3].view(torch.int32))
    empty = tcol.depth_keys(ct, batch, p[:0], v[:0], 4)
    assert empty.shape == keys.shape and (empty == F32_MAX).all()


def _jax_step(state, cj, image, T_cw, position, pts, valid, mask, kw):
    """One keyframe of the JAX package's fuse scan, op by op."""
    topk, count, best_s, best_l = state
    with jax.disable_jit():
        obs = jcol.observe_keyframe(cj, image, T_cw, pts, valid, mask_image=mask,
                                    camera_position_world=position, **kw)
        topk = jfus.update_topk(topk, obs.score, obs.rgb_packed, obs.visible)
        if mask is not None:
            s = jnp.where(obs.visible, obs.score, -jnp.inf)
            better = s > best_s
            best_s = jnp.where(better, s, best_s)
            best_l = jnp.where(better, obs.label, best_l)
    return topk, count + obs.visible.astype(jnp.int32), best_s, best_l


def _assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6)


CASES = {
    # name: (masks, (saturation, brightness), reference_compat, optimal distance, distorted)
    "plain": (False, (1.0, 1.0), False, 2.0, False),
    "masks hsv compat od3": (True, (0.7, 1.2), True, 3.0, False),
    "masks distorted": (True, (1.0, 1.0), False, 2.0, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fuse_in_two_steps_matches_jax_scan(case):
    """Pass (a) for the four keyframes at once, then pass (b) a keyframe
    against its row, twice over: after every keyframe the state equals the
    JAX scan's (slots, counts, labels bit for bit, scores within 1e-6) and
    the one-keyframe composition's (each keyframe its own cull) bit for
    bit."""
    labelled, hsv, compat, od, distorted = CASES[case]
    cj, ct, pts, valid, images, masks, q, t, corr = _scene(distorted)
    kw = dict(optimal_distance=od, score_floor=0.2, saturation_scale=hsv[0],
              brightness_scale=hsv[1], reference_compat_orientation=compat,
              culling_method="zbuffer", downsample_factor=4, depth_epsilon=EPS)
    n = len(pts)
    jviews = _jax_views(q, t, corr)
    batch = _port_views(jviews, t)
    p, v = torch.from_numpy(pts), torch.from_numpy(valid)
    js = (jfus.init_topk(n, TOP_K), jnp.zeros(n, jnp.int32), jnp.full(n, -jnp.inf, jnp.float32),
          jnp.zeros(n, jnp.int32))
    two, one = (tcol.init_fuse_state(n, CPU, TOP_K, labelled) for _ in range(2))
    for _ in range(2):
        keys = tcol.depth_keys(ct, batch, p, v, 4)
        for j in range(N_KF):
            m = masks[j] if labelled else None
            js = _jax_step(js, cj, jnp.asarray(images[j]), jviews[j], jnp.asarray(t[j]),
                           jnp.asarray(pts), jnp.asarray(valid),
                           None if m is None else jnp.asarray(m), kw)
            args = (ct, torch.from_numpy(images[j]), batch.at(j), p, v,
                    None if m is None else torch.from_numpy(m))
            tcol.fuse_keyframe(two, *args, keys=keys[j], **kw)
            tcol.fuse_keyframe(one, *args, **kw)
            topk, count, best_s, best_l = js
            _assert_scores_close(two.topk.scores.numpy(), topk.scores)
            np.testing.assert_array_equal(two.topk.rgb.numpy(), np.asarray(topk.rgb))
            np.testing.assert_array_equal(two.count.numpy(), np.asarray(count))
            if labelled:
                _assert_scores_close(two.best_score.numpy(), best_s)
                np.testing.assert_array_equal(two.best_label.numpy(), np.asarray(best_l))
            for a, b in zip(two.topk + tuple(two[1:]), one.topk + tuple(one[1:])):
                if a is not None:
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(two.count.max()) > TOP_K and torch.isfinite(two.topk.scores).all(0).sum() > 100


@pytest.mark.parametrize("scatter_views", [1, 3])
def test_fuse_runs_pass_a_in_runs_of_scatter_views(scatter_views, monkeypatch):
    """`fuse` takes pass (a) for up to SCATTER_VIEWS keyframes at once; runs
    of 1 or 3 give the bits of one run of all four, with masks."""
    cj, ct, pts, valid, images, masks, q, t, corr = _scene()
    calls = []
    depth_keys = tcol.depth_keys

    def counted(camera, views, *a):
        calls.append(views.R.shape[0])
        return depth_keys(camera, views, *a)

    args = (ct, torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(images),
            interop.pose(q, t, CPU), interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU),
            torch.from_numpy(masks))
    kw = dict(top_k=TOP_K, downsample_factor=4, depth_epsilon=EPS)
    monkeypatch.setattr(tcol, "depth_keys", counted)
    want = tcol.fuse(*args, **kw)
    assert calls == [N_KF]
    monkeypatch.setattr(tcol, "SCATTER_VIEWS", scatter_views)
    got = tcol.fuse(*args, **kw)
    assert calls[1:] == [min(scatter_views, N_KF - s) for s in range(0, N_KF, scatter_views)]
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    tcol.fuse(*args, plain=True, **kw)  # the eager path: each keyframe its own cull
    assert len(calls) == 1 + len(range(0, N_KF, scatter_views))
    assert tcol.launch_counts == {"colorize_scatter": 0, "colorize_update": 0}


def _encode(r):
    """`csrc/zbuffer.cuh`'s order key of an f32 range, in numpy."""
    b = (np.asarray(r, np.float32) + np.float32(0.0)).view(np.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF) ^ np.int32(-2**31)).astype(np.int32)


def test_cell_minima_reads_the_kernels_keys():
    """`cell_minima` decodes the keys pass (a) writes as pass (b) reads
    them: a range's key back to its bits (-0 as +0), +inf and the all-ones
    key of an empty cell to f32 max; keys order as their ranges."""
    r = np.asarray([0.0, -0.0, 1e-45, 1e-38, 0.05, 1.0, 2.5, 1e30, F32_MAX, np.inf, -1.0],
                   np.float32)
    keys = np.concatenate([_encode(r), [-1]]).astype(np.int32)
    got = tcol.cell_minima(torch.from_numpy(keys)).numpy()
    want = np.concatenate([np.minimum(r + np.float32(0.0), F32_MAX), [F32_MAX]]).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ordered = np.asarray([-1.0, 0.0, 1e-45, 1e-38, 0.05, 1.0, 2.5, 1e30, F32_MAX, np.inf],
                         np.float32)
    assert (np.diff(_encode(ordered).view(np.uint32).astype(np.int64)) > 0).all()


def test_depth_keys_dispatch():
    """Any device but the CPU and CUDA raises; the CUDA wrapper refuses CPU
    tensors before any build or launch."""
    camera = tcam.create_camera("pinhole", (100.0, 100.0, 32.0, 24.0), (0.0,) * 5, 64, 48, "meta")
    eye = tse3.identity("meta")
    view = tcol.keyframe_pose(eye, eye).batch()
    with pytest.raises(NotImplementedError, match="no kernel"):
        tcol.depth_keys(camera, view, torch.empty((16, 3), device="meta"),
                        torch.empty((16,), dtype=torch.bool, device="meta"), 4)
    cj, ct, pts, valid, _, _, q, t, corr = _scene()
    batch = tcol.keyframe_pose(interop.pose(q, t, CPU), tse3.identity(CPU))
    with pytest.raises(ValueError, match="CUDA"):
        tcol.depth_keys_cuda(ct, batch, torch.from_numpy(pts), torch.from_numpy(valid), 4)
    assert tcol.launch_counts == {"colorize_scatter": 0, "colorize_update": 0}


def test_scatter_views_is_the_kernels_limit():
    """`SCATTER_VIEWS` is `kMaxViews` of csrc/colorize.cu, the views a pass
    (a) launch stages, and its launcher takes `colorize_keys`'s arguments."""
    with open(os.path.join(kbuild.CSRC_DIR, "colorize.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kMaxViews = (\d+);", src).group(1)) == tcol.SCATTER_VIEWS
    assert re.search(r"int colorize_keys\(const ColorizeArgs\* args, int views, void\* stream\)",
                     src)
    argtypes, _ = tcol._SIGNATURES["colorize_keys"]
    assert len(argtypes) == 3
