"""PyTorch port vs the JAX package: the per-keyframe colorize-and-fuse step
(C1, `csrc/colorize.cu`) through its plain twin, and the dispatch around it.

On the CPU, `pipeline/colorize.fuse_keyframe` takes its twin
`fuse_keyframe_plain`: the JAX package's `observe_keyframe`, `update_topk`
and the label and count updates of its `fuse` scan, in eager torch. The JAX
functions run op by op (`jax.disable_jit()`): under `jit` XLA divides by a
number through its reciprocal and fuses f32 math, and C1 and its twin
divide exactly and round every step. The kernels run only on the card,
where `chip_smoke.py` holds them to the twin bit for bit. Tolerance class:
bit-exact visibility, top-K color slots, counts, best labels and dump
outputs; the top-K and best scores within f32 rounding (1e-6, as
tests/test_torch_culling_fusion.py holds scores). A score is a function of
the range, a square root, and torch's CPU square root (its AVX512 path in
the torch 2.13 CPU build) is not correctly rounded on some inputs, where
XLA's, the card's and C1's (``__fsqrt_rn``) are: the range of point 1336 of
keyframe 0 below is one ulp under the JAX package's, and an ulp of a range
moves its score by a few ulp through z / range and |range - d| / d."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.ops import fusion as jfus
from pointcloudprocessor_tpu.pipeline import colorize as jcol
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.kernels import build as kbuild
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.ops import fusion as tfus
from pointcloudprocessor_tpu_torch.pipeline import colorize as tcol
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import gradient_image, simple_camera, wall_scene

CPU = "cpu"
DISTORTION = (-0.05, 0.012, 0.001, -0.0005, 0.002)
N_KF = 4
TOP_K = 3  # fewer slots than keyframes, so the registers fill and replace


def _scene(distorted=False):
    """The occluder scene of tests/test_torch_culling_fusion.py with
    off-image, behind-camera and invalid points and padding, four
    keyframes' images, masks and poses, and a non-identity correction."""
    cj = simple_camera(distortion=DISTORTION if distorted else None)
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion), cj.width,
                        cj.height, CPU)
    pts, _, _ = wall_scene(cj)
    rs = np.random.default_rng(11)
    extra = rs.uniform(-8, 8, (300, 3)).astype(np.float32)
    pts = np.concatenate([pts, extra, np.zeros((100, 3), np.float32)])
    valid = rs.uniform(size=len(pts)) > 0.05
    valid[-100:] = False
    images = np.stack([np.roll(gradient_image(), 7 * i, axis=1) for i in range(N_KF)])
    images[..., 1] = rs.integers(0, 256, images.shape[:3])  # hue in every pixel
    masks = rs.integers(0, 256, (N_KF, cj.height, cj.width)).astype(np.int32)
    q = np.asarray([[1, 0, 0, 0], [0.9998, 0.0, 0.02, 0.0], [0.9995, 0.01, -0.03, 0.0],
                    [0.9997, -0.02, 0.0, 0.01]], np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.asarray([[0, 0, 0], [0.2, 0.0, 0.1], [-0.15, 0.05, 0.0], [0.05, -0.1, 0.3]],
                   np.float32)
    corr = jse3.exp(jnp.asarray([0.01, -0.02, 0.015, 0.003, -0.002, 0.004], jnp.float32))
    return cj, ct, pts, valid, images, masks, q, t, corr


def _jax_step(state, cj, image, T_cw, position, pts, valid, mask, kw):
    """One keyframe of the JAX package's fuse scan, op by op."""
    topk, count, best_s, best_l = state
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
    """Equal in every non-finite element (the -inf of an empty slot), within
    1e-6 elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6)


def _assert_state_equal(ts, js):
    topk, count, best_s, best_l = js
    _assert_scores_close(ts.topk.scores.numpy(), topk.scores)
    np.testing.assert_array_equal(ts.topk.rgb.numpy(), np.asarray(topk.rgb))
    np.testing.assert_array_equal(ts.count.numpy(), np.asarray(count))
    if ts.best_score is not None:
        _assert_scores_close(ts.best_score.numpy(), best_s)
        np.testing.assert_array_equal(ts.best_label.numpy(), np.asarray(best_l))


CASES = {
    # name: (culling, masks, (saturation, brightness), reference_compat, optimal distance, distorted)
    "zbuffer": ("zbuffer", False, (1.0, 1.0), False, 2.0, False),
    "zbuffer masks": ("zbuffer", True, (1.0, 1.0), False, 2.0, False),
    "zbuffer masks hsv compat od3": ("zbuffer", True, (0.7, 1.2), True, 3.0, False),
    "zbuffer hsv od3 distorted": ("zbuffer", False, (0.7, 1.2), False, 3.0, True),
    "zbuffer masks compat distorted": ("zbuffer", True, (1.0, 1.0), True, 2.0, True),
    "hpr grid masks hsv": ("hpr", True, (0.7, 1.2), False, 2.0, False),
    "hpr dense compat od3": ("hpr", False, (1.0, 1.0), True, 3.0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fuse_keyframe_twin_matches_jax(case):
    """Four keyframes twice over (eight steps, three slots) at a fixed
    correction: after every step the twin's color slots, count and best
    label are the JAX scan's bit for bit, its scores within 1e-6."""
    method, labelled, hsv, compat, od, distorted = CASES[case]
    cj, ct, pts, valid, images, masks, q, t, corr = _scene(distorted)
    culling = dict(culling_method=method, downsample_factor=4, depth_epsilon=0.3)
    if method == "hpr":
        culling.update(hpr_impl="grid" if "grid" in case else "dense", hpr_tolerance=0.05)
    kw = dict(optimal_distance=od, score_floor=0.2, saturation_scale=hsv[0],
              brightness_scale=hsv[1], reference_compat_orientation=compat, **culling)
    n = len(pts)
    js = (jfus.init_topk(n, TOP_K), jnp.zeros(n, jnp.int32), jnp.full(n, -jnp.inf, jnp.float32),
          jnp.zeros(n, jnp.int32))
    ts = tcol.init_fuse_state(n, CPU, TOP_K, labelled)
    corr_t = interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU)
    for step in range(2 * N_KF):
        j = step % N_KF
        kf_j = jse3.SE3(jnp.asarray(q[j]), jnp.asarray(t[j]))
        mask = masks[j] if labelled else None
        with jax.disable_jit():
            T_cw = jse3.inverse(jse3.compose(kf_j, corr))
            js = _jax_step(js, cj, jnp.asarray(images[j]), T_cw, kf_j.t, jnp.asarray(pts),
                           jnp.asarray(valid), None if mask is None else jnp.asarray(mask), kw)
        # The JAX view, handed over as it is, so that both sides round alike.
        T_t = interop.pose(np.asarray(T_cw.q), np.asarray(T_cw.t), CPU)
        view = tcol.KeyframePose(T_t, tse3.quat_to_matrix(T_t.q), torch.from_numpy(t[j]))
        out = tcol.fuse_keyframe(ts, ct, torch.from_numpy(images[j]), view,
                                 torch.from_numpy(pts), torch.from_numpy(valid),
                                 None if mask is None else torch.from_numpy(mask), **kw)
        assert out is ts
        _assert_state_equal(ts, js)
    filled = torch.isfinite(ts.topk.scores)
    assert filled.all(dim=0).sum() > 100  # every slot of many points filled, then replaced
    assert int(ts.count.max()) > TOP_K


def _fuse_before(camera, points_world, valid, images, kf_poses, T_correction,
                 mask_images=None, *, top_k=5, **kw):
    """`colorize.fuse` as it was before the per-keyframe step: the JAX scan's
    body, observe_keyframe + update_topk + the label and count updates."""
    n = points_world.shape[0]
    labelled = mask_images is not None
    topk = tfus.init_topk(n, CPU, top_k)
    count = torch.zeros((n,), dtype=torch.int32)
    best_s = torch.full((n,), -torch.inf, dtype=torch.float32)
    best_l = torch.zeros((n,), dtype=torch.int32)
    for j in range(images.shape[0]):
        T_c2w = tse3.compose(tse3.SE3(kf_poses.q[j], kf_poses.t[j]), T_correction)
        obs = tcol.observe_keyframe(camera, images[j], tse3.inverse(T_c2w), points_world, valid,
                                    mask_image=mask_images[j] if labelled else None,
                                    camera_position_world=kf_poses.t[j], **kw)
        topk = tfus.update_topk(topk, obs.score, obs.rgb_packed, obs.visible)
        if labelled:
            s = torch.where(obs.visible, obs.score, -torch.inf)
            better = s > best_s
            best_s = torch.where(better, s, best_s)
            best_l = torch.where(better, obs.label, best_l)
        count = count + obs.visible.to(torch.int32)
    rgb, colored = tfus.blend_topk(topk)
    return rgb, colored & valid, best_l if labelled else None, count


@pytest.mark.parametrize("case", ["zbuffer", "zbuffer masks hsv compat od3",
                                  "hpr grid masks hsv"])
@pytest.mark.parametrize("plain", [False, True])
def test_fuse_equals_the_composition_before_the_step(case, plain):
    """`fuse` through `fuse_keyframe` (and through its twin, ``plain``)
    equals the pre-change composition bit for bit."""
    method, labelled, hsv, compat, od, _ = CASES[case]
    cj, ct, pts, valid, images, masks, q, t, corr = _scene()
    kw = dict(culling_method=method, downsample_factor=4, depth_epsilon=0.3,
              optimal_distance=od, saturation_scale=hsv[0], brightness_scale=hsv[1],
              reference_compat_orientation=compat)
    if method == "hpr":
        kw["hpr_impl"] = "grid"
    args = (ct, torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(images),
            interop.pose(q, t, CPU), interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU),
            torch.from_numpy(masks) if labelled else None)
    got = tcol.fuse(*args, top_k=TOP_K, plain=plain, **kw)
    rgb, colored, best_l, count = _fuse_before(*args, top_k=TOP_K, **kw)
    np.testing.assert_array_equal(got.rgb.numpy().view(np.int32), rgb.numpy().view(np.int32))
    np.testing.assert_array_equal(got.colored.numpy(), colored.numpy())
    np.testing.assert_array_equal(got.observation_count.numpy(), count.numpy())
    if labelled:
        np.testing.assert_array_equal(got.best_label.numpy(), best_l.numpy())
    else:
        assert got.best_label is None
    assert int(colored.sum()) > 1000


@pytest.mark.parametrize("case", ["zbuffer", "zbuffer masks hsv compat od3", "hpr grid masks hsv"])
def test_keyframe_rgb_mask_twin_matches_jax(case):
    """The dumps' twin against the JAX package's `keyframe_rgb_mask`, op by
    op: camera-frame points, colors (the highlight label painted red),
    labels and visibility of every point."""
    method, _, hsv, _, _, _ = CASES[case]
    cj, ct, pts, valid, images, masks, q, t, corr = _scene()
    kw = dict(culling_method=method, downsample_factor=4, depth_epsilon=0.3,
              saturation_scale=hsv[0], brightness_scale=hsv[1], mask_highlight_value=170)
    if method == "hpr":
        kw["hpr_impl"] = "grid"
    with jax.disable_jit():
        want = jcol.keyframe_rgb_mask(cj, jnp.asarray(pts), jnp.asarray(valid),
                                      jnp.asarray(images[1]), jnp.asarray(masks[1]),
                                      jse3.SE3(jnp.asarray(q[1]), jnp.asarray(t[1])), corr, **kw)
    got = tcol.keyframe_rgb_mask(ct, torch.from_numpy(pts), torch.from_numpy(valid),
                                 torch.from_numpy(images[1]), torch.from_numpy(masks[1]),
                                 interop.pose(q[1], t[1], CPU),
                                 interop.pose(np.asarray(corr.q), np.asarray(corr.t), CPU), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    label, vis = got[2].numpy(), got[3].numpy()
    assert vis.sum() > 500 and (got[1].numpy()[label == 170] == (255.0, 0.0, 0.0)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_views_are_the_per_keyframe_views(seed):
    """`keyframe_pose` over a batch of keyframes (as `fuse` forms the views)
    gives each keyframe the bits it gets alone."""
    rs = np.random.default_rng(seed)
    q = rs.normal(size=(9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rs.normal(size=(9, 3)).astype(np.float32)
    corr = tse3.exp(torch.from_numpy(rs.normal(size=6).astype(np.float32) * 0.1))
    views = tcol.keyframe_pose(interop.pose(q, t, CPU), corr)
    for j in range(len(q)):
        one = tcol.keyframe_pose(interop.pose(q[j], t[j], CPU), corr)
        got = views.at(j)
        for a, b in ((got.T.q, one.T.q), (got.T.t, one.T.t), (got.R, one.R),
                     (got.position, one.position)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fuse_keyframe_on_cpu_takes_the_twin_and_launches_nothing():
    cj, ct, pts, valid, images, masks, q, t, corr = _scene()
    tcol.reset_launch_counts()
    n = len(pts)
    view = tcol.keyframe_pose(interop.pose(q[1], t[1], CPU), tse3.identity(CPU))
    args = (ct, torch.from_numpy(images[1]), view, torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(masks[1]))
    a = tcol.fuse_keyframe(tcol.init_fuse_state(n, CPU, 5, True), *args, downsample_factor=4)
    b = tcol.fuse_keyframe_plain(tcol.init_fuse_state(n, CPU, 5, True), *args,
                                 downsample_factor=4)
    for x, y in zip((a.topk.scores, a.topk.rgb, a.count, a.best_score, a.best_label),
                    (b.topk.scores, b.topk.rgb, b.count, b.best_score, b.best_label)):
        assert torch.equal(x, y)
    assert tcol.launch_counts == {"colorize_scatter": 0, "colorize_update": 0}
    with pytest.raises(ValueError, match="must be 'zbuffer' or 'hpr'"):
        tcol.fuse_keyframe(a, *args, culling_method="none")


def test_unknown_device_raises():
    camera = tcam.create_camera("pinhole", (100.0, 100.0, 32.0, 24.0), (0.0,) * 5, 64, 48, "meta")
    pts = torch.empty((16, 3), device="meta")
    valid = torch.empty((16,), dtype=torch.bool, device="meta")
    image = torch.empty((48, 64, 3), dtype=torch.uint8, device="meta")
    mask = torch.empty((48, 64), dtype=torch.int32, device="meta")
    eye = tse3.identity("meta")
    view = tcol.keyframe_pose(eye, eye)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tcol.fuse_keyframe(tcol.init_fuse_state(16, "meta"), camera, image, view, pts, valid)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tcol.keyframe_rgb_mask(camera, pts, valid, image, mask, eye, eye)


def test_cuda_wrapper_rejects_cpu_tensors():
    """C1's argument checks run before any build or launch."""
    cj, ct, pts, valid, images, masks, q, t, corr = _scene()
    view = tcol.keyframe_pose(interop.pose(q[0], t[0], CPU), tse3.identity(CPU))
    state = tcol.init_fuse_state(len(pts), CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tcol._colorize_cuda(ct, view, torch.from_numpy(pts), torch.from_numpy(valid),
                            torch.from_numpy(images[0]), None, tcol._culling(), state=state)
    assert tcol.launch_counts == {"colorize_scatter": 0, "colorize_update": 0}


def test_colorize_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The C1 library build raises without nvcc; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "_build"))
    real_isfile = kbuild.os.path.isfile
    monkeypatch.setattr(kbuild.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild._compile("colorize")


_CTYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}


def test_args_structure_matches_the_kernel_source():
    """`_ColorizeArgs` lists `ColorizeArgs`'s fields in csrc/colorize.cu in
    order, each with the ctypes type of its C type, so the launcher reads
    what the wrapper wrote."""
    with open(os.path.join(kbuild.CSRC_DIR, "colorize.cu")) as f:
        src = f.read()
    body = re.search(r"struct ColorizeArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"((?:const )?(?:unsigned char|unsigned|long long|float|int)\*?) (.+);",
                         line)
        assert m, line
        typ = ctypes.c_void_p if m.group(1).endswith("*") else _CTYPES[m.group(1)]
        fields += [(name.strip(), typ) for name in m.group(2).split(",")]
    assert list(tcol._ColorizeArgs._fields_) == fields


def test_zbuffer_header_is_shared():
    """The cull's gate and key live once, in csrc/zbuffer.cuh: both the
    z-buffer and the C1 library include it, and its digest covers it."""
    header = os.path.join(kbuild.CSRC_DIR, "zbuffer.cuh")
    for name in ("zbuffer", "colorize"):
        assert header in kbuild._sources(kbuild._source(name), [])
