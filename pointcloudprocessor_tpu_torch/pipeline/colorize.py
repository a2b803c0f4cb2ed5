"""Projective colorization + multi-view fusion.

Port of `pointcloudprocessor_tpu/pipeline/colorize.py`, itself a rebuild of
`pcdColorizationAndSmooth` (`PointCloudProcessor.cpp:474-631`): per
keyframe, transform the map into the camera, z-buffer cull, sample the
image (and the mask label), score, and update the per-point top-K
registers. The JAX package's `lax.scan` over keyframes is a Python loop
here over :func:`fuse_keyframe`; the registers, the observation count and,
with masks, the best score and its label (:class:`FuseState`) are the only
state carried from one keyframe to the next.

``culling_method`` selects the visibility test as the refine path's
`CullingConfig.method` does: the reference colorizes through the same
`ViewCulling::cull` (`PointCloudProcessor.cpp:527`), qhull HPR on its active
path, so with "hpr" each keyframe's mask is the HPR mask (`ops/hpr.py`).

Dispatch goes by the map's device. CPU tensors take the plain twins
(:func:`fuse_keyframe_plain`, :func:`keyframe_rgb_mask_plain`: eager torch,
:func:`observe_keyframe` and ``fusion.update_topk``). CUDA tensors take C1,
the two kernels of `csrc/colorize.cu`. Pass (a), ``colorize_scatter``
(:func:`depth_keys`: transform, projection, gate, cell and scatter-min),
reads nothing of the fusion state, so :func:`fuse` runs it once for all its
keyframes (up to ``SCATTER_VIEWS`` a launch) after one memset of their key
buffers; then pass (b), ``colorize_update`` (the same transform and
projection again, the depth test against the keyframe's keys, the sample,
the HSV map, the score and the register, count and label updates), once a
keyframe. Under HPR, :func:`fuse` culls all its keyframes in one H2 call
(:func:`hpr_masks`: its passes transform, project and gate the map in each
view) and each keyframe is one ``colorize_update`` against its row. A
single keyframe (:func:`fuse_keyframe` without keys or masks,
:func:`keyframe_rgb_mask`) is a memset and both launches, or under HPR an
H2 call of its own and one ``colorize_update``; a build or launch failure
raises. The CPU takes the same two steps through the twins
(:func:`depth_keys_plain` or :func:`hpr_masks`, then the twin step against
those cell minima or masks).
Any other device raises. Both paths update the state in place and agree bit
for bit. ``launch_counts`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..kernels import build as kbuild
from ..models import camera as cam
from ..ops import fusion, hpr, zbuffer
from ..utils.numeric import to_int32

# Launches of each CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"colorize_scatter": 0, "colorize_update": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class _ColorizeArgs(ctypes.Structure):
    """`csrc/colorize.cu`'s ``ColorizeArgs``, field for field (null
    pointers for what a call does not use)."""

    _fields_ = [
        ("pts", _PTR), ("sp0", _I64), ("sp1", _I64), ("valid", _PTR), ("sv", _I64), ("n", _I32),
        ("R", _PTR), ("t", _PTR), ("intr", _PTR), ("dist", _PTR), ("pos", _PTR),
        ("width", _I32), ("height", _I32), ("ds", _I32), ("eps", _F32),
        ("keys", _PTR), ("vis_in", _PTR),
        ("image", _PTR), ("img_h", _I32), ("img_w", _I32), ("mask", _PTR),
        ("hsv", _I32), ("sat", _F32), ("bri", _F32),
        ("opt_dist", _F32), ("floor_", _F32), ("one_minus_floor", _F32),
        ("k", _I32), ("scores", _PTR), ("rgb", _PTR), ("count", _PTR),
        ("best_s", _PTR), ("best_l", _PTR),
        ("pts_cam", _PTR), ("rgb_out", _PTR), ("label_out", _PTR), ("vis_out", _PTR),
        ("highlight", _I32),
    ]


_SIGNATURES = {"colorize_keys": ([ctypes.POINTER(_ColorizeArgs), _I32, _PTR], _I32),
               "colorize": ([ctypes.POINTER(_ColorizeArgs), _PTR], _I32)}

# Keyframes one colorize_scatter launch takes at most (csrc/colorize.cu
# kMaxViews); fuse launches once for each run of this many.
SCATTER_VIEWS = 32


def _lib() -> ctypes.CDLL:
    return kbuild.library("colorize", _SIGNATURES)


class KeyframePose(NamedTuple):
    """A keyframe's view of the map (or a batch of them): ``T`` (camera <-
    world), its rotation matrix ``R`` (``se3.quat_to_matrix(T.q)``, as
    ``se3.transform_xyz`` forms it) and the camera's position in the world
    (the reference_compat score's)."""

    T: se3.SE3
    R: torch.Tensor  # (..., 3, 3)
    position: torch.Tensor  # (..., 3)

    def to(self, device) -> "KeyframePose":
        return KeyframePose(self.T.to(device), self.R.to(device), self.position.to(device))

    def at(self, j) -> "KeyframePose":
        """Keyframe ``j`` of a batch, or the batch of keyframes ``j`` for a
        slice (views, no copy)."""
        return KeyframePose(se3.SE3(self.T.q[j], self.T.t[j]), self.R[j], self.position[j])

    def batch(self) -> "KeyframePose":
        """One keyframe's view as a batch of one (views, no copy)."""
        return KeyframePose(se3.SE3(self.T.q[None], self.T.t[None]), self.R[None],
                            self.position[None])


def keyframe_pose(kf_pose: se3.SE3, T_correction: se3.SE3) -> KeyframePose:
    """The view of a keyframe whose camera -> world pose is ``kf_pose``,
    corrected as ``T_c2w * T_correction`` (`PointCloudProcessor.cpp:507,
    516`), or of each keyframe of a batch in one set of ops; none runs over
    the points. A batch gives each keyframe the bits it gets alone
    (``tests/test_torch_colorize_kernel.py``; ``chip_smoke.py`` on the card)."""
    T = se3.inverse(se3.compose(kf_pose, T_correction))
    return KeyframePose(T, se3.quat_to_matrix(T.q), kf_pose.t)


class KeyframeObservation(NamedTuple):
    """Per-point observation of one keyframe, aligned with the map cloud."""

    points_camera: torch.Tensor  # (N, 3)
    pixels: torch.Tensor  # (N, 2)
    visible: torch.Tensor  # (N,) bool
    rgb_packed: torch.Tensor  # (N,) int32 0xRRGGBB
    score: torch.Tensor  # (N,) finalScore
    label: Optional[torch.Tensor] = None  # (N,) int32 mask label


def _hpr_visible(camera, x, y, z, u, v, valid, radius, tolerance, impl, dense_cutoff):
    """The HPR mask of one keyframe's camera-frame points, gated on the
    unfloored pixel coordinates (``hpr.colorize_gate``)."""
    return hpr.mask(torch.stack([x, y, z], dim=-1), hpr.colorize_gate(camera, z, u, v, valid),
                    radius, tolerance, impl, dense_cutoff)


def hpr_masks(camera, views: KeyframePose, points_world, valid, culling: dict) -> torch.Tensor:
    """The colorize HPR masks of a batch of V keyframes, (V, N) bool, from
    one batched cull (``hpr.mask_views``): the grid cull on the card is one
    H2 call whose passes transform, project and gate the map themselves; its
    twin, and the dense cull a keyframe at a time, take the transform of
    ``se3.transform_xyz`` broadcast over the views (each keyframe gets the
    bits it gets alone). Row j is keyframe j's ``vis`` for
    :func:`fuse_keyframe`."""
    return hpr.mask_views(camera, views.R, views.T.t, points_world, valid,
                          culling["hpr_radius"], culling["hpr_tolerance"], culling["hpr_impl"],
                          culling["hpr_dense_cutoff"])


def observe_keyframe(
    camera: cam.PinholeCamera,
    image_rgb: torch.Tensor,  # (H, W, 3) uint8
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    mask_image: Optional[torch.Tensor] = None,  # (H, W) int32
    camera_position_world: Optional[torch.Tensor] = None,
    *,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
    cell_min: Optional[torch.Tensor] = None,
    visible: Optional[torch.Tensor] = None,
) -> KeyframeObservation:
    """Project the map into one keyframe: cull (the z-buffer, or HPR with
    ``culling_method="hpr"``), sample colors (and the mask label), score
    (`PointCloudProcessor.cpp:495-591`). The HPR branch gates on the
    unfloored pixel coordinates, as the JAX package's does
    (colorize.py:95-109). With ``cell_min`` (this keyframe's row of
    :func:`depth_keys_plain`) the z-buffer's depth test reads those cell
    minima instead of scattering its own; with ``visible`` (this keyframe's
    row of :func:`hpr_masks`) the HPR branch takes that mask instead of
    culling."""
    x, y, z = se3.transform_xyz(
        T_camera_world, points_world[:, 0], points_world[:, 1], points_world[:, 2]
    )
    rng = torch.sqrt(x * x + y * y + z * z)
    u, v = cam.project_xyz(camera, x, y, z)
    if culling_method == "hpr" and visible is not None:
        vis = visible
    elif culling_method == "hpr":
        vis = _hpr_visible(camera, x, y, z, u, v, valid, hpr_radius, hpr_tolerance, hpr_impl,
                           hpr_dense_cutoff)
    elif culling_method == "zbuffer" and cell_min is None:
        vis = zbuffer.cull_mask_uv(
            camera, u, v, z, rng, valid,
            downsample_factor=downsample_factor, depth_epsilon=depth_epsilon,
        )
    elif culling_method == "zbuffer":
        # A gated-out point's cell is the sink, one past the buffer.
        ok, cell, _ = zbuffer.cells(camera, u, v, z, valid, downsample_factor)
        buf = torch.cat([cell_min, cell_min.new_full((1,), torch.finfo(torch.float32).max)])
        vis = zbuffer.visible_plain(ok, rng, buf, cell, depth_epsilon)
    else:
        raise ValueError(f"culling.method must be 'zbuffer' or 'hpr', got {culling_method!r}")

    h, w = image_rgb.shape[0], image_rgb.shape[1]
    ui = torch.clamp(to_int32(u), 0, w - 1)
    vi = torch.clamp(to_int32(v), 0, h - 1)
    flat = (vi * w + ui).long()
    # Nearest sampling commutes with the per-pixel HSV map, so the samples
    # are adjusted, not the image (12x fewer values at 4096x3000 / 1M pts).
    rgb_packed = fusion.pack_image_rgb(image_rgb)[flat]
    if saturation_scale != 1.0 or brightness_scale != 1.0:
        rgb_packed = fusion.pack_rgb(
            fusion.hsv_adjust(
                fusion.unpack_rgb(rgb_packed), saturation_scale, brightness_scale
            )
        )
    score = fusion.final_score_xyz(
        x, y, z, rng,
        camera_position_world,
        optimal_distance=optimal_distance,
        score_floor=score_floor,
        reference_compat=reference_compat_orientation,
    )
    label = None
    if mask_image is not None:
        label = mask_image.reshape(-1)[flat].to(torch.int32)
    pixels = torch.stack([u, v], dim=-1)
    pts_cam = torch.stack([x, y, z], dim=-1)
    return KeyframeObservation(pts_cam, pixels, vis, rgb_packed, score, label)


# ---------------------------------------------------------------------------
# C1 on the card
# ---------------------------------------------------------------------------


def _check_cuda(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"C1: {name} must be on {device} (CUDA), got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"C1: {name} must be contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _map_args(camera, points_world, valid) -> tuple[_ColorizeArgs, int]:
    """The kernel arguments of the map and the camera, checked: (args, n)."""
    dev = points_world.device
    n = points_world.shape[0] if points_world.dim() == 2 else -1
    if dev.type != "cuda" or tuple(points_world.shape) != (n, 3) or n >= 2**31:
        raise ValueError(f"C1: points must be (N, 3) on a CUDA device, got "
                         f"{tuple(points_world.shape)} on {dev}")
    if points_world.dtype != torch.float32 or valid.dtype != torch.bool or valid.device != dev \
            or tuple(valid.shape) != (n,):
        raise ValueError(f"C1: points must be f32 and valid ({n},) bool on {dev}")
    _check_cuda("intrinsic", camera.intrinsic, dev, torch.float32, (4,))
    _check_cuda("distortion", camera.distortion, dev, torch.float32, (5,))
    return _ColorizeArgs(
        pts=points_world.data_ptr(), sp0=points_world.stride(0), sp1=points_world.stride(1),
        valid=valid.data_ptr(), sv=valid.stride(0), n=n, intr=camera.intrinsic.data_ptr(),
        dist=camera.distortion.data_ptr(), width=camera.width, height=camera.height), n


def _launch(name: str, a: _ColorizeArgs, dev, *extra) -> None:
    err = getattr(_lib(), name)(ctypes.byref(a), *extra, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def depth_keys_cuda(camera, views: KeyframePose, points_world, valid,
                    downsample_factor: int = 14) -> torch.Tensor:
    """C1's pass (a) on the card for a batch of V keyframes (1 <= V <=
    ``SCATTER_VIEWS``): one memset of a (V, gw * gh) int32 key buffer and
    one ``colorize_scatter`` launch (none for an empty map). Row j holds
    keyframe j's z-buffer as `csrc/zbuffer.cuh`'s order keys of the
    minimum range a cell (all ones where no point gates in);
    :func:`cell_minima` reads them as :func:`depth_keys_plain` gives them."""
    a, n = _map_args(camera, points_world, valid)
    dev = points_world.device
    v = views.R.shape[0] if views.R.dim() == 3 else -1
    if not 1 <= v <= SCATTER_VIEWS:
        raise ValueError(f"C1: pass (a) takes 1 to {SCATTER_VIEWS} keyframes a launch, got "
                         f"views of shape {tuple(views.R.shape)}")
    _check_cuda("R", views.R, dev, torch.float32, (v, 3, 3))
    _check_cuda("t", views.T.t, dev, torch.float32, (v, 3))
    gw, gh = zbuffer.grid(camera, downsample_factor)
    keys = torch.empty((v, gw * gh), dtype=torch.int32, device=dev)
    a.R, a.t, a.ds, a.keys = (views.R.data_ptr(), views.T.t.data_ptr(), int(downsample_factor),
                              keys.data_ptr())
    _launch("colorize_keys", a, dev, v)
    if n:
        launch_counts["colorize_scatter"] += 1
    return keys


def depth_keys_plain(camera, views: KeyframePose, points_world, valid,
                     downsample_factor: int = 14) -> torch.Tensor:
    """The twin of :func:`depth_keys_cuda` on any device, for any number of
    keyframes (at least one): (V, gw * gh) f32, row j each cell's minimum
    range over the points keyframe j gates in (f32 max where none), from
    the eager transform and projection of :func:`observe_keyframe` and
    ``zbuffer.depth_buffer_plain``, the buffer of the cull's twin."""
    p = points_world
    rows = []
    for j in range(views.R.shape[0]):
        x, y, z = se3.transform_xyz(views.at(j).T, p[:, 0], p[:, 1], p[:, 2])
        rng = torch.sqrt(x * x + y * y + z * z)
        u, v = cam.project_xyz(camera, x, y, z)
        buf = zbuffer.depth_buffer_plain(camera, u, v, z, rng, valid, downsample_factor)[2]
        rows.append(buf[:-1])
    return torch.stack(rows)


def depth_keys(camera, views: KeyframePose, points_world, valid,
               downsample_factor: int = 14) -> torch.Tensor:
    """Pass (a) of C1 for a batch of keyframes: the twin on CPU tensors
    (f32 cell minima), the kernel on CUDA ones (order keys); pass (b)
    (:func:`fuse_keyframe`'s ``keys``) reads either on its device."""
    dev = points_world.device.type
    if dev == "cpu":
        return depth_keys_plain(camera, views, points_world, valid, downsample_factor)
    if dev == "cuda":
        return depth_keys_cuda(camera, views, points_world, valid, downsample_factor)
    raise NotImplementedError(f"depth_keys: no kernel for device {points_world.device}")


def cell_minima(keys: torch.Tensor) -> torch.Tensor:
    """The f32 cell minima that pass (b) reads from pass (a)'s order keys
    (`csrc/zbuffer.cuh`: decode, then fmin with f32 max, which takes the
    all-ones key of an empty cell to f32 max): the contract of
    :func:`depth_keys_plain`."""
    b = keys ^ torch.iinfo(torch.int32).min
    f = (b ^ ((b >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return torch.fmin(f, torch.tensor(torch.finfo(torch.float32).max, device=keys.device))


def _colorize_cuda(camera, pose: KeyframePose, points_world, valid, image_rgb, mask_image,
                   culling: dict, keys: Optional[torch.Tensor] = None,
                   vis: Optional[torch.Tensor] = None, *,
                   state: Optional["FuseState"] = None, dumps=None,
                   optimal_distance: float = 2.0, score_floor: float = 0.2,
                   saturation_scale: float = 1.0, brightness_scale: float = 1.0,
                   reference_compat: bool = False, highlight: int = 255) -> None:
    """C1's pass (b) for one keyframe, one ``colorize_update`` launch: the
    fusion ``state`` updated in place, or the ``dumps`` (points_camera,
    rgb, label, visible) written. Under the z-buffer it reads ``keys``, the
    keyframe's row of :func:`depth_keys_cuda`, and without them runs pass
    (a) for this keyframe first (a memset and a launch); under HPR it reads
    ``vis``, the keyframe's row of :func:`hpr_masks`, and without it culls
    this keyframe first (:func:`hpr_masks` of a batch of one)."""
    a, n = _map_args(camera, points_world, valid)
    dev = points_world.device
    h, w = image_rgb.shape[0], image_rgb.shape[1]
    _check_cuda("image", image_rgb, dev, torch.uint8, (h, w, 3))
    if mask_image is not None:
        _check_cuda("mask image", mask_image, dev, torch.int32, (h, w))
    _check_cuda("R", pose.R, dev, torch.float32, (3, 3))
    _check_cuda("t", pose.T.t, dev, torch.float32, (3,))
    compat = reference_compat and state is not None
    if compat:
        _check_cuda("camera position", pose.position, dev, torch.float32, (3,))
    a.R, a.t, a.pos = pose.R.data_ptr(), pose.T.t.data_ptr(), _ptr(pose.position if compat
                                                                   else None)
    a.image, a.img_h, a.img_w, a.mask = image_rgb.data_ptr(), h, w, _ptr(mask_image)
    a.hsv = int(saturation_scale != 1.0 or brightness_scale != 1.0)
    a.sat, a.bri, a.opt_dist = saturation_scale, brightness_scale, optimal_distance
    a.floor_, a.one_minus_floor, a.highlight = score_floor, 1.0 - score_floor, highlight
    method = culling["culling_method"]
    if method == "zbuffer":
        ds = int(culling["downsample_factor"])
        if keys is None:
            keys = depth_keys_cuda(camera, pose.batch(), points_world, valid, ds)[0]
        gw, gh = zbuffer.grid(camera, ds)
        _check_cuda("keys", keys, dev, torch.int32, (gw * gh,))
        a.keys, a.ds, a.eps = keys.data_ptr(), ds, culling["depth_epsilon"]
    elif method == "hpr":
        # Pass (b) with the keyframe's HPR mask.
        if vis is None:
            vis = hpr_masks(camera, pose.batch(), points_world, valid, culling)[0]
        _check_cuda("HPR mask", vis, dev, torch.bool, (n,))
        a.vis_in = vis.data_ptr()
    else:
        raise ValueError(f"culling.method must be 'zbuffer' or 'hpr', got {method!r}")
    if state is not None:
        k = state.topk.scores.shape[0]
        _check_cuda("top-K scores", state.topk.scores, dev, torch.float32, (k, n))
        _check_cuda("top-K colors", state.topk.rgb, dev, torch.int32, (k, n))
        _check_cuda("count", state.count, dev, torch.int32, (n,))
        a.k, a.scores, a.rgb, a.count = k, state.topk.scores.data_ptr(), \
            state.topk.rgb.data_ptr(), state.count.data_ptr()
        if state.best_score is not None:
            if mask_image is None:
                raise ValueError("C1: a labelled fusion state needs the keyframe's mask image")
            _check_cuda("best score", state.best_score, dev, torch.float32, (n,))
            _check_cuda("best label", state.best_label, dev, torch.int32, (n,))
            a.best_s, a.best_l = state.best_score.data_ptr(), state.best_label.data_ptr()
    else:
        pts_cam, rgb, label, vis_out = dumps
        a.pts_cam, a.rgb_out, a.label_out, a.vis_out = (
            pts_cam.data_ptr(), rgb.data_ptr(), label.data_ptr(), vis_out.data_ptr())
    if n == 0:
        return
    _launch("colorize", a, dev)
    launch_counts["colorize_update"] += 1


def _culling(culling_method="zbuffer", downsample_factor=14, depth_epsilon=0.05,
             hpr_radius=90000.0, hpr_tolerance=0.05, hpr_impl="auto", hpr_dense_cutoff=100_000):
    return dict(culling_method=culling_method, downsample_factor=downsample_factor,
                depth_epsilon=depth_epsilon, hpr_radius=hpr_radius, hpr_tolerance=hpr_tolerance,
                hpr_impl=hpr_impl, hpr_dense_cutoff=hpr_dense_cutoff)


# ---------------------------------------------------------------------------
# The per-keyframe fusion step
# ---------------------------------------------------------------------------


class FuseState(NamedTuple):
    """What the fusion carries from one keyframe to the next (updated in
    place by :func:`fuse_keyframe`)."""

    topk: fusion.TopKColors  # (K, N) scores (-inf when empty) and packed colors
    count: torch.Tensor  # (N,) int32 visible observations
    best_score: Optional[torch.Tensor]  # (N,) f32, with masks: the best visible score
    best_label: Optional[torch.Tensor]  # (N,) int32, with masks: its label


def init_fuse_state(n: int, device, top_k: int = 5, labelled: bool = False) -> FuseState:
    return FuseState(
        topk=fusion.init_topk(n, device, top_k),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        best_score=(torch.full((n,), -torch.inf, dtype=torch.float32, device=device)
                    if labelled else None),
        best_label=torch.zeros((n,), dtype=torch.int32, device=device) if labelled else None,
    )


def fuse_keyframe_plain(
    state: FuseState,
    camera: cam.PinholeCamera,
    image_rgb: torch.Tensor,
    pose: KeyframePose,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    mask_image: Optional[torch.Tensor] = None,
    *,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    keys: Optional[torch.Tensor] = None,
    vis: Optional[torch.Tensor] = None,
    **culling,
) -> FuseState:
    """The twin of C1 on any device: :func:`observe_keyframe`, then
    ``fusion.update_topk``, the count and, with masks, the label of the
    strictly better visible score, written into ``state``. Under the
    z-buffer, ``keys`` (the keyframe's row of :func:`depth_keys_plain`)
    stands in for its own scatter-min, and under HPR ``vis`` (its row of
    :func:`hpr_masks`) for its own cull: the twin of pass (b) alone."""
    obs = observe_keyframe(
        camera, image_rgb, pose.T, points_world, valid, mask_image=mask_image,
        camera_position_world=pose.position, optimal_distance=optimal_distance,
        score_floor=score_floor, saturation_scale=saturation_scale,
        brightness_scale=brightness_scale,
        reference_compat_orientation=reference_compat_orientation, cell_min=keys, visible=vis,
        **_culling(**culling),
    )
    topk = fusion.update_topk(state.topk, obs.score, obs.rgb_packed, obs.visible)
    state.topk.scores.copy_(topk.scores)
    state.topk.rgb.copy_(topk.rgb)
    if state.best_score is not None:
        s = torch.where(obs.visible, obs.score, -torch.inf)
        better = s > state.best_score
        state.best_label.copy_(torch.where(better, obs.label, state.best_label))
        state.best_score.copy_(torch.where(better, s, state.best_score))
    state.count.copy_(state.count + obs.visible.to(torch.int32))
    return state


def fuse_keyframe(
    state: FuseState,
    camera: cam.PinholeCamera,
    image_rgb: torch.Tensor,  # (H, W, 3) uint8
    pose: KeyframePose,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    mask_image: Optional[torch.Tensor] = None,  # (H, W) int32, with a labelled state
    *,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    keys: Optional[torch.Tensor] = None,
    vis: Optional[torch.Tensor] = None,
    **culling,
) -> FuseState:
    """Fuse one keyframe into ``state`` in place and return it
    (`PointCloudProcessor.cpp:495-591`): cull, sample, score, keep the top
    K. ``culling`` holds ``culling_method``, ``downsample_factor``,
    ``depth_epsilon`` and the ``hpr_*`` options of :func:`observe_keyframe`.
    Under the z-buffer, ``keys`` is this keyframe's row of
    :func:`depth_keys`, and under HPR ``vis`` its row of :func:`hpr_masks`
    (as :func:`fuse` makes them for all its keyframes); without them the
    keyframe makes its own. CPU tensors take :func:`fuse_keyframe_plain`,
    CUDA tensors C1 (with keys or vis one launch of pass (b); without, a
    memset and both passes, or H2 and pass (b)); any other device raises."""
    dev = points_world.device.type
    scoring = dict(optimal_distance=optimal_distance, score_floor=score_floor,
                   saturation_scale=saturation_scale, brightness_scale=brightness_scale)
    if dev == "cpu":
        return fuse_keyframe_plain(state, camera, image_rgb, pose, points_world, valid, mask_image,
                                   reference_compat_orientation=reference_compat_orientation,
                                   keys=keys, vis=vis, **scoring, **culling)
    if dev == "cuda":
        _colorize_cuda(camera, pose, points_world, valid, image_rgb, mask_image,
                       _culling(**culling), keys, vis, state=state,
                       reference_compat=reference_compat_orientation, **scoring)
        return state
    raise NotImplementedError(f"fuse_keyframe: no kernel for device {points_world.device}")


@torch.no_grad()
def keyframe_rgb_mask_plain(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    image_rgb: torch.Tensor,
    mask_image: torch.Tensor,
    pose: KeyframePose,
    *,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    mask_highlight_value: int = 255,
    **culling,
):
    """The twin of :func:`keyframe_rgb_mask`'s C1 on any device:
    :func:`observe_keyframe`, the sampled colors unpacked and the highlight
    label painted red."""
    obs = observe_keyframe(
        camera, image_rgb, pose.T, points_world, valid, mask_image=mask_image,
        camera_position_world=pose.position, saturation_scale=saturation_scale,
        brightness_scale=brightness_scale, **_culling(**culling),
    )
    rgb = fusion.unpack_rgb(obs.rgb_packed)
    highlight = obs.label == mask_highlight_value
    red = torch.tensor([255.0, 0.0, 0.0], dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(highlight[:, None], red, rgb)
    return obs.points_camera, rgb, obs.label, obs.visible


@torch.no_grad()
def keyframe_rgb_mask(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    image_rgb: torch.Tensor,  # (H, W, 3) uint8
    mask_image: torch.Tensor,  # (H, W) int32
    kf_pose: se3.SE3,  # camera->world
    T_correction: se3.SE3,
    *,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    mask_highlight_value: int = 255,
    **culling,
):
    """One keyframe's colored + mask-labelled view for the artifact dumps.

    Rebuilds `generateColorMap` + `generateSegmentMap`
    (`PointCloudProcessor.cpp:705-816`) for the per-keyframe
    ``<ts>_rgb-mask.pcd`` files written at :539-546: camera-frame points,
    sampled rgb (label == ``mask_highlight_value`` painted red, :806-811),
    mask label. Returns ``(points_camera (N,3), rgb (N,3), label (N,),
    visible (N,))`` at full map capacity; the caller compacts with
    ``visible``. ``culling`` as for :func:`fuse_keyframe`. CPU tensors take
    :func:`keyframe_rgb_mask_plain`, CUDA tensors C1 with its dump outputs
    (a memset and both passes, or H2 and pass (b) under HPR)."""
    pose = keyframe_pose(kf_pose, T_correction)
    colors = dict(saturation_scale=saturation_scale, brightness_scale=brightness_scale)
    dev = points_world.device
    if dev.type == "cpu":
        return keyframe_rgb_mask_plain(camera, points_world, valid, image_rgb, mask_image, pose,
                                       mask_highlight_value=mask_highlight_value, **colors,
                                       **culling)
    if dev.type == "cuda":
        n = points_world.shape[0]
        dumps = (torch.empty((n, 3), dtype=torch.float32, device=dev),
                 torch.empty((n, 3), dtype=torch.float32, device=dev),
                 torch.empty((n,), dtype=torch.int32, device=dev),
                 torch.empty((n,), dtype=torch.bool, device=dev))
        _colorize_cuda(camera, pose, points_world, valid, image_rgb, mask_image,
                       _culling(**culling), dumps=dumps, highlight=mask_highlight_value, **colors)
        return dumps
    raise NotImplementedError(f"keyframe_rgb_mask: no kernel for device {dev}")


class FusionResult(NamedTuple):
    rgb: torch.Tensor  # (N, 3) blended color [0,255]
    colored: torch.Tensor  # (N,) bool
    best_label: Optional[torch.Tensor]  # (N,) int32 label of the best observation
    observation_count: torch.Tensor  # (N,) int32


@torch.no_grad()
def fuse_state(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    images: torch.Tensor,  # (K, H, W, 3) uint8
    kf_poses: se3.SE3,  # batched (K,) camera->world
    T_correction: se3.SE3,  # NID correction: scalar, or (K,) one a keyframe
    mask_images: Optional[torch.Tensor] = None,  # (K, H, W) int32
    *,
    top_k: int = 5,
    plain: bool = False,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    **culling,
) -> FuseState:
    """The :class:`FuseState` that :func:`fuse` blends: every keyframe's
    observations fused into the top-K registers, the count and, with masks,
    the best score and its label. Arguments as for :func:`fuse`;
    `parallel/fusion_shard` merges the states of keyframe shards."""
    device = points_world.device
    labelled = mask_images is not None
    state = init_fuse_state(points_world.shape[0], device, top_k, labelled)
    views = keyframe_pose(kf_poses, T_correction)
    step = fuse_keyframe_plain if plain else fuse_keyframe
    cull = _culling(**culling)
    scatter = not plain and cull["culling_method"] == "zbuffer"
    batch_hpr = not plain and cull["culling_method"] == "hpr"
    k = images.shape[0]
    for start in range(0, k, SCATTER_VIEWS):
        stop = min(start + SCATTER_VIEWS, k)
        batch = views.at(slice(start, stop))
        keys = (depth_keys(camera, batch, points_world, valid, cull["downsample_factor"])
                if scatter else None)
        vis = hpr_masks(camera, batch, points_world, valid, cull) if batch_hpr else None
        for j in range(start, stop):
            step(state, camera, images[j].to(device), views.at(j), points_world, valid,
                 mask_images[j].to(device) if labelled else None,
                 optimal_distance=optimal_distance, score_floor=score_floor,
                 saturation_scale=saturation_scale, brightness_scale=brightness_scale,
                 reference_compat_orientation=reference_compat_orientation,
                 keys=None if keys is None else keys[j - start],
                 vis=None if vis is None else vis[j - start], **culling)
    return state


@torch.no_grad()
def fuse(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    images: torch.Tensor,  # (K, H, W, 3) uint8
    kf_poses: se3.SE3,  # batched (K,) camera->world
    T_correction: se3.SE3,  # NID correction: scalar, or (K,) one a keyframe
    mask_images: Optional[torch.Tensor] = None,  # (K, H, W) int32
    **kwargs,
) -> FusionResult:
    """Colorize the map from all keyframes and blend the top-K observations.

    The correction composes as ``T_c2w_optimized = T_c2w * T_correction``
    (`PointCloudProcessor.cpp:507,516`), a scalar correction with every
    keyframe's pose and a (K,) one row by row (:func:`keyframe_pose`
    composes a batch elementwise). ``images`` (and ``mask_images``)
    may live on the host: each keyframe's image is moved to the map's device
    as it is used. With masks, each point keeps the label of its visible
    observation of strictly highest score (`best_label`). Under the z-buffer
    the keyframes' depth keys come first, for up to ``SCATTER_VIEWS`` of
    them at once (:func:`depth_keys`: on the card one memset and one
    ``colorize_scatter`` launch), and under HPR their masks
    (:func:`hpr_masks`: on the card one H2 call); then each keyframe is one
    :func:`fuse_keyframe` against its row. With ``plain`` each keyframe is
    its twin :func:`fuse_keyframe_plain` with its own cull, on any device
    (the eager path C1 replaces); ``culling`` as for
    :func:`fuse_keyframe`. Keywords: those of :func:`fuse_state` (``top_k``,
    ``plain``, ``optimal_distance``, ``score_floor``, ``saturation_scale``,
    ``brightness_scale``, ``reference_compat_orientation`` and the culling
    options)."""
    state = fuse_state(camera, points_world, valid, images, kf_poses, T_correction, mask_images,
                       **kwargs)
    rgb, colored = fusion.blend_topk(state.topk)
    return FusionResult(
        rgb=rgb,
        colored=colored & valid,
        best_label=state.best_label,
        observation_count=state.count,
    )
