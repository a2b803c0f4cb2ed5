"""Normalized Information Distance (NID) photometric objective — the exact
(gather-every-evaluation) objective.

Port of `pointcloudprocessor_tpu/opt/nid.py`, a differentiable rebuild of
the reference's NID cost (`include/vlcal/costs/nid_cost.hpp:24-126`) summed
over keyframes (`visual_camera_calibration.cpp:86-129`). Per evaluation:
project every keyframe's points, gather each point's 4x4 window of image
bins as ONE nibble-packed row (the JAX package takes it from a per-pixel
tap table; the direct take here assembles it from the bin image packed at
4 bits a pixel, `ops/tap_gather` G1), build the joint
histogram from cubic B-spline weights (`ops/nid_hist`: CUDA kernels K1/K2
on the card, the plain twin on the CPU), then entropies -> NID.

Gradients flow only through the fractional offsets ``s``: knots, image
bins, the point histogram and the inlier gate are detached, the
differentiability structure of the reference (knots via `get_real`,
hpp:61; `hist_points` a plain vector, hpp:49).

The JAX package's `vmap` over keyframes is a written-out leading K
dimension. Beside the exact objective this module holds the frozen-tap
cache (:class:`TapCache`, :func:`multi_nid_loss_cached`) with its wide
window (the cache holds each point's (4+2m)^2 window, taken by kernel G2,
and every evaluation selects the 4x4 sub-window with kernel W1) and its
partial refresh (the block forms of G1 and G2 re-take only the drifted
128-point blocks, in place), the raster sort that makes gathers
near-monotone, and the grouped gathers over the row table
(`ops/tap_gather`: kernels K3/K4). Its ``lax.cond`` branches are Python
branches on host values: each costs one device sync.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..models import camera as cam
from ..ops import nid_hist, tap_gather
from ..ops.nid_hist import spline_weights, unpack_tap_nibbles  # noqa: F401 (API)
from ..utils.numeric import bits_to_int32, to_int32


def quantize_image(image_gray01: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """Per-pixel intensity bin map (int32), computed once per keyframe."""
    b = torch.clamp(to_int32(image_gray01 * bins), max=bins - 1)
    return torch.clamp(b, min=0)


@dataclass
class NIDKeyframe:
    """Per-keyframe data for the NID objective, batched over a leading
    keyframe axis K on every field.

    points/intensity/valid are fixed-capacity (padded); intensities are
    normalized to [0, 1] (`visual_lidar_data.cpp:87-96`). ``bin_tiles`` is
    the bin image packed at 4 bits a pixel in 8x8-pixel tiles placed every 5
    pixels (``tap_gather.pack_bins``: (K, (H-2)//5+1, (W-2)//5+1, 8) int32,
    120 MiB for 8 keyframes of 4096x3000), which the direct take reads:
    each gather reads 8 B of knot and writes 8 B of row a point, and reads
    the one 32-byte tile that holds each point's window (its bound counts
    16 B a point and each distinct window pixel at 4 bits). ``tap_rows`` is the
    (K, H*W, 2) int32 table of :func:`build_tap_table` (750 MiB at that
    size), which only the grouped gathers read, and ``slab_width`` their
    slab S (H*W a multiple of S); ``tap_slabs`` is the JAX package's
    plane-concat slab layout (:func:`build_tap_slabs`), built only on
    request. All are attached once per solve by :func:`prepare_keyframes`.
    ``wide_margin`` m (0, 1 or 2) makes the frozen-tap cache hold each
    point's (4+2m)^2 window (JAX's ``tap_wide`` table, `nid.py:84-91`); no
    table is built: kernel G2 takes the windows from ``bin_tiles``.
    """

    points: torch.Tensor  # (K, N, 3) in the keyframe CAMERA frame (pre-correction)
    intensity: torch.Tensor  # (K, N)
    valid: torch.Tensor  # (K, N) bool
    bin_image: torch.Tensor  # (K, H, W) int32
    bin_tiles: Optional[torch.Tensor] = None  # (K, TH, TW, 8) int32 nibbles (pack_bins)
    tap_rows: Optional[torch.Tensor] = None  # (K, H*W, 2) int32 packed nibbles (grouped)
    tap_slabs: Optional[torch.Tensor] = None  # (K, H*W/S, 2S) int32
    slab_width: Optional[int] = None  # S; None: no grouped gather
    wide_margin: int = 0  # m of the frozen cache's wide window; 0: 4x4 rows


def check_bins(bins: int) -> None:
    """A tap holds a bin in 4 bits: ``bins`` must be in [1, 16]. The JAX
    package's table ORs a bin of 16 or more into the next nibble
    (`nid.py:98-100`, "Requires bins <= 16"), so the port refuses it."""
    if not 1 <= bins <= 16:
        raise ValueError(f"bins must be in [1, 16] (4-bit taps), got {bins}")


def pack_tap_nibbles(taps: torch.Tensor) -> torch.Tensor:
    """(N, 16) tap values in [0, 16) -> (N, 2) int32, nibble t of word t//8
    at bit 4*(t%8). Requires bins <= 16."""
    t = taps.to(torch.int64)
    words = []
    for c in range(2):
        w = torch.zeros(taps.shape[0], dtype=torch.int64, device=taps.device)
        for j in range(8):
            w = w | (t[:, c * 8 + j] << (4 * j))
        words.append(bits_to_int32(w))
    return torch.stack(words, dim=-1)


def _tap_word_planes(bin_image: torch.Tensor):
    """(H, W) bin image -> two (H, W) int32 nibble-packed word planes (words
    0/1 of each pixel's 4x4 B-spline window; taps dy=-1..2 outer, dx=-1..2
    inner, edges clamped). 16 shifted ORs, no (H*W, 16) intermediate."""
    h, w = bin_image.shape
    dev = bin_image.device
    rows = torch.clamp(torch.arange(-1, h + 2, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 2, device=dev), 0, w - 1)
    p = bin_image.to(torch.int64)[rows][:, cols]  # edge-padded (H+3, W+3)
    words = [torch.zeros((h, w), dtype=torch.int64, device=dev) for _ in range(2)]
    for t in range(16):
        dy, dx = t // 4 - 1, t % 4 - 1
        tap = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        words[t // 8] = words[t // 8] | (tap << (4 * (t % 8)))
    return bits_to_int32(words[0]), bits_to_int32(words[1])


def build_tap_table(bin_image: torch.Tensor) -> torch.Tensor:
    """(H, W) bin image -> (H*W, 2) int32 nibble-packed tap-row table."""
    w0, w1 = _tap_word_planes(bin_image)
    return torch.stack([w0.reshape(-1), w1.reshape(-1)], dim=-1)


def build_tap_slabs(bin_image: torch.Tensor, slab: int) -> torch.Tensor:
    """(H, W) bin image -> (H*W/slab, 2*slab) int32 plane-concat slab table
    for the grouped gathers (`nid.py:170-184`): row j = [word0 of pixels
    jS..jS+S-1 | word1 of the same pixels], built from the word planes."""
    h, w = bin_image.shape
    r = h * w
    if r % slab:
        raise ValueError(f"H*W = {r} is not a multiple of the slab {slab}")
    w0, w1 = _tap_word_planes(bin_image)
    return torch.cat([w0.reshape(r // slab, slab), w1.reshape(r // slab, slab)], dim=1)


def prepare_keyframes(kfs: NIDKeyframe, build_slabs: bool = False,
                      grouped: bool = False, wide_margin: int = 0) -> NIDKeyframe:
    """Attach the pose-independent gather sources (`nid.py:187-237`): the
    packed bin tiles of the direct take (``tap_gather.pack_bins``, one
    ``bin_pack`` launch for all keyframes on the card) and the slab width of
    the grouped gathers where the shapes allow one. A grouped-gather request
    (``grouped`` or ``build_slabs``) also builds the (K, H*W, 2) tap-row
    table that K3/K4 read, and ``build_slabs`` the JAX package's
    plane-concat slab table, which the port's gathers do not read. A grouped-gather request
    that no slab width can serve warns. ``wide_margin`` m in 1..2 sets the
    keyframes' wide window for the frozen-tap cache (`nid.py:187-209`; a
    margin already set stays, as JAX keeps an attached ``tap_wide``), 0
    none; any other m raises ValueError (JAX asserts 1 <= m <= 2,
    `nid.py:154`). Idempotent; called by the optimizer at solve entry."""
    if wide_margin:
        tap_gather.check_margin(wide_margin)
        if not kfs.wide_margin:
            kfs = replace(kfs, wide_margin=wide_margin)
    if kfs.bin_tiles is None:
        kfs = replace(kfs, bin_tiles=tap_gather.pack_bins(kfs.bin_image))
    _, h, w = kfs.bin_image.shape
    r = h * w
    slab = tap_gather.default_slab(r, kfs.points.shape[1], 16)
    if kfs.slab_width is None and r % slab == 0 and r // slab >= 2:
        kfs = replace(kfs, slab_width=slab)
    if (build_slabs or grouped) and kfs.slab_width is None:
        # An explicit grouped-gather request that cannot be honored must
        # not degrade silently to the direct take.
        warnings.warn(
            f"prepare_keyframes: cannot build tap slabs (H*W={r}, "
            f"slab={slab}); the grouped gather will fall back to the "
            "direct per-point take",
            stacklevel=2,
        )
        return kfs
    if (build_slabs or grouped) and kfs.tap_rows is None:
        kfs = replace(kfs, tap_rows=torch.stack([build_tap_table(b) for b in kfs.bin_image]))
    if build_slabs and kfs.tap_slabs is None:
        kfs = replace(kfs, tap_slabs=torch.stack(
            [build_tap_slabs(b, kfs.slab_width) for b in kfs.bin_image]))
    return kfs


def _project_all(camera: cam.PinholeCamera, T: se3.SE3, kfs: NIDKeyframe):
    """Batched projection over keyframes: (proj (K,N,2), knot (K,N,2) int32,
    inlier (K,N) bool). Knots and gates are pose-constant (detached)."""
    pts_cam = se3.transform_points(T, kfs.points)
    proj = cam.project(camera, pts_cam)
    knot = to_int32(torch.floor(proj.detach()))
    inl = (
        kfs.valid
        & (knot[..., 0] >= 0)
        & (knot[..., 0] < camera.width)
        & (knot[..., 1] >= 0)
        & (knot[..., 1] < camera.height)
        & (pts_cam[..., 2].detach() > 0)
    )
    return proj, knot, inl


def sort_by_raster(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                   kfs: NIDKeyframe) -> NIDKeyframe:
    """Permute each keyframe's points into projected raster order at
    ``T_camera_lidar`` (`nid.py:240-290`), so the tap gathers of a solve
    near that pose read near-monotone table rows. The key is the anchor
    pixel's raster index, 2^31-1 for out-of-view or invalid points, and the
    sort is stable, so the permutation equals the JAX package's stable
    ``lax.sort``, ties included. The NID is a sum over points, so the
    permutation changes only the f32 summation order."""
    with torch.no_grad():
        _, knot, inb = _project_all(camera, T_camera_lidar, kfs)
        anchor = knot[..., 1] * camera.width + knot[..., 0]
        key = torch.where(inb, anchor, 2**31 - 1)
        order = torch.sort(key, dim=-1, stable=True).indices
    return replace(
        kfs,
        points=torch.gather(kfs.points, 1, order[..., None].expand(-1, -1, 3)),
        intensity=torch.gather(kfs.intensity, 1, order),
        valid=torch.gather(kfs.valid, 1, order),
    )


def _gather_taps(camera: cam.PinholeCamera, kfs: NIDKeyframe, knot: torch.Tensor,
                 inlier: torch.Tensor, use_grouped=None):
    """(K, N, 2) knots -> (K, N, 2) packed tap rows (`nid.py:490-560`).

    The direct per-point row take by default, ``use_grouped`` None or False
    (:func:`tap_gather.direct_take` over the packed bin tiles, G1 on the
    card; `nid.py:456-487`): the grouped gathers win only while points stay
    raster-sorted at the evaluation pose, and after a solve's few-centimetre
    motion most groups overflow into the fallback. ``use_grouped`` True takes
    the slabbed grouped gather (K3), "streamed" the streamed one (K4),
    wherever the keyframes carry a slab width: all keyframes flatten into
    one call over the stacked row tables (flat index kf*H*W + anchor), which
    :func:`prepare_keyframes` builds on a grouped request. Rows whose
    ``inlier`` is False hold unspecified data under the grouped gathers; the
    histogram gate zeroes them."""
    if not use_grouped or kfs.slab_width is None:
        return tap_gather.direct_take(kfs.bin_tiles, knot, camera.width, camera.height)
    if kfs.tap_rows is None:
        raise ValueError("a grouped gather reads the tap-row table: call "
                         "prepare_keyframes(kfs, grouped=True) first")
    anchor = tap_gather.anchors(knot, camera.width, camera.height)
    k, r, c = kfs.tap_rows.shape
    n = anchor.shape[1]
    # int32 flat indices would wrap at K*H*W >= 2^31 (~175 keyframes of
    # 4096x3000) and gather wrong rows.
    if k * r >= 2**31:
        raise ValueError(
            f"grouped gather flat index overflow: K*H*W = {k}*{r} >= 2^31; "
            "split the keyframe batch or use use_grouped_gather=False"
        )
    flat_idx = anchor + torch.arange(k, dtype=torch.int32, device=anchor.device)[:, None] * r
    impl = (
        tap_gather.grouped_take_streamed
        if use_grouped == "streamed"
        else tap_gather.grouped_take_slabbed
    )
    taps = impl(kfs.tap_rows.reshape(k * r, c), flat_idx.reshape(-1), inlier.reshape(-1),
                slab=kfs.slab_width)
    return taps.reshape(k, n, c)


def _histograms_from_taps(taps, s, bin_pts, inlier_f, bins: int):
    """(hist_joint (K,bins,bins) [point_bin, image_bin], hist_image (K,bins),
    hist_points (K,bins), num (K,)) from already-gathered tap rows — the
    kernel branch of `nid.py:321-333`: the image marginal is the per-point-
    bin sum of the joint, so its pose gradient stays exact."""
    inlier_f = inlier_f.detach()
    hist_joint = nid_hist.joint_histogram(taps, s, bin_pts, inlier_f, bins)
    levels = torch.arange(bins, device=s.device)
    hist_points = torch.sum(
        (bin_pts[..., None] == levels).to(s.dtype) * inlier_f[..., None], dim=-2
    )
    hist_image = torch.sum(hist_joint, dim=-2)
    num = torch.sum(inlier_f, dim=-1)
    return hist_joint, hist_image, hist_points, num


def nid_from_histograms(hist_joint, hist_image, hist_points, num):
    """Entropies -> NID per keyframe (`nid_cost.hpp:95-105`, log(p + 1e-6)).

    Probabilities are clamped to >= 0 with where(p < 0) (`nid.py:882-906`):
    an identity in value and gradient for exact-path histograms, and the
    guard against NaN once the frozen-tap cache extrapolates spline weights.
    Batched over a leading K axis."""
    denom = torch.clamp(num, min=1.0)

    def clamp(p):
        return torch.where(p < 0, torch.zeros_like(p), p)

    pj = clamp(hist_joint / denom[..., None, None])
    pi = clamp(hist_image / denom[..., None])
    pp = clamp(hist_points / denom[..., None])
    H_image = -torch.sum(pi * torch.log(pi + 1e-6), dim=-1)
    H_points = -torch.sum(pp * torch.log(pp + 1e-6), dim=-1)
    H_joint = -torch.sum(pj * torch.log(pj + 1e-6), dim=(-2, -1))
    MI = H_image + H_points - H_joint
    return (H_joint - MI) / torch.clamp(H_joint, min=1e-12)


def multi_nid_loss(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                   kfs: NIDKeyframe, bins: int = 16, use_grouped=None) -> torch.Tensor:
    """Sum of per-keyframe NIDs — `MultiNIDCost::operator()`
    (`visual_camera_calibration.cpp:94-123`), `nid.py:922-960`.
    ``use_grouped`` selects the tap gather (see :func:`_gather_taps`)."""
    check_bins(bins)
    kfs = prepare_keyframes(kfs, grouped=bool(use_grouped))
    proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
    s = proj - knot.to(proj.dtype)
    with torch.no_grad():
        taps = _gather_taps(camera, kfs, knot, inl, use_grouped)
    return _sum_nid(taps, s, kfs.intensity, inl.to(proj.dtype), bins)


def multi_nid_per_keyframe(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                           kfs: NIDKeyframe, bins: int = 16) -> torch.Tensor:
    """The (K,) per-keyframe NIDs at a batched correction ``T_camera_lidar``
    of shape (K,), keyframe j's at its own row: the objective of the
    per-keyframe solves (JAX `refine_pose_per_keyframe`, `refine.py:421-478`,
    evaluates :func:`multi_nid_loss` on each keyframe under a ``vmap``).
    ``se3.transform_points`` applies row j to keyframe j's points, so the
    knots, gate and ``s`` are each keyframe's own, and one evaluation is one
    direct take (G1) and one histogram launch (K1; K2 on the backward) for
    all K keyframes. Keyframe j's NID depends on row j alone, so the
    gradient of ``nids.sum()`` with respect to the (K, 6) tangents of the
    rows is each keyframe's own gradient in its row. The direct take only:
    the JAX package's per-keyframe solves never group (`refine.py:468-473`)."""
    check_bins(bins)
    kfs = prepare_keyframes(kfs)
    proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
    s = proj - knot.to(proj.dtype)
    with torch.no_grad():
        taps = _gather_taps(camera, kfs, knot, inl)
    return _keyframe_nids(taps, s, kfs.intensity, inl.to(proj.dtype), bins)


def _keyframe_nids(taps, s, intensity, inlier_f, bins: int) -> torch.Tensor:
    bin_pts = torch.clamp(to_int32(intensity * bins), 0, bins - 1)
    return nid_from_histograms(*_histograms_from_taps(taps, s, bin_pts, inlier_f, bins))


def _sum_nid(taps, s, intensity, inlier_f, bins: int) -> torch.Tensor:
    return torch.sum(_keyframe_nids(taps, s, intensity, inlier_f, bins))


class TapCache(NamedTuple):
    """Frozen gather state of the cached NID objective (`nid.py:406-432`):
    the last gathered taps with the knots and inlier gate they were
    gathered at. :func:`multi_nid_loss_cached` reuses them until anchors
    measurably drift, then re-gathers. No reference analogue (the reference
    re-reads image values per point per evaluation, `nid_cost.hpp:78-92`).
    A partial refresh rewrites ``taps`` in place: the cache threads through
    a solve, and the one it replaces is not read again.
    """

    taps: torch.Tensor  # (K, N, 2) int32 packed rows, or (K, 4+2m, N) wide planes
    knot: torch.Tensor  # (K, N, 2) int32 anchor knots at gather time
    inlier: torch.Tensor  # (K, N) f32 0/1 gate at gather time
    refreshes: int  # gathers made, the first included
    partials: int  # refreshes served by a partial re-gather
    drift_accum: torch.Tensor  # () f32 sum of the drifted fraction at refreshes


def _wide_margin_of(kfs: NIDKeyframe) -> int:
    """The margin of the keyframes' wide window (0: 4x4 rows; `nid.py:
    616-620`)."""
    return kfs.wide_margin


def _take(camera: cam.PinholeCamera, kfs: NIDKeyframe, knot: torch.Tensor,
          inlier: torch.Tensor, use_grouped) -> torch.Tensor:
    """A full gather of the cache: the (K, 4+2m, N) wide planes (G2, JAX's
    `_gather_wide`, `nid.py:630-638`) under a margin, else the tap rows."""
    margin = _wide_margin_of(kfs)
    if margin:
        return tap_gather.wide_take(kfs.bin_tiles, knot, camera.width, camera.height, margin)
    return _gather_taps(camera, kfs, knot, inlier, use_grouped)


def make_tap_cache(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                   kfs: NIDKeyframe, use_grouped=None) -> TapCache:
    """A fresh gather at ``T_camera_lidar`` (`nid.py:699-721`; kfs must
    carry the packed bin tiles, and for a grouped gather the tap-row table:
    see :func:`prepare_keyframes`). Under a wide margin the cache holds the
    (K, 4+2m, N) wide planes instead of (K, N, 2) rows."""
    with torch.no_grad():
        proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
        taps = _take(camera, kfs, knot, inl, use_grouped)
    return TapCache(
        taps, knot, inl.to(proj.dtype), 1, 0,
        torch.zeros((), dtype=torch.float32, device=proj.device),
    )


def _refresh(camera: cam.PinholeCamera, kfs: NIDKeyframe, c: TapCache, knot_true, inl_true,
             inl_true_f, drifted, frac1, use_grouped, partial_frac: float,
             all_partial=int) -> TapCache:
    """The cache re-gathered at ``knot_true`` (the ``fresh`` branch of
    `nid.py:796-846`). With ``partial_frac`` > 0 and N a whole number of
    128-point blocks, cap = round(nb * partial_frac) blocks a keyframe: when
    no keyframe has more than cap blocks holding a drifted point (one host
    read), only those blocks are re-taken, in place, by G1's or G2's block
    form over the (K, cap) block list, ascending and padded with nb (JAX's
    ``sort(where(dirty, iota, nb))[:cap]``). After such a refresh at margin
    0 every point is re-centred (`:832-833`, as JAX does it: a point outside
    both gates on a clean block keeps its old row under its new knot); under
    a margin only the points of the re-taken blocks are (`:821-822`).
    ``all_partial(flag) -> int`` makes the count of partial refreshes (a
    sharded cache counts one only where every rank's was partial)."""
    k, n = kfs.points.shape[:2]
    margin = _wide_margin_of(kfs)
    block = tap_gather.PARTIAL_BLOCK
    nb = n // block if n % block == 0 else 0
    cap = int(round(nb * partial_frac)) if partial_frac > 0 else 0
    partial = False
    if 0 < cap <= nb:
        dirty = torch.any(drifted.reshape(k, nb, block), dim=2)
        partial = int(torch.amax(torch.sum(dirty, dim=1))) <= cap  # one device sync
    if not partial:
        taps, knot, inl = _take(camera, kfs, knot_true, inl_true, use_grouped), knot_true, inl_true_f
    else:
        iota = torch.arange(nb, dtype=torch.int32, device=dirty.device)
        blocks = torch.sort(torch.where(dirty, iota, nb), dim=1).values[:, :cap].contiguous()
        w, h = camera.width, camera.height
        if margin:
            taps = tap_gather.wide_take_blocks(kfs.bin_tiles, knot_true, blocks, c.taps, w, h,
                                               margin)
            in_dirty = dirty[:, :, None].expand(k, nb, block).reshape(k, n)
            knot = torch.where(in_dirty[..., None], knot_true, c.knot)
            inl = torch.where(in_dirty, inl_true_f, c.inlier)
        else:
            taps = tap_gather.tap_take_blocks(kfs.bin_tiles, knot_true, blocks, c.taps, w, h)
            knot, inl = knot_true, inl_true_f
    return TapCache(taps, knot, inl, c.refreshes + 1, c.partials + all_partial(int(partial)),
                    c.drift_accum + frac1)


def multi_nid_loss_cached(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                          kfs: NIDKeyframe, cache: TapCache, bins: int = 16,
                          guard_frac: float = 0.25, allow_refresh: bool = True,
                          use_grouped=None, partial_frac: float = 0.0):
    """Sum of per-keyframe NIDs with a guarded frozen-tap gather
    (`nid.py:724-879`). Returns ``(loss, cache')``.

    Equal to :func:`multi_nid_loss` whenever the gather is fresh; between
    refreshes, points whose anchor drifted past the cached window evaluate
    its cubic extended past its span. With the keyframes' wide margin m
    (0: 4x4 rows) the guard re-gathers when more than ``guard_frac`` of the
    live points drifted >= m + 1 px or more than 0.1% drifted >= m + 2 px,
    and ``s`` is clipped to [-1.5, 2.5] so a not-yet-refreshed far point
    cannot poison the histogram. Under a margin every evaluation selects
    each point's 4x4 sub-window at its offset from the cached knot, clipped
    to +-m (W1: the exact tap row for every point within the margin).
    ``partial_frac`` > 0 lets a refresh re-take only the drifted blocks
    (:func:`_refresh`). ``allow_refresh`` False suppresses the refresh (the
    caller will discard the value). The refresh decision is a host branch:
    one device sync, and one more to choose a partial refresh."""
    return cached_objective(camera, T_camera_lidar, kfs, cache, bins, guard_frac, allow_refresh,
                            use_grouped, partial_frac, LOCAL)


class Reductions(NamedTuple):
    """How :func:`cached_objective` combines what it counts and sums over
    the shards of a keyframe batch: ``counts`` the (3,) int64 guard counts
    (care, drifted past the margin, past it by one more pixel),
    ``all_partial`` a refresh's partial flag, ``sum_nid`` the histograms
    into the summed NID (:func:`_sum_nid`'s signature). :data:`LOCAL` is one
    process holding the whole batch; `parallel/nid_shard` reduces each over
    the mesh."""

    counts: object
    all_partial: object
    sum_nid: object


LOCAL = Reductions(counts=lambda c: c, all_partial=int, sum_nid=_sum_nid)


def cached_objective(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3, kfs: NIDKeyframe,
                     cache: TapCache, bins: int, guard_frac: float, allow_refresh: bool,
                     use_grouped, partial_frac: float, reduce: Reductions):
    """:func:`multi_nid_loss_cached` with its reductions given: the guard
    reads the counts ``reduce.counts`` returns, so that every shard of a
    sharded batch takes the same refresh branch."""
    check_bins(bins)
    if kfs.bin_tiles is None:
        raise ValueError("call prepare_keyframes first")
    proj, knot_true, inl_true = _project_all(camera, T_camera_lidar, kfs)
    margin = _wide_margin_of(kfs)

    with torch.no_grad():
        # f32 on purpose: behind-camera knots reach ~1e9, and int32
        # differences would overflow (those points are masked by `care`,
        # but the arithmetic still runs).
        shift = torch.amax(torch.abs(knot_true.float() - cache.knot.float()), dim=-1)
        care = inl_true | (cache.inlier > 0)
        # A margin-m window serves exact sub-windows up to m px of drift.
        thr = float(margin + 1)
        drifted = (shift >= thr) & care
        counts = reduce.counts(torch.stack(
            [torch.sum(care), torch.sum(drifted), torch.sum((shift >= thr + 1.0) & care)]))
        n_care = torch.clamp(counts[0], min=1).to(torch.float32)
        frac1 = counts[1] / n_care
        frac2 = counts[2] / n_care
        if allow_refresh and bool((frac1 > guard_frac) | (frac2 > 0.001)):
            cache = _refresh(camera, kfs, cache, knot_true, inl_true, inl_true.to(proj.dtype),
                             drifted, frac1, use_grouped, partial_frac, reduce.all_partial)
        if margin:
            taps, eff_knot = tap_gather.wide_select(cache.taps, knot_true, cache.knot, margin)
        else:
            taps, eff_knot = cache.taps, cache.knot

    # The clip bound lies outside everything the guard lets through, so
    # live gradients are unaffected.
    s = torch.clamp(proj - eff_knot.to(proj.dtype), -1.5, 2.5)
    return reduce.sum_nid(taps, s, kfs.intensity, cache.inlier, bins), cache
