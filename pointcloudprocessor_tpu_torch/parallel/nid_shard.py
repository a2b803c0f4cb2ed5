"""NID refinement over the (kf, pt) mesh: keyframes and points sharded.

Port of `pointcloudprocessor_tpu/parallel/nid_shard.py`, the multi-device
form of the reference's OpenMP cost evaluation
(`visual_camera_calibration.cpp:110-114`). Each rank projects its
(K/kf keyframes x N/pt points) shard, takes its taps (G1, or G2 and W1 under
a wide cache) and builds its keyframes' histograms (K1); the histograms sum
over the ``pt`` axis, each keyframe's NID comes from the summed histograms,
and the keyframes' sum sums over the ``kf`` axis. The solve itself
(``opt/refine.refine_pose``: BFGS, line search, outer loop) runs replicated
on every rank: all-reduces give every rank the same bits, so every host
branch reads the same value everywhere and every rank issues the same
collectives in the same order.

The gradient crosses the mesh twice, by hand: the histogram and loss sums
are all-reduced forward and pass their gradient through unchanged (every
rank already holds the same upstream gradient), and the replicated pose
enters each shard unchanged and all-reduces its 7-vector gradient over the
world (each rank's gradient is its shard's share). The autograd of
``torch.distributed.nn.functional.all_reduce`` would all-reduce the
histograms' gradient again and scale the pose gradient by ``pt``.

Raster sort and grouped gathers do not run here, as in the JAX package
(`refine_pose_sharded` passes no partial fraction to ``refine_pose``, so it
never sorts, `refine.py:179-189`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import se3
from ..models import camera as cam
from ..opt import nid as _nid
from ..opt.nid import NIDKeyframe, TapCache
from ..opt.refine import RefineResult, refine_pose, refine_pose_per_keyframe
from ..utils.numeric import to_int32
from . import mesh as mesh_lib


class _SumForward(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; the gradient passes
    unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh_lib.all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """The identity forward; the gradient all-reduced (sum) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.detach().clone()

    @staticmethod
    def backward(ctx, grad):
        return mesh_lib.all_reduce(grad.contiguous().clone(), ctx.group), None


def replicated_pose(T: se3.SE3) -> se3.SE3:
    """The replicated pose entering this rank's shard: the same values, and
    its gradient summed over the world (one 7-float all-reduce)."""
    qt = _SumBackward.apply(torch.cat([T.q, T.t], dim=-1), dist.group.WORLD)
    return se3.SE3(qt[..., :4], qt[..., 4:])


def sharded_sum_nid(mesh: DeviceMesh):
    """``(taps, s, intensity, inlier_f, bins) -> summed NID`` over the mesh,
    ``opt/nid._sum_nid`` with the histograms summed over ``pt`` (one
    all-reduce of the four packed flat) and the keyframes' NIDs over ``kf``."""
    pt, kf = mesh.get_group(mesh_lib.PT_AXIS), mesh.get_group(mesh_lib.KF_AXIS)

    def sum_nid(taps, s, intensity, inlier_f, bins: int) -> torch.Tensor:
        bin_pts = torch.clamp(to_int32(intensity * bins), 0, bins - 1)
        hists = _nid._histograms_from_taps(taps, s, bin_pts, inlier_f, bins)
        packed = _SumForward.apply(torch.cat([h.reshape(-1) for h in hists]), pt)
        parts, at = [], 0
        for h in hists:
            parts.append(packed[at:at + h.numel()].view(h.shape))
            at += h.numel()
        return _SumForward.apply(torch.sum(_nid.nid_from_histograms(*parts)), kf)

    return sum_nid


def sharded_multi_nid_loss(camera: cam.PinholeCamera, T_camera_lidar: se3.SE3,
                           kfs: NIDKeyframe, mesh: DeviceMesh, bins: int = 16) -> torch.Tensor:
    """Sum of NIDs over every keyframe of the mesh (`nid_shard.py:40-112`),
    ``opt/nid.multi_nid_loss`` on this rank's shard (:func:`mesh.
    shard_keyframes`: keyframes over ``kf``, points over ``pt``) with the
    sums of :func:`sharded_sum_nid`. Every rank returns the same value, and
    its gradient with respect to a replicated ``T_camera_lidar`` is the
    whole objective's."""
    _nid.check_bins(bins)
    kfs = _nid.prepare_keyframes(kfs)
    proj, knot, inl = _nid._project_all(camera, replicated_pose(T_camera_lidar), kfs)
    s = proj - knot.to(proj.dtype)
    with torch.no_grad():
        taps = _nid._gather_taps(camera, kfs, knot, inl)
    return sharded_sum_nid(mesh)(taps, s, kfs.intensity, inl.to(proj.dtype), bins)


def make_sharded_loss(mesh: DeviceMesh):
    """:func:`sharded_multi_nid_loss` with ``opt/refine.refine_pose``'s
    ``loss_fn`` signature."""

    def loss_fn(camera, T, kfs, bins):
        return sharded_multi_nid_loss(camera, T, kfs, mesh, bins)

    return loss_fn


def _reductions(mesh: DeviceMesh) -> _nid.Reductions:
    world = dist.group.WORLD

    def counts(c: torch.Tensor) -> torch.Tensor:
        return mesh_lib.all_reduce(c, world)

    def all_partial(flag: int) -> int:
        # The diagnostic counts a refresh as partial only where every
        # rank's was (JAX's pmin, `nid_shard.py:299-300`).
        t = torch.tensor([flag], dtype=torch.int32, device=mesh.device_type)
        return int(mesh_lib.all_reduce(t, world, dist.ReduceOp.MIN))

    return _nid.Reductions(counts=counts, all_partial=all_partial, sum_nid=sharded_sum_nid(mesh))


def make_sharded_frozen(mesh: DeviceMesh, partial_frac: float = 0.0):
    """``(make_cache, cached_loss)``, the frozen-tap objective over the mesh
    (`nid_shard.py:124-365`) for ``refine_pose(frozen_taps=True,
    frozen_impl=...)``. The cache shards with the points: taps and knots
    (K/kf, N/pt, 2), the gate (K/kf, N/pt), under a wide margin m the
    (K/kf, 4+2m, N/pt) planes. The guard's three counts (care, drifted past
    the margin, by one pixel more) sum over the world before the host
    branch, so every rank refreshes together and ``drift_accum`` adds the
    world's fraction. The choice of a partial refresh (``partial_frac``)
    stays rank-local and free of collectives, as JAX's ``lax.cond``; the
    ``partials`` count is the world's minimum of the flag."""
    reduce = _reductions(mesh)

    def make_cache(camera, T, kfs) -> TapCache:
        return _nid.make_tap_cache(camera, T, kfs)

    def cached_loss(camera, T, kfs, cache, bins=16, guard_frac=0.25, allow_refresh=True):
        return _nid.cached_objective(camera, replicated_pose(T), kfs, cache, bins, guard_frac,
                                     allow_refresh, None, partial_frac, reduce)

    return make_cache, cached_loss


def refine_pose_sharded(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    T_init: se3.SE3,
    mesh: DeviceMesh,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    frozen_taps: bool = False,
    frozen_guard_frac: float = 0.25,
    frozen_partial_frac: float = 0.0,
    frozen_margin: int = 0,
    coarse_outer_iterations: int = 0,
    coarse_stride: int = 4,
    carry_hessian: bool = False,
    ftol: float = 0.0,
    use_grouped_gather=None,
) -> RefineResult:
    """``opt/refine.refine_pose`` over the mesh (`nid_shard.py:429-481`):
    ``kfs`` is this rank's shard (:func:`mesh.shard_keyframes`), ``T_init``
    and the result are replicated, and every rank returns the same bits.
    The frozen-tap cache is :func:`make_sharded_frozen`'s. The coarse phase
    strides each shard's points, which takes JAX's global subsample (every
    ``coarse_stride``-th point of the whole axis) only where the stride
    divides a shard's N/pt; otherwise this raises. The grouped gathers do
    not run sharded: ``use_grouped_gather`` raises."""
    if use_grouped_gather:
        raise ValueError("the sharded solve takes the direct take: use_grouped_gather must be off")
    n_local = kfs.points.shape[1]
    coarse = coarse_outer_iterations > 0 and coarse_stride > 1
    if coarse and mesh.size(1) > 1 and n_local % coarse_stride:
        raise ValueError(f"coarse_stride {coarse_stride} does not divide a shard's "
                         f"{n_local} points: its subsample would not be the global one")
    kfs = _nid.prepare_keyframes(kfs, wide_margin=frozen_margin if frozen_taps else 0)
    return refine_pose(
        camera, kfs, T_init, bins=bins, max_outer_iterations=max_outer_iterations,
        max_inner_iterations=max_inner_iterations, loss_fn=make_sharded_loss(mesh),
        frozen_taps=frozen_taps, frozen_guard_frac=frozen_guard_frac,
        frozen_impl=(make_sharded_frozen(mesh, frozen_partial_frac) if frozen_taps else None),
        frozen_margin=frozen_margin, coarse_outer_iterations=coarse_outer_iterations,
        coarse_stride=coarse_stride, carry_hessian=carry_hessian, ftol=ftol,
    )


def refine_per_keyframe_sharded(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    T_init: se3.SE3,
    mesh: DeviceMesh,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
) -> RefineResult:
    """Per-keyframe NID refinement with the keyframes over ``kf``
    (`nid_shard.py:372-411`): ``kfs`` holds this rank's keyframes with all
    their points (:func:`mesh.shard_keyframes` with ``split_points=False``),
    ``T_init`` is one correction or this rank's (K/kf,) rows. Each rank runs
    the lockstep ``refine_pose_per_keyframe`` on its keyframes, with no
    collective inside; the (K,) result is then all-gathered over ``kf``
    (two all-gathers: the float fields, the integer ones). Its
    ``lockstep_evaluations`` is the most any ``kf`` row made."""
    res = refine_pose_per_keyframe(camera, kfs, T_init, bins=bins,
                                   max_outer_iterations=max_outer_iterations,
                                   max_inner_iterations=max_inner_iterations)
    device = res.T_camera_lidar.t.device
    k = res.nid.shape[0]
    floats = torch.cat([res.T_camera_lidar.q, res.T_camera_lidar.t, res.nid[:, None],
                        res.gather_drift.to(device)[:, None]], dim=1)
    ints = torch.stack([res.outer_iterations, res.converged.to(torch.int64), res.evaluations,
                        res.gathers, res.partial_gathers,
                        torch.full((k,), res.lockstep_evaluations, dtype=torch.int64)], dim=1)
    floats = mesh_lib.gather_kf(mesh, floats)
    ints = mesh_lib.gather_kf(mesh, ints.to(device)).cpu()
    return RefineResult(
        T_camera_lidar=se3.SE3(floats[:, :4], floats[:, 4:7]),
        nid=floats[:, 7],
        outer_iterations=ints[:, 0],
        converged=ints[:, 1].to(torch.bool),
        evaluations=ints[:, 2],
        gathers=ints[:, 3],
        partial_gathers=ints[:, 4],
        gather_drift=floats[:, 8].cpu(),
        lockstep_evaluations=int(ints[:, 5].max()),
    )
