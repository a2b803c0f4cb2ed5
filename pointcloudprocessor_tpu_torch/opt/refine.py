"""NID pose refinement: trust-region-guarded inner BFGS + outer re-solve loop.

Port of `pointcloudprocessor_tpu/opt/refine.py` (`refine_pose`,
`refine.py:79-418`), the rebuild of `VisualCameraCalibration::calibrate` /
`estimate_pose_bfgs` (`visual_camera_calibration.cpp:49-129`):

* the pose is ``T = T_init ∘ exp(xi)`` (right perturbation, :205);
* iterates more than 0.2 m / 2° from the inner-solve start are rejected
  as +inf (the trust-region guard, :102), which the line search backtracks
  out of;
* the outer loop restarts the inner solve from the new pose until the
  pose delta is below ``delta_trans_thresh`` / ``delta_rot_thresh`` or
  ``max_outer_iterations`` (:53-81).

:func:`refine_pose_per_keyframe` (`refine.py:421-478`) gives every keyframe
its own correction: the JAX package's ``vmap`` of ``refine_pose`` over
keyframes becomes one lockstep solve (``bfgs.minimize_batched``) whose every
probe evaluates all keyframes at once.

With no reference analogue, as in the JAX package: a coarse-to-fine
schedule, the frozen-tap cache (`opt/nid.multi_nid_loss_cached`), the
raster sort and the grouped gathers. The JAX package's `lax.while_loop`s
and `lax.cond`s are Python loops and branches on host values: each branch
costs one device sync.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial
from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..models import camera as cam
from . import bfgs
from . import nid as _nid
from .nid import NIDKeyframe


class RefineResult(NamedTuple):
    T_camera_lidar: se3.SE3
    nid: torch.Tensor  # final summed NID
    outer_iterations: int
    converged: bool
    evaluations: int  # total objective (value+grad) evaluations
    gathers: int = 0  # tap-table gathers (frozen_taps only; 0 otherwise)
    partial_gathers: int = 0  # gathers served by a partial refresh (a subset of gathers)
    gather_drift: float = 0.0  # sum of the drifted fraction at each refresh
    # Objective calls of refine_pose_per_keyframe's lockstep solve, each one
    # evaluation of every keyframe (0 from refine_pose).
    lockstep_evaluations: int = 0


def _guarded_objective(trust_trans: float, trust_rot: float, loss):
    """``loss(T, cache) -> (value, cache')`` -> ``(xi, T_init, cache) ->
    (value, grad, cache')`` at T_init∘exp(xi).

    Outside the trust region (in the tangent of the inner-solve start pose)
    the value is +inf with a zero gradient, as under the JAX package's
    `jnp.where`. The loss is not evaluated there, since the line search
    discards a rejected probe's value and gradient, so such a probe cannot
    refresh a frozen-tap cache (``allow_refresh`` False in the JAX package,
    `refine.py:258-274`)."""

    def value_and_grad(xi: torch.Tensor, T_init: se3.SE3, cache):
        with torch.no_grad():
            trans = torch.linalg.norm(se3.exp(xi).t)
            rot = torch.linalg.norm(xi[3:])
            if bool((trans > trust_trans) | (rot > trust_rot)):  # one device sync
                inf = torch.full((), float("inf"), dtype=xi.dtype, device=xi.device)
                return inf, torch.zeros_like(xi), cache
        x = xi.detach().requires_grad_(True)
        with torch.enable_grad():
            value, cache = loss(se3.compose(T_init, se3.exp(x)), cache)
            (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad, cache

    return value_and_grad


def _subsample_keyframes(kfs: NIDKeyframe, stride: int) -> NIDKeyframe:
    """Every ``stride``-th point of each keyframe (`refine.py:68-76`; tap
    tables and bin images shared). Culled points arrive in map or raster
    order, so a strided slice is a spatially unbiased subsample."""
    return replace(
        kfs,
        points=kfs.points[:, ::stride],
        intensity=kfs.intensity[:, ::stride],
        valid=kfs.valid[:, ::stride],
    )


class _Outer(NamedTuple):
    T: se3.SE3
    nid: torch.Tensor
    it: int
    done: bool
    evals: int
    gathers: int
    pgathers: int  # partial refreshes among the gathers
    drift: torch.Tensor  # () f32
    H: torch.Tensor  # carried inverse-Hessian metric (carry_hessian)


def refine_pose(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,  # batched over keyframes
    T_init: se3.SE3,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    delta_trans_thresh: float = 0.01,
    delta_rot_thresh: float = 0.017453,  # 1 degree, hpp:24
    trust_region_trans: float = 0.2,
    trust_region_rot: float = 0.034907,  # 2 degrees, :102
    coarse_outer_iterations: int = 0,
    coarse_stride: int = 4,
    frozen_taps: bool = False,
    frozen_guard_frac: float = 0.25,
    frozen_partial_frac: float = 0.0,
    frozen_margin: int = 0,
    sort_points: Optional[bool] = None,
    use_grouped_gather=None,
    carry_hessian: bool = False,
    ftol: float = 0.0,
    loss_fn=None,
    frozen_impl=None,
) -> RefineResult:
    """Optimize the shared camera<-lidar correction over keyframes.

    ``coarse_outer_iterations`` > 0: the first outer solves run the plain
    objective with the direct take on every ``coarse_stride``-th point; the
    final solves always run at full resolution with the same convergence
    criteria. ``frozen_taps``: the full-resolution phase descends the
    guarded frozen-tap objective (the cache is built once per phase and
    carried across outer iterations; ``frozen_guard_frac`` is its guard),
    and the returned ``nid`` is a fresh exact evaluation at the final pose.
    With ``frozen_taps``, ``frozen_margin`` m (0..2) caches (4+2m)^2 windows
    and moves the guard to m+1 / m+2 px, and ``frozen_partial_frac`` > 0
    lets refreshes re-take only the drifted 128-point blocks
    (`opt/nid.multi_nid_loss_cached`); without ``frozen_taps`` both are
    inert, as in the JAX package. ``sort_points`` (None: on when a grouped
    gather runs or a partial refresh can, `refine.py:179-189`) raster-sorts
    the points once at ``T_init``; ``use_grouped_gather`` True / "streamed"
    selects the grouped gathers (kernels K3 / K4). ``carry_hessian``
    warm-starts each inner BFGS with the previous solve's inverse Hessian;
    ``ftol`` is the inner solves' relative function-decrease exit (0
    disables).

    ``loss_fn(camera, T, kfs, bins)`` replaces the exact objective in the
    coarse phase, the fine phase and the final exact evaluation, and
    ``frozen_impl``, a pair ``(make_cache(camera, T, kfs),
    cached_loss(camera, T, kfs, cache, bins, guard_frac=...))``, the
    frozen-tap cache (`refine.py:109-114, 190-226`; the sharded objective of
    `parallel/nid_shard` brings both). ``frozen_taps`` with a custom loss
    requires ``frozen_impl``, and a custom loss takes no grouped gather."""
    if loss_fn is not None:
        if frozen_taps and frozen_impl is None:
            raise ValueError("frozen_taps with a custom loss_fn requires frozen_impl")
        if use_grouped_gather:
            raise ValueError("a custom loss_fn takes the direct take: use_grouped_gather must "
                             "be off")
    if sort_points is None:
        # The raster sort makes the grouped gathers' rows near-monotone and
        # drift block-coherent for the partial refresh; without either it
        # is a sort per solve and a summation-order change.
        sort_points = bool(use_grouped_gather) or (frozen_taps and frozen_partial_frac > 0)
    kfs = _nid.prepare_keyframes(kfs, grouped=bool(use_grouped_gather),
                                 wide_margin=frozen_margin if frozen_taps else 0)
    if sort_points:
        kfs = _nid.sort_by_raster(camera, T_init, kfs)
    dtype, device = T_init.t.dtype, T_init.t.device
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def inner(vg_c, cache, H):
        return bfgs.minimize_cached(
            vg_c,
            torch.zeros(6, dtype=dtype, device=device),
            cache,
            max_iterations=max_inner_iterations,
            H0=H if carry_hessian else None,
            scale_initial=bool(torch.all(H == eye6)) if carry_hessian else True,
            ftol=ftol,
        )

    def exact(phase_grouped):
        if loss_fn is not None:
            return loss_fn
        return partial(_nid.multi_nid_loss, use_grouped=phase_grouped)

    def solve_phase(init: _Outer, phase_kfs, max_iters, use_frozen, phase_grouped) -> _Outer:
        if use_frozen:
            make_cache, cached_loss = frozen_impl or (
                partial(_nid.make_tap_cache, use_grouped=phase_grouped),
                partial(_nid.multi_nid_loss_cached, use_grouped=phase_grouped,
                        partial_frac=frozen_partial_frac),
            )

            def loss(T, cache):
                return cached_loss(camera, T, phase_kfs, cache, bins, guard_frac=frozen_guard_frac)

            # Built once per phase and carried across outer iterations:
            # knots are stored absolute, so the guard alone decides when
            # the pose has moved enough to re-gather.
            cache = make_cache(camera, init.T, phase_kfs)
        else:
            phase_loss = exact(phase_grouped)

            def loss(T, cache):
                return phase_loss(camera, T, phase_kfs, bins), cache

            cache = None
        objective = _guarded_objective(trust_region_trans, trust_region_rot, loss)
        st = init
        while not st.done and st.it < max_iters:
            res, cache = inner(lambda xi, c, T=st.T: objective(xi, T, c), cache, st.H)
            with torch.no_grad():
                T_new = se3.compose(st.T, se3.exp(res.x))
                dt, dr = se3.delta_magnitudes(st.T, T_new)
            st = _Outer(
                T=T_new,
                nid=res.value,
                it=st.it + 1,
                done=bool((dt < delta_trans_thresh) & (dr < delta_rot_thresh)),
                evals=st.evals + res.evaluations,
                # The cache counts this phase's gathers; the phase-entry
                # total keeps earlier phases' gathers.
                gathers=init.gathers + cache.refreshes if use_frozen else st.gathers,
                pgathers=init.pgathers + cache.partials if use_frozen else st.pgathers,
                drift=init.drift + cache.drift_accum if use_frozen else st.drift,
                H=res.H if carry_hessian else st.H,
            )
        return st

    state = _Outer(
        T=T_init,
        nid=torch.tensor(float("inf"), dtype=dtype, device=device),
        it=0,
        done=False,
        evals=0,
        gathers=0,
        pgathers=0,
        drift=torch.zeros((), dtype=torch.float32, device=device),
        H=eye6,
    )
    if coarse_outer_iterations > 0 and coarse_stride > 1:
        # The coarse phase runs the plain objective with the direct take:
        # the stride multiplies sorted-point gaps, so grouped windows would
        # overflow, and it takes the large steps that would refresh a
        # frozen cache constantly.
        coarse = solve_phase(
            state, _subsample_keyframes(kfs, coarse_stride), coarse_outer_iterations,
            use_frozen=False, phase_grouped=False,
        )
        # The fine phase starts from the coarse pose with a reset iteration
        # and convergence state; evaluations, gathers and H carry over.
        state = coarse._replace(nid=state.nid, it=0, done=False)
    final = solve_phase(
        state, kfs, max_outer_iterations, use_frozen=frozen_taps,
        phase_grouped=use_grouped_gather,
    )
    nid_final = final.nid
    if frozen_taps:
        # The exact full-resolution objective at the final pose, not the
        # last surrogate value (one extra forward evaluation).
        with torch.no_grad():
            nid_final = exact(use_grouped_gather)(camera, final.T, kfs, bins)
    return RefineResult(
        T_camera_lidar=final.T,
        nid=nid_final,
        outer_iterations=final.it,
        converged=final.done,
        evaluations=final.evals,
        gathers=final.gathers,
        partial_gathers=final.pgathers,
        gather_drift=float(final.drift),
    )


def _guarded_per_keyframe(camera: cam.PinholeCamera, kfs: NIDKeyframe, bins: int,
                          trust_trans: float, trust_rot: float, T_init: se3.SE3):
    """(K, 6) host tangents -> ((K,) values, (K, 6) gradients) on the host:
    keyframe j's NID at ``T_init[j] ∘ exp(xi[j])``, one evaluation of all K
    keyframes on their device (one G1, one K1 and one K2 launch on the card)
    and one device sync. The trust region is a lane's own: a lane more than
    ``trust_trans`` / ``trust_rot`` from its inner-solve start gets +inf and
    a zero gradient while the other lanes are evaluated as usual (the JAX
    package's ``jnp.where``, `refine.py:52-65`)."""
    device = kfs.points.device

    def value_and_grad(xi: torch.Tensor):
        x = xi.to(device)
        with torch.no_grad():
            trans = torch.linalg.norm(se3.exp(x).t, dim=-1)
            outside = (trans > trust_trans) | (torch.linalg.norm(x[:, 3:], dim=-1) > trust_rot)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            nids = _nid.multi_nid_per_keyframe(camera, se3.compose(T_init, se3.exp(x)), kfs, bins)
            # Keyframe j's NID depends on row j alone: the gradient of the
            # sum is each keyframe's own in its row.
            (grad,) = torch.autograd.grad(nids.sum(), x)
        value = torch.where(outside, torch.full_like(nids, float("inf")), nids.detach())
        grad = torch.where(outside[:, None], torch.zeros_like(grad), grad)
        out = torch.cat([value[:, None], grad], dim=1).cpu()
        return out[:, 0], out[:, 1:]

    return value_and_grad


def refine_pose_per_keyframe(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,  # batched over keyframes
    T_init: se3.SE3,  # scalar or batched (K,) initial correction(s)
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    delta_trans_thresh: float = 0.01,
    delta_rot_thresh: float = 0.017453,
    trust_region_trans: float = 0.2,
    trust_region_rot: float = 0.034907,
) -> RefineResult:
    """An independent NID correction per keyframe (`refine.py:421-478`), the
    generalization of the reference's per-keyframe manual poses
    (`FrameData::addManualOptimizedPose`, honored at
    `PointCloudProcessor.cpp:510-519`).

    The JAX package runs ``refine_pose`` on each keyframe alone under a
    ``vmap``; here the K solves run in lockstep: the outer loop and its
    convergence test are each lane's own, and every inner BFGS probe is one
    evaluation of all K keyframes (``bfgs.minimize_batched`` over
    :func:`_guarded_per_keyframe`), which a lane's result does not depend
    on. ``T_init`` broadcasts to every keyframe. As in the JAX package the
    gather is the direct take (the packed bin tiles of one ``bin_pack``), with
    no raster sort, coarse phase or frozen taps.

    Returns a RefineResult whose fields carry a leading K axis as tensors:
    ``T_camera_lidar`` (K,) and ``nid`` (K,) (each lane's last inner-solve
    value) on the keyframes' device; ``outer_iterations``, ``evaluations``
    (each lane's own probes), ``gathers`` and ``partial_gathers`` (zeros)
    int64 and ``converged`` bool, ``gather_drift`` f32 zeros, on the host.
    ``lockstep_evaluations`` counts the objective calls, each over all K."""
    kfs = _nid.prepare_keyframes(kfs)
    k = kfs.points.shape[0]
    device = kfs.points.device
    T = se3.SE3(T_init.q.to(device).expand(k, 4).clone(), T_init.t.to(device).expand(k, 3).clone())
    dtype = T.t.dtype
    nid = torch.full((k,), float("inf"), dtype=dtype, device=device)
    it = torch.zeros(k, dtype=torch.int64)
    done = torch.zeros(k, dtype=torch.bool)
    evals = torch.zeros(k, dtype=torch.int64)
    calls = 0
    while True:
        active = ~done & (it < max_outer_iterations)
        if not bool(active.any()):
            break
        res = bfgs.minimize_batched(
            _guarded_per_keyframe(camera, kfs, bins, trust_region_trans, trust_region_rot, T),
            torch.zeros((k, 6), dtype=dtype),
            active=active,
            max_iterations=max_inner_iterations,
        )
        calls += res.calls
        with torch.no_grad():
            T_new = se3.compose(T, se3.exp(res.x.to(device)))
            dt, dr = se3.delta_magnitudes(T, T_new)
        converged = ((dt < delta_trans_thresh) & (dr < delta_rot_thresh)).cpu()
        on = active.to(device)
        T = se3.SE3(torch.where(on[:, None], T_new.q, T.q), torch.where(on[:, None], T_new.t, T.t))
        nid = torch.where(on, res.value.to(device), nid)
        it = it + active
        done = torch.where(active, converged, done)
        evals = evals + res.evaluations
    return RefineResult(
        T_camera_lidar=T,
        nid=nid,
        outer_iterations=it,
        converged=done,
        evaluations=evals,
        gathers=torch.zeros(k, dtype=torch.int64),
        partial_gathers=torch.zeros(k, dtype=torch.int64),
        gather_drift=torch.zeros(k, dtype=torch.float32),
        lockstep_evaluations=calls,
    )
