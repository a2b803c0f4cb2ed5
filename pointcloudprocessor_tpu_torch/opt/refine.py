"""NID pose refinement: trust-region-guarded inner BFGS + outer re-solve loop.

Port of `pointcloudprocessor_tpu/opt/refine.py` (`refine_pose`'s plain
outer/inner loop, `refine.py:336-360`), the rebuild of
`VisualCameraCalibration::calibrate` / `estimate_pose_bfgs`
(`visual_camera_calibration.cpp:49-129`):

* the pose is ``T = T_init ∘ exp(xi)`` (right perturbation, :205);
* iterates more than 0.2 m / 2° from the inner-solve start are rejected
  as +inf (the trust-region guard, :102), which the line search backtracks
  out of;
* the outer loop restarts the inner solve from the new pose until the
  pose delta is below ``delta_trans_thresh`` / ``delta_rot_thresh`` or
  ``max_outer_iterations`` (:53-81).

The JAX package's `lax.while_loop`s are Python loops. Its frozen-tap cache,
coarse-to-fine schedule, raster sort and grouped gathers are not ported yet
and raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..models import camera as cam
from . import bfgs
from .nid import NIDKeyframe, multi_nid_loss, prepare_keyframes


class RefineResult(NamedTuple):
    T_camera_lidar: se3.SE3
    nid: torch.Tensor  # final summed NID
    outer_iterations: int
    converged: bool
    evaluations: int  # total objective (value+grad) evaluations


def _guarded_objective(camera, kfs, bins, trust_trans, trust_rot):
    """(xi, T_init) -> (value, grad) of the summed NID at T_init∘exp(xi).

    Outside the trust region (in the tangent of the inner-solve start pose)
    the value is +inf with a zero gradient, as under the JAX package's
    `jnp.where`; the NID is not evaluated there, since the line search
    discards a rejected probe's value and gradient."""

    def value_and_grad(xi: torch.Tensor, T_init: se3.SE3):
        with torch.no_grad():
            trans = torch.linalg.norm(se3.exp(xi).t)
            rot = torch.linalg.norm(xi[3:])
            if bool((trans > trust_trans) | (rot > trust_rot)):
                inf = torch.full((), float("inf"), dtype=xi.dtype, device=xi.device)
                return inf, torch.zeros_like(xi)
        x = xi.detach().requires_grad_(True)
        with torch.enable_grad():
            value = multi_nid_loss(camera, se3.compose(T_init, se3.exp(x)), kfs, bins)
            (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    return value_and_grad


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
    frozen_taps: bool = False,
    sort_points: bool | None = None,
    use_grouped_gather=None,
    carry_hessian: bool = False,
    ftol: float = 0.0,
) -> RefineResult:
    """Optimize the shared camera<-lidar correction over keyframes.

    ``carry_hessian`` warm-starts each inner BFGS with the previous solve's
    inverse Hessian; ``ftol`` is the inner solves' relative
    function-decrease exit (0 disables)."""
    unported = {
        "frozen_taps": frozen_taps,
        "coarse_outer_iterations": coarse_outer_iterations > 0,
        "sort_points": bool(sort_points),
        "use_grouped_gather": bool(use_grouped_gather),
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"refine_pose({name}=...) is not ported to PyTorch yet; "
                "see ROADMAP.md (frozen-tap cache / coarse-to-fine / gathers)"
            )
    kfs = prepare_keyframes(kfs)
    objective = _guarded_objective(camera, kfs, bins, trust_region_trans, trust_region_rot)
    dtype, device = T_init.t.dtype, T_init.t.device
    eye6 = torch.eye(6, dtype=dtype, device=device)

    T = T_init
    nid = torch.tensor(float("inf"), dtype=dtype, device=device)
    it, done, evals, H = 0, False, 0, eye6
    while not done and it < max_outer_iterations:
        res = bfgs.minimize(
            lambda xi, T=T: objective(xi, T),
            torch.zeros(6, dtype=dtype, device=device),
            max_iterations=max_inner_iterations,
            H0=H if carry_hessian else None,
            scale_initial=bool(torch.all(H == eye6)) if carry_hessian else True,
            ftol=ftol,
        )
        with torch.no_grad():
            T_new = se3.compose(T, se3.exp(res.x))
            dt, dr = se3.delta_magnitudes(T, T_new)
        done = bool((dt < delta_trans_thresh) & (dr < delta_rot_thresh))
        T, nid, it = T_new, res.value, it + 1
        evals += res.evaluations
        if carry_hessian:
            H = res.H
    return RefineResult(
        T_camera_lidar=T,
        nid=nid,
        outer_iterations=it,
        converged=done,
        evaluations=evals,
    )
