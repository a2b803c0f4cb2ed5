"""BFGS with Armijo backtracking line search, as a host loop.

Port of `pointcloudprocessor_tpu/opt/bfgs.py` (`minimize` and
`minimize_cached`, `bfgs.py:35-299`),
the stand-in for the reference's `ceres::GradientProblemSolver` BFGS inner
solve (`visual_camera_calibration.cpp:204-233`). The JAX solver runs nested
`lax.while_loop`s on device; here the loops are Python, over one
value+grad evaluation per probe, while the iterate, gradient and inverse
Hessian stay f32 tensors and every scalar of the line search is computed
in f32 as the JAX solver computes it: line-search changes flip solve
outcomes, not just evaluation counts (CLAUDE.md).

The objective may return +inf to reject an iterate (the trust-region guard,
`MultiNIDCost::operator()` :102); the line search then backtracks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class BFGSResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: int
    converged: bool
    evaluations: int  # total value_and_grad calls (objective cost)
    H: torch.Tensor  # final inverse-Hessian approximation (d, d)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def minimize(
    value_and_grad: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    max_iterations: int = 64,
    grad_tol: float = 1e-6,
    step_tol: float = 1e-10,
    armijo_c1: float = 1e-4,
    max_backtracks: int = 25,
    H0: Optional[torch.Tensor] = None,
    ftol: float = 0.0,
    scale_initial: bool = True,
) -> BFGSResult:
    """Minimize from ``x0`` (1-D). ``value_and_grad(x) -> (value, grad)``:
    :func:`minimize_cached` with an empty cache."""
    res, _ = minimize_cached(
        lambda x, cache: (*value_and_grad(x), cache),
        x0,
        None,
        max_iterations=max_iterations,
        grad_tol=grad_tol,
        step_tol=step_tol,
        armijo_c1=armijo_c1,
        max_backtracks=max_backtracks,
        H0=H0,
        ftol=ftol,
        scale_initial=scale_initial,
    )
    return res


def minimize_cached(
    vg_c: Callable,
    x0: torch.Tensor,
    cache0,
    max_iterations: int = 64,
    grad_tol: float = 1e-6,
    step_tol: float = 1e-10,
    armijo_c1: float = 1e-4,
    max_backtracks: int = 25,
    H0: Optional[torch.Tensor] = None,
    ftol: float = 0.0,
    scale_initial: bool = True,
):
    """BFGS over an objective with a carried evaluation cache
    (`bfgs.py:70-299`). ``vg_c(x, cache) -> (value, grad, cache')`` may
    update its cache on any evaluation (the frozen-tap NID gather,
    `opt/nid.TapCache`); the cache threads through every probe, rejected
    ones included, and the final cache is returned: ``(BFGSResult, cache)``.

    ``H0`` warm-starts the inverse Hessian; ``scale_initial`` applies the
    classic first-update scaling H = (sy/yy) I; ``ftol`` > 0 exits when an
    accepted step decreases the value by less than ``ftol * (|f| + 1e-12)``
    (Ceres function_tolerance)."""
    d = x0.shape[0]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    c1 = _f32(armijo_c1, x0)

    def line_search(x, direction, val, g, alpha0, cache):
        """Backtracking Armijo; also backtracks out of +inf regions. Each
        probe evaluates value AND gradient; the accepted probe's gradient is
        returned. A rejected finite probe proposes the minimizer of the
        quadratic through f(0), f'(0) and f(alpha), clamped to
        [alpha/10, alpha/2]; a +inf probe halves."""
        dg = torch.dot(g, direction)

        def accepted(alpha, new_val):
            return bool(torch.isfinite(new_val) & (new_val <= val + c1 * alpha * dg))

        alpha = alpha0
        new_val, new_g, cache = vg_c(x + alpha * direction, cache)
        it = 0
        while not accepted(alpha, new_val) and it < max_backtracks:
            denom = new_val - val - dg * alpha
            if bool(torch.isfinite(new_val) & (denom > 0)):
                interp = -dg * alpha * alpha / (2.0 * denom)
                alpha = torch.clamp(interp, 0.1 * alpha, 0.5 * alpha)
            else:
                alpha = alpha * 0.5
            new_val, new_g, cache = vg_c(x + alpha * direction, cache)
            it += 1
        if accepted(alpha, new_val):
            return alpha, new_val, new_g, it + 1, cache
        return torch.zeros_like(alpha), val, g, it + 1, cache

    x = x0
    val, g, cache = vg_c(x0, cache0)
    H = eye if H0 is None else H0
    it = 0
    evals = 1
    done = bool(torch.linalg.norm(g) < grad_tol)
    prev_alpha = _f32(1.0, x0)
    one, sixteenth = _f32(1.0, x0), _f32(1.0 / 16.0, x0)
    while not done and it < max_iterations:
        direction = -(H @ g)
        # Not a descent direction (H lost positive definiteness): steepest.
        if not bool(torch.dot(direction, g) < 0):
            direction = -g
        if it == 0:
            # Under an identity metric a raw |g| step overshoots steep
            # objectives: start from min(1, 1/|g|) (Nocedal-Wright).
            alpha0 = (
                torch.minimum(one, 1.0 / (torch.linalg.norm(g) + 1e-12))
                if scale_initial
                else one
            )
        else:
            alpha0 = torch.clamp(1.5 * prev_alpha, sixteenth, one)
        alpha, val_new, g_new, probes, cache = line_search(x, direction, val, g, alpha0, cache)
        step = alpha * direction
        x_new = x + step

        s = step
        y = g_new - g
        sy = torch.dot(s, y)
        yy = torch.dot(y, y)
        curv = bool(sy > 1e-12)
        rho = 1.0 / sy if curv else torch.zeros_like(sy)
        H_base = H
        if it == 0 and curv and bool(yy > 1e-12) and scale_initial:
            H_base = (sy / torch.clamp(yy, min=1e-20)) * eye
        V = eye - rho * torch.outer(s, y)
        H_new = V @ H_base @ V.T + rho * torch.outer(s, s) if curv else H

        stalled = bool(alpha == 0.0)
        moved = torch.linalg.norm(step)
        rel_drop_small = bool((val - val_new) <= ftol * (torch.abs(val_new) + 1e-12))
        done = (
            stalled
            or bool(torch.linalg.norm(g_new) < grad_tol)
            or bool(moved < step_tol)
            or (ftol > 0 and not stalled and rel_drop_small)
        )
        if not stalled:
            x, val, g, H, prev_alpha = x_new, val_new, g_new, H_new, alpha
        it += 1
        evals += probes
    return (
        BFGSResult(
            x=x,
            value=val,
            grad_norm=torch.linalg.norm(g),
            iterations=it,
            converged=done,
            evaluations=evals,
            H=H,
        ),
        cache,
    )
