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

Every decision on a tensor is read through ``utils.profiling.host_read``
and every constant made through ``to_device`` (one device sync each on
the card). Each step of :func:`minimize_cached` is two spans:
``bfgs.line_search`` (the probes, where the objective's spans nest) and
``bfgs.update`` (the host's direction, curvature, inverse-Hessian update and
convergence tests).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import host_read, span, spanned, to_device


class BFGSResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: int
    converged: bool
    evaluations: int  # total value_and_grad calls (objective cost)
    H: torch.Tensor  # final inverse-Hessian approximation (d, d)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return to_device(x, like.device, like.dtype)


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

    @spanned("bfgs.line_search")
    def line_search(x, direction, val, g, alpha0, cache):
        """Backtracking Armijo; also backtracks out of +inf regions. Each
        probe evaluates value AND gradient; the accepted probe's gradient is
        returned. A rejected finite probe proposes the minimizer of the
        quadratic through f(0), f'(0) and f(alpha), clamped to
        [alpha/10, alpha/2]; a +inf probe halves."""
        dg = torch.dot(g, direction)

        def accepted(alpha, new_val):
            return host_read(torch.isfinite(new_val) & (new_val <= val + c1 * alpha * dg))

        alpha = alpha0
        new_val, new_g, cache = vg_c(x + alpha * direction, cache)
        it = 0
        while not accepted(alpha, new_val) and it < max_backtracks:
            denom = new_val - val - dg * alpha
            if host_read(torch.isfinite(new_val) & (denom > 0)):
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
    with span("bfgs.update"):
        done = host_read(torch.linalg.norm(g) < grad_tol)
    prev_alpha = _f32(1.0, x0)
    one, sixteenth = _f32(1.0, x0), _f32(1.0 / 16.0, x0)
    while not done and it < max_iterations:
        with span("bfgs.update"):
            direction = -(H @ g)
            # Not a descent direction (H lost positive definiteness): steepest.
            if not host_read(torch.dot(direction, g) < 0):
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
        with span("bfgs.update"):
            step = alpha * direction
            x_new = x + step

            s = step
            y = g_new - g
            sy = torch.dot(s, y)
            yy = torch.dot(y, y)
            curv = host_read(sy > 1e-12)
            rho = 1.0 / sy if curv else torch.zeros_like(sy)
            H_base = H
            if it == 0 and curv and host_read(yy > 1e-12) and scale_initial:
                H_base = (sy / torch.clamp(yy, min=1e-20)) * eye
            V = eye - rho * torch.outer(s, y)
            H_new = V @ H_base @ V.T + rho * torch.outer(s, s) if curv else H

            stalled = host_read(alpha == 0.0)
            moved = torch.linalg.norm(step)
            rel_drop_small = host_read((val - val_new) <= ftol * (torch.abs(val_new) + 1e-12))
            done = (
                stalled
                or host_read(torch.linalg.norm(g_new) < grad_tol)
                or host_read(moved < step_tol)
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


class BatchedBFGSResult(NamedTuple):
    x: torch.Tensor  # (B, d)
    value: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,) int64
    converged: torch.Tensor  # (B,) bool
    evaluations: torch.Tensor  # (B,) int64: the probes of each lane, its first included
    H: torch.Tensor  # (B, d, d)
    calls: int  # value_and_grad calls, each over every lane


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis, summed in index order, one rounding
    a step. Elementwise ops only: a row's bits do not depend on the batch it
    sits in (a reduction or a batched matmul may vectorize across rows)."""
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j] * b[..., j]
    return acc


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, m) @ (..., m, p) with :func:`_dot`'s order and rounding."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., :, j, None] * b[..., None, j, :]
    return acc


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def minimize_batched(
    value_and_grad: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    max_iterations: int = 64,
    grad_tol: float = 1e-6,
    step_tol: float = 1e-10,
    armijo_c1: float = 1e-4,
    max_backtracks: int = 25,
) -> BatchedBFGSResult:
    """B independent BFGS solves in lockstep: the JAX package's ``minimize``
    under ``vmap`` (`bfgs.py:35-299`, vmapped by `refine.py:476`).

    ``x0`` is (B, d); ``value_and_grad(x)`` takes all B rows and returns
    ((B,) values, (B, d) gradients) in one call, row b a function of
    ``x[b]`` alone. Each lane has its own line search (Armijo, the clamped
    quadratic backtrack, halving out of +inf), its own ``done`` and its own
    iteration and evaluation counts; a lane that has finished, or has
    accepted its probe while others backtrack, keeps its state, as a
    ``vmap``ped ``while_loop`` keeps it. Every probe evaluates all B rows
    (rows not probing are handed their iterate). Lanes where ``active`` is
    False do not solve: their rows are ``x0`` with 0 iterations and 0
    evaluations. As the JAX package's per-keyframe solves, every lane starts
    from the identity metric with the first-update scaling and no ``ftol``
    exit.

    Each lane's scalars are those of :func:`minimize_cached`, in f32 and in
    its order of operations; its dot products, norms and 6x6 products are
    summed in index order (:func:`_dot`), so a lane's bits do not depend on
    the batch it is solved in. The state lives on ``x0``'s device and its
    decisions are read there: hand host tensors in and out of
    ``value_and_grad`` and a probe costs the one device sync of its
    evaluation, whatever B."""
    b, d = x0.shape
    dtype, device = x0.dtype, x0.device
    eye = torch.eye(d, dtype=dtype, device=device).expand(b, d, d)
    c1 = _f32(armijo_c1, x0)
    one, sixteenth = _f32(1.0, x0), _f32(1.0 / 16.0, x0)
    lane = torch.ones(b, dtype=torch.bool, device=device) if active is None else active.clone()
    calls = 0

    def evaluate(x):
        nonlocal calls
        calls += 1
        return value_and_grad(x)

    x = x0.clone()
    val, g = evaluate(x)
    H = eye.clone()
    it = torch.zeros(b, dtype=torch.int64, device=device)
    evals = lane.to(torch.int64)
    done = ~lane | (_norm(g) < grad_tol)
    prev_alpha = torch.ones(b, dtype=dtype, device=device)
    while True:
        run = ~done & (it < max_iterations)
        if not host_read(run.any()):
            break
        direction = -_dot(H, g[:, None, :])
        # Not a descent direction (H lost positive definiteness): steepest.
        direction = torch.where((_dot(direction, g) < 0)[:, None], direction, -g)
        first = torch.minimum(one, 1.0 / (_norm(g) + 1e-12))
        alpha = torch.where(it == 0, first, torch.clamp(1.5 * prev_alpha, sixteenth, one))

        # The line search, every lane at once (minimize_cached's line_search).
        dg = _dot(g, direction)

        def accepted(alpha, new_val):
            return torch.isfinite(new_val) & (new_val <= val + c1 * alpha * dg)

        new_val, new_g = evaluate(torch.where(run[:, None], x + alpha[:, None] * direction, x))
        probes = run.to(torch.int64)
        backtracks = torch.zeros(b, dtype=torch.int64, device=device)
        search = run & ~accepted(alpha, new_val) & (backtracks < max_backtracks)
        while host_read(search.any()):
            denom = new_val - val - dg * alpha
            quad = torch.isfinite(new_val) & (denom > 0)
            interp = -dg * alpha * alpha / (2.0 * torch.where(quad, denom, one))
            shrunk = torch.where(quad, torch.clamp(interp, 0.1 * alpha, 0.5 * alpha), alpha * 0.5)
            alpha = torch.where(search, shrunk, alpha)
            v, gv = evaluate(torch.where(search[:, None], x + alpha[:, None] * direction, x))
            new_val = torch.where(search, v, new_val)
            new_g = torch.where(search[:, None], gv, new_g)
            backtracks = backtracks + search
            probes = probes + search
            search = run & ~accepted(alpha, new_val) & (backtracks < max_backtracks)
        ok = accepted(alpha, new_val)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
        val_new = torch.where(ok, new_val, val)
        g_new = torch.where(ok[:, None], new_g, g)

        step = alpha[:, None] * direction
        x_new = x + step
        s, y = step, g_new - g
        sy, yy = _dot(s, y), _dot(y, y)
        curv = sy > 1e-12
        rho = torch.where(curv, 1.0 / torch.where(curv, sy, one), torch.zeros_like(sy))
        scaled = (it == 0) & curv & (yy > 1e-12)
        H_base = torch.where(
            scaled[:, None, None], (sy / torch.clamp(yy, min=1e-20))[:, None, None] * eye, H)
        V = eye - rho[:, None, None] * (s[:, :, None] * y[:, None, :])
        H_new = _matmul(_matmul(V, H_base), V.transpose(-1, -2)) + rho[:, None, None] * (
            s[:, :, None] * s[:, None, :])
        H_new = torch.where(curv[:, None, None], H_new, H)

        stalled = alpha == 0.0
        finished = stalled | (_norm(g_new) < grad_tol) | (_norm(step) < step_tol)
        move = run & ~stalled
        x = torch.where(move[:, None], x_new, x)
        val = torch.where(move, val_new, val)
        g = torch.where(move[:, None], g_new, g)
        H = torch.where(move[:, None, None], H_new, H)
        prev_alpha = torch.where(move, alpha, prev_alpha)
        done = torch.where(run, finished, done)
        it = it + run
        evals = evals + probes
    return BatchedBFGSResult(x=x, value=val, grad_norm=_norm(g), iterations=it,
                             converged=done & lane, evaluations=evals, H=H, calls=calls)
