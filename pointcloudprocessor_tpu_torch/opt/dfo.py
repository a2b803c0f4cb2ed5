"""Derivative-free optimizers: Nelder-Mead simplex + directional direct
search, batched over independent problems.

Port of `pointcloudprocessor_tpu/opt/dfo.py`, parity with the reference's
generic DFO headers (`PointCloudProcessor/include/dfo/optimizer.hpp:8-48`,
`nelder_mead.hpp:8-117`, `directional_direct_search.hpp:8-99`), which back
its projection inversion (`estimate_fov.cpp:17-34`, a 2-dof Nelder-Mead).

The JAX package writes each optimizer as a branch-free `lax.while_loop`
and batches problems with `vmap`. Here each is one torch loop over a
leading axis of B independent problems (x0 of shape (B, N), or (N,) for
one): every iteration updates all B problems with the same tensor ops, a
problem that has met its exit keeps its state, and the loop ends when every
problem has (one host read an iteration). The objective ``f`` maps (..., N)
to (...): it is evaluated on whole batches of points. The pipeline does
not use these for bearings (``models/camera.bearing`` inverts the
distortion in closed form); they stay for black-box calibration
objectives and are cross-checked against the closed form.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class DFOResult(NamedTuple):
    x: torch.Tensor  # best parameters (N,) or (B, N)
    value: torch.Tensor  # objective at x, () or (B,)
    iterations: torch.Tensor  # int32 iterations used, () or (B,)


def _batch(x0: torch.Tensor):
    single = x0.dim() == 1
    return (x0[None] if single else x0), single


def _unbatch(res: DFOResult, single: bool) -> DFOResult:
    return DFOResult(*(t[0] for t in res)) if single else res


def nelder_mead(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    init_step: float = 0.1,
    max_iterations: int = 256,
    xtol: float = 1e-8,
    alpha: float = 1.0,  # reflection   (nelder_mead.hpp:49-97 coefficients)
    beta: float = 2.0,  # expansion
    gamma: float = 0.5,  # contraction
    delta: float = 0.5,  # shrink
) -> DFOResult:
    """Minimize ``f`` from ``x0`` ((N,) or (B, N)) with a Nelder-Mead
    simplex per problem (JAX `dfo.py:31-110`).

    A problem stops when its simplex spread (largest coordinate distance
    from the first vertex) is at most ``xtol`` or after ``max_iterations``.
    Each iteration evaluates the reflection, expansion, contraction and
    shrink points of every live problem and selects branch-free, as JAX's
    loop body does."""
    x, single = _batch(x0)
    b, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    simplex = torch.cat([x[:, None, :], x[:, None, :] + init_step * eye], dim=1)  # (B, n+1, n)
    values = f(simplex)  # (B, n+1)
    it = torch.zeros((b,), dtype=torch.int32, device=x.device)

    def live(simplex, it):
        spread = torch.amax(torch.abs(simplex - simplex[:, 0:1]), dim=(1, 2))
        return (it < max_iterations) & (spread > xtol)

    active = live(simplex, it)
    while bool(active.any()):
        order = torch.argsort(values, dim=1, stable=True)
        simplex = torch.take_along_dim(simplex, order[..., None], dim=1)
        values = torch.take_along_dim(values, order, dim=1)
        best_v, worst_v, second_worst_v = values[:, 0], values[:, -1], values[:, -2]
        worst = simplex[:, -1]
        centroid = torch.mean(simplex[:, :-1], dim=1)

        xr = centroid + alpha * (centroid - worst)
        xe = centroid + beta * (xr - centroid)
        xc = centroid + gamma * (worst - centroid)
        fr, fe, fc = f(torch.stack([xr, xe, xc], dim=1)).unbind(1)

        # Branch-free selection of the replacement for the worst vertex.
        use_expand = (fr < best_v) & (fe < fr)
        use_reflect = (fr < second_worst_v) & ~use_expand
        use_contract = (fc < worst_v) & ~use_expand & ~use_reflect
        shrink = ~(use_expand | use_reflect | use_contract)

        new_last = torch.where(use_expand[:, None], xe, torch.where(
            use_reflect[:, None], xr, torch.where(use_contract[:, None], xc, worst)))
        new_last_v = torch.where(use_expand, fe, torch.where(
            use_reflect, fr, torch.where(use_contract, fc, worst_v)))
        updated = torch.cat([simplex[:, :-1], new_last[:, None]], dim=1)
        updated_v = torch.cat([values[:, :-1], new_last_v[:, None]], dim=1)

        # Shrink all vertices toward the best (evaluated every iteration,
        # selected only where needed).
        shrunk = simplex[:, 0:1] + delta * (simplex - simplex[:, 0:1])
        shrunk_v = f(shrunk)
        new_simplex = torch.where(shrink[:, None, None], shrunk, updated)
        new_values = torch.where(shrink[:, None], shrunk_v, updated_v)
        # A finished problem does not move (its state was last sorted, as
        # JAX's loop leaves it after its last body).
        simplex = torch.where(active[:, None, None], new_simplex, simplex)
        values = torch.where(active[:, None], new_values, values)
        it = it + active.to(torch.int32)
        active = live(simplex, it)

    best = torch.argmin(values, dim=1)
    rows = torch.arange(b, device=x.device)
    return _unbatch(DFOResult(x=simplex[rows, best], value=values[rows, best], iterations=it),
                    single)


def directional_direct_search(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    init_step: float = 0.1,
    max_iterations: int = 256,
    step_tol: float = 1e-8,
    shrink: float = 0.5,
) -> DFOResult:
    """Coordinate-direction direct search
    (`directional_direct_search.hpp:29-93`, JAX `dfo.py:113-147`): poll
    +-e_i * step; move to the best improving poll point, else shrink the
    step. All 2N polls of every live problem evaluate as one batch an
    iteration; a problem stops when its step is at most ``step_tol`` or
    after ``max_iterations``."""
    x, single = _batch(x0)
    b, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    dirs = torch.cat([eye, -eye])  # (2N, N)
    fx = f(x)
    step = torch.full((b,), init_step, dtype=x.dtype, device=x.device)
    it = torch.zeros((b,), dtype=torch.int32, device=x.device)
    active = (it < max_iterations) & (step > step_tol)
    while bool(active.any()):
        cand = x[:, None, :] + step[:, None, None] * dirs  # (B, 2N, N)
        fv = f(cand)
        j = torch.argmin(fv, dim=1)
        rows = torch.arange(b, device=x.device)
        best_v = fv[rows, j]
        improved = (best_v < fx) & active
        x = torch.where(improved[:, None], cand[rows, j], x)
        fx = torch.where(improved, best_v, fx)
        step = torch.where(active & ~improved, step * shrink, step)
        it = it + active.to(torch.int32)
        active = (it < max_iterations) & (step > step_tol)
    return _unbatch(DFOResult(x=x, value=fx, iterations=it), single)


def estimate_direction_nm(camera, pixel: torch.Tensor, max_iterations: int = 128) -> torch.Tensor:
    """Bearing of a pixel ((2,) or (B, 2), on the camera's device) by
    Nelder-Mead over two rotation angles — the reference's exact inversion
    strategy (`estimate_fov.cpp:17-34`, JAX `dfo.py:150-165`), kept as a
    cross-check for the closed-form ``camera.bearing``. A batch of pixels is
    one batch of problems."""
    from ..models import camera as cam

    def angles_to_dir(x):
        # (pitch, yaw) applied to +z, as the reference parameterizes.
        sp, cp = torch.sin(x[..., 0]), torch.cos(x[..., 0])
        sy, cy = torch.sin(x[..., 1]), torch.cos(x[..., 1])
        return torch.stack([cp * sy, sp, cp * cy], dim=-1)

    px, single = _batch(pixel)

    def objective(x):  # (B, ..., 2) -> (B, ...)
        target = px.reshape((px.shape[0],) + (1,) * (x.dim() - 2) + (2,))
        return torch.sum((cam.project(camera, angles_to_dir(x)) - target) ** 2, dim=-1)

    x0 = torch.zeros((px.shape[0], 2), dtype=torch.float32, device=px.device)
    res = nelder_mead(objective, x0, init_step=0.3, max_iterations=max_iterations, xtol=1e-10)
    d = angles_to_dir(res.x)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d[0] if single else d
