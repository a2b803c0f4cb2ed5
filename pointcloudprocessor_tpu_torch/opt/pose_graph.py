"""Pose-graph fusion of per-keyframe NID corrections with odometry.

Port of `pointcloudprocessor_tpu/opt/pose_graph.py` (`pose_graph.py:1-249`).
The reference applies one global correction (or per-keyframe manual poses)
directly to the VO trajectory and never reconciles them
(`PointCloudProcessor.cpp:495-519`). Here the per-keyframe NID refinements
(`opt/refine.refine_pose_per_keyframe`) are absolute measurement factors on
a pose graph whose between factors are the VO relative motions, and a
Gauss-Newton smoother solves for the maximum a posteriori trajectory. The
normal equations of a chain with unary factors are block-tridiagonal, so
each step is exact block Gaussian elimination down the chain (a Schur
sweep) in O(K) 6x6 solves; no (6K)^2 matrix is formed.

Poses are camera-to-world SE(3), right-perturbed ``T_i <- T_i @ exp(xi_i)``.
The JAX package's ``jax.jacfwd`` Jacobians at zero come from one reverse
pass over the batch of factors repeated once a residual component, and its
``lax.scan`` sweeps are Python loops over the keyframes. Everything runs on
the device of its inputs, with no kernel: K is the keyframe count, so a
solve is a few hundred 6x6 operations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import se3


class PoseGraphResult(NamedTuple):
    poses: se3.SE3  # (K,) optimized camera-to-world poses
    residual_norm: torch.Tensor  # () final weighted residual 2-norm
    initial_residual_norm: torch.Tensor  # ()
    iterations: int


def _row(x: se3.SE3, i) -> se3.SE3:
    return se3.SE3(x.q[i], x.t[i])


def relative_measurements(poses: se3.SE3) -> se3.SE3:
    """Chain measurements Z_i = T_i^{-1} T_{i+1} from a trajectory (K,)."""
    return se3.compose(se3.inverse(_row(poses, slice(None, -1))), _row(poses, slice(1, None)))


def _between_residual(xi_i, xi_j, Ti: se3.SE3, Tj: se3.SE3, Z: se3.SE3):
    """log(Z^{-1} (Ti exp(xi_i))^{-1} (Tj exp(xi_j))): a 6-vector."""
    Ti_p = se3.compose(Ti, se3.exp(xi_i))
    Tj_p = se3.compose(Tj, se3.exp(xi_j))
    rel = se3.compose(se3.inverse(Ti_p), Tj_p)
    return se3.log(se3.compose(se3.inverse(Z), rel))


def _unary_residual(xi, T: se3.SE3, M: se3.SE3):
    """log(M^{-1} (T exp(xi))): pulls a node toward its measurement M."""
    return se3.log(se3.compose(se3.inverse(M), se3.compose(T, se3.exp(xi))))


def _linearize(residual, n_args: int, k: int, dtype, device):
    """The residual at xi = 0 and its (k, 6, 6) Jacobians in each of its
    ``n_args`` tangent arguments there, for a batched
    ``residual(*xi) -> (..., k, 6)`` whose row i reads row i of each xi
    alone. One forward and one reverse pass: the batch is repeated once a
    residual component, and copy c carries only component c's cotangent,
    so its gradient is row c of every Jacobian (the columns ``jax.jacfwd``
    pushes through its ``vmap`` of JVPs). On the card each pass is a few
    hundred launches, whatever k."""
    xis = [torch.zeros((6, k, 6), dtype=dtype, device=device, requires_grad=True)
           for _ in range(n_args)]
    pick = torch.eye(6, dtype=dtype, device=device)[:, None, :]
    with torch.enable_grad():
        r = residual(*xis)
        grads = torch.autograd.grad(torch.sum(r * pick), xis)
    return r[0].detach(), [g.transpose(0, 1) for g in grads]


def _tmatvec(J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """J^T r over a leading batch axis."""
    return (J.transpose(-1, -2) @ r[..., None])[..., 0]


def absolute_blocks(poses: se3.SE3, meas: se3.SE3, weight: torch.Tensor):
    """Per-node unary-factor normal-equation contributions: ``(H_diag
    (K, 6, 6), rhs (K, 6))`` with ``rhs = -w J^T r`` (`pose_graph.py:62-83`)."""
    r, (J,) = _linearize(lambda xi: _unary_residual(xi, poses, meas), 1, poses.t.shape[0],
                         poses.t.dtype, poses.t.device)
    w = weight[:, None, None]
    return w * (J.transpose(-1, -2) @ J), -weight[:, None] * _tmatvec(J, r)


def _between_blocks(poses: se3.SE3, odo: se3.SE3, weight: torch.Tensor):
    """Chain-factor contributions (`pose_graph.py:86-120`): (diag add
    (K, 6, 6), upper (K-1, 6, 6), rhs add (K, 6), weighted squared sum)."""
    k = poses.q.shape[0]
    dtype, device = poses.q.dtype, poses.q.device
    diag = torch.zeros((k, 6, 6), dtype=dtype, device=device)
    rhs = torch.zeros((k, 6), dtype=dtype, device=device)
    if k < 2:
        return diag, torch.zeros((0, 6, 6), dtype=dtype, device=device), rhs, diag.sum()
    Ti, Tj = _row(poses, slice(None, -1)), _row(poses, slice(1, None))
    r, (Ji, Jj) = _linearize(lambda xi_i, xi_j: _between_residual(xi_i, xi_j, Ti, Tj, odo), 2,
                             k - 1, dtype, device)
    w = weight[:, None, None]
    Jit, Jjt = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    diag[:-1] += w * (Jit @ Ji)
    diag[1:] += w * (Jjt @ Jj)
    rhs[:-1] += -weight[:, None] * _tmatvec(Ji, r)
    rhs[1:] += -weight[:, None] * _tmatvec(Jj, r)
    return diag, w * (Jit @ Jj), rhs, torch.sum(weight * torch.sum(r * r, dim=-1))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for a 6x6 A, without ``torch.linalg.solve``'s check of the
    factorization, which reads it back to the host (a device sync a solve
    on the card). A singular A gives non-finite values, as ``jnp.linalg.solve``."""
    return torch.linalg.solve_ex(A, b)[0]


def solve_block_tridiagonal(diag: torch.Tensor, upper: torch.Tensor,
                            rhs: torch.Tensor) -> torch.Tensor:
    """Solve H x = rhs for a symmetric block-tridiagonal H in O(K) 6x6 solves
    (`pose_graph.py:123-160`): the forward sweep is exact block Gaussian
    elimination, each step the Schur complement of the eliminated node on
    its successor, then back-substitution. ``diag`` (K, 6, 6), ``upper``
    (K-1, 6, 6) = H_{i,i+1}, ``rhs`` (K, 6)."""
    k = diag.shape[0]
    Cs, gs = [diag[0]], [rhs[0]]
    for i in range(1, k):
        U = upper[i - 1]  # H_{i-1,i}
        CinvU = _solve(Cs[-1], U)
        Cs.append(diag[i] - U.T @ CinvU)
        gs.append(rhs[i] - CinvU.T @ gs[-1])
    xs = [_solve(Cs[-1], gs[-1])]
    for i in range(k - 2, -1, -1):
        xs.append(_solve(Cs[i], gs[i] - upper[i] @ xs[-1]))
    return torch.stack(xs[::-1])


def _residual_norm(P: se3.SE3, odo_meas: se3.SE3, abs_meas: se3.SE3,
                   abs_weight: torch.Tensor, odo_w: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(P.t.shape[:-1] + (6,), dtype=P.t.dtype, device=P.t.device)
    r_abs = _unary_residual(zero, P, abs_meas)
    r_odo = se3.log(se3.compose(se3.inverse(odo_meas), relative_measurements(P)))
    return torch.sqrt(torch.sum(abs_weight[:, None] * r_abs * r_abs)
                      + torch.sum(odo_w[:, None] * r_odo * r_odo))


def optimize(
    poses: se3.SE3,  # (K,) initial camera-to-world trajectory
    odo_meas: se3.SE3,  # (K-1,) VO relative motions
    abs_meas: se3.SE3,  # (K,) per-keyframe refined poses
    *,
    abs_weight: torch.Tensor,  # (K,) >= 0; 0 masks nodes without a measurement
    odo_weight=1.0,
    anchor_weight: float = 1e4,
    damping: float = 1e-6,
    iterations: int = 8,
) -> PoseGraphResult:
    """Gauss-Newton MAP trajectory over chain and unary factors
    (`pose_graph.py:163-216`). Node 0 also carries a prior at its initial
    value scaled by ``anchor_weight``, which fixes the gauge however many
    nodes ``abs_weight`` masks. A fixed ``iterations`` count; each step's
    system is solved by :func:`solve_block_tridiagonal`."""
    k = poses.q.shape[0]
    dtype, device = poses.q.dtype, poses.q.device
    odo_w = torch.as_tensor(odo_weight, dtype=dtype, device=device).expand(k - 1)
    abs_weight = torch.as_tensor(abs_weight, dtype=dtype, device=device)
    anchor = se3.SE3(poses.q[:1], poses.t[:1])
    anchor_w = torch.full((1,), anchor_weight, dtype=dtype, device=device)
    eye = torch.eye(6, dtype=dtype, device=device)
    P = poses
    for _ in range(iterations):
        Hd_a, b_a = absolute_blocks(P, abs_meas, abs_weight)
        Hd_anchor, b_anchor = absolute_blocks(_row(P, slice(0, 1)), anchor, anchor_w)
        Hd_o, Hu, b_o, _ = _between_blocks(P, odo_meas, odo_w)
        diag = Hd_a + Hd_o
        diag[0] += Hd_anchor[0]
        diag = diag + damping * eye
        rhs = b_a + b_o
        rhs[0] += b_anchor[0]
        P = se3.compose(P, se3.exp(solve_block_tridiagonal(diag, Hu, rhs)))
    return PoseGraphResult(
        poses=P,
        residual_norm=_residual_norm(P, odo_meas, abs_meas, abs_weight, odo_w),
        initial_residual_norm=_residual_norm(poses, odo_meas, abs_meas, abs_weight, odo_w),
        iterations=iterations,
    )


def smooth_refined_trajectory(
    c2w: se3.SE3,  # (K,) VO camera-to-world keyframe poses
    corrections: se3.SE3,  # (K,) per-keyframe NID corrections (camera frame)
    *,
    converged: Optional[torch.Tensor] = None,  # (K,) bool from RefineResult
    abs_weight: float = 1.0,
    odo_weight: float = 10.0,
    iterations: int = 8,
) -> PoseGraphResult:
    """Fuse per-keyframe NID corrections into a smoothed trajectory
    (`pose_graph.py:219-249`). Measurements are ``c2w_i @ corr_i``, the
    composition order of `PointCloudProcessor.cpp:507`; refinements that did
    not converge (where ``converged`` is given) weigh 0, so those nodes ride
    the odometry chain."""
    meas = se3.compose(c2w, corrections)
    k = c2w.q.shape[0]
    w = torch.full((k,), abs_weight, dtype=c2w.q.dtype, device=c2w.q.device)
    if converged is not None:
        w = w * converged.to(device=w.device, dtype=w.dtype)
    return optimize(c2w, relative_measurements(c2w), meas, abs_weight=w,
                    odo_weight=odo_weight, iterations=iterations)
