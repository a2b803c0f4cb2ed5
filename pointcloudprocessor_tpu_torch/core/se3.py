"""SE(3) / quaternion math as batched torch functions.

PyTorch port of `pointcloudprocessor_tpu/core/se3.py` (the reference's
Sophus::SE3d usage, `visual_camera_calibration.cpp:151`, and the slerp of
`scripts/pose_interp.py:66-88`). Same conventions:

* quaternions are ``(w, x, y, z)``;
* an SE(3) element is the pair ``(q, t)``, batched over leading dims;
* tangent vectors are ``[rho, omega]`` (translation first, Sophus order).

Every function is differentiable with autograd and runs on the device of
its inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.profiling import to_device

_EPS = 1e-8


@dataclass
class SE3:
    """A (batch of) rigid transform(s): ``x -> R(q) @ x + t``.

    Attributes:
        q: (..., 4) unit quaternion(s), (w, x, y, z).
        t: (..., 3) translation(s).
    """

    q: torch.Tensor
    t: torch.Tensor

    def to(self, device) -> "SE3":
        return SE3(self.q.to(device), self.t.to(device))


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * to_device([1.0, -1.0, -1.0, -1.0], q.device, q.dtype)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    w = w.expand(u.shape[:-1] + (1,))
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion (branch-free
    Shepperd extraction: all four candidates, keep the best-conditioned)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(qs, -2, idx)[..., 0, :])


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians, in [0, pi]) of quaternion(s)."""
    w = torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0)
    return 2.0 * torch.arccos(w)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Spherical linear interpolation with the branch structure of
    `scripts/pose_interp.py:66-88` (linear when dot >= 1; the q1
    coefficient negated when dot < 0)."""
    d = torch.sum(q0 * q1, dim=-1)
    theta = torch.arccos(torch.clamp(torch.abs(d), 0.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    lin = d >= 1.0
    denom = torch.clamp(sin_theta, min=_EPS)
    s0 = torch.where(lin, 1.0 - frac, torch.sin((1.0 - frac) * theta) / denom)
    s1 = torch.where(lin, frac, torch.sin(frac * theta) / denom)
    s1 = torch.where(d < 0.0, -s1, s1)
    return s0[..., None] * q0 + s1[..., None] * q1


# ---------------------------------------------------------------------------
# SE(3) group ops
# ---------------------------------------------------------------------------


def identity(device, dtype=torch.float32, batch_shape=()) -> SE3:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return SE3(q, torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))


def from_qt(q_wxyz: torch.Tensor, t: torch.Tensor) -> SE3:
    return SE3(quat_normalize(q_wxyz), t)


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b (apply b first, then a) — `t_c2w * T_correction` at
    `PointCloudProcessor.cpp:507`."""
    return SE3(quat_normalize(quat_multiply(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(x: SE3) -> SE3:
    qinv = quat_conjugate(x.q)
    return SE3(qinv, -quat_rotate(qinv, x.t))


def transform_points(x: SE3, points: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) to points (..., 3); a batched transform (K,)
    applies to points (K, N, 3) keyframe by keyframe."""
    q = x.q[..., None, :] if x.q.ndim == points.ndim - 1 else x.q
    t = x.t[..., None, :] if x.t.ndim == points.ndim - 1 else x.t
    return quat_rotate(q, points) + t


def transform_xyz(T: SE3, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Apply one transform to points given as separate coordinate arrays
    (the JAX package's hot-path form, kept so both packages round alike)."""
    R = quat_to_matrix(T.q)
    cx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + T.t[0]
    cy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + T.t[1]
    cz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + T.t[2]
    return cx, cy, cz


def matrix(x: SE3) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(x.q)
    top = torch.cat([R, x.t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=x.t.dtype, device=x.t.device)
    bottom = bottom.expand(x.t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: torch.Tensor) -> SE3:
    return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def _skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1).reshape(
        w.shape[:-1] + (3, 3)
    )


def exp(tangent: torch.Tensor) -> SE3:
    """SE(3) exponential map of ``[rho, omega]``.

    Wide Taylor window (theta < 0.1 rad) as in the JAX package: the exact
    branch's 1-cos(theta) cancels catastrophically in f32 below it. Do not
    tighten. The unselected `where` branch is still evaluated and
    differentiated, so its denominators are clamped away from zero."""
    return SE3(*_exp_terms(tangent)[:2])


def _exp_terms(tangent: torch.Tensor):
    """(q, t, terms): :func:`exp` and the terms its gradient reads
    (:class:`_Perturb`)."""
    rho, omega = tangent[..., :3], tangent[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    theta4 = theta2 * theta2

    half = 0.5 * theta
    sin_half, cos_half = torch.sin(half), torch.cos(half)
    sinc_half = torch.where(
        small, 0.5 - theta2 / 48.0 + theta4 / 3840.0, sin_half / theta
    )
    qw = torch.where(small, 1.0 - theta2 / 8.0 + theta4 / 384.0, cos_half)
    qv = omega * sinc_half[..., None]
    q_raw = torch.cat([qw[..., None], qv], dim=-1)
    q_norm = torch.linalg.norm(q_raw, dim=-1, keepdim=True)
    q = q_raw / q_norm  # quat_normalize

    W = _skew(omega)
    W2 = W @ W
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = torch.where(
        small, 0.5 - theta2 / 24.0 + theta4 / 720.0, (1.0 - cos_t) / theta2_safe
    )
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta4 / 5040.0,
        (theta - sin_t) / (theta2_safe * theta),
    )
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(W.shape)
    V = eye + a[..., None, None] * W + b[..., None, None] * W2
    t = (V @ rho[..., :, None])[..., 0]
    return q, t, (theta2, small, theta2_safe, theta, sin_half, cos_half, sin_t, cos_t,
                  sinc_half, q_norm, a, b)


class _Perturb(torch.autograd.Function):
    """``T_init ∘ exp(x)`` (:func:`perturb`): the forward is :func:`exp`'s and
    :func:`compose`'s ops, op for op; the backward is their gradient with
    respect to ``x`` in closed form, a few dozen small ops in place of
    autograd's ~200 nodes over the two. In exp's Taylor window the gradient
    is that of the Taylor branch, outside it that of the closed forms, as
    autograd takes it through the ``where``."""

    @staticmethod
    def forward(ctx, x, q0, t0):
        qe, te, terms = _exp_terms(x)
        m = quat_multiply(q0, qe)
        m_norm = torch.linalg.norm(m, dim=-1, keepdim=True)
        q = m / m_norm  # compose: quat_normalize(q0 ⊗ qe)
        t = quat_rotate(q0, te) + t0
        ctx.save_for_backward(x, q0, qe, q, m_norm, *terms)
        ctx.mark_non_differentiable(te)
        return q, t, te

    @staticmethod
    def backward(ctx, gq, gt, _):
        (x, q0, qe, q, m_norm, theta2, small, t2s, theta, sin_half, cos_half, sin_t, cos_t,
         sinc_half, q_norm, a, b) = ctx.saved_tensors
        rho, omega = x[..., :3], x[..., 3:]
        w0, x0, y0, z0 = q0.unbind(-1)
        # t = R(q0) te + t0: the rotation formula at the conjugate is its transpose.
        gte = quat_rotate(torch.cat([q0[..., :1], -q0[..., 1:]], dim=-1), gt)
        # q = m / |m|, m = L(q0) qe (the Hamilton product's left matrix).
        gm = (gq - q * torch.sum(q * gq, dim=-1, keepdim=True)) / m_norm
        L = torch.stack([w0, -x0, -y0, -z0, x0, w0, -z0, y0, y0, z0, w0, -x0, z0, -y0, x0, w0],
                        dim=-1).reshape(q0.shape[:-1] + (4, 4))
        gqe = (gm[..., None, :] @ L)[..., 0, :]
        # qe = q_raw / |q_raw|, q_raw = [qw, omega sinc_half].
        g_raw = (gqe - qe * torch.sum(qe * gqe, dim=-1, keepdim=True)) / q_norm
        g_qw, g_qv = g_raw[..., 0], g_raw[..., 1:]
        # te = rho + a (omega x rho) + b (omega x (omega x rho)).
        w_rho = torch.linalg.cross(omega, rho, dim=-1)
        ww_rho = torch.linalg.cross(omega, w_rho, dim=-1)
        # d/d theta2 of qw, sinc_half, a, b on the branch exp took.
        taylor = torch.stack([-1.0 / 8.0 + theta2 / 192.0, -1.0 / 48.0 + theta2 / 1920.0,
                              -1.0 / 24.0 + theta2 / 360.0, -1.0 / 120.0 + theta2 / 2520.0],
                             dim=-1)
        h = 0.5 / theta  # d theta / d theta2
        closed = torch.stack([-0.5 * sin_half * h,
                              (0.5 * cos_half / theta - sin_half / t2s) * h,
                              sin_t * h / t2s - (1.0 - cos_t) / (t2s * t2s),
                              ((1.0 - cos_t) / (t2s * theta) - 3.0 * (theta - sin_t) / (t2s * t2s))
                              * h], dim=-1)
        d = torch.where(small[..., None], taylor, closed)
        dots = torch.stack([g_qw, torch.sum(omega * g_qv, dim=-1), torch.sum(gte * w_rho, dim=-1),
                            torch.sum(gte * ww_rho, dim=-1)], dim=-1)
        g_t2 = torch.sum(dots * d, dim=-1, keepdim=True)
        a_, b_ = a[..., None], b[..., None]
        w_g = torch.linalg.cross(omega, gte, dim=-1)
        g_rho = gte - a_ * w_g + b_ * torch.linalg.cross(omega, w_g, dim=-1)
        g_omega = (sinc_half[..., None] * g_qv + a_ * torch.linalg.cross(rho, gte, dim=-1)
                   + b_ * (rho * torch.sum(omega * gte, dim=-1, keepdim=True)
                           + torch.sum(omega * rho, dim=-1, keepdim=True) * gte
                           - 2.0 * omega * torch.sum(rho * gte, dim=-1, keepdim=True))
                   + 2.0 * omega * g_t2)
        return torch.cat([g_rho, g_omega], dim=-1), None, None


def perturb(T_init: SE3, x: torch.Tensor) -> tuple[SE3, torch.Tensor]:
    """``compose(T_init, exp(x))``, the right perturbation of a solve, and
    ``exp(x).t``. Batched as :func:`compose`: x (..., 6) against T_init
    (...). On CUDA tensors its gradient with respect to ``x`` is
    :class:`_Perturb`'s closed form (``T_init`` a constant: no gradient
    reaches it), where autograd's ~200 nodes over the two would each be a
    launch; elsewhere autograd's, through :func:`compose` and :func:`exp`."""
    if x.device.type == "cuda":
        q, t, te = _Perturb.apply(x, T_init.q.detach(), T_init.t.detach())
        return SE3(q, t), te
    step = exp(x)
    return compose(T_init, step), step.t


def log(x: SE3) -> torch.Tensor:
    """SE(3) logarithm, the inverse of :func:`exp`: (..., 6) [rho, omega].

    Written in terms of the smooth |v|^2 so it stays differentiable at the
    identity; the Taylor window is wide (theta < ~0.1 rad), as in `exp`."""
    q = quat_normalize(x.q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1)
    small = v2 < 2.5e-3
    vnorm = torch.sqrt(torch.where(small, torch.ones_like(v2), v2))
    theta = 2.0 * torch.atan2(vnorm, w)
    w_safe = torch.clamp(w, min=0.5)
    t2 = v2 / (w_safe * w_safe)
    scale = torch.where(
        small,
        (2.0 / w_safe) * (1.0 - t2 / 3.0 + t2 * t2 / 5.0),
        theta / vnorm,
    )
    omega = q[..., 1:] * scale[..., None]

    theta2 = torch.sum(omega * omega, dim=-1)
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    W = _skew(omega)
    W2 = W @ W
    theta_c = torch.sqrt(theta2_safe)
    coeff = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (
            1.0
            - theta_c * torch.sin(theta_c)
            / (2.0 * torch.clamp(1.0 - torch.cos(theta_c), min=1e-12))
        )
        / theta2_safe,
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coeff[..., None, None] * W2
    rho = (Vinv @ x.t[..., :, None])[..., 0]
    return torch.cat([rho, omega], dim=-1)


def delta_magnitudes(a: SE3, b: SE3) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation delta norm, rotation delta angle) between two
    transforms — the convergence metric of
    `visual_camera_calibration.cpp:67-72`."""
    d = compose(inverse(a), b)
    return torch.linalg.norm(d.t, dim=-1), quat_angle(d.q)


# ---------------------------------------------------------------------------
# Trajectory interpolation (pose_interp.py semantics)
# ---------------------------------------------------------------------------


def interpolate_trajectory(
    pose_times: torch.Tensor,
    quats_wxyz: torch.Tensor,
    positions: torch.Tensor,
    query_times: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interpolate a pose track at query timestamps: slerp on rotation, lerp
    on translation (`scripts/pose_interp.py:54-94`, JAX `se3.py:344-373`),
    one vectorised bracket search + slerp for all queries.

    The bracket search and the fraction run in the dtype of the times: f64
    times stay f64 (epoch timestamps near 1.6e9 s lose whole milliseconds
    in f32); the fraction is then cast to the positions' dtype. The
    fraction divides by a tensor, an IEEE division on every device.

    Args:
        pose_times: (M,) ascending timestamps of the input track.
        quats_wxyz: (M, 4) track quaternions.
        positions: (M, 3) track positions.
        query_times: (Q,) requested timestamps.

    Returns:
        (Q, 4) quaternions and (Q, 3) positions.
    """
    m = pose_times.shape[0]
    upper = torch.clamp(torch.searchsorted(pose_times, query_times, right=True), 1, m - 1)
    lower = upper - 1
    t0 = pose_times[lower]
    t1 = pose_times[upper]
    dt = torch.clamp(t1 - t0, min=_EPS)
    frac = torch.where(t1 > t0, (query_times - t0) / dt, torch.zeros_like(dt)).to(positions.dtype)
    q = quat_slerp(quats_wxyz[lower], quats_wxyz[upper], frac)
    p = (1.0 - frac)[..., None] * positions[lower] + frac[..., None] * positions[upper]
    return quat_normalize(q), p
