"""Plain rigid-body and pinhole arithmetic for the reference.

Written out here so that the reference imports nothing of the program under
test. The operations follow the conventions the benchmark's inputs use:
quaternions are (w, x, y, z), an SE(3) element is a pair (q, t) acting as
x -> R(q) x + t, tangents are [rho, omega], and a pinhole camera is (fx, fy,
cx, cy, width, height) with plumb_bob distortion coefficients. The op order
of each function is that of the straightforward formula, so on a device
that rounds every step (eager PyTorch) the results are reproducible.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    w = w.expand(u.shape[:-1] + (1,))
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def compose(a, b):
    """a o b (b first) of (q, t) pairs."""
    (aq, at), (bq, bt) = a, b
    return quat_normalize(quat_multiply(aq, bq)), quat_rotate(aq, bt) + at


def inverse(x):
    q, t = x
    qi = quat_conjugate(q)
    return qi, -quat_rotate(qi, t)


def exp(tangent: torch.Tensor):
    """SE(3) exponential of [rho, omega] in float64 on the host: the
    benchmark draws its poses with it, and the exact branch is accurate
    there at every angle it draws."""
    x = tangent.to(torch.float64)
    rho, omega = x[..., :3], x[..., 3:]
    theta = torch.linalg.norm(omega, dim=-1)
    half = 0.5 * theta
    safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    sinc_half = torch.where(theta > 0, torch.sin(half) / safe, 0.5 - theta * theta / 48.0)
    q = torch.cat([torch.cos(half)[..., None], omega * sinc_half[..., None]], dim=-1)
    wx, wy, wz = omega.unbind(-1)
    z = torch.zeros_like(wx)
    W = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], -1).reshape(omega.shape[:-1] + (3, 3))
    t2 = safe * safe
    a = torch.where(theta > 0, (1.0 - torch.cos(theta)) / t2, 0.5 - theta * theta / 24.0)
    b = torch.where(theta > 0, (theta - torch.sin(theta)) / (t2 * safe),
                    1.0 / 6.0 - theta * theta / 120.0)
    eye = torch.eye(3, dtype=x.dtype).expand(W.shape)
    V = eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
    return quat_normalize(q), (V @ rho[..., :, None])[..., 0]


def pose_error(q: torch.Tensor, t: torch.Tensor) -> tuple[float, float]:
    """(translation in cm, rotation in degrees) of a correction against the
    identity, in float64."""
    q = q.detach().to("cpu", torch.float64)
    t = t.detach().to("cpu", torch.float64)
    # atan2 of the vector part's norm and |w|: accurate at small angles,
    # where arccos(w) of a float32 w is not.
    angle = 2.0 * torch.atan2(torch.linalg.norm(q[1:]), torch.abs(q[0]))
    return float(torch.linalg.norm(t)) * 100.0, float(torch.rad2deg(angle))


def transform_xyz(R: torch.Tensor, t: torch.Tensor, x, y, z):
    """R (3, 3) and t (3,) applied to coordinate arrays, term by term."""
    cx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    cy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    cz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return cx, cy, cz


def project_xyz(intrinsic: torch.Tensor, distortion: torch.Tensor, px, py, pz):
    """Pinhole projection with plumb_bob distortion (`pinhole.hpp:13-51`):
    divide by z (kept away from 0), distort, apply K."""
    tiny = torch.where(pz < 0, -1e-9, 1e-9).to(pz.dtype)
    safe_z = torch.where(torch.abs(pz) < 1e-9, tiny, pz)
    x = px / safe_z
    y = py / safe_z
    k1, k2, p1, p2, k3 = distortion.to(px.dtype).unbind(0)
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = r_coeff * x + p1 * (2.0 * xy) + p2 * (r2 + 2.0 * x2)
    yd = r_coeff * y + p1 * (r2 + 2.0 * y2) + p2 * (2.0 * xy)
    fx, fy, cx, cy = intrinsic.to(px.dtype).unbind(0)
    return fx * xd + cx, fy * yd + cy


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32, truncating toward zero and saturating; NaN -> 0."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0)
    above = x >= 2147483648.0
    out = torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(above, 2147483647, out)


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division (a Python divisor of a CUDA tensor would
    multiply by its reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
