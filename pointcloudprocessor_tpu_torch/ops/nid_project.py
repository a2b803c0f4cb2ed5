"""NID projection chain: CUDA kernels P1/P2 and the plain adjoint.

One NID evaluation's per-point work outside the histogram kernels: the
pose applied to every keyframe's points, the plumb_bob projection, the
knots, the inlier gate, the fractional offsets ``s``, the intensity bins,
the point-bin marginal and, for the frozen-tap cache, the guard's counts
(``opt/nid.project_points_plain`` is that chain in eager torch, the twin).
On the card it is two hand-written kernels in `csrc/nid_project.cu`:

* P1 ``nid_project_fwd`` reads each point once (xyz, intensity, valid, and
  the cache's knot and gate where given) and writes ``s``, the knots, the
  gate and the bins, bit-equal to the eager chain; per keyframe it reduces
  the point-bin histogram and its count, and over all keyframes the guard's
  three counts. One launch.
* P2 ``nid_project_bwd`` takes ``ds`` (K2's output) back to the pose: it
  recomputes each point's camera-frame position and projection Jacobian and
  reduces dL/dq and dL/dt for each row of the pose table. One launch.

:class:`ProjectPoints` wires them as one ``torch.autograd.Function`` whose
differentiable inputs are the pose's quaternion (R, 4) and translation
(R, 3), R = 1 (one correction for every keyframe) or K (a correction a
keyframe); autograd goes on only over the pose's few numbers.
:func:`project_bwd_plain` is P2's arithmetic in torch, which the tests hold
to autograd through the eager chain. ``launch_counts`` counts each
kernel's launches, ``kernels.build.launch_shapes`` the same by points a
keyframe.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..kernels import build as kbuild
from ..models import camera as cam

launch_counts = {"nid_project_fwd": 0, "nid_project_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    kbuild.reset_launch_shapes(launch_counts)


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, t, intrinsic, distortion, points, intensity, valid, ref_knot, gate, s, knot,
    # inl, bin, hist_points, num, counts, acc, totals, arrive; thr; pose_rows, K, N,
    # width, height, bins, guard, per_kf, ppb; stream
    "nid_project_fwd": ([_PTR] * 19 + [_F32] + [_I32] * 9 + [_PTR], _I32),
    # ds, q, t, intrinsic, distortion, points, ref_knot, partial, kf_sums, arrive, dq,
    # dt; pose_rows, K, N, per_kf, ppb; stream
    "nid_project_bwd": ([_PTR] * 12 + [_I32] * 5 + [_PTR], _I32),
}
_fns: dict = {}


def _fn(name: str):
    if name not in _fns:
        _fns[name] = getattr(kbuild.library("nid_project", _SIGNATURES), name)
    return _fns[name]


# Launch geometry (csrc/nid_project.cu): a block of 256 threads walks ``ppb``
# consecutive points of one keyframe, one a thread a step; ``per_kf``
# blocks cover a keyframe. Both kernels only stream, so the grid aims at 8
# blocks on each of the H100's 132 SMs for any (K, N), the coarse shape
# (64 x 16,384) as the fine one (64 x 262,144), and gives a block at least
# one step of work.
THREADS = 256
TARGET_BLOCKS = 8 * 132
MIN_POINTS_PER_BLOCK = THREADS
MAX_BINS = 16
ACC = MAX_BINS + 1  # per keyframe: the point-bin counts, then the gate's


def grid(k: int, n: int) -> tuple[int, int]:
    """(per_kf, ppb): blocks a keyframe and points a block of P1/P2 for K
    keyframes of N points; block bx of a keyframe takes its points
    [bx * ppb, min(N, (bx + 1) * ppb)), each block at least one."""
    per_kf = max(1, min(-(-TARGET_BLOCKS // k), -(-n // MIN_POINTS_PER_BLOCK)))
    ppb = -(-n // per_kf)
    return -(-n // ppb), ppb


class Projected(NamedTuple):
    """What an evaluation takes from its points: ``s`` (K, N, 2) f32, the
    only output with a gradient; ``knot`` (K, N, 2) int32; ``inlier`` (K, N)
    f32 0/1, the point's own gate; ``bin_pts`` (K, N) int32; ``hist_points``
    (K, bins) f32 and ``num`` (K,) f32, the point-bin histogram and count
    under the histogram's gate; ``counts`` (3,) int64, the frozen-tap
    guard's (care, drifted past the margin, by one pixel more), or None."""

    s: torch.Tensor
    knot: torch.Tensor
    inlier: torch.Tensor
    bin_pts: torch.Tensor
    hist_points: torch.Tensor
    num: torch.Tensor
    counts: Optional[torch.Tensor]


# Scratch, allocated once per (device, stream, K, N) and left zeroed by each
# launch where it must be: P1's keyframe totals, guard totals and arrival
# counters, P2's block partials, keyframe sums and arrival counters. One
# stream's launches run in order, so they share them.
_scratch_cache: dict = {}
_SCRATCH_KEYS = 16


def _scratch(device: torch.device, stream: int, k: int, n: int):
    key = (device, stream, k, n)
    buf = _scratch_cache.get(key)
    if buf is None:
        if len(_scratch_cache) >= _SCRATCH_KEYS:
            _scratch_cache.clear()
        per_kf, _ = grid(k, n)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        buf = _scratch_cache[key] = {
            "acc": zeros(k, ACC), "totals": zeros(3, dtype=torch.int64),
            "fwd_arrive": zeros(k + 1), "partial": zeros(k, per_kf, 12, dtype=torch.float32),
            "kf_sums": zeros(k, 12, dtype=torch.float32), "bwd_arrive": zeros(k + 1),
        }
    return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _check(points, intensity, valid, q, t, ref_knot, gate, bins):
    """P1/P2's argument checks; they raise before any launch."""
    dev = points.device
    if dev.type != "cuda" or points.dtype != torch.float32 or points.dim() != 3 \
            or points.shape[2] != 3:
        raise ValueError(f"points must be (K, N, 3) float32 on CUDA, got {tuple(points.shape)} "
                         f"{points.dtype} on {dev}")
    k, n = points.shape[:2]
    if not (1 <= k <= 65_535 and 1 <= n < 2**31 // 3):
        raise ValueError(f"(K, N) = ({k}, {n}) outside the kernels' range")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}] (4-bit taps), got {bins}")
    for name, x, dtype in (("intensity", intensity, torch.float32), ("valid", valid, torch.bool),
                           ("gate", gate, torch.float32)):
        if x is not None and (x.device != dev or x.dtype != dtype or x.shape != (k, n)):
            raise ValueError(f"{name} must be ({k}, {n}) {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if ref_knot is not None and (ref_knot.device != dev or ref_knot.dtype != torch.int32
                                 or ref_knot.shape != (k, n, 2)):
        raise ValueError(f"ref_knot must be ({k}, {n}, 2) int32 on {dev}")
    rows = q.shape[0]
    if q.shape != (rows, 4) or t.shape != (rows, 3) or rows not in (1, k):
        raise ValueError(f"the pose must be (1 or K, 4) and (1 or K, 3) for K = {k}, got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")


def project_fwd_cuda(intrinsic, distortion, width: int, height: int, q, t, points, intensity,
                     valid, bins: int, ref_knot=None, gate=None, guard_thr=None) -> Projected:
    """P1: one launch for all K keyframes (no gradient; see
    :class:`ProjectPoints`). ``ref_knot`` (the cache's knot): ``s`` is
    clamp(proj - ref_knot, -1.5, 2.5), else proj - knot. ``gate``: the
    histogram's gate, else the points' own. ``guard_thr`` (with both): the
    guard's counts at that threshold (margin + 1 px); ``counts`` is 0
    without it."""
    dev = points.device
    q, t = _f32(q, dev), _f32(t, dev)
    _check(points, intensity, valid, q, t, ref_knot, gate, bins)
    guard = guard_thr is not None
    if guard and (ref_knot is None or gate is None):
        raise ValueError("the guard's counts need the cache's knot and gate")
    points, intensity, valid = points.contiguous(), intensity.contiguous(), valid.contiguous()
    ref_knot = None if ref_knot is None else ref_knot.contiguous()
    gate = None if gate is None else gate.contiguous()
    k, n = points.shape[:2]
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_kf, ppb = grid(k, n)
    sc = _scratch(dev, stream, k, n)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Projected(empty(k, n, 2), empty(k, n, 2, dtype=torch.int32), empty(k, n),
                    empty(k, n, dtype=torch.int32), empty(k, bins), empty(k),
                    empty(3, dtype=torch.int64))
    err = _fn("nid_project_fwd")(
        q.data_ptr(), t.data_ptr(), _f32(intrinsic, dev).data_ptr(),
        _f32(distortion, dev).data_ptr(), points.data_ptr(), intensity.data_ptr(),
        valid.data_ptr(), _ptr(ref_knot), _ptr(gate), *(o.data_ptr() for o in out),
        sc["acc"].data_ptr(), sc["totals"].data_ptr(), sc["fwd_arrive"].data_ptr(),
        float(guard_thr) if guard else 0.0, q.shape[0], k, n, width, height, bins, int(guard),
        per_kf, ppb, stream)
    if err != 0:
        raise RuntimeError(f"nid_project_fwd launch failed: CUDA error {err}")
    launch_counts["nid_project_fwd"] += 1
    kbuild.launch_shapes["nid_project_fwd", n] += 1
    return out


def project_bwd_cuda(ds, intrinsic, distortion, q, t, points, ref_knot=None):
    """P2: (dq (R, 4), dt (R, 3)), the gradient of the loss with respect to
    the pose rows, from ``ds`` = dL/ds (K, N, 2); ``ref_knot`` as P1 took
    it (the clamp's mask)."""
    dev = points.device
    q, t = _f32(q, dev), _f32(t, dev)
    _check(points, None, None, q, t, ref_knot, None, 1)
    k, n = points.shape[:2]
    ds = ds.to(torch.float32).contiguous()
    if ds.shape != (k, n, 2) or ds.device != dev:
        raise ValueError(f"ds must be ({k}, {n}, 2) on {dev}")
    points = points.contiguous()
    ref_knot = None if ref_knot is None else ref_knot.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_kf, ppb = grid(k, n)
    sc = _scratch(dev, stream, k, n)
    rows = q.shape[0]
    dq = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    dt = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    err = _fn("nid_project_bwd")(
        ds.data_ptr(), q.data_ptr(), t.data_ptr(), _f32(intrinsic, dev).data_ptr(),
        _f32(distortion, dev).data_ptr(), points.data_ptr(), _ptr(ref_knot),
        sc["partial"].data_ptr(), sc["kf_sums"].data_ptr(), sc["bwd_arrive"].data_ptr(),
        dq.data_ptr(), dt.data_ptr(), rows, k, n, per_kf, ppb, stream)
    if err != 0:
        raise RuntimeError(f"nid_project_bwd launch failed: CUDA error {err}")
    launch_counts["nid_project_bwd"] += 1
    kbuild.launch_shapes["nid_project_bwd", n] += 1
    return dq, dt


class ProjectPoints(torch.autograd.Function):
    """P1 forward, P2 backward; a gradient for the pose (q, t) only."""

    @staticmethod
    def forward(ctx, q, t, camera, points, intensity, valid, bins, ref_knot, gate, guard_thr):
        out = project_fwd_cuda(camera.intrinsic, camera.distortion, camera.width,
                               camera.height, q, t, points, intensity, valid, bins, ref_knot,
                               gate, guard_thr)
        ctx.camera = camera
        # The outputs other than s take no gradient: no zeros made for them.
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, t, points, ref_knot)
        ctx.mark_non_differentiable(*out[1:])
        return tuple(out)

    @staticmethod
    def backward(ctx, ds, *_):
        q, t, points, ref_knot = ctx.saved_tensors
        if ds is None:
            return (None,) * 10
        cam = ctx.camera
        dq, dt = project_bwd_cuda(ds, cam.intrinsic, cam.distortion, q, t, points, ref_knot)
        return dq.to(q.dtype), dt.to(t.dtype), *(None,) * 8


def project(camera, q, t, points, intensity, valid, bins: int, ref_knot=None, gate=None,
            guard_thr=None) -> Projected:
    """P1 under autograd (P2 on the backward): ``q`` (R, 4), ``t`` (R, 3)
    with R = 1 or K; the other arguments as :func:`project_fwd_cuda`."""
    out = ProjectPoints.apply(q, t, camera, points, intensity, valid, bins, ref_knot, gate,
                              guard_thr)
    out = Projected(*out)
    return out if guard_thr is not None else out._replace(counts=None)


def _pose_grad_plain(g_cam: torch.Tensor, points: torch.Tensor, q: torch.Tensor):
    """P2's arithmetic after the projection, in torch: (dq (R, 4), dt (R,
    3)) from ``g_cam`` (K, N, 3), dL/d(camera-frame point), the points
    (K, N, 3) and the pose rows ``q`` (R, 4): the sums G = sum g and M =
    sum g p^T of each row, then dL/dw = 2 u.a and dL/du = 2 w a + 2 (M u +
    M^T u - 2 tr(M) u), a_j = sum_ik eps_ijk M_ik, for the point
    v + 2 w (u x v) + 2 u x (u x v) + t."""
    rows = q.shape[0]
    G = torch.sum(g_cam, dim=1)  # (K, 3)
    M = torch.einsum("kni,knc->kic", g_cam, points)  # (K, 3, 3)
    if rows == 1:
        G, M = G.sum(0, keepdim=True), M.sum(0, keepdim=True)
    w, u = q[:, :1], q[:, 1:]
    a = torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                     M[:, 1, 0] - M[:, 0, 1]], dim=-1)
    tr = M.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True)
    mu = torch.einsum("rjc,rc->rj", M, u)
    mtu = torch.einsum("rij,ri->rj", M, u)
    dw = 2.0 * torch.sum(u * a, dim=-1, keepdim=True)
    du = 2.0 * w * a + 2.0 * (mu + mtu - 2.0 * tr * u)
    return torch.cat([dw, du], dim=-1), G


def project_bwd_plain(ds, camera, q, t, points, ref_knot=None):
    """P2's twin: its arithmetic in torch, on any device. (dq (R, 4), dt
    (R, 3)) from ``ds`` (K, N, 2) through the clamp's mask (``ref_knot``),
    the projection's Jacobian at each camera-frame point (the divisor a
    constant where |z| < 1e-9, as ``camera.project_xyz``'s guard makes it)
    and :func:`_pose_grad_plain`."""
    rows = q.shape[0]
    T = se3.SE3(q, t) if rows > 1 else se3.SE3(q[0], t[0])
    c = se3.transform_points(T, points)
    z = c[..., 2]
    tiny = torch.abs(z) < 1e-9
    sz = torch.where(tiny, torch.where(z < 0, -1e-9, 1e-9), z)
    x, y = c[..., 0] / sz, c[..., 1] / sz
    gx, gy = ds[..., 0], ds[..., 1]
    if ref_knot is not None:
        u, v = cam.project_uv(camera, c)
        rx, ry = u - ref_knot[..., 0].to(u.dtype), v - ref_knot[..., 1].to(v.dtype)
        gx = torch.where((rx >= -1.5) & (rx <= 2.5), gx, 0.0)
        gy = torch.where((ry >= -1.5) & (ry <= 2.5), gy, 0.0)
    k1, k2, p1, p2, k3 = camera.distortion.unbind(0)
    fx, fy = camera.intrinsic[0], camera.intrinsic[1]
    r2 = x * x + y * y
    rc = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    drc = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r2 * r2
    jxy = 2.0 * x * y * drc + 2.0 * p1 * x + 2.0 * p2 * y
    jxx = rc + 2.0 * x * x * drc + 2.0 * p1 * y + 6.0 * p2 * x
    jyy = rc + 2.0 * y * y * drc + 6.0 * p1 * y + 2.0 * p2 * x
    gu, gv = fx * gx, fy * gy
    dx, dy = gu * jxx + gv * jxy, gu * jxy + gv * jyy
    dz = torch.where(tiny, 0.0, -(dx * x + dy * y) / sz)
    g_cam = torch.stack([dx / sz, dy / sz, dz], dim=-1)
    return _pose_grad_plain(g_cam, points, q)
