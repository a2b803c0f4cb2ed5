"""Occlusion culling as a scatter-min z-buffer — fixed shapes, mask output.

Port of `pointcloudprocessor_tpu/ops/zbuffer.py`, the reference's z-buffer
depth-culling design (`view_culling.cpp:52-174`: 14x downsampled cells at
:63, 0.05 m depth epsilon at :157). It returns a mask over the ORIGINAL
point indices, which removes the reference's kd-tree re-association.

The JAX package leaves the cull to XLA (a ``.at[].min`` scatter and a
gather). Here it runs as two hand-written CUDA kernels from
`csrc/zbuffer.cu`: ``zmin``, the scatter-min into a (W/ds)*(H/ds)+1 buffer
whose last cell is a sink for invalid points (the counterpart of the TPU
kernel `tools/zbuffer_probe._zmin_kernel` as well), and
``zbuffer_visible``, the cell-min gather fused with the depth test.

Dispatch goes by the tensors' device: CPU tensors take the plain twins
(:func:`zmin_plain`, :func:`cull_mask_uv_plain`), CUDA tensors the kernels
(a build or launch failure raises), any other device raises.
``launch_counts`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import se3
from ..kernels import build as kbuild
from ..models import camera as cam
from ..utils.numeric import to_int32

# Launches of each CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"zmin": 0, "zbuffer_visible": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # cell, rng, buf, n, n_slots, fill, stream
    "zmin": ([_PTR] * 3 + [_I32] * 2 + [_F32, _PTR], _I32),
    # ok, rng, buf, cell, vis, n, n_slots, eps, stream
    "zbuffer_visible": ([_PTR] * 5 + [_I32] * 2 + [_F32, _PTR], _I32),
}


def _lib() -> ctypes.CDLL:
    return kbuild.library("zbuffer", _SIGNATURES)


def _check_cuda(name: str, t: torch.Tensor, dtype, n: int, device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape ({n},), got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The scatter-min (K5 / Z1)
# ---------------------------------------------------------------------------


def zmin_plain(cell: torch.Tensor, rng: torch.Tensor, fill: float, n_slots: int) -> torch.Tensor:
    """The twin: (n_slots,) buffer = ``fill``, lowered to the minimum
    ``rng`` of the points of each cell; cells outside [0, n_slots) are
    dropped (XLA's ``mode="drop"``): they go to an extra slot that is cut
    off, so nothing waits on the host. -0.0 counts as +0.0 (adding +0.0
    turns it into +0.0), so the buffer never holds -0.0 and the kernel,
    which does the same, agrees with it bit for bit on any non-NaN input."""
    idx = torch.where((cell >= 0) & (cell < n_slots), cell, n_slots).long()
    buf = torch.full((n_slots + 1,), fill + 0.0, dtype=rng.dtype, device=rng.device)
    buf.scatter_reduce_(0, idx, rng + 0.0, reduce="amin", include_self=True)
    return buf[:n_slots]


def zmin_cuda(cell: torch.Tensor, rng: torch.Tensor, fill: float, n_slots: int) -> torch.Tensor:
    """``zmin`` on the card; same contract as :func:`zmin_plain`."""
    n = cell.shape[0] if cell.dim() == 1 else -1
    _check_cuda("cell", cell, torch.int32, n, cell.device)
    _check_cuda("rng", rng, torch.float32, n, cell.device)
    if not 1 <= n_slots < 2**31 or n >= 2**31:
        raise ValueError(f"zmin: {n} points / {n_slots} slots out of range")
    buf = torch.empty((n_slots,), dtype=torch.float32, device=cell.device)
    err = _lib().zmin(cell.data_ptr(), rng.data_ptr(), buf.data_ptr(), n, n_slots,
                      float(fill), _stream(cell))
    if err != 0:
        raise RuntimeError(f"zmin launch failed: CUDA error {err}")
    launch_counts["zmin"] += 1
    return buf


def zmin(cell: torch.Tensor, rng: torch.Tensor, fill: float, n_slots: int) -> torch.Tensor:
    """(n_slots,) f32 scatter-min of ``rng`` at ``cell`` over a ``fill``ed
    buffer: the twin on CPU tensors, the kernel on CUDA ones."""
    dev = rng.device.type
    if dev == "cpu":
        return zmin_plain(cell, rng, fill, n_slots)
    if dev == "cuda":
        return zmin_cuda(cell, rng, fill, n_slots)
    raise NotImplementedError(f"zmin: no kernel for device {rng.device}")


def visible_plain(ok, rng, buf, cell, depth_epsilon: float) -> torch.Tensor:
    """The twin of ``zbuffer_visible``: ``ok & (rng <= buf[cell] + eps)``
    (cells inside the buffer)."""
    return ok & (rng <= buf[cell.long()] + depth_epsilon)


def visible_cuda(ok, rng, buf, cell, depth_epsilon: float) -> torch.Tensor:
    """``zbuffer_visible`` on the card: ``ok & (rng <= buf[cell] + eps)``
    in f32 (false where ``cell`` is outside the buffer)."""
    n = cell.shape[0] if cell.dim() == 1 else -1
    _check_cuda("ok", ok, torch.bool, n, cell.device)
    _check_cuda("rng", rng, torch.float32, n, cell.device)
    _check_cuda("cell", cell, torch.int32, n, cell.device)
    _check_cuda("buf", buf, torch.float32, buf.shape[0], cell.device)
    vis = torch.empty((n,), dtype=torch.bool, device=cell.device)
    err = _lib().zbuffer_visible(ok.data_ptr(), rng.data_ptr(), buf.data_ptr(), cell.data_ptr(),
                                 vis.data_ptr(), n, buf.shape[0], float(depth_epsilon),
                                 _stream(cell))
    if err != 0:
        raise RuntimeError(f"zbuffer_visible launch failed: CUDA error {err}")
    launch_counts["zbuffer_visible"] += 1
    return vis


def visible(ok, rng, buf, cell, depth_epsilon: float) -> torch.Tensor:
    """(N,) bool depth test against the cell minima: the twin on CPU
    tensors, the kernel on CUDA ones."""
    dev = rng.device.type
    if dev == "cpu":
        return visible_plain(ok, rng, buf, cell, depth_epsilon)
    if dev == "cuda":
        return visible_cuda(ok, rng, buf, cell, depth_epsilon)
    raise NotImplementedError(f"zbuffer_visible: no kernel for device {rng.device}")


# ---------------------------------------------------------------------------
# The cull (Z1)
# ---------------------------------------------------------------------------


def cells(camera, u, v, z, valid, ds: int):
    """(ok, cell, n_cells): the gate z > 0 (:76-80), in image (:90-94), and
    each point's cell of the ds-downsampled grid. A point that fails the
    gate goes to the sink cell ``n_cells``, so it never shadows a real one."""
    grid_w = camera.width // ds
    grid_h = camera.height // ds
    ok = valid & (z > 0.0) & cam.in_image_uv(camera, u, v)
    ui = torch.clamp(to_int32(u / ds), 0, grid_w - 1)
    vi = torch.clamp(to_int32(v / ds), 0, grid_h - 1)
    return ok, torch.where(ok, vi * grid_w + ui, grid_w * grid_h), grid_w * grid_h


def cull_mask_uv_plain(
    camera: cam.PinholeCamera,
    u: torch.Tensor,
    v: torch.Tensor,
    z: torch.Tensor,
    rng: torch.Tensor,
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> torch.Tensor:
    """The twin of :func:`cull_mask_uv` on any device: :func:`zmin_plain`
    (``scatter_reduce_(..., "amin")``) and :func:`visible_plain` (a gather
    and the depth test)."""
    ok, cell, n_cells = cells(camera, u, v, z, valid, int(downsample_factor))
    big = torch.finfo(rng.dtype).max
    buf = zmin_plain(cell, torch.where(ok, rng, big), big, n_cells + 1)
    return visible_plain(ok, rng, buf, cell, depth_epsilon)


def cull_mask_uv(
    camera: cam.PinholeCamera,
    u: torch.Tensor,  # (N,) pixel u of each point
    v: torch.Tensor,  # (N,) pixel v
    z: torch.Tensor,  # (N,) camera-frame depth
    rng: torch.Tensor,  # (N,) camera-frame range |p|
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> torch.Tensor:
    """Visibility mask from per-point projections (`view_culling.cpp:52-174`):
    z > 0, in image, then keep points whose range is within
    ``depth_epsilon`` of their cell's minimum.

    CPU tensors take :func:`cull_mask_uv_plain`; CUDA tensors the kernels
    ``zmin`` and ``zbuffer_visible``; any other device raises. Both give
    the same mask bit for bit: a minimum does not depend on order, and both
    store a -0.0 range as +0.0 (a culled range, a square root of a sum of
    squares, is never -0.0 anyway)."""
    dev = rng.device.type
    if dev == "cpu":
        return cull_mask_uv_plain(camera, u, v, z, rng, valid, downsample_factor, depth_epsilon)
    if dev != "cuda":
        raise NotImplementedError(f"cull_mask_uv: no kernel for device {rng.device}")
    ok, cell, n_cells = cells(camera, u, v, z, valid, int(downsample_factor))
    rng = rng.to(torch.float32).contiguous()
    big = torch.finfo(torch.float32).max
    buf = zmin_cuda(cell, torch.where(ok, rng, big), big, n_cells + 1)
    return visible_cuda(ok, rng, buf, cell, depth_epsilon)


def cull_mask(
    camera: cam.PinholeCamera,
    points_camera: torch.Tensor,
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> torch.Tensor:
    """Visibility mask for camera-frame points (N, 3) (see :func:`cull_mask_uv`)."""
    u, v = cam.project_uv(camera, points_camera)
    x, y, z = points_camera.unbind(-1)
    rng = torch.sqrt(x * x + y * y + z * z)
    return cull_mask_uv(camera, u, v, z, rng, valid, downsample_factor, depth_epsilon)


def cull_world_points(
    camera: cam.PinholeCamera,
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform world points into the camera frame and cull; returns
    (points_camera, visibility_mask) (`PointCloudProcessor.cpp:186-207`)."""
    pts_cam = se3.transform_points(T_camera_world, points_world)
    mask = cull_mask(camera, pts_cam, valid, downsample_factor, depth_epsilon)
    return pts_cam, mask
