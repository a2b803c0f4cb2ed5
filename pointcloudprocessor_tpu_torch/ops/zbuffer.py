"""Occlusion culling as a scatter-min z-buffer — fixed shapes, mask output.

Port of `pointcloudprocessor_tpu/ops/zbuffer.py`, the reference's z-buffer
depth-culling design (`view_culling.cpp:52-174`: 14x downsampled cells at
:63, 0.05 m depth epsilon at :157). It returns a mask over the ORIGINAL
point indices, which removes the reference's kd-tree re-association.

The JAX package leaves the cull to XLA (the gate, a ``.at[].min`` scatter
and a gather). On CUDA tensors :func:`cull_mask_uv` is two hand-written
kernels from `csrc/zbuffer.cu` after a memset of their scratch buffer,
and nothing else on the card: ``zmin`` (the gate, the cell and the
scatter-min of each point's range key into a (W/ds)*(H/ds) key buffer; a
point that fails the gate issues nothing) and ``zbuffer_visible`` (the
same gate and cell and the depth test against its cell's minimum). The
probe's form, :func:`zmin` (cells given, any fill, an f32 buffer out; the
counterpart of the TPU kernel `tools/zbuffer_probe._zmin_kernel`), fills
the keys, scatters and decodes them in three launches, and :func:`visible`
tests given cells against such a buffer.

Dispatch goes by the tensors' device: CPU tensors take the plain twins
(:func:`zmin_plain`, :func:`visible_plain`, :func:`cull_mask_uv_plain`),
CUDA tensors the kernels (a build or launch failure raises), any other
device raises. ``launch_counts`` counts each kernel's launches.
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


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # u, v, z, rng, valid, their 5 element strides, buf, vis, n, width,
    # height, ds, eps, stream
    "cull_mask": ([_PTR] * 5 + [_I64] * 5 + [_PTR] * 2 + [_I32] * 4 + [_F32, _PTR], _I32),
    # cell, rng, buf, n, n_slots, fill, stream
    "zmin": ([_PTR] * 3 + [_I32] * 2 + [_F32, _PTR], _I32),
    # ok, rng, buf, cell, vis, n, n_slots, eps, stream
    "zbuffer_visible": ([_PTR] * 5 + [_I32] * 2 + [_F32, _PTR], _I32),
}


def _lib() -> ctypes.CDLL:
    return kbuild.library("zbuffer", _SIGNATURES)


def _check_cuda(name: str, t: torch.Tensor, dtype, n: int, device, strided: bool = False) -> None:
    """``t`` (n,) of ``dtype`` on CUDA ``device``, contiguous unless ``strided``."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != (n,) or not (strided or t.is_contiguous()):
        raise ValueError(f"{name} must be {'' if strided else 'contiguous '}of shape ({n},), "
                         f"got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def grid(camera, downsample_factor: int) -> tuple[int, int]:
    """(cells a row, rows) of the z-buffer: the image cut into ds x ds
    cells, the partial last row and column dropped."""
    ds = int(downsample_factor)
    if ds < 1 or camera.width // ds < 1 or camera.height // ds < 1:
        raise ValueError(f"downsample_factor {ds} leaves no cell of a "
                         f"{camera.width}x{camera.height} image")
    return camera.width // ds, camera.height // ds


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
    grid_w, grid_h = grid(camera, ds)
    ok = valid & (z > 0.0) & cam.in_image_uv(camera, u, v)
    # An IEEE division on every device: torch divides a CUDA tensor by a
    # Python number as a product with its reciprocal, which near a cell's
    # edge rounds to the cell before.
    div = torch.full((), ds, dtype=u.dtype, device=u.device)
    ui = torch.clamp(to_int32(u / div), 0, grid_w - 1)
    vi = torch.clamp(to_int32(v / div), 0, grid_h - 1)
    return ok, torch.where(ok, vi * grid_w + ui, grid_w * grid_h), grid_w * grid_h


def depth_buffer_plain(camera, u, v, z, rng, valid, ds: int):
    """(ok, cell, buf): each point's gate and cell (:func:`cells`) and the
    (n_cells + 1,) buffer of each cell's minimum range over the points it
    gates in (f32 max where none; the sink cell last), by
    :func:`zmin_plain` (``scatter_reduce_(..., "amin")``)."""
    ok, cell, n_cells = cells(camera, u, v, z, valid, ds)
    big = torch.finfo(rng.dtype).max
    return ok, cell, zmin_plain(cell, torch.where(ok, rng, big), big, n_cells + 1)


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
    """The twin of :func:`cull_mask_uv` on any device: :func:`depth_buffer_plain`
    and :func:`visible_plain` (a gather and the depth test)."""
    ok, cell, buf = depth_buffer_plain(camera, u, v, z, rng, valid, int(downsample_factor))
    return visible_plain(ok, rng, buf, cell, depth_epsilon)


def cull_mask_uv_cuda(camera, u, v, z, rng, valid, downsample_factor: int = 14,
                      depth_epsilon: float = 0.05) -> torch.Tensor:
    """The cull on the card: a memset of a (W/ds)*(H/ds) key buffer, then
    ``zmin`` and ``zbuffer_visible``, one launch each, reading u, v, z, rng
    (f32) and valid (bool) through their strides."""
    n = rng.shape[0] if rng.dim() == 1 else -1
    dev = rng.device
    for name, t, dtype in (("u", u, torch.float32), ("v", v, torch.float32),
                           ("z", z, torch.float32), ("rng", rng, torch.float32),
                           ("valid", valid, torch.bool)):
        _check_cuda(name, t, dtype, n, dev, strided=True)
    gw, gh = grid(camera, downsample_factor)
    if n >= 2**31 or gw * gh >= 2**31:
        raise ValueError(f"cull_mask_uv: {n} points / {gw * gh} cells out of range")
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return vis
    buf = torch.empty((gw * gh,), dtype=torch.int32, device=dev)
    err = _lib().cull_mask(
        u.data_ptr(), v.data_ptr(), z.data_ptr(), rng.data_ptr(), valid.data_ptr(),
        u.stride(0), v.stride(0), z.stride(0), rng.stride(0), valid.stride(0),
        buf.data_ptr(), vis.data_ptr(), n, camera.width, camera.height,
        int(downsample_factor), float(depth_epsilon), _stream(rng))
    if err != 0:
        raise RuntimeError(f"cull_mask launch failed: CUDA error {err}")
    launch_counts["zmin"] += 1
    launch_counts["zbuffer_visible"] += 1
    return vis


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

    CPU tensors take :func:`cull_mask_uv_plain`; CUDA tensors
    :func:`cull_mask_uv_cuda` (a memset and two launches); any other
    device raises. Both give the same mask bit for bit: a minimum does not
    depend on order, and both store a -0.0 range as +0.0 (a culled range, a
    square root of a sum of squares, is never -0.0 anyway)."""
    dev = rng.device.type
    if dev == "cpu":
        return cull_mask_uv_plain(camera, u, v, z, rng, valid, downsample_factor, depth_epsilon)
    if dev == "cuda":
        return cull_mask_uv_cuda(camera, u, v, z, rng, valid, downsample_factor, depth_epsilon)
    raise NotImplementedError(f"cull_mask_uv: no kernel for device {rng.device}")


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
