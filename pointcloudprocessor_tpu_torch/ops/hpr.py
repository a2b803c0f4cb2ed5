"""Hidden-point removal: Katz spherical flip + support-function hull test.

Port of `pointcloudprocessor_tpu/ops/hpr.py`, the rebuild of the
reference's ACTIVE occlusion path (`view_culling.cpp:266-334`: the flip
``p + 2*(R - |p|) * p/|p|`` at :292 with R = 90000 from `view_culling.hpp:14`,
then a qhull hull whose vertices are the visible points). A flipped point is
a hull vertex when it is the farthest flipped point along its own bearing,
so point i is visible when

    max_j <f_j, u_i> - <f_i, u_i> <= tolerance        (dense, O(N^2))

and, expanding cos(theta) to second order, when no j has
``r_j + R * theta_ij^2 < r_i - tol`` (grid, O(N)): a scatter-min of ranges
onto a G x G gnomonic grid, a separable parabolic min-convolution and one
gather a point. Both return a mask over the ORIGINAL indices.

Dispatch goes by the tensors' device: CPU tensors take the plain twins
(:func:`hpr_mask_plain`, chunked ``d @ f.T`` then ``amax`` in f32, never
TF32; :func:`hpr_mask_grid_plain`, the JAX package's ops in torch), CUDA
tensors the kernels of `csrc/hpr.cu` (H1 ``hpr_support``: two launches;
H2 ``hpr_grid``: a memset and four launches, no eager op and no host sync),
any other device raises. ``launch_counts`` counts each wrapper's calls that
launched. The grid mask equals its twin bit for bit. The dense kernel
chains its FMAs as XLA's CPU norm and dot do, so it equals the twin run on
the CPU bit for bit; the twin run on the card rounds otherwise, and a mask
bit may then differ where the margin is within a few ulp of 2R.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core import se3
from ..kernels import build as kbuild
from ..models import camera as cam
from ..utils.numeric import to_int32

DEFAULT_RADIUS = 90000.0  # view_culling.hpp:14

# Launches of each CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"hpr_support": 0, "hpr_grid": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, y, z, valid, their 4 strides, f, u, poison, vis, n, radius, tol, stream
    "hpr_support": ([_PTR] * 4 + [_I64] * 4 + [_PTR] * 4 + [_I32] + [_F32] * 2 + [_PTR], _I32),
    # x, y, z, valid, their 4 strides, scratch, eroded, vis, n, grid, window, radius, tol, stream
    "hpr_grid": ([_PTR] * 4 + [_I64] * 4 + [_PTR] * 3 + [_I32] * 3 + [_F32] * 2 + [_PTR], _I32),
}
MAX_WINDOW = 31  # the erosion's tile with its halo in 48 KB of shared memory (csrc/hpr.cu)


def _lib() -> ctypes.CDLL:
    return kbuild.library("hpr", _SIGNATURES)


def _columns(points_camera: torch.Tensor, valid: torch.Tensor):
    """(x, y, z, valid, n) views for a kernel, checked: points (N, 3) f32
    and valid (N,) bool on one CUDA device, any strides."""
    dev = points_camera.device
    if dev.type != "cuda" or valid.device != dev:
        raise ValueError(f"hpr: points and valid must be on one CUDA device, got {dev} / "
                         f"{valid.device}")
    if points_camera.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"hpr: points must be float32 and valid bool, got "
                        f"{points_camera.dtype} / {valid.dtype}")
    n = points_camera.shape[0]
    if points_camera.dim() != 2 or points_camera.shape[1] != 3 or tuple(valid.shape) != (n,):
        raise ValueError(f"hpr: points (N, 3) and valid (N,), got {tuple(points_camera.shape)} / "
                         f"{tuple(valid.shape)}")
    if n >= 2**31:
        raise ValueError(f"hpr: {n} points out of range")
    x, y, z = points_camera.unbind(-1)
    return x, y, z, valid, n


def _strided_args(x, y, z, valid):
    return (x.data_ptr(), y.data_ptr(), z.data_ptr(), valid.data_ptr(),
            x.stride(0), y.stride(0), z.stride(0), valid.stride(0))


def spherical_flip(points: torch.Tensor, radius: float = DEFAULT_RADIUS) -> torch.Tensor:
    """Katz spherical flip p -> p + 2*(R - |p|) * p/|p| (view_culling.cpp:292).
    A point at the origin maps to the origin (it stays hidden)."""
    r = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe = torch.clamp(r, min=1e-12)
    return points * ((2.0 * radius - r) / safe)


# ---------------------------------------------------------------------------
# H1: the dense support test
# ---------------------------------------------------------------------------


def hpr_support_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                      radius: float = DEFAULT_RADIUS, chunk: int = 4096,
                      rows: torch.Tensor | None = None):
    """(ok, support, self_support): the twin's pieces of the dense test.
    support_i = max_j <f_j, d_i> over the flipped points f (0 where not
    ok) and the bearings d (0 where not ok), as chunked f32 products
    ``d @ f.T`` and ``amax`` (the caller keeps TF32 off); self_support =
    2R - r. With ``rows``, only those directions i (all three outputs
    indexed by ``rows``).

    On the CPU this is the JAX package's arithmetic bit for bit (the norm
    and the matmul both chain FMAs as XLA's do); on the card torch's norm
    and cuBLAS round otherwise, and supports drift by a few ulp of 2R."""
    # vector_norm on the CPU is sqrt(fma(z, z, fma(y, y, x * x))), as XLA
    # computes jnp.linalg.norm (an explicit sum of squares differs in ~10%
    # of the ranges' last bit).
    r = torch.linalg.vector_norm(points_camera, dim=-1)
    ok = valid & (r > 1e-9)
    u = points_camera / torch.clamp(r, min=1e-12)[:, None]
    flipped = torch.where(ok[:, None], u * (2.0 * radius - r)[:, None], 0.0)
    dirs = torch.where(ok[:, None], u, 0.0)
    self_support = 2.0 * radius - r
    if rows is not None:
        dirs, ok, self_support = dirs[rows], ok[rows], self_support[rows]
    m = dirs.shape[0]
    support = torch.empty((m,), dtype=points_camera.dtype, device=points_camera.device)
    ft = flipped.T.contiguous()
    for s in range(0, m, chunk):
        support[s: s + chunk] = torch.amax(dirs[s: s + chunk] @ ft, dim=1)
    return ok, support, self_support


def hpr_mask_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                   radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                   chunk: int = 4096) -> torch.Tensor:
    """The twin of the dense test: ``ok & (support - self_support <= tol)``."""
    ok, support, self_support = hpr_support_plain(points_camera, valid, radius, chunk)
    return ok & (support - self_support <= tolerance)


def hpr_mask_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                  radius: float = DEFAULT_RADIUS, tolerance: float = 0.05) -> torch.Tensor:
    """H1 on the card: the dense test in two launches (flip, support and
    test), no (N, N) matrix."""
    x, y, z, valid, n = _columns(points_camera, valid)
    dev = points_camera.device
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return vis
    fu = torch.empty((2, n, 4), dtype=torch.float32, device=dev)
    poison = torch.empty((1,), dtype=torch.int32, device=dev)
    err = _lib().hpr_support(*_strided_args(x, y, z, valid), fu[0].data_ptr(), fu[1].data_ptr(),
                             poison.data_ptr(), vis.data_ptr(), n, float(radius),
                             float(tolerance), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hpr_support launch failed: CUDA error {err}")
    launch_counts["hpr_support"] += 1
    return vis


def hpr_mask(points_camera: torch.Tensor, valid: torch.Tensor,
             radius: float = DEFAULT_RADIUS, tolerance: float = 0.05) -> torch.Tensor:
    """Visibility mask of camera-frame points (N, 3) by the dense
    spherical-flip support test (hpr.py:57-123): point i is visible when it
    is ok (valid, r > 1e-9) and ``max_j <f_j, u_i> - (2R - r_i) <=
    tolerance``. The twin on CPU tensors, H1 on CUDA ones."""
    dev = points_camera.device.type
    if dev == "cpu":
        return hpr_mask_plain(points_camera, valid, radius, tolerance)
    if dev == "cuda":
        return hpr_mask_cuda(points_camera, valid, radius, tolerance)
    raise NotImplementedError(f"hpr_mask: no kernel for device {points_camera.device}")


# ---------------------------------------------------------------------------
# H2: the grid parabolic z-buffer
# ---------------------------------------------------------------------------


def _erode_parabolic_axis(m: torch.Tensor, cell: torch.Tensor, radius: float, window: int,
                          axis: int) -> torch.Tensor:
    """One axis of the separable parabolic min-convolution (hpr.py:126-143):
    m'[c] = min_{|k| <= window} m[c + k] + R * (k * cell)^2, the outside
    read as FLT_MAX (FLT_MAX + pen overflows to +inf, harmless under min)."""
    big = torch.finfo(m.dtype).max
    pad = (window, window, 0, 0) if axis == 1 else (0, 0, window, window)
    mp = F.pad(m, pad, value=big)
    best = torch.full_like(m, big)
    for k in range(2 * window + 1):
        sl = mp.narrow(axis, k, m.shape[axis])
        t = (k - window) * cell
        best = torch.minimum(best, sl + radius * (t * t))
    return best


def hpr_mask_grid_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                        radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                        grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """The twin of H2, the JAX package's hpr_mask_grid (hpr.py:145-208) op
    for op: the gate, the gnomonic bounds, the cells (IEEE division by
    device tensors), the scatter-min into G*G + 1 slots (the last a sink),
    both erosions, the gather and the test. Bit-equal to it on the CPU."""
    n = points_camera.shape[0]
    dev, dt = points_camera.device, points_camera.dtype
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    big = torch.finfo(dt).max
    x, y, z = points_camera.unbind(-1)
    r = torch.sqrt(x * x + y * y + z * z)
    ok = valid & (z > 1e-9) & (r > 1e-9)
    zz = torch.clamp(z, min=1e-9)
    ax = torch.where(ok, x / zz, 0.0)
    ay = torch.where(ok, y / zz, 0.0)
    lo_x = torch.amin(torch.where(ok, ax, torch.inf))
    hi_x = torch.amax(torch.where(ok, ax, -torch.inf))
    lo_y = torch.amin(torch.where(ok, ay, torch.inf))
    hi_y = torch.amax(torch.where(ok, ay, -torch.inf))
    g = grid_size
    g_t = torch.full((), g, dtype=dt, device=dev)
    cu = torch.clamp((hi_x - lo_x) / g_t, min=1e-9)
    cv = torch.clamp((hi_y - lo_y) / g_t, min=1e-9)
    iu = torch.clamp(to_int32((ax - lo_x) / cu), 0, g - 1)
    iv = torch.clamp(to_int32((ay - lo_y) / cv), 0, g - 1)
    cell = torch.where(ok, iv * g + iu, g * g)
    zmin = torch.full((g * g + 1,), big, dtype=dt, device=dev)
    zmin.scatter_reduce_(0, cell.long(), torch.where(ok, r, big), reduce="amin")
    m = zmin[: g * g].reshape(g, g)
    m = _erode_parabolic_axis(m, cv, radius, window, axis=0)
    m = _erode_parabolic_axis(m, cu, radius, window, axis=1)
    eroded = m.reshape(-1)[torch.clamp(cell, max=g * g - 1).long()]
    return ok & ~(eroded < r - tolerance)


def hpr_mask_grid_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                       radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                       grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """H2 on the card: a memset of its scratch and four launches (bounds,
    scatter, both erosions, test); the bounds stay on the device."""
    x, y, z, valid, n = _columns(points_camera, valid)
    if not 1 <= grid_size <= 32768 or not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"hpr_mask_grid: grid_size {grid_size} (1..32768), window {window} "
                         f"(0..{MAX_WINDOW}) out of range")
    dev = points_camera.device
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return vis
    g2 = grid_size * grid_size
    scratch = torch.empty((g2 + 8,), dtype=torch.int32, device=dev)
    eroded = torch.empty((g2,), dtype=torch.float32, device=dev)
    err = _lib().hpr_grid(*_strided_args(x, y, z, valid), scratch.data_ptr(), eroded.data_ptr(),
                          vis.data_ptr(), n, grid_size, window, float(radius), float(tolerance),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hpr_grid launch failed: CUDA error {err}")
    launch_counts["hpr_grid"] += 1
    return vis


def hpr_mask_grid(points_camera: torch.Tensor, valid: torch.Tensor,
                  radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                  grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """O(N) visibility mask, the parabolic z-buffer form of :func:`hpr_mask`
    (hpr.py:145-208): hidden(i) when some j has r_j + R * theta_ij^2 <
    r_i - tol, theta measured on a G x G gnomonic grid of cell (cu, cv),
    occluders reaching ``window`` cells. The twin on CPU tensors, H2 on CUDA
    ones (bit-equal)."""
    dev = points_camera.device.type
    if dev == "cpu":
        return hpr_mask_grid_plain(points_camera, valid, radius, tolerance, grid_size, window)
    if dev == "cuda":
        return hpr_mask_grid_cuda(points_camera, valid, radius, tolerance, grid_size, window)
    raise NotImplementedError(f"hpr_mask_grid: no kernel for device {points_camera.device}")


def select_impl(impl: str, n: int, dense_cutoff: int) -> str:
    """"dense" or "grid" for a cull of ``n`` points: "auto" is the grid
    above ``dense_cutoff`` points (hpr.py:236)."""
    if impl == "auto":
        return "grid" if n > dense_cutoff else "dense"
    if impl not in ("dense", "grid"):
        raise ValueError(f"culling.hpr_impl must be 'auto', 'dense' or 'grid', got {impl!r}")
    return impl


def mask(points_camera: torch.Tensor, gate: torch.Tensor, radius: float, tolerance: float,
         impl: str = "auto", dense_cutoff: int = 100_000) -> torch.Tensor:
    """The HPR mask of gated camera-frame points by the selected impl."""
    fn = hpr_mask_grid if select_impl(impl, points_camera.shape[0], dense_cutoff) == "grid" \
        else hpr_mask
    return fn(points_camera, gate, radius=radius, tolerance=tolerance)


def cull_world_points(
    camera: cam.PinholeCamera,
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    radius: float = DEFAULT_RADIUS,
    tolerance: float = 0.05,
    impl: str = "auto",
    dense_cutoff: int = 100_000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform world points into the camera frame, gate them to the
    frustum (valid, z > 0, floor(u), floor(v) in the image:
    `hidden_points_removal` pre-filters at view_culling.cpp:270-289) and
    HPR-cull; returns (points_camera, visibility_mask) (hpr.py:211-240)."""
    pts_cam = se3.transform_points(T_camera_world, points_world)
    u, v = cam.project_uv(camera, pts_cam)
    gate = valid & (pts_cam[..., 2] > 0.0) & cam.in_image_uv(camera, u, v)
    return pts_cam, mask(pts_cam, gate, radius, tolerance, impl, dense_cutoff)
