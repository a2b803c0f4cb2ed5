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
tensors the kernels of `csrc/hpr.cu`, any other device raises. Each takes
a batch of K keyframes in one call, no host sync:

- H1 ``hpr_support`` (:func:`hpr_mask_dense_batch`; one keyframe,
  :func:`hpr_mask`, is a batch of one): ``hpr_flip`` (a memset and a
  launch), :func:`dense_plan` (torch ops: keys, one sort, the blocks' and
  subtiles' descriptors), ``hpr_support`` (two memsets and a launch). A
  block of directions reads only the subtiles of flipped points that
  :func:`skip_rule` cannot drop; the max, and the mask, stay bit-equal to
  the dense one's. :func:`hpr_support_tiled_plain` runs the same plan and
  rule in torch, for the tests.
- H2 ``hpr_grid``: a memset and four launches, each pass taking every
  keyframe: camera-frame points, :func:`hpr_mask_grid_batch` (one
  keyframe, :func:`hpr_mask_grid`, is a batch of one), or world points seen
  by K views, which the passes transform, project and gate themselves,
  :func:`hpr_mask_grid_views`.

The callers cull a batch: :func:`cull_world_points_batch` (the NID
keyframes of ``runner.build_nid_keyframes``) and :func:`mask_views` (the
keyframes of a ``fuse``, ``pipeline/colorize.hpr_masks``); the CPU twins go
a keyframe at a time. H2's bound: K x 14 B a point for camera-frame points;
for views, the world points' 13 B a point and K B out, or the ~64 f32
operations a point and view where larger (`csrc/hpr.cu`). H1's: the pairs
its inputs need (`csrc/hpr.cu`). ``launch_counts`` counts each wrapper's
calls that launched. The grid mask equals its twin bit for bit. The dense
kernel chains its FMAs as XLA's CPU norm and dot do, so it equals the twin
run on the CPU bit for bit; the twin run on the card rounds otherwise, and
a mask bit may then differ where the margin is within a few ulp of 2R.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
    # x, y, z, valid, their 4 element and 4 keyframe strides, u4, f4, key, flags, n, k,
    # radius, stream
    "hpr_flip": ([_PTR] * 4 + [_I64] * 8 + [_PTR] * 4 + [_I32] * 2 + [_F32, _PTR], _I32),
    # key, rank, sub_cs, blk_cs, u4, f4, the plan's 12 tensors (DensePlan's order), m, k,
    # stream
    "hpr_describe": ([_PTR] * 18 + [_I32] * 2 + [_PTR], _I32),
    # the plan's 12 tensors, flags, vis, ticket, stats, m, pad_zero, tol, stream
    "hpr_support": ([_PTR] * 16 + [_I32] * 2 + [_F32, _PTR], _I32),
    # x, y, z, valid, their 4 element and 4 keyframe strides, R, t, intrinsic, distortion,
    # width, height, scratch, eroded, vis, n, k, grid, window, radius, tol, stream
    "hpr_grid": ([_PTR] * 4 + [_I64] * 8 + [_PTR] * 4 + [_I32] * 2 + [_PTR] * 3 + [_I32] * 4
                 + [_F32] * 2 + [_PTR], _I32),
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


def spherical_flip(points: torch.Tensor, radius: float = DEFAULT_RADIUS) -> torch.Tensor:
    """Katz spherical flip p -> p + 2*(R - |p|) * p/|p| (view_culling.cpp:292).
    A point at the origin maps to the origin (it stays hidden)."""
    r = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe = torch.clamp(r, min=1e-12)
    return points * ((2.0 * radius - r) / safe)


# ---------------------------------------------------------------------------
# H1: the dense support test
# ---------------------------------------------------------------------------

# The JAX package pads the flipped points with zero rows to a multiple of its
# point chunk (`hpr_mask`'s ``chunk``, default 16384, hpr.py:85, 111-112), so
# its max takes a 0 wherever n % 16384 != 0, besides the zero rows of the
# points that are not ok.
JAX_CHUNK = 16384

# H1's tiled plan (csrc/hpr.cu proves its skip rule): the ok points keyed by
# bearing on a GRID x GRID octahedral grid over the sphere, cut into blocks
# of at most BLOCK_DIRS directions and subtiles of at most SUBTILE flipped
# points, neither crossing a cell.
GRID = 256
BLOCK_DIRS = 128
SUBTILE = 32
RHO_UP, RHO_FLOOR = 1.0 + 2.0**-20, 2.0**-60  # a chord radius rounded up
CHORD_DOWN = 1.0 - 2.0**-20  # a centre distance rounded down
SKIP_DELTA = 2.0**-17  # delta(t) = SKIP_DELTA * s_max(t)

# Where set to an int64 (2,) tensor on the card, every H1 launch adds to it
# the pairs it evaluated and the subtiles it kept (chip_smoke.py reads it).
support_stats: torch.Tensor | None = None


def _pads_zero(n: int) -> bool:
    return n % JAX_CHUNK != 0


def hpr_support_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                      radius: float = DEFAULT_RADIUS, chunk: int = 4096,
                      rows: torch.Tensor | None = None):
    """(ok, support, self_support): the twin's pieces of the dense test.
    support_i = max_j <f_j, d_i> over the flipped points f (0 where not
    ok), and 0 where the JAX package pads them (n % JAX_CHUNK != 0), and the
    bearings d (0 where not ok), as chunked f32 products ``d @ f.T`` and
    ``amax`` (the caller keeps TF32 off); self_support = 2R - r. With
    ``rows``, only those directions i (all three outputs indexed by
    ``rows``).

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
    if _pads_zero(points_camera.shape[0]):
        support = torch.clamp(support, min=0.0)  # NaN stays NaN, as in max
    return ok, support, self_support


def hpr_mask_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                   radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                   chunk: int = 4096) -> torch.Tensor:
    """The twin of the dense test: ``ok & (support - self_support <= tol)``."""
    ok, support, self_support = hpr_support_plain(points_camera, valid, radius, chunk)
    return ok & (support - self_support <= tolerance)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of f32 tensors, rounded once as the card's FFMA: the
    product is exact in f64, the sum is rounded to odd (TwoSum gives its
    error; an inexact sum with an even last bit steps one ulp toward the
    exact one), and f64 -> f32 then rounds as one rounding would (53 >= 24 +
    2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)
    step = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def hpr_flip_plain(points: torch.Tensor, valid: torch.Tensor, radius: float, k: int = 1):
    """The twin of csrc/hpr.cu's ``hpr_flip`` for the M = K N points (M, 3)
    of K keyframes: (u4, f4, ok, key, flags). u4 (M, 4) holds the bearing u
    = p / max(r, 1e-12) and s = 2R - r, f4 (M, 4) the flipped point f = u s
    and the self dot fma(f.z, u.z, fma(f.y, u.y, f.x u.x)), both 0 where not
    ok (valid, r > 1e-9); r = sqrt(fma(z, z, fma(y, y, x x))), each step
    rounded as the kernel rounds it (:func:`_fma`; the square root in f64,
    which rounds to f32 as one correct rounding would). key (M,) int32: the
    keyframe, then the cell of u on the GRID x GRID octahedral map over the
    whole sphere (the dense test has no z > 0 gate), row-major; K GRID^2
    where not ok. flags (K,) int32: 1 where an ok point's flip is not
    finite (the plain max is then NaN everywhere), 2 where some point is
    not ok (its zero row joins the max)."""
    x, y, z = points.unbind(-1)
    r = torch.sqrt(_fma(z, z, _fma(y, y, x * x)).double()).float()
    ok = valid & (r > 1e-9)
    u = points / torch.clamp(r, min=1e-12)[:, None]
    s = 2.0 * radius - r
    f = u * s[:, None]
    (fx, fy, fz), (ux, uy, uz) = f.unbind(-1), u.unbind(-1)
    self_dot = _fma(fz, uz, _fma(fy, uy, fx * ux))
    u4 = torch.where(ok[:, None], torch.cat([u, s[:, None]], 1), 0.0)
    f4 = torch.where(ok[:, None], torch.stack([fx, fy, fz, self_dot], 1), 0.0)
    # The octahedral map: o = (u.x, u.y) / |u|_1, folded over the lower
    # hemisphere; cells clamp((o + 1) GRID / 2) truncated, NaN to 0.
    o = u[:, :2] / ((ux.abs() + uy.abs()) + uz.abs())[:, None]
    fold = (1.0 - o.abs().flip(1)) * torch.where(o >= 0, 1.0, -1.0)
    o = torch.where((uz < 0)[:, None], fold, o)
    cell = torch.nan_to_num((o + 1.0) * (GRID / 2)).clamp_(0, GRID - 1).int()
    kf = torch.arange(points.shape[0], device=points.device, dtype=torch.int32) // (
        points.shape[0] // k)
    key = torch.where(ok, (kf * GRID + cell[:, 1]) * GRID + cell[:, 0], k * GRID * GRID)
    poison = (ok & ~torch.isfinite(f).all(-1)).view(k, -1).any(1)
    loose = (~ok).view(k, -1).any(1)
    return u4, f4, ok, key, poison.int() | (loose.int() << 1)


class DensePlan(NamedTuple):
    """H1's tiled plan of M = K N points. Segment arrays have M rows, of
    which the first are the ok points' blocks or subtiles in key order
    (keyframe, cell, original index); a segment is the run of sorted
    positions [start[b], start[b + 1]). Rows past the ok segments are not
    read."""

    u: torch.Tensor  # (M, 4) f32: u4 in key order
    f: torch.Tensor  # (M, 4) f32: f4 in key order
    order: torch.Tensor  # (M,) int64: the points in key order, the not-ok last
    block: torch.Tensor  # (M, 4) f32: each block's centre c and chord radius rho
    block_low: torch.Tensor  # (M,) f32: L_b, its directions' least self dot
    block_start: torch.Tensor  # (M + 1,) int32
    block_kf: torch.Tensor  # (M,) int32: its keyframe
    sub: torch.Tensor  # (M, 4) f32: each subtile's centre and chord radius
    sub_s: torch.Tensor  # (M,) f32: its s_max where its s_min > 0, else +inf
    sub_start: torch.Tensor  # (M + 1,) int32
    kf_sub: torch.Tensor  # (K + 1,) int32: keyframe k's subtiles [kf_sub[k], kf_sub[k + 1])
    n_blocks: torch.Tensor  # (1,) int32: the ok points' blocks


def _segments(seg: torch.Tensor, us: torch.Tensor, fs: torch.Tensor, m: int):
    """(c | rho (m, 4), s_min, s_max, least self dot) of the segments
    ``seg`` (M,) over the sorted rows ``us``, ``fs``, as ``describe``
    computes them: the bounding box's centre, the largest member distance
    to it, sqrt((dx dx + dy dy) + dz dz), rounded up (RHO_UP's 16 ulp cover
    the norm's rounding, 5 ulp with a root an ulp off; RHO_FLOOR the
    squares that underflow)."""
    idx = seg[:, None].expand(-1, 4)
    lo = torch.full((m, 4), math.inf, device=us.device).scatter_reduce_(0, idx, us, "amin")
    hi = torch.full((m, 4), -math.inf, device=us.device).scatter_reduce_(0, idx, us, "amax")
    c = (lo[:, :3] + hi[:, :3]) * 0.5
    d = us[:, :3] - c[seg]
    d = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    rho = torch.zeros((m,), device=us.device).scatter_reduce_(0, seg, d, "amax")
    low = torch.full((m,), math.inf, device=us.device).scatter_reduce_(0, seg, fs[:, 3], "amin")
    return torch.cat([c, (rho * RHO_UP + RHO_FLOOR)[:, None]], 1), lo[:, 3], hi[:, 3], low


def _starts(new: torch.Tensor, seg: torch.Tensor, m: int) -> torch.Tensor:
    """(M + 1,) int32: each segment's first sorted position; M after the
    last segment."""
    pos = torch.arange(m, dtype=torch.int32, device=seg.device)
    out = torch.full((m + 2,), m, dtype=torch.int32, device=seg.device)
    return out.scatter_(0, torch.where(new, seg, m + 1), pos)[: m + 1]


def describe_plain(key, order, rank, sub_cs, blk_cs, u4, f4, k: int) -> DensePlan:
    """The twin of csrc/hpr.cu's ``hpr_describe``: the plan's sorted rows,
    segments and descriptors from the sorted keys, the order, each sorted
    position's rank in its cell's run and the running counts of subtile and
    block starts (a start where the rank is a multiple of SUBTILE, or of
    BLOCK_DIRS)."""
    m, dev, g2 = key.shape[0], key.device, GRID * GRID
    us, fs = u4[order], f4[order]
    sub_new, blk_new = rank % SUBTILE == 0, rank % BLOCK_DIRS == 0
    sub, s_min, s_max, _ = _segments(sub_cs.long() - 1, us, fs, m)
    block, _, _, low = _segments(blk_cs.long() - 1, us, fs, m)
    kfs = key.long() // g2
    block_kf = torch.zeros((m + 1,), dtype=torch.int32, device=dev).scatter_(
        0, torch.where(blk_new, blk_cs.long() - 1, m), kfs.int())
    # Keyframe q's first sorted position: its subtiles and blocks before it.
    first = torch.searchsorted(key, torch.arange(k + 1, device=dev, dtype=torch.int32) * g2)
    zero = sub_cs.new_zeros(1)
    kf_sub = torch.cat([zero, sub_cs])[first]
    return DensePlan(us, fs, order, block, low, _starts(blk_new, blk_cs.long() - 1, m),
                     block_kf[:m], sub, torch.where(s_min > 0, s_max, math.inf),
                     _starts(sub_new, sub_cs.long() - 1, m), kf_sub,
                     torch.cat([zero, blk_cs])[first[k:]])


def dense_plan(key: torch.Tensor, u4: torch.Tensor, f4: torch.Tensor, k: int) -> DensePlan:
    """H1's plan of the flip (:func:`hpr_flip_plain`, or the card's
    ``hpr_flip``) of K keyframes: one stable sort of the keys, each
    position's rank in its cell's run (a binary search for the run's
    start), the running counts of subtile and block starts, then the
    descriptors (``hpr_describe`` on the card, :func:`describe_plain` off
    it). No host sync. A cell's run is cut into blocks of BLOCK_DIRS and
    subtiles of SUBTILE (a block is whole subtiles)."""
    m = key.shape[0]
    key, order = torch.sort(key, stable=True)
    rank = torch.arange(m, dtype=torch.int32, device=key.device) - torch.searchsorted(
        key, key, out_int32=True)
    sub_cs = torch.cumsum(rank % SUBTILE == 0, 0, dtype=torch.int32)
    blk_cs = torch.cumsum(rank % BLOCK_DIRS == 0, 0, dtype=torch.int32)
    if key.device.type == "cuda":
        return _describe_cuda(key, order, rank, sub_cs, blk_cs, u4, f4, k)
    return describe_plain(key, order, rank, sub_cs, blk_cs, u4, f4, k)


def skip_rule(block: torch.Tensor, low: torch.Tensor, sub: torch.Tensor,
              sub_s: torch.Tensor) -> torch.Tensor:
    """True where a subtile (``sub`` c | rho, ``sub_s``) can raise no
    direction of a block (``block`` c | rho, ``low`` L_b), broadcast: the
    rule csrc/hpr.cu proves, each step rounded as the kernel rounds it
    (``skips``): with D = max(0, |c_b - c_t| (1 - 2^-20) - rho_b - rho_t),
    s_max (1 - D^2 / 2)^+ + 2^-17 s_max < L_b, s_max = +inf where s_min <= 0."""
    dx, dy, dz = (block[..., i] - sub[..., i] for i in range(3))
    d = (torch.sqrt((dx * dx + dy * dy) + dz * dz) * CHORD_DOWN - block[..., 3]) - sub[..., 3]
    d = torch.where(d < 0, 0.0, d)
    fac = 1.0 - (d * d) * 0.5
    fac = torch.where(fac < 0, 0.0, fac)
    return sub_s * fac + sub_s * SKIP_DELTA < low


def _expand(starts: torch.Tensor, lens: torch.Tensor):
    """(owner, position): for each i, the positions starts[i] ..
    starts[i] + lens[i] - 1, tagged with i."""
    owner = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens)
    first = torch.cumsum(lens, 0) - lens
    return owner, starts[owner] + torch.arange(owner.numel(), device=lens.device) - first[owner]


def hpr_support_tiled_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                            radius: float = DEFAULT_RADIUS, pairs_a_chunk: int = 1 << 20):
    """(ok, support, self_support, stats): H1's tiled computation in torch,
    for points (N, 3) and valid (N,), or K keyframes (K, N, 3) and (K, N)
    (outputs (K, N)). :func:`dense_plan`, :func:`skip_rule` for every block
    and subtile of its keyframe, then the max over the kept subtiles' pairs
    only, each dot fma(f.z, u.z, fma(f.y, u.y, f.x u.x)) rounded as the
    kernel's (:func:`_fma`), from 0 where the JAX package's max has a zero
    row, else -inf; NaN for a keyframe with a non-finite flip. stats: the
    pairs evaluated and the subtiles kept, as the kernel counts them. Not
    on the main path: the CPU tests hold its support and mask to the twin's
    and JAX's, so the skip is shown exact; on the card it is the kernel's
    count's check."""
    single = points_camera.dim() == 2
    if single:
        points_camera, valid = points_camera[None], valid[None]
    k, n = valid.shape
    m, dev = k * n, points_camera.device
    if m == 0:
        empty = torch.zeros((k, n), device=dev)
        out = (empty.bool(), empty, empty)
        return (*(a[0] for a in out), (0, 0)) if single else (*out, (0, 0))
    u4, f4, ok, key, flags = hpr_flip_plain(points_camera.reshape(m, 3), valid.reshape(m),
                                            radius, k)
    plan = dense_plan(key, u4, f4, k)
    nb, nt = int(plan.n_blocks), int(plan.kf_sub[k])
    bstart, tstart = plan.block_start.long(), plan.sub_start.long()
    blen, tlen = bstart[1: nb + 1] - bstart[:nb], tstart[1: nt + 1] - tstart[:nt]
    sub_kf = torch.searchsorted(plan.kf_sub[1:].long(), torch.arange(nt, device=dev), right=True)
    zero = _pads_zero(n) | ((flags & 2) != 0)
    best = torch.where(zero, 0.0, -math.inf)[plan.block_kf[:nb].long()]
    best = best.repeat_interleave(blen)  # (ok points,) in key order
    kept_b = kept_t = [torch.zeros((0,), dtype=torch.int64, device=dev)]
    for b0 in range(0, nb, 256):
        b = torch.arange(b0, min(nb, b0 + 256), device=dev)
        keep = ~skip_rule(plan.block[b, None], plan.block_low[b, None], plan.sub[None, :nt],
                          plan.sub_s[None, :nt])
        keep &= plan.block_kf[b, None] == sub_kf[None]
        bi, ti = keep.nonzero(as_tuple=True)
        kept_b, kept_t = kept_b + [bi + b0], kept_t + [ti]
    kb, kt = torch.cat(kept_b), torch.cat(kept_t)
    work = blen[kb] * tlen[kt]
    stats = (int(work.sum()), int(kb.numel()))
    # Chunks of kept (block, subtile) pairs of at most ~pairs_a_chunk pairs.
    bounds = torch.searchsorted(torch.cumsum(work, 0),
                                torch.arange(0, stats[0] + pairs_a_chunk, pairs_a_chunk,
                                             device=dev), right=True)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if lo >= hi:
            continue
        pb, pt = kb[lo:hi], kt[lo:hi]
        owner, i = _expand(bstart[pb], blen[pb])  # a row a (direction, subtile)
        row, j = _expand(tstart[pt[owner]], tlen[pt[owner]])
        i = i[row]
        uu, ff = plan.u[i], plan.f[j]
        dot = _fma(ff[:, 2], uu[:, 2], _fma(ff[:, 1], uu[:, 1], ff[:, 0] * uu[:, 0]))
        best.scatter_reduce_(0, i, dot, "amax")
    support = torch.zeros((m,), device=dev)
    support[plan.order[: best.numel()]] = best
    support = torch.where((flags & 1).bool()[:, None], math.nan, support.view(k, n))
    ok, self_support = ok.view(k, n), u4[:, 3].view(k, n)
    if single:
        return ok[0], support[0], self_support[0], stats
    return ok, support, self_support, stats


def _describe_cuda(key, order, rank, sub_cs, blk_cs, u4, f4, k: int) -> DensePlan:
    """``hpr_describe`` on the card: one launch, a thread a sorted position
    (:func:`describe_plain` is its twin)."""
    m, dev = key.shape[0], key.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    plan = DensePlan(empty(m, 4), empty(m, 4), order, empty(m, 4), empty(m), empty(m + 1, dtype=i32),
                     empty(m, dtype=i32), empty(m, 4), empty(m), empty(m + 1, dtype=i32),
                     empty(k + 1, dtype=i32), empty(1, dtype=i32))
    err = _lib().hpr_describe(key.data_ptr(), rank.data_ptr(), sub_cs.data_ptr(),
                              blk_cs.data_ptr(), u4.data_ptr(), f4.data_ptr(),
                              *(a.data_ptr() for a in plan), m, k,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hpr_describe launch failed: CUDA error {err}")
    return plan


def hpr_mask_dense_batch_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                              radius: float = DEFAULT_RADIUS,
                              tolerance: float = 0.05) -> torch.Tensor:
    """H1 on the card for K keyframes at once: (K, N) masks from camera-frame
    points (K, N, 3) and gates (K, N), any strides, K <= 32767. ``hpr_flip``
    (a memset and a launch), :func:`dense_plan` (a sort, a binary search,
    six elementwise ops and two running counts, ``hpr_describe``), then
    ``hpr_support`` (two memsets and a persistent walk over the blocks,
    each keeping only the subtiles the skip rule cannot drop); no host
    sync. Each keyframe's row equals the dense max's mask,
    :func:`hpr_mask_plain` run on the CPU, bit for bit."""
    x, y, z, valid, k, n = _batch_columns(points_camera, valid)
    if k > 32767:
        raise ValueError(f"hpr: {k} keyframes in one dense batch (at most 32767: int32 keys)")
    dev = points_camera.device
    vis = torch.empty((k, n), dtype=torch.bool, device=dev)
    if n == 0 or k == 0:
        return vis
    m = k * n
    u4 = torch.empty((m, 4), dtype=torch.float32, device=dev)
    f4 = torch.empty((m, 4), dtype=torch.float32, device=dev)
    key = torch.empty((m,), dtype=torch.int32, device=dev)
    flags = torch.empty((k,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    err = lib.hpr_flip(x.data_ptr(), y.data_ptr(), z.data_ptr(), valid.data_ptr(),
                       x.stride(-1), y.stride(-1), z.stride(-1), valid.stride(-1),
                       x.stride(0), y.stride(0), z.stride(0), valid.stride(0),
                       u4.data_ptr(), f4.data_ptr(), key.data_ptr(), flags.data_ptr(), n, k,
                       float(radius), stream)
    if err != 0:
        raise RuntimeError(f"hpr_flip launch failed: CUDA error {err}")
    plan = dense_plan(key, u4, f4, k)
    ticket = torch.empty((1,), dtype=torch.int32, device=dev)
    stats = support_stats
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,)):
        raise ValueError(f"hpr.support_stats must be int64 (2,) on {dev}")
    err = lib.hpr_support(*(a.data_ptr() for a in plan), flags.data_ptr(), vis.data_ptr(),
                          ticket.data_ptr(), None if stats is None else stats.data_ptr(), m,
                          int(_pads_zero(n)), float(tolerance), stream)
    if err != 0:
        raise RuntimeError(f"hpr_support launch failed: CUDA error {err}")
    launch_counts["hpr_support"] += 1
    return vis


def hpr_mask_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                  radius: float = DEFAULT_RADIUS, tolerance: float = 0.05) -> torch.Tensor:
    """H1 on the card for one keyframe: a batch of one."""
    return hpr_mask_dense_batch_cuda(points_camera[None], valid[None], radius, tolerance)[0]


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


def hpr_mask_dense_batch(points_camera: torch.Tensor, valid: torch.Tensor,
                         radius: float = DEFAULT_RADIUS, tolerance: float = 0.05) -> torch.Tensor:
    """:func:`hpr_mask` of K keyframes, (K, N, 3) and (K, N) -> (K, N): the
    twin a keyframe at a time on CPU tensors, one H1 call for the batch on
    CUDA ones."""
    dev = points_camera.device.type
    if dev == "cpu":
        rows = [hpr_mask_plain(p, g, radius, tolerance) for p, g in zip(points_camera, valid)]
        return torch.stack(rows) if rows else torch.zeros_like(valid)
    if dev == "cuda":
        return hpr_mask_dense_batch_cuda(points_camera, valid, radius, tolerance)
    raise NotImplementedError(f"hpr_mask_dense_batch: no kernel for device {points_camera.device}")


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


def _batch_columns(points_camera: torch.Tensor, valid: torch.Tensor):
    """(x, y, z, valid, k, n) views for H2, checked: points (K, N, 3) f32 and
    valid (K, N) bool on one CUDA device, any strides."""
    dev = points_camera.device
    if dev.type != "cuda" or valid.device != dev:
        raise ValueError(f"hpr: points and valid must be on one CUDA device, got {dev} / "
                         f"{valid.device}")
    if points_camera.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"hpr: points must be float32 and valid bool, got "
                        f"{points_camera.dtype} / {valid.dtype}")
    if points_camera.dim() != 3 or points_camera.shape[2] != 3 \
            or tuple(valid.shape) != tuple(points_camera.shape[:2]):
        raise ValueError(f"hpr: points (K, N, 3) and valid (K, N), got "
                         f"{tuple(points_camera.shape)} / {tuple(valid.shape)}")
    k, n = valid.shape
    if n >= 2**31 or k > 65535:
        raise ValueError(f"hpr: {k} keyframes of {n} points out of range (K <= 65535)")
    x, y, z = points_camera.unbind(-1)
    return x, y, z, valid, k, n


def _check_grid(grid_size: int, window: int) -> None:
    if not 1 <= grid_size <= 32768 or not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"hpr_mask_grid: grid_size {grid_size} (1..32768), window {window} "
                         f"(0..{MAX_WINDOW}) out of range")


def _grid_launch(columns, views, camera, dev, k, n, radius, tolerance, grid_size,
                 window) -> torch.Tensor:
    """H2's memset and four launches over k keyframes of n points: (k, n)
    masks. ``columns`` (x, y, z, valid) with their element and keyframe
    strides; ``views`` ((R, t), contiguous) and ``camera``, or None."""
    vis = torch.empty((k, n), dtype=torch.bool, device=dev)
    if n == 0 or k == 0:
        return vis
    g2 = grid_size * grid_size
    scratch = torch.empty((k, g2 + 8), dtype=torch.int32, device=dev)
    eroded = torch.empty((k, g2), dtype=torch.float32, device=dev)
    x, y, z, valid = columns
    kstride = (lambda a: a.stride(0)) if views is None else (lambda a: 0)
    view_args = (None,) * 4 + (0, 0) if views is None else (
        views[0].data_ptr(), views[1].data_ptr(), camera.intrinsic.data_ptr(),
        camera.distortion.data_ptr(), int(camera.width), int(camera.height))
    err = _lib().hpr_grid(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), valid.data_ptr(),
        x.stride(-1), y.stride(-1), z.stride(-1), valid.stride(-1),
        kstride(x), kstride(y), kstride(z), kstride(valid), *view_args,
        scratch.data_ptr(), eroded.data_ptr(), vis.data_ptr(), n, k, grid_size,
        window, float(radius), float(tolerance), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hpr_grid launch failed: CUDA error {err}")
    launch_counts["hpr_grid"] += 1
    return vis


def hpr_mask_grid_batch_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                             radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                             grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """H2 on the card for K keyframes at once: (K, N) masks from camera-frame
    points (K, N, 3) and gates (K, N), any strides. One memset of the (K,
    G*G + 8) scratch and four launches (bounds, scatter, both erosions,
    test), each over every keyframe; each keyframe keeps its own bounds and
    grids, and its row is the one-keyframe cull's bit for bit."""
    x, y, z, valid, k, n = _batch_columns(points_camera, valid)
    _check_grid(grid_size, window)
    return _grid_launch((x, y, z, valid), None, None, points_camera.device, k, n, radius,
                        tolerance, grid_size, window)


def hpr_mask_grid_cuda(points_camera: torch.Tensor, valid: torch.Tensor,
                       radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                       grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """H2 on the card for one keyframe: :func:`hpr_mask_grid_batch_cuda` on
    a batch of one (a memset and four launches)."""
    return hpr_mask_grid_batch_cuda(points_camera[None], valid[None], radius, tolerance,
                                    grid_size, window)[0]


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


def hpr_mask_grid_batch_plain(points_camera: torch.Tensor, valid: torch.Tensor,
                              radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                              grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """The twin of :func:`hpr_mask_grid_batch_cuda`: (K, N) masks, each
    keyframe's :func:`hpr_mask_grid_plain`."""
    n = valid.shape[1]
    rows = [hpr_mask_grid_plain(p, v, radius, tolerance, grid_size, window)
            for p, v in zip(points_camera, valid)]
    return torch.stack(rows) if rows else torch.zeros((0, n), dtype=torch.bool,
                                                      device=points_camera.device)


def hpr_mask_grid_batch(points_camera: torch.Tensor, valid: torch.Tensor,
                        radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                        grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """:func:`hpr_mask_grid` of K keyframes at once: (K, N) masks from
    camera-frame points (K, N, 3) and gates (K, N). The twin on CPU tensors,
    H2 on CUDA ones (one memset and four launches for the batch)."""
    dev = points_camera.device.type
    if dev == "cpu":
        return hpr_mask_grid_batch_plain(points_camera, valid, radius, tolerance, grid_size,
                                         window)
    if dev == "cuda":
        return hpr_mask_grid_batch_cuda(points_camera, valid, radius, tolerance, grid_size,
                                        window)
    raise NotImplementedError(f"hpr_mask_grid_batch: no kernel for device {points_camera.device}")


def colorize_gate(camera: cam.PinholeCamera, z, u, v, valid) -> torch.Tensor:
    """The colorize HPR cull's gate: valid, z > 0 and the unfloored pixel in
    the image, as the JAX package's colorize gates it (colorize.py:95-109)."""
    return valid & (z > 0.0) & (u >= 0) & (u < camera.width) & (v >= 0) & (v < camera.height)


def view_points(camera: cam.PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                points_world: torch.Tensor, valid: torch.Tensor):
    """(points_camera (V, N, 3), gate (V, N)): world points (N, 3) seen by V
    views (R (V, 3, 3), t (V, 3)), the ops of ``se3.transform_xyz`` broadcast
    over the views (each view gets the bits it gets alone), projected, and
    :func:`colorize_gate`."""
    R, t = R[..., None], t[..., None]
    px, py, pz = (points_world[None, :, c] for c in range(3))
    x = R[:, 0, 0] * px + R[:, 0, 1] * py + R[:, 0, 2] * pz + t[:, 0]
    y = R[:, 1, 0] * px + R[:, 1, 1] * py + R[:, 1, 2] * pz + t[:, 1]
    z = R[:, 2, 0] * px + R[:, 2, 1] * py + R[:, 2, 2] * pz + t[:, 2]
    u, v = cam.project_xyz(camera, x, y, z)
    return torch.stack([x, y, z], dim=-1), colorize_gate(camera, z, u, v, valid)


def hpr_mask_grid_views_plain(camera: cam.PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                              points_world: torch.Tensor, valid: torch.Tensor,
                              radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                              grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """The twin of :func:`hpr_mask_grid_views_cuda`: :func:`view_points`,
    then :func:`hpr_mask_grid_batch_plain`."""
    pts, gate = view_points(camera, R, t, points_world, valid)
    return hpr_mask_grid_batch_plain(pts, gate, radius, tolerance, grid_size, window)


def hpr_mask_grid_views_cuda(camera: cam.PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                             points_world: torch.Tensor, valid: torch.Tensor,
                             radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                             grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """H2 on the card for world points (N, 3) seen by V views (R (V, 3, 3),
    t (V, 3)): (V, N) masks, the colorize HPR cull of each view. The same
    memset and four launches as :func:`hpr_mask_grid_batch_cuda`; each pass
    over the points transforms, projects and gates them itself (the world
    points, 13 B a point, stay in L2 across the views), so no (V, N, 3)
    camera-frame tensor is written. Each row equals
    :func:`hpr_mask_grid_views_plain`'s bit for bit."""
    x, y, z, valid, n = _columns(points_world, valid)
    dev = points_world.device
    v = R.shape[0] if R.dim() == 3 else -1
    for name, a, size in (("R", R, (v, 3, 3)), ("t", t, (v, 3)),
                          ("intrinsic", camera.intrinsic, (4,)),
                          ("distortion", camera.distortion, (5,))):
        if (a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != size
                or not a.is_contiguous()):
            raise ValueError(f"hpr: {name} must be contiguous float32 {size} on {dev}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    _check_grid(grid_size, window)
    return _grid_launch((x, y, z, valid), (R, t), camera, dev, v, n, radius, tolerance,
                        grid_size, window)


def hpr_mask_grid_views(camera: cam.PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                        points_world: torch.Tensor, valid: torch.Tensor,
                        radius: float = DEFAULT_RADIUS, tolerance: float = 0.05,
                        grid_size: int = 512, window: int = 16) -> torch.Tensor:
    """The colorize HPR grid culls of world points seen by V views, (V, N):
    the twin on CPU tensors, H2 on CUDA ones (one memset and four launches,
    the transform, projection and gate in its passes)."""
    dev = points_world.device.type
    if dev == "cpu":
        return hpr_mask_grid_views_plain(camera, R, t, points_world, valid, radius, tolerance,
                                         grid_size, window)
    if dev == "cuda":
        return hpr_mask_grid_views_cuda(camera, R, t, points_world, valid, radius, tolerance,
                                        grid_size, window)
    raise NotImplementedError(f"hpr_mask_grid_views: no kernel for device {points_world.device}")


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


def mask_batch(points_camera: torch.Tensor, gate: torch.Tensor, radius: float,
               tolerance: float, impl: str = "auto", dense_cutoff: int = 100_000
               ) -> torch.Tensor:
    """:func:`mask` of K keyframes, (K, N, 3) and (K, N) -> (K, N), each
    cull in one batch on the card (:func:`hpr_mask_grid_batch`,
    :func:`hpr_mask_dense_batch`)."""
    if select_impl(impl, points_camera.shape[1], dense_cutoff) == "grid":
        return hpr_mask_grid_batch(points_camera, gate, radius=radius, tolerance=tolerance)
    return hpr_mask_dense_batch(points_camera, gate, radius=radius, tolerance=tolerance)


def mask_views(camera: cam.PinholeCamera, R: torch.Tensor, t: torch.Tensor,
               points_world: torch.Tensor, valid: torch.Tensor, radius: float,
               tolerance: float, impl: str = "auto", dense_cutoff: int = 100_000
               ) -> torch.Tensor:
    """The colorize HPR masks of world points seen by V views, (V, N), by
    the selected impl: the grid cull in one batch that transforms the points
    itself (:func:`hpr_mask_grid_views`), the dense one in one batch on
    :func:`view_points`."""
    if select_impl(impl, points_world.shape[0], dense_cutoff) == "grid":
        return hpr_mask_grid_views(camera, R, t, points_world, valid, radius=radius,
                                   tolerance=tolerance)
    pts, gate = view_points(camera, R, t, points_world, valid)
    return mask_batch(pts, gate, radius, tolerance, impl, dense_cutoff)


def _frustum(camera: cam.PinholeCamera, points_world: torch.Tensor, valid: torch.Tensor,
             T_camera_world: se3.SE3):
    """(points_camera, gate): the transform and the frustum gate (valid, z >
    0, floor(u), floor(v) in the image) of `hidden_points_removal`'s
    pre-filter (view_culling.cpp:270-289)."""
    pts_cam = se3.transform_points(T_camera_world, points_world)
    u, v = cam.project_uv(camera, pts_cam)
    return pts_cam, valid & (pts_cam[..., 2] > 0.0) & cam.in_image_uv(camera, u, v)


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
    pts_cam, gate = _frustum(camera, points_world, valid, T_camera_world)
    return pts_cam, mask(pts_cam, gate, radius, tolerance, impl, dense_cutoff)


def cull_world_points_batch(
    camera: cam.PinholeCamera,
    T_camera_world: se3.SE3,
    points_world: torch.Tensor,
    valid: torch.Tensor,
    radius: float = DEFAULT_RADIUS,
    tolerance: float = 0.05,
    impl: str = "auto",
    dense_cutoff: int = 100_000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cull_world_points` for K keyframes at once (``T_camera_world``
    batched (K,)): (points_camera (K, N, 3), masks (K, N)), each keyframe's
    the bits its own call gives (the same elementwise ops, broadcast), the
    grid culls in one batch (:func:`mask_batch`)."""
    k, n = T_camera_world.q.shape[0], points_world.shape[0]
    pts_cam, gate = _frustum(camera, points_world.expand(k, n, 3), valid, T_camera_world)
    return pts_cam, mask_batch(pts_cam, gate, radius, tolerance, impl, dense_cutoff)
