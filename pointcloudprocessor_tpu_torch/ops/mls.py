"""Moving-least-squares surface smoothing: the reference's MLS map stage.

Port of `pointcloudprocessor_tpu/ops/mls.py`, which replaces
`pcl::MovingLeastSquares` as the reference drives it
(`cloudSmooth.cpp:124-154`, parameters at `PointCloudProcessor.cpp:67-86`):
for every point, fit a plane to its radius neighborhood with Gaussian
weights ``exp(-d^2 / sqr_gauss)``, then an order-2 polynomial of the
height over the plane's tangent frame, and project the point onto that
surface. Optional upsampling regenerates points on the fitted surfaces
(`cloudSmooth.cpp:133-152`). :func:`smooth_cloud` is the whole stage, SOR
-> MLS (+ upsampling) -> SOR (`cloudSmooth.cpp:77-181`).

The default fit (``fit_impl="moments"``) weighs every in-radius candidate
of the 27 cells around the point, as the JAX package's
``fit_surfaces_moments`` does. On CPU tensors :func:`mls_smooth` runs the
plain version, the JAX package's pass op for op (the cell-sorted,
run-deduplicated candidate fetch with its per-query fallback included);
on CUDA tensors the grid is built with torch ops and the M1 kernel
(`csrc/mls.cu`) does the fetch, the fit and the projection of every point in
one launch, taking the points in the grid's sort order and staging each
cell's candidate window once a block (the TPU's dedup fetch, redone for
shared memory). ``launch_counts`` counts its launches. The top-K fit
(``fit_impl="topk"``) is plain torch on every device.

The JAX package runs its pass under ``jit``, where XLA divides by the cell
size and by ``sqr_gauss`` through reciprocals; the port divides exactly
(ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cloud import PointCloud
from ..kernels import build as kbuild
from ..utils.config import MLSConfig
from . import knn, sor
from .voxel import voxel_coords, voxel_hash


class MLSSurface(NamedTuple):
    """Per-point fitted local surface.

    origin: (N, 3) weighted neighborhood mean (the frame's origin).
    normal: (N, 3) unit plane normal.
    tangent_u / tangent_v: (N, 3) orthonormal tangent axes.
    coeffs: (N, 6) coefficients of h(u, v) = c0 + c1 u + c2 v + c3 u^2 +
        c4 uv + c5 v^2 (zeros when fewer than 6 neighbors).
    ok: (N,) bool, at least 3 neighbors.
    """

    origin: torch.Tensor
    normal: torch.Tensor
    tangent_u: torch.Tensor
    tangent_v: torch.Tensor
    coeffs: torch.Tensor
    ok: torch.Tensor


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``like``'s type and device: a division by
    it is exact on every device (torch divides a CUDA tensor by a Python
    number through the reciprocal)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve by an unrolled Cholesky factorization of the small
    (..., d, d) system (JAX mls.py:54-84, with its ``max(s, 1e-30)``
    clamp of the pivots)."""
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    y = [None] * d
    for i in range(d):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-20), |v| summed in f32 as XLA sums it: a norm past
    the f32 range is inf and gives 0, as in the JAX package (a degenerate
    neighborhood's inverse iteration gets there; torch's vector_norm does
    not overflow)."""
    norm = torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])
    return v / torch.clamp(norm, min=1e-20)


def _smallest_eigvec_3x3(C: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    inverse iteration on C + 1e-6 (tr C + 1e-12) I from the seed (0.577,
    0.577, 0.577), three solves (JAX mls.py:87-105)."""
    tr = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    A = C + (1e-6 * (tr[..., None, None] + 1e-12)) * eye
    v0 = torch.full(C.shape[:-2] + (3,), 0.577, dtype=C.dtype, device=C.device)
    sol = _unit(_chol_solve(A, v0))
    sol = _chol_solve(A, sol)
    return _unit(_chol_solve(A, sol))


def _tangent_frame(n: torch.Tensor):
    """Deterministic orthonormal (u, v) completing the unit normal n: u =
    n x (the world x axis, or y where |n_x| >= 0.9), v = n x u."""
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.9, x_axis, y_axis)
    u = _unit(torch.linalg.cross(n, ref, dim=-1))
    return u, torch.linalg.cross(n, u, dim=-1)


def _oriented_frame(C: torch.Tensor, q: torch.Tensor, mean: torch.Tensor):
    """(normal, tu, tv): the smallest eigenvector of C, turned towards the
    query's side of the mean, and its tangent frame."""
    normal = _smallest_eigvec_3x3(C)
    sgn = torch.sign(torch.sum(normal * (q - mean), dim=-1))
    normal = normal * torch.where(sgn == 0, 1.0, sgn)[:, None]
    return (normal, *_tangent_frame(normal))


def fit_surfaces(
    points: torch.Tensor,
    queries: torch.Tensor,
    neigh_idx: torch.Tensor,
    neigh_ok: torch.Tensor,
    sqr_gauss_param: float,
    polynomial_order: int = 2,
    neigh_pts: torch.Tensor | None = None,
) -> MLSSurface:
    """The top-K fit (JAX mls.py:123-178): the MLS surface around every
    query from its (M, K) neighbors (``knn.radius_neighbors``; their
    positions ``neigh_pts`` (M, K, 3) where given)."""
    q = queries
    npts = neigh_pts if neigh_pts is not None else points[torch.clamp(neigh_idx, min=0).long()]
    d2 = torch.sum((npts - q[:, None, :]) ** 2, dim=-1)
    w = neigh_ok.to(points.dtype) * torch.exp(-d2 / _scalar(sqr_gauss_param, d2))
    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-20)
    mean = torch.sum(npts * w[..., None], dim=1) / wsum[:, None]
    centered = (npts - mean[:, None, :]) * torch.sqrt(w)[..., None]
    C = torch.einsum("mki,mkj->mij", centered, centered)
    normal, tu, tv = _oriented_frame(C, q, mean)
    cnt = torch.sum(neigh_ok, dim=1)
    if polynomial_order >= 2:
        rel = npts - mean[:, None, :]
        u = torch.sum(rel * tu[:, None, :], dim=-1)
        v = torch.sum(rel * tv[:, None, :], dim=-1)
        h = torch.sum(rel * normal[:, None, :], dim=-1)
        A = torch.stack([torch.ones_like(u), u, v, u * u, u * v, v * v], dim=-1)
        Aw = A * w[..., None]
        AtA = torch.einsum("mki,mkj->mij", Aw, A)
        Ath = torch.einsum("mki,mk->mi", Aw, h)
        ridge = 1e-8 * torch.eye(6, dtype=points.dtype, device=points.device)
        coeffs = _chol_solve(AtA + ridge, Ath)
        coeffs = torch.where((cnt >= 6)[:, None], coeffs, 0.0)
    else:
        coeffs = torch.zeros((q.shape[0], 6), dtype=points.dtype, device=points.device)
    return MLSSurface(origin=mean, normal=normal, tangent_u=tu, tangent_v=tv, coeffs=coeffs,
                      ok=cnt >= 3)


def project_onto(surf: MLSSurface, pts: torch.Tensor, owner: torch.Tensor | None = None):
    """Project points onto their own (or ``owner``'s) fitted surface, PCL's
    SIMPLE projection: the point's height in the local frame is replaced by
    the polynomial's, and the normal tilts by its gradient. Returns
    (positions, normals); a point whose surface is not ok keeps its
    position."""
    s = surf if owner is None else MLSSurface(*(a[owner.long()] for a in surf))
    rel = pts - s.origin
    u = torch.sum(rel * s.tangent_u, dim=-1)
    v = torch.sum(rel * s.tangent_v, dim=-1)
    c = s.coeffs
    h = c[..., 0] + c[..., 1] * u + c[..., 2] * v + c[..., 3] * u * u + c[..., 4] * u * v \
        + c[..., 5] * v * v
    pos = s.origin + u[..., None] * s.tangent_u + v[..., None] * s.tangent_v \
        + h[..., None] * s.normal
    du = c[..., 1] + 2.0 * c[..., 3] * u + c[..., 4] * v
    dv = c[..., 2] + c[..., 4] * u + 2.0 * c[..., 5] * v
    n = _unit(s.normal - du[..., None] * s.tangent_u - dv[..., None] * s.tangent_v)
    return torch.where(s.ok[..., None], pos, pts), n


def _in_radius(q, cx, cy, cz, search_radius):
    """The in-radius candidates of (M, C) coordinate planes, in candidate
    order at the front of each row, the rest dropped: (dx, dy, dz, d2) from
    the query, each (M, W) with W the largest in-radius count (0 past a
    row's count), and the counts (M,)."""
    dx = cx - q[:, 0:1]
    dy = cy - q[:, 1:2]
    dz = cz - q[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    # radius * radius in double, then f32, as JAX compares with the weak scalar.
    inr = torch.isfinite(cz) & (d2 <= _scalar(search_radius * search_radius, d2))
    cnt = torch.sum(inr, dim=1)
    width = int(cnt.max()) if cnt.numel() else 0
    col = torch.where(inr, torch.cumsum(inr, dim=1) - 1, width)  # the rest to a spare column
    packed = [p.new_zeros((p.shape[0], width + 1)).scatter_(1, col, p)[:, :width]
              for p in (dx, dy, dz, d2)]
    return (*packed, cnt)


def _fit_moments(q, dx, dy, dz, d2, cnt, sqr_gauss_param, polynomial_order):
    """(MLSSurface, in-radius counts (M,) int32) of
    :func:`fit_surfaces_moments` from :func:`_in_radius`'s packed rows
    (any width at least the largest count). The fit sums only the packed
    rows: a row's sums depend on its values and the rows' width, not on
    the other rows of the chunk."""
    inr = torch.arange(dx.shape[1], device=dx.device) < cnt[:, None]
    w = torch.where(inr, torch.exp(-torch.where(inr, d2, 0.0) / _scalar(sqr_gauss_param, d2)),
                    0.0)

    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-20)
    mx = torch.sum(w * dx, dim=1) / wsum
    my = torch.sum(w * dy, dim=1) / wsum
    mz = torch.sum(w * dz, dim=1) / wsum
    mean = q + torch.stack([mx, my, mz], dim=-1)
    # Weighted covariance about the mean, in coordinates relative to it.
    ex = dx - mx[:, None]
    ey = dy - my[:, None]
    ez = dz - mz[:, None]
    cxx = torch.sum(w * ex * ex, dim=1)
    cxy = torch.sum(w * ex * ey, dim=1)
    cxz = torch.sum(w * ex * ez, dim=1)
    cyy = torch.sum(w * ey * ey, dim=1)
    cyz = torch.sum(w * ey * ez, dim=1)
    czz = torch.sum(w * ez * ez, dim=1)
    C = torch.stack([torch.stack([cxx, cxy, cxz], -1), torch.stack([cxy, cyy, cyz], -1),
                     torch.stack([cxz, cyz, czz], -1)], -2)
    normal, tu, tv = _oriented_frame(C, q, mean)

    if polynomial_order >= 2:
        u = ex * tu[:, 0:1] + ey * tu[:, 1:2] + ez * tu[:, 2:3]
        v = ex * tv[:, 0:1] + ey * tv[:, 1:2] + ez * tv[:, 2:3]
        h = ex * normal[:, 0:1] + ey * normal[:, 1:2] + ez * normal[:, 2:3]
        # A^T W A of A = [1, u, v, u^2, uv, v^2] holds 15 distinct weighted
        # moments sum w u^a v^b (a + b <= 4); A^T W h 6 more.
        pow_u = [torch.ones_like(u), u, u * u]
        pow_u += [pow_u[2] * u, pow_u[2] * u * u]
        pow_v = [torch.ones_like(v), v, v * v]
        pow_v += [pow_v[2] * v, pow_v[2] * v * v]
        mom = {(a, b): torch.sum(w * pow_u[a] * pow_v[b], dim=1)
               for a in range(5) for b in range(5 - a)}
        exps = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]
        AtA = torch.stack([torch.stack([mom[(ei[0] + ej[0], ei[1] + ej[1])] for ej in exps], -1)
                           for ei in exps], -2)
        wh = w * h
        Ath = torch.stack([torch.sum(wh * pow_u[a] * pow_v[b], dim=1) for a, b in exps], -1)
        ridge = 1e-8 * torch.eye(6, dtype=q.dtype, device=q.device)
        coeffs = _chol_solve(AtA + ridge, Ath)
        coeffs = torch.where((cnt >= 6)[:, None], coeffs, 0.0)
    else:
        coeffs = torch.zeros((q.shape[0], 6), dtype=q.dtype, device=q.device)
    surf = MLSSurface(origin=mean, normal=normal, tangent_u=tu, tangent_v=tv, coeffs=coeffs,
                      ok=cnt >= 3)
    return surf, cnt.to(torch.int32)


def fit_surfaces_moments(
    queries: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    cz: torch.Tensor,
    search_radius: float,
    sqr_gauss_param: float,
    polynomial_order: int = 2,
) -> MLSSurface:
    """The selection-free MLS fit (JAX mls.py:203-317): weighted moments
    over every in-radius candidate of the (M, C) coordinate planes (+inf in
    empty slots), as PCL fits over every point its radius search returns.
    A plane from the weighted covariance, then the polynomial in its frame
    from 15 monomial moments and 6 right-hand sides."""
    *packed, cnt = _in_radius(queries, cx, cy, cz, search_radius)
    return _fit_moments(queries, *packed, cnt, sqr_gauss_param, polynomial_order)[0]


def _cell_order(points, valid, cell_size, table_size):
    """(order, keys, fits): the queries sorted by (bucket hash, exact cell
    key), stably, as the JAX pass's ``lax.sort(num_keys=2)``; invalid points
    last (hash = table_size)."""
    cells = voxel_coords(points, cell_size)
    key, fits = knn.pack_cell_key(cells)
    h = torch.where(valid, voxel_hash(cells, table_size), table_size)
    # One int64 key: the hash above the key's int32 bits made unsigned.
    lex = (h.to(torch.int64) << 32) | (key.to(torch.int64) + 2**31)
    order = torch.sort(lex, stable=True).indices
    return order, key[order], fits


def mls_pass_plain(points, valid, *, search_radius, sqr_gauss_param, polynomial_order,
                   bucket_capacity, table_size, chunk_size, fit_impl="moments",
                   max_neighbors=32, dedup_candidates=True):
    """The plain version of the MLS pass (JAX ``_mls_smooth_jit``,
    mls.py:334-458): the grid with ``bucket_points``, then chunks of
    ``chunk_size`` queries, each fetched, fitted and projected. With
    ``dedup_candidates`` (moments only) the queries go in cell order and
    each chunk fetches one window a run of equal cells, or each query's
    own where it holds more than ``chunk_size // 4`` runs or the cloud
    exceeds :func:`knn.pack_cell_key`'s extent; the candidates, and so the
    results, are the same either way. Returns (positions, normals,
    MLSSurface, in-radius counts), all in point order."""
    n = points.shape[0]
    grid = knn.build(points, valid, search_radius, table_size, bucket_capacity,
                     store_points=True)
    run_cap = chunk_size // 4
    dedup = bool(dedup_candidates) and fit_impl == "moments"
    if dedup:
        order, keys, fits = _cell_order(points, valid, search_radius, table_size)
        queries = points[order]
    else:
        order, queries = None, points
    chunks = []
    for s in range(0, max(n, 1), chunk_size):  # an empty cloud runs one empty chunk
        q = queries[s: s + chunk_size]
        if fit_impl == "moments":
            cand = None
            if dedup:
                # The last chunk's padding (JAX pads it with a key no cell
                # makes) is a run of its own.
                kk = keys[s: s + chunk_size]
                runs = 1 + int((kk[1:] != kk[:-1]).sum()) + (q.shape[0] < chunk_size)
                if runs <= run_cap and bool(fits):
                    pad = chunk_size - q.shape[0]
                    qp = torch.cat([q, q.new_zeros((pad, 3))])
                    kp = torch.cat([kk, kk.new_full((pad,), 1 << 30)])
                    cx, cy, cz, _ = knn.candidate_points_dedup(grid, qp, kp, run_cap)
                    cand = (cx[: q.shape[0]], cy[: q.shape[0]], cz[: q.shape[0]])
            if cand is None:
                cand = knn.candidate_points(grid, q)
            chunks.append((q, *_in_radius(q, *cand, search_radius)))
        elif fit_impl == "topk":
            idx, npts, _, ok = knn.radius_neighbors_with_points(
                grid, points, q, search_radius, max_neighbors, select="approx")
            surf = fit_surfaces(points, q, idx, ok, sqr_gauss_param, polynomial_order,
                                neigh_pts=npts)
            chunks.append((q, surf, torch.sum(ok, dim=1).to(torch.int32)))
        else:
            raise ValueError(f"fit_impl must be 'moments' or 'topk', got {fit_impl!r}")
    if fit_impl == "moments":
        # Every chunk's rows padded to the widest count of the cloud, so a
        # point's sums do not depend on its chunk (dedup on and off agree).
        width = max(c[1].shape[1] for c in chunks)
        chunks = [(q, *_fit_moments(q, *(F.pad(p, (0, width - p.shape[1])) for p in packed),
                                    cnt, sqr_gauss_param, polynomial_order))
                  for q, *packed, cnt in chunks]
    parts = [(*project_onto(surf, q), *surf, cnt) for q, surf, cnt in chunks]
    fields = [torch.cat(p) for p in zip(*parts)]
    if order is not None:
        for i, f in enumerate(fields):
            out = torch.empty_like(f)
            out[order] = f
            fields[i] = out
    pos, nrm, *surf, cnt = fields
    return pos, nrm, MLSSurface(*surf), cnt


def mls_smooth(
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MLSConfig,
    chunk_size: int = 16384,
    fit_impl: str = "moments",
    dedup_candidates: bool = True,
):
    """Smooth every valid point onto its local MLS surface.

    Returns (positions (N, 3), normals (N, 3), ok (N,), surfaces), ok being
    the surface's and ``valid``; a point without a fit keeps its position
    (PCL drops it; callers AND ``ok`` into validity). The grid's table
    holds ``max(n // 2, 1024)`` buckets and a chunk ``min(chunk_size,
    max(2n, 1024))`` queries, as in the JAX package.

    ``fit_impl="moments"`` (the default) fits over every in-radius
    candidate: on CPU tensors by the plain pass (``dedup_candidates`` as
    the JAX package's), on CUDA tensors by M1, one launch, where
    ``dedup_candidates`` changes nothing (the kernel stages each cell's
    window itself). ``"topk"`` fits over the ``cfg.max_neighbors``
    nearest, plain torch on every device."""
    n = points.shape[0]
    kw = dict(search_radius=float(cfg.search_radius),
              sqr_gauss_param=float(cfg.sqr_gauss_param),
              polynomial_order=int(cfg.polynomial_order),
              bucket_capacity=int(cfg.bucket_capacity), table_size=max(n // 2, 1024))
    dev = points.device.type
    if dev == "cuda" and fit_impl == "moments":
        pos, nrm, surf, _ = mls_moments_cuda(points.contiguous(), valid, **kw)
    elif dev in ("cpu", "cuda"):
        pos, nrm, surf, _ = mls_pass_plain(
            points, valid, chunk_size=min(chunk_size, max(2 * n, 1024)), fit_impl=fit_impl,
            max_neighbors=int(cfg.max_neighbors), dedup_candidates=dedup_candidates, **kw)
    else:
        raise NotImplementedError(f"mls_smooth: no kernel for device {points.device}")
    return pos, nrm, surf.ok & valid, surf


# ---------------------------------------------------------------------------
# M1: the moments pass (fetch, fit, projection) in one launch
# ---------------------------------------------------------------------------

# Launches of the CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"mls_moments": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # buckets, counts, points, schedule, pos, nrm, origin, normal, tu, tv, coeffs, ok,
    # cnt, run_sizes, n_sizes, n, table, cap, cell, r2, sqr_gauss, order, stream
    "mls_moments": ([_PTR] * 14 + [_I32] * 4 + [_F32] * 3 + [_I32, _PTR], _I32),
}
MAX_BUCKET_CAPACITY = 128  # csrc/mls.cu kMaxB


def mls_moments_cuda(points, valid, *, search_radius, sqr_gauss_param, polynomial_order,
                     bucket_capacity, table_size, grid: knn.HashGrid | None = None,
                     order: torch.Tensor | None = None, run_sizes: torch.Tensor | None = None):
    """M1 on the card: the moments pass of :func:`mls_pass_plain` over the
    hash grid of the valid points (torch ops; ``grid``, where given, is that
    grid built already), then one launch that, for every point, reads the
    in-radius candidates of its 27 cells, fits the weighted plane and
    polynomial and projects the point. The kernel takes the points in
    ``order``, an (N,) int32 permutation (default: the grid's own sort
    order ``grid.order``, else :func:`knn.cell_order`), and stages the
    window of each cell among a block's points once; the results, in point
    order, do not depend on it. ``run_sizes``, where given, an (L,) int32
    tensor on the card, gains 1 at min(s, L - 1) for each window the launch
    stages, s its points. Returns
    (positions, normals, MLSSurface, in-radius counts (N,) int32)."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"mls_moments_cuda: points must be on a CUDA device, got {dev}")
    n = points.shape[0]
    knn._check("points", points, torch.float32, (n, 3), dev)
    knn._check("valid", valid, torch.bool, (n,), dev)
    if not 1 <= bucket_capacity <= MAX_BUCKET_CAPACITY or n >= 2**31 or table_size >= 2**31:
        raise ValueError(f"mls_moments: capacity {bucket_capacity} (<= {MAX_BUCKET_CAPACITY}), "
                         f"{n} points, table {table_size} out of range")
    if grid is None:
        grid = knn.build(points, valid, search_radius, table_size, bucket_capacity)
    elif tuple(grid.buckets.shape) != (table_size, bucket_capacity):
        raise ValueError(f"mls_moments: grid of shape {tuple(grid.buckets.shape)}, "
                         f"expected {(table_size, bucket_capacity)}")
    out3 = [torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(6)]
    coeffs = torch.empty((n, 6), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        if order is None:
            order = (grid.order if grid.order is not None
                     else knn.cell_order(points, grid.cell_size, table_size))
        knn._check("order", order, torch.int32, (n,), dev)
        sizes_ptr, n_sizes = knn._run_sizes(run_sizes, dev)
        r2 = torch.tensor(search_radius * search_radius, dtype=torch.float32).item()
        sg = torch.tensor(sqr_gauss_param, dtype=torch.float32).item()
        err = kbuild.library("mls", _SIGNATURES).mls_moments(
            grid.buckets.data_ptr(), grid.counts.data_ptr(), points.data_ptr(),
            order.data_ptr(), *(t.data_ptr() for t in out3), coeffs.data_ptr(),
            ok.data_ptr(), cnt.data_ptr(), sizes_ptr, n_sizes, n, table_size, bucket_capacity,
            float(search_radius), r2, sg, int(polynomial_order),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mls_moments launch failed: CUDA error {err}")
        launch_counts["mls_moments"] += 1
    pos, nrm, origin, normal, tu, tv = out3
    return pos, nrm, MLSSurface(origin, normal, tu, tv, coeffs, ok), cnt


# ---------------------------------------------------------------------------
# Upsampling (`cloudSmooth.cpp:133-152`)
# ---------------------------------------------------------------------------


def _disc_offsets(radius: float, step: float) -> np.ndarray:
    """(S, 2) f32 grid of (du, dv) offsets within the disc, the
    SAMPLE_LOCAL_PLANE pattern (`cloudSmooth.cpp:136-139`)."""
    ax = np.arange(-radius, radius + step * 0.5, step)
    du, dv = np.meshgrid(ax, ax)
    m = du**2 + dv**2 <= radius**2
    return np.stack([du[m], dv[m]], axis=-1).astype(np.float32)


def _samples(surf: MLSSurface, valid: torch.Tensor, base: torch.Tensor):
    """Sample points ``base`` (N, S, 3), the S of point i on its surface,
    projected there: (positions, normals, ok, owner), each N * S long."""
    n, s = base.shape[:2]
    owner = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=base.device), s)
    pos, nrm = project_onto(surf, base.reshape(n * s, 3), owner=owner)
    return pos, nrm, (valid & surf.ok)[owner.long()], owner


def upsample_local_plane(surf: MLSSurface, valid: torch.Tensor, cfg: MLSConfig):
    """SAMPLE_LOCAL_PLANE: a disc of surface samples around every point."""
    offs = torch.from_numpy(_disc_offsets(cfg.slp_upsampling_radius,
                                          cfg.slp_upsampling_stepsize)).to(surf.origin.device)
    base = surf.origin[:, None, :] + (offs[None, :, 0:1] * surf.tangent_u[:, None, :]
                                      + offs[None, :, 1:2] * surf.tangent_v[:, None, :])
    return _samples(surf, valid, base)


def upsample_random_density(surf: MLSSurface, valid: torch.Tensor, cfg: MLSConfig,
                            generator: torch.Generator | None = None):
    """RANDOM_UNIFORM_DENSITY: ``rud_point_density`` uniform samples in the
    search-radius disc around every point (`cloudSmooth.cpp:141-144`),
    drawn from ``generator`` (on the surfaces' device; a fresh one seeded
    0 if None). Not the JAX package's numbers: ``jax.random`` and torch
    draw differently from one seed (ROADMAP.md §3)."""
    dev = surf.origin.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n, s = surf.origin.shape[0], int(cfg.rud_point_density)
    r = cfg.search_radius * torch.sqrt(torch.rand((n, s), generator=generator, device=dev))
    th = 2.0 * np.pi * torch.rand((n, s), generator=generator, device=dev)
    base = (surf.origin[:, None, :] + (r * torch.cos(th))[..., None] * surf.tangent_u[:, None, :]
            + (r * torch.sin(th))[..., None] * surf.tangent_v[:, None, :])
    return _samples(surf, valid, base)


def _dilate_voxels_host(coords: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation of an integer voxel set on the host (the
    VOXEL_GRID_DILATION grid step): set operations on packed int64 keys,
    the JAX package's numpy code (mls.py:564-580)."""
    offs = np.array(
        [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        np.int64,
    )
    cur = np.unique(coords.astype(np.int64), axis=0)
    for _ in range(iterations):
        grown = (cur[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        key = ((grown[:, 0] + (1 << 20)) << 42) | ((grown[:, 1] + (1 << 20)) << 21) | (
            grown[:, 2] + (1 << 20)
        )
        _, first = np.unique(key, return_index=True)
        cur = grown[first]
    return cur


def upsample_voxel_grid_dilation(points: torch.Tensor, surf: MLSSurface, valid: torch.Tensor,
                                 cfg: MLSConfig):
    """VOXEL_GRID_DILATION: dilate the occupied voxels on the host and
    project every voxel center onto the surface of its nearest source point
    (`cloudSmooth.cpp:146-152`); the nearest search is
    :func:`knn.radius_search` with K = 1 (S1 on the card)."""
    vs = cfg.vgd_voxel_size
    p_np, v_np = points.cpu().numpy(), valid.cpu().numpy()
    occ = np.floor(p_np[v_np] / vs).astype(np.int64)
    cells = _dilate_voxels_host(occ, cfg.vgd_iterations)
    centers = torch.from_numpy((cells.astype(np.float32) + 0.5) * vs).to(points.device)
    reach = max(vs * (cfg.vgd_iterations + 1), cfg.search_radius)
    grid = knn.build(points, valid, cell_size=reach, table_size=max(2 * len(p_np), 1024),
                     bucket_capacity=cfg.bucket_capacity)
    idx, _, ok = knn.radius_search(grid, points, centers, radius=reach, max_neighbors=1)
    owner = torch.clamp(idx[:, 0], min=0)
    pos, nrm = project_onto(surf, centers, owner=owner)
    return pos, nrm, ok[:, 0] & surf.ok[owner.long()], owner


# ---------------------------------------------------------------------------
# The whole stage
# ---------------------------------------------------------------------------

# The upsampling methods `smooth_cloud` takes ("" is "none").
UPSAMPLING = ("none", "", "sample_local_plane", "random_uniform_density", "voxel_grid_dilation")


def _stage(timer, name):
    return contextlib.nullcontext() if timer is None else timer.stage(name)


def smooth_cloud(cloud: PointCloud, cfg: MLSConfig, generator: torch.Generator | None = None,
                 timer=None) -> PointCloud:
    """SOR -> MLS (+ upsampling) -> SOR, `CloudSmooth::process`
    (`cloudSmooth.cpp:77-181`). The result's capacity exceeds the input's
    when upsampling multiplies the points. ``generator`` feeds the
    random-density upsampler; a ``utils.profiling.StageTimer`` given as
    ``timer`` records the stages "mls_sor1", "mls_fit" (the pass and any
    upsampling) and "mls_sor2"."""
    sor_kw = dict(mean_k=cfg.sor_mean_k, std_mult=cfg.sor_std_dev,
                  cell_size=max(cfg.search_radius * 4.0, 0.25),
                  bucket_capacity=max(cfg.bucket_capacity, cfg.sor_mean_k))
    method = cfg.upsampling.lower()
    if method not in UPSAMPLING:
        raise ValueError(f"unknown MLS upsampling method: {cfg.upsampling!r}")
    with _stage(timer, "mls_sor1"):
        valid = cloud.valid & sor.sor_mask(cloud.points, cloud.valid, **sor_kw)
    with _stage(timer, "mls_fit"):
        pos, nrm, ok, surf = mls_smooth(cloud.points, valid, cfg)
        if method in ("none", ""):
            out = cloud.replace(points=pos, normals=nrm if cfg.compute_normals else None,
                                valid=valid & ok)
        else:
            if method == "sample_local_plane":
                up_pos, up_nrm, up_ok, owner = upsample_local_plane(surf, valid, cfg)
            elif method == "random_uniform_density":
                up_pos, up_nrm, up_ok, owner = upsample_random_density(surf, valid, cfg,
                                                                       generator)
            else:
                up_pos, up_nrm, up_ok, owner = upsample_voxel_grid_dilation(
                    cloud.points, surf, valid, cfg)
            owner = owner.long()
            out = PointCloud(
                points=up_pos,
                intensity=cloud.intensity[owner],
                valid=up_ok,
                rgb=None if cloud.rgb is None else cloud.rgb[owner],
                mask_label=None if cloud.mask_label is None else cloud.mask_label[owner],
                normals=up_nrm if cfg.compute_normals else None,
            )
    # The second SOR pass (`cloudSmooth.cpp:160-164`).
    with _stage(timer, "mls_sor2"):
        return out.replace(valid=out.valid & sor.sor_mask(out.points, out.valid, **sor_kw))
