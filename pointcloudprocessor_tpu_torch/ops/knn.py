"""Grid-hash neighbor search, the kd-tree's replacement.

Port of `pointcloudprocessor_tpu/ops/knn.py` (the reference's PCL kd-tree
radius searches, e.g. the color smoothing's octree at
`PointCloudProcessor.cpp:642-644`): points are bucketed by the spatial hash
of their voxel cell (`vector3i_hash.hpp:14-37`) into a fixed (table_size,
bucket_capacity) index table built with a sort, and a query examines the 27
cells around its own. With cell_size >= radius every neighbor within the
radius lies in those cells; results are exact up to bucket overflow (points
past ``bucket_capacity`` in a bucket are dropped) and include a bucket twice
where two of the 27 cells hash to it, as in the JAX package.

:func:`build` and the queries are torch ops on any device. The JAX package
runs the queries of :func:`chunked_radius_neighbors` under ``lax.map``,
where XLA divides a query by the cell size as a product with its reciprocal
(its ``build`` divides exactly); the port divides exactly everywhere, so a
query whose coordinate is within an ulp of a cell face can see its 27 cells
one cell over (ROADMAP.md §3). :func:`smooth_local_cuda` is the N1 kernel
(`csrc/smooth.cu`): the radius search and the color blend of
``fusion.smooth_colors_local`` in one launch. ``launch_counts`` counts its
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..kernels import build as kbuild
from .voxel import voxel_coords, voxel_hash


class HashGrid(NamedTuple):
    """Bucketed point index table.

    buckets: (T, B) int32 point indices, -1 = empty slot.
    counts: (T,) int32 occupancy (may exceed B; slots past B dropped).
    cell_size: the cell edge used for bucketing.
    table_size: T.
    """

    buckets: torch.Tensor
    counts: torch.Tensor
    cell_size: float
    table_size: int


def build(
    points: torch.Tensor,
    valid: torch.Tensor,
    cell_size: float,
    table_size: int,
    bucket_capacity: int = 32,
) -> HashGrid:
    """The hash grid, built with a sort (no atomics), as the JAX package
    builds it (knn.py:51-117): hash each valid point's cell (invalid points
    go to a sink bucket), sort the indices by hash (stable, as
    ``jnp.argsort``), rank each within its hash run, and scatter the index
    to (bucket, rank) for rank < capacity."""
    n = points.shape[0]
    dev = points.device
    h = voxel_hash(voxel_coords(points, cell_size), table_size)
    h = torch.where(valid, h, table_size)
    sorted_h, order = torch.sort(h, stable=True)
    # A run's start is the first index of its hash in the sorted hashes (the
    # JAX package's cummax of the run starts; torch's cummax on the card
    # is a slow scan: 2.7 ms at 1M points).
    rank = torch.arange(n, dtype=torch.int64, device=dev) - torch.searchsorted(sorted_h, sorted_h)
    counts = torch.zeros((table_size + 1,), dtype=torch.int32, device=dev).scatter_add_(
        0, h.long(), valid.to(torch.int32))[:table_size]
    keep = (rank < bucket_capacity) & (sorted_h < table_size)
    flat_slot = torch.where(
        keep, sorted_h.long() * bucket_capacity + torch.clamp(rank, max=bucket_capacity - 1),
        table_size * bucket_capacity,
    )
    buckets = torch.full((table_size * bucket_capacity + 1,), -1, dtype=torch.int32, device=dev)
    buckets[flat_slot] = order.to(torch.int32)
    return HashGrid(
        buckets=buckets[:-1].reshape(table_size, bucket_capacity),
        counts=counts,
        cell_size=cell_size,
        table_size=table_size,
    )


# The 27 cell offsets, in the JAX package's order (dx, then dy, then dz).
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))


def _neighbor_hashes(grid: HashGrid, query_points: torch.Tensor) -> torch.Tensor:
    """(M, 27) buckets of the cells around each query."""
    cells = voxel_coords(query_points, grid.cell_size)  # (M, 3)
    off = torch.tensor(OFFSETS, dtype=torch.int32, device=query_points.device)
    return voxel_hash(cells[:, None, :] + off[None, :, :], grid.table_size)


def gather_candidates(grid: HashGrid, query_points: torch.Tensor) -> torch.Tensor:
    """(M, 27 * B) candidate point indices (-1 = empty) from the 27 cells
    around each query."""
    cand = grid.buckets[_neighbor_hashes(grid, query_points).long()]  # (M, 27, B)
    return cand.reshape(cand.shape[0], -1)


def _candidates_with_points(grid: HashGrid, points: torch.Tensor, query_points: torch.Tensor):
    """(cand (M, C), cx, cy, cz each (M, C)): candidate indices and their
    coordinates, gathered from ``points``."""
    cand = gather_candidates(grid, query_points)
    cand_pts = points[torch.clamp(cand, min=0).long()]
    return cand, cand_pts[..., 0], cand_pts[..., 1], cand_pts[..., 2]


def radius_neighbors_with_points(
    grid: HashGrid,
    points: torch.Tensor,
    query_points: torch.Tensor,
    radius: float,
    max_neighbors: int,
    exclude_self_index: torch.Tensor | None = None,
):
    """:func:`radius_neighbors` that also returns the selected neighbors'
    positions (M, K, 3) (0 in empty slots). Selection is exact: the K
    smallest squared distances, ties to the lower candidate position, as
    ``lax.top_k(-d2, K)`` selects them (a stable sort, not ``torch.topk``)."""
    cand, cx, cy, cz = _candidates_with_points(grid, points, query_points)
    dx = cx - query_points[:, 0:1]
    dy = cy - query_points[:, 1:2]
    dz = cz - query_points[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    # radius * radius in double, then f32, as JAX compares with the weak scalar.
    r2 = torch.tensor(radius * radius, dtype=d2.dtype, device=d2.device)
    d2 = torch.where((cand >= 0) & (d2 <= r2), d2, torch.inf)
    if exclude_self_index is not None:
        d2 = torch.where(cand == exclude_self_index[:, None], torch.inf, d2)
    k = min(max_neighbors, cand.shape[1])
    top_d2, top_idx = torch.sort(d2, dim=1, stable=True)
    top_d2, top_idx = top_d2[:, :k], top_idx[:, :k]
    ok = top_d2 < torch.inf  # finite <=> an in-radius candidate
    dist = torch.sqrt(torch.clamp(top_d2, min=0.0))
    idx = torch.take_along_dim(cand, top_idx, dim=1)
    pts_sel = torch.stack([torch.take_along_dim(c, top_idx, dim=1) for c in (cx, cy, cz)], dim=-1)
    pts_sel = torch.where(ok[..., None], pts_sel, 0.0)
    return torch.where(ok, idx, -1), pts_sel, torch.where(ok, dist, torch.inf), ok


def radius_neighbors(
    grid: HashGrid,
    points: torch.Tensor,
    query_points: torch.Tensor,
    radius: float,
    max_neighbors: int,
    exclude_self_index: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_neighbors`` nearest points within ``radius`` per query:
    (indices (M, K), distances (M, K), valid (M, K)), nearest first; empty
    slots have index -1 and distance +inf."""
    idx, _, dist, ok = radius_neighbors_with_points(
        grid, points, query_points, radius, max_neighbors, exclude_self_index)
    return idx, dist, ok


def chunked_radius_neighbors(
    grid: HashGrid,
    points: torch.Tensor,
    query_points: torch.Tensor,
    radius: float,
    max_neighbors: int,
    chunk_size: int = 65536,
    exclude_self: bool = False,
):
    """:func:`radius_neighbors` over chunks of ``chunk_size`` queries, so
    the (chunk, 27 * B) candidate tensors stay small (the JAX package's
    ``lax.map``)."""
    m = query_points.shape[0]
    dev = query_points.device
    outs = []
    for s in range(0, m, chunk_size):
        q = query_points[s: s + chunk_size]
        self_idx = (torch.arange(s, s + q.shape[0], dtype=torch.int32, device=dev)
                    if exclude_self else None)
        outs.append(radius_neighbors(grid, points, q, radius, max_neighbors, self_idx))
    if not outs:
        k = min(max_neighbors, 27 * grid.buckets.shape[1])
        return (torch.full((0, k), -1, dtype=torch.int32, device=dev),
                torch.full((0, k), torch.inf, device=dev),
                torch.zeros((0, k), dtype=torch.bool, device=dev))
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# N1: the radius search and color blend of smooth_colors_local, fused
# ---------------------------------------------------------------------------

# Launches of the CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"smooth_local": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # buckets, counts, points, rgb, colored, out, n, table, cap, cell, r2, k, stream
    "smooth_local": ([_PTR] * 6 + [_I32] * 3 + [_F32] * 2 + [_I32, _PTR], _I32),
}
MAX_BUCKET_CAPACITY = 32  # csrc/smooth.cu kMaxB


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {tuple(shape)}, got {tuple(t.shape)}")


def smooth_local_cuda(grid: HashGrid, points: torch.Tensor, rgb: torch.Tensor,
                      colored: torch.Tensor, radius: float, max_neighbors: int) -> torch.Tensor:
    """N1 on the card: (N, 3) colors, each colored point's the
    ``1 / (1 + d^2)``-weighted mean of its ``max_neighbors`` nearest
    colored points within ``radius`` (itself included), found in ``grid``
    (built over ``points`` with ``valid = colored``); other points keep
    their color. One launch; the plain version is
    ``fusion.smooth_colors_local_plain``."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"smooth_local_cuda: points must be on a CUDA device, got {dev}")
    n = points.shape[0]
    t, cap = grid.buckets.shape
    _check("buckets", grid.buckets, torch.int32, (t, cap), dev)
    _check("counts", grid.counts, torch.int32, (t,), dev)
    _check("points", points, torch.float32, (n, 3), dev)
    _check("rgb", rgb, torch.float32, (n, 3), dev)
    _check("colored", colored, torch.bool, (n,), dev)
    if not 1 <= cap <= MAX_BUCKET_CAPACITY or max_neighbors < 1 or n >= 2**31 or t >= 2**31:
        raise ValueError(f"smooth_local: capacity {cap} (<= {MAX_BUCKET_CAPACITY}), "
                         f"max_neighbors {max_neighbors}, {n} points, table {t} out of range")
    out = torch.empty_like(rgb)
    if n == 0:
        return out
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    err = kbuild.library("smooth", _SIGNATURES).smooth_local(
        grid.buckets.data_ptr(), grid.counts.data_ptr(), points.data_ptr(), rgb.data_ptr(),
        colored.data_ptr(), out.data_ptr(), n, t, cap, float(grid.cell_size), r2,
        int(max_neighbors), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smooth_local launch failed: CUDA error {err}")
    launch_counts["smooth_local"] += 1
    return out
