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
one cell over (ROADMAP.md §3). ``build(..., store_points=True)`` also lays
the points out in the JAX package's (T, 3B) coordinate planes
(``bucket_points``), from which :func:`candidate_points` and the
run-deduplicated :func:`candidate_points_dedup` fetch the MLS fit's
candidates.

Two CUDA kernels live here: :func:`smooth_local_cuda` is N1
(`csrc/smooth.cu`), the radius search and the color blend of
``fusion.smooth_colors_local`` in one launch; :func:`knn_select_cuda` is S1
(`csrc/sor.cu`), the K-nearest radius search of
:func:`chunked_radius_neighbors` in one launch, which :func:`radius_search`
takes on CUDA tensors (the SOR filter, the VGD upsampler's nearest source).
Both take the queries in a schedule that groups equal cells (the grid's own
sort order ``HashGrid.order`` where the caller's queries are the grid's
points, else :func:`cell_order`) and stage each cell's 27-bucket window
once a block in shared memory (`csrc/cell_window.cuh`). N1's schedule is
the order of a grid built with ``valid_first``: its colored points, the
queries, come first, so an uncolored point stages no window. N1's bounds
(`csrc/smooth.cu`): the unique bytes, each input read once (the counts,
the occupied slots, points, rgb, colored, the schedule, the output), and
the bytes of the windows it stages (27 count words and 16 B a slot each).
``launch_counts`` counts their launches.
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
    bucket_points: optional (T, 3B) point coordinates in bucket layout, each
        row [x_0..x_B-1, y_0.., z_0..], +inf in empty slots: the JAX
        package's planes (knn.py:94-105), kept for the plain MLS fit.
    order: optional (N,) int32, the points sorted by bucket (stable; in a
        bucket the valid before the invalid, or with ``valid_first`` all the
        valid before all the invalid), which :func:`build` sorts anyway: the
        schedule that a CUDA search whose queries are the grid's points is
        given.
    """

    buckets: torch.Tensor
    counts: torch.Tensor
    cell_size: float
    table_size: int
    bucket_points: torch.Tensor | None = None
    order: torch.Tensor | None = None


def build(
    points: torch.Tensor,
    valid: torch.Tensor,
    cell_size: float,
    table_size: int,
    bucket_capacity: int = 32,
    store_points: bool = False,
    valid_first: bool = False,
) -> HashGrid:
    """The hash grid, built with a sort (no atomics), as the JAX package
    builds it (knn.py:51-117): hash each point's cell, sort the indices by
    hash (stable, as ``jnp.argsort``; an invalid point after the valid ones
    of its bucket, where the JAX package sends it to a sink bucket), rank
    each valid point within its hash run, and scatter the index to (bucket,
    rank) for rank < capacity. The sorted indices are kept as ``order``.
    ``store_points`` also scatters the coordinates into ``bucket_points``.
    ``valid_first`` sorts every valid point before every invalid one (each
    part by hash): the same tables, and an ``order`` whose valid points come
    first, the schedule of a search whose queries are the valid points
    (N1's colored points, :func:`smooth_local_cuda`)."""
    n = points.shape[0]
    dev = points.device
    h = voxel_hash(voxel_coords(points, cell_size), table_size)
    if table_size >= 2**30:
        h = h.to(torch.int64)
    if valid_first:
        sorted_k, order = torch.sort(h + (~valid).to(h.dtype) * table_size, stable=True)
        is_valid, bucket = sorted_k < table_size, sorted_k
    else:
        sorted_k, order = torch.sort(h * 2 + ~valid, stable=True)
        is_valid, bucket = sorted_k % 2 == 0, sorted_k // 2
    # A run's start is the first index of its key in the sorted keys (the
    # JAX package's cummax of the run starts; torch's cummax on the card
    # is a slow scan: 2.7 ms at 1M points).
    rank = torch.arange(n, dtype=torch.int64, device=dev) - torch.searchsorted(sorted_k, sorted_k)
    counts = torch.zeros((table_size,), dtype=torch.int32, device=dev).scatter_add_(
        0, h.long(), valid.to(torch.int32))
    keep = (rank < bucket_capacity) & is_valid
    flat_slot = torch.where(
        keep, bucket.long() * bucket_capacity + torch.clamp(rank, max=bucket_capacity - 1),
        table_size * bucket_capacity,
    )
    order = order.to(torch.int32)
    buckets = torch.full((table_size * bucket_capacity + 1,), -1, dtype=torch.int32, device=dev)
    buckets[flat_slot] = order
    bucket_points = None
    if store_points:
        bp = torch.full((table_size * bucket_capacity + 1, 3), torch.inf, dtype=points.dtype,
                        device=dev)
        bp[flat_slot] = points[order.long()]
        # (T, B, 3) -> (T, 3, B) -> (T, 3B), coordinate-major rows.
        bucket_points = (bp[:-1].reshape(table_size, bucket_capacity, 3).transpose(1, 2)
                         .reshape(table_size, 3 * bucket_capacity))
    return HashGrid(
        buckets=buckets[:-1].reshape(table_size, bucket_capacity),
        counts=counts,
        cell_size=cell_size,
        table_size=table_size,
        bucket_points=bucket_points,
        order=order,
    )


# The 27 cell offsets, in the JAX package's order (dx, then dy, then dz).
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))


def _neighbor_hashes(grid: HashGrid, query_points: torch.Tensor) -> torch.Tensor:
    """(M, 27) buckets of the cells around each query."""
    cells = voxel_coords(query_points, grid.cell_size)  # (M, 3)
    off = torch.tensor(OFFSETS, dtype=torch.int32, device=query_points.device)
    return voxel_hash(cells[:, None, :] + off[None, :, :], grid.table_size)


def pack_cell_key(cells: torch.Tensor):
    """(..., 3) int32 cell coords -> (key, fits): a unique int32 key a cell
    while every coordinate lies in [-512, 511], and a 0-dim bool saying
    whether all do (JAX knn.py:120; int32 arithmetic wraps as XLA's)."""
    c = cells + 512
    fits = torch.all((c >= 0) & (c < 1024))
    return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20), fits


def cell_order(query_points: torch.Tensor, cell_size: float, table_size: int) -> torch.Tensor:
    """(M,) int32 permutation of the queries sorted by (bucket hash, packed
    cell key) (:func:`pack_cell_key`), stably: equal cells next to each
    other, hash collisions and all, while the cells fit the key's extent (a
    cell past it may share its key and hash with another, and only then
    interleave with it)."""
    cells = voxel_coords(query_points, cell_size)
    key, _ = pack_cell_key(cells)
    h = voxel_hash(cells, table_size)
    lex = (h.to(torch.int64) << 32) | (key.to(torch.int64) + 2**31)
    return torch.sort(lex, stable=True).indices.to(torch.int32)


def _planes(rows: torch.Tensor, m: int):
    """(M, 27, 3B) bucket rows -> (cx, cy, cz), each (M, 27 * B)."""
    b = rows.shape[-1] // 3
    return tuple(rows[..., i * b: (i + 1) * b].reshape(m, 27 * b) for i in range(3))


def candidate_points(grid: HashGrid, query_points: torch.Tensor):
    """Candidate coordinate planes (cx, cy, cz), each (M, 27 * B), +inf in
    empty slots, from ``bucket_points`` (``build(store_points=True)``)."""
    rows = grid.bucket_points[_neighbor_hashes(grid, query_points).long()]  # (M, 27, 3B)
    return _planes(rows, query_points.shape[0])


def candidate_points_dedup(grid: HashGrid, q_chunk: torch.Tensor, key_chunk: torch.Tensor,
                           run_cap: int):
    """:func:`candidate_points` for queries grouped by cell (runs of equal
    ``key_chunk``, the keys of :func:`pack_cell_key`): each run's 27-cell
    window is fetched once, for its first query, and broadcast to the run
    (JAX knn.py:133-209). Returns ``(cx, cy, cz, ok)``; ``ok`` (0-dim bool)
    is False when the chunk holds more than ``run_cap`` runs, and the
    planes are then not to be used."""
    m = q_chunk.shape[0]
    dev = q_chunk.device
    starts = torch.ones((m,), dtype=torch.bool, device=dev)
    starts[1:] = key_chunk[1:] != key_chunk[:-1]
    run_id = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1
    n_runs = run_id[-1] + 1
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    lead_pos = torch.sort(torch.where(starts, iota, m)).values[:run_cap]
    lead_q = q_chunk[torch.clamp(lead_pos, max=m - 1).long()]
    rows = grid.bucket_points[_neighbor_hashes(grid, lead_q).long()]  # (R, 27, 3B)
    wins = rows.reshape(run_cap, -1)[torch.clamp(run_id, max=run_cap - 1).long()]
    return (*_planes(wins.reshape(m, 27, rows.shape[-1]), m), n_runs <= run_cap)


def gather_candidates(grid: HashGrid, query_points: torch.Tensor) -> torch.Tensor:
    """(M, 27 * B) candidate point indices (-1 = empty) from the 27 cells
    around each query."""
    cand = grid.buckets[_neighbor_hashes(grid, query_points).long()]  # (M, 27, B)
    return cand.flatten(1)


def _candidates_with_points(grid: HashGrid, points: torch.Tensor, query_points: torch.Tensor):
    """(cand (M, C), cx, cy, cz each (M, C)): candidate indices and their
    coordinates gathered from ``points`` (those of point 0 in empty slots,
    which the callers mask by ``cand >= 0``)."""
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
    select: str = "exact",
):
    """:func:`radius_neighbors` that also returns the selected neighbors'
    positions (M, K, 3) (0 in empty slots). Selection is exact: the K
    smallest squared distances, ties to the lower candidate position, as
    ``lax.top_k(-d2, K)`` selects them (a stable sort, not ``torch.topk``).

    ``select="approx"`` is the JAX package's ``lax.approx_min_k``, which is
    exact off the TPU (on the CPU it equals ``top_k``,
    tests/test_torch_mls.py), so here it is the same exact selection."""
    if select not in ("exact", "approx"):
        raise ValueError(f"select must be 'exact' or 'approx', got {select!r}")
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


def radius_search(
    grid: HashGrid,
    points: torch.Tensor,
    query_points: torch.Tensor,
    radius: float,
    max_neighbors: int,
    chunk_size: int = 65536,
    exclude_self: bool = False,
    order: torch.Tensor | None = None,
):
    """:func:`chunked_radius_neighbors` by device: CPU tensors take it as it
    is (the plain version); CUDA tensors launch S1
    (:func:`knn_select_cuda`, taking the queries in ``order``), one launch
    for all queries, with the same indices, distances and flags. Any other
    device raises."""
    dev = query_points.device.type
    if dev == "cpu":
        return chunked_radius_neighbors(grid, points, query_points, radius, max_neighbors,
                                        chunk_size, exclude_self)
    if dev == "cuda":
        return knn_select_cuda(grid, points.contiguous(), query_points.contiguous(), radius,
                               max_neighbors, exclude_self, order=order)
    raise NotImplementedError(f"radius_search: no kernel for device {query_points.device}")


# ---------------------------------------------------------------------------
# N1: the radius search and color blend of smooth_colors_local, fused;
# S1: the K-nearest radius search of chunked_radius_neighbors
# ---------------------------------------------------------------------------

# Launches of the CUDA kernels in this process (see reset_launch_counts).
launch_counts = {"smooth_local": 0, "knn_select": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # buckets, counts, points, rgb, colored, order, out, run_sizes, n_sizes, n, table, cap,
    # cell, r2, k, stream
    "smooth_local": ([_PTR] * 8 + [_I32] * 4 + [_F32] * 2 + [_I32, _PTR], _I32),
}
MAX_BUCKET_CAPACITY = 32  # csrc/smooth.cu kMaxB
MAX_SMOOTH_NEIGHBORS = 32  # csrc/smooth.cu kMaxK
_SELECT_SIGNATURES = {
    # buckets, counts, points, queries, order, idx, dist, ok, run_sizes, n_sizes, n_q,
    # table, cap, cell, r2, k, exclude_self, stream
    "knn_select": ([_PTR] * 9 + [_I32] * 4 + [_F32] * 2 + [_I32] * 2 + [_PTR], _I32),
}
MAX_SELECT_CAPACITY = 128  # csrc/sor.cu kMaxB


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {tuple(shape)}, got {tuple(t.shape)}")


def _run_sizes(run_sizes: torch.Tensor | None, device) -> tuple[int | None, int]:
    """(pointer, length) of an optional (L,) int32 histogram of the windows
    a launch stages; (None, 0) without one."""
    if run_sizes is None:
        return None, 0
    if run_sizes.dim() != 1 or run_sizes.numel() < 1:
        raise ValueError(f"run_sizes must be of shape (L,), L >= 1, got {tuple(run_sizes.shape)}")
    _check("run_sizes", run_sizes, torch.int32, run_sizes.shape, device)
    return run_sizes.data_ptr(), run_sizes.numel()


def smooth_local_cuda(grid: HashGrid, points: torch.Tensor, rgb: torch.Tensor,
                      colored: torch.Tensor, radius: float, max_neighbors: int,
                      order: torch.Tensor | None, run_sizes: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """N1 on the card: (N, 3) colors, each colored point's the
    ``1 / (1 + d^2)``-weighted mean of its ``max_neighbors`` (at most 32)
    nearest colored points within ``radius`` (itself included), found in
    ``grid`` (built over ``points`` with ``valid = colored``); other points
    keep their color. One launch. The kernel takes the points in ``order``,
    an (N,) int32 permutation that groups equal cells and lists the colored
    points first: ``grid.order`` of a grid built with ``valid_first``. Its
    colored points are the queries; each cell among a block's queries stages
    its window once, and no uncolored point stages one. The colors do not
    depend on the order (under one that interleaves them, a block also
    takes its uncolored points as queries, which keep their color).
    ``run_sizes``, where given, an (L,) int32 tensor on the card, gains 1 at
    min(s, L - 1) for each window the launch stages, s its queries. The
    plain version is ``fusion.smooth_colors_local_plain``."""
    n = points.shape[0]
    if order is None:
        raise ValueError("smooth_local: the schedule `order` is required (grid.order of a "
                         "grid built with valid_first)")
    _check("order", order, torch.int32, (n,), points.device)
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"smooth_local_cuda: points must be on a CUDA device, got {dev}")
    t, cap = grid.buckets.shape
    _check("buckets", grid.buckets, torch.int32, (t, cap), dev)
    _check("counts", grid.counts, torch.int32, (t,), dev)
    _check("points", points, torch.float32, (n, 3), dev)
    _check("rgb", rgb, torch.float32, (n, 3), dev)
    _check("colored", colored, torch.bool, (n,), dev)
    if (not 1 <= cap <= MAX_BUCKET_CAPACITY or not 1 <= max_neighbors <= MAX_SMOOTH_NEIGHBORS
            or n >= 2**31 or t >= 2**31):
        raise ValueError(f"smooth_local: capacity {cap} (<= {MAX_BUCKET_CAPACITY}), "
                         f"max_neighbors {max_neighbors} (1..{MAX_SMOOTH_NEIGHBORS}), {n} points, "
                         f"table {t} out of range")
    out = torch.empty_like(rgb)
    if n == 0:
        return out
    sizes_ptr, n_sizes = _run_sizes(run_sizes, dev)
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    err = kbuild.library("smooth", _SIGNATURES).smooth_local(
        grid.buckets.data_ptr(), grid.counts.data_ptr(), points.data_ptr(), rgb.data_ptr(),
        colored.data_ptr(), order.data_ptr(), out.data_ptr(), sizes_ptr, n_sizes, n, t, cap,
        float(grid.cell_size), r2, int(max_neighbors), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smooth_local launch failed: CUDA error {err}")
    launch_counts["smooth_local"] += 1
    return out


def knn_select_cuda(grid: HashGrid, points: torch.Tensor, query_points: torch.Tensor,
                    radius: float, max_neighbors: int, exclude_self: bool = False,
                    order: torch.Tensor | None = None, run_sizes: torch.Tensor | None = None):
    """S1 on the card: :func:`chunked_radius_neighbors` for all queries in
    one launch — (idx (M, K) int32, dist (M, K) f32, ok (M, K) bool), K =
    min(max_neighbors, 27 * B): the K smallest squared distances within
    ``radius`` (ties to the lower candidate position, a bucket listed twice
    where two cells share it), nearest first, -1 / +inf / False in empty
    slots; with ``exclude_self`` query i skips point i (the queries are then
    the points). The kernel takes the queries in ``order``, an (M,) int32
    permutation (default :func:`cell_order`; a caller whose queries are the
    grid's points passes ``grid.order``), and stages the window of each
    cell among a block's queries once; the results, in query order, do not
    depend on it. ``run_sizes``, where given, an (L,) int32 tensor on the
    card, gains 1 at min(s, L - 1) for each window the launch stages, s its
    queries. The plain version is :func:`chunked_radius_neighbors`."""
    dev = query_points.device
    if dev.type != "cuda":
        raise ValueError(f"knn_select_cuda: queries must be on a CUDA device, got {dev}")
    n, m = points.shape[0], query_points.shape[0]
    t, cap = grid.buckets.shape
    _check("buckets", grid.buckets, torch.int32, (t, cap), dev)
    _check("counts", grid.counts, torch.int32, (t,), dev)
    _check("points", points, torch.float32, (n, 3), dev)
    _check("queries", query_points, torch.float32, (m, 3), dev)
    if exclude_self and m != n:
        raise ValueError(f"knn_select: exclude_self needs the points as queries ({m} != {n})")
    if not 1 <= cap <= MAX_SELECT_CAPACITY or max_neighbors < 1 or m >= 2**31 or t >= 2**31:
        raise ValueError(f"knn_select: capacity {cap} (<= {MAX_SELECT_CAPACITY}), "
                         f"max_neighbors {max_neighbors}, {m} queries, table {t} out of range")
    k = min(max_neighbors, 27 * cap)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    dist = torch.empty((m, k), dtype=torch.float32, device=dev)
    ok = torch.empty((m, k), dtype=torch.bool, device=dev)
    if m == 0:
        return idx, dist, ok
    if order is None:
        order = cell_order(query_points, grid.cell_size, t)
    _check("order", order, torch.int32, (m,), dev)
    sizes_ptr, n_sizes = _run_sizes(run_sizes, dev)
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    err = kbuild.library("sor", _SELECT_SIGNATURES).knn_select(
        grid.buckets.data_ptr(), grid.counts.data_ptr(), points.data_ptr(),
        query_points.data_ptr(), order.data_ptr(), idx.data_ptr(), dist.data_ptr(),
        ok.data_ptr(), sizes_ptr, n_sizes, m, t, cap, float(grid.cell_size), r2, k,
        int(bool(exclude_self)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_select launch failed: CUDA error {err}")
    launch_counts["knn_select"] += 1
    return idx, dist, ok
