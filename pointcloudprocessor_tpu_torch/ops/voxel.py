"""Voxel-grid ops: hashing, one point a voxel, per-voxel means.

Port of `pointcloudprocessor_tpu/ops/voxel.py`, the reference's spatial
hash (`vector3i_hash.hpp:14-37`) and voxel-grid averaging
(`frame_cpu.cpp:363-451`). Voxels are keyed by a 3D integer hash into a
fixed-size table; a collision merges two voxels, as in the JAX package.

torch has no general uint32 arithmetic, so the hash is computed in int64
and wrapped to 32 bits with ``& 0xFFFFFFFF`` after each product: the same
bits as the JAX package's uint32 products. ``voxel_coords`` divides by a
0-dim tensor on the points' device: torch divides a CUDA tensor by a Python
number as a product with its reciprocal, which moves points near a voxel's
face into the voxel before.
"""

from __future__ import annotations

import torch

from ..utils.numeric import to_int32

# Prime multipliers of the reference's XORCombineVector3iHash
# (vector3i_hash.hpp:14-37), as the JAX package holds them (voxel.py:18-20).
P1, P2, P3 = 73856093, 19349669, 83492791
_U32 = 0xFFFFFFFF


def voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(..., 3) int32 voxel coordinates: floor(p / size), cast as XLA casts
    (saturating, NaN -> 0)."""
    div = torch.full((), voxel_size, dtype=points.dtype, device=points.device)
    return to_int32(torch.floor(points / div))


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """XOR-combine spatial hash of int32 voxel coords (..., 3) ->
    [0, table_size) int32, bit-equal to the JAX package's uint32 hash."""
    c = coords.to(torch.int64) & _U32  # the int32 bits as uint32
    h = ((c[..., 0] * P1) & _U32) ^ ((c[..., 1] * P2) & _U32) ^ ((c[..., 2] * P3) & _U32)
    return (h % table_size).to(torch.int32)


def voxel_downsample_mask(
    points: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    table_size: int | None = None,
) -> torch.Tensor:
    """Keep one representative (lowest-index valid) point per voxel
    (`randomgrid_sampling` with budget 1; the GUI display path at 3 mm,
    `visual_lidar_data.cpp:65-69`). Hash collisions merge voxels."""
    n = points.shape[0]
    table_size = table_size or max(4 * n, 1024)
    h = voxel_hash(voxel_coords(points, voxel_size), table_size)
    idx = torch.arange(n, dtype=torch.int32, device=points.device)
    h_masked = torch.where(valid, h, table_size).long()  # invalid -> sink slot
    winners = torch.full((table_size + 1,), n, dtype=torch.int32, device=points.device)
    winners.scatter_reduce_(0, h_masked, torch.where(valid, idx, n), reduce="amin")
    return valid & (winners[h_masked] == idx)


def voxel_average(
    points: torch.Tensor,
    values: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    table_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-voxel mean of positions and values (`voxelgrid_sampling`
    attribute averaging, `frame_cpu.cpp:363-451`). Returns (mean_points
    (T, 3), mean_values (T, ...), counts (T,)) over the hash table; empty
    slots have count 0."""
    h = voxel_hash(voxel_coords(points, voxel_size), table_size)
    h = torch.where(valid, h, table_size).long()
    w = valid.to(points.dtype)
    dev, dt = points.device, points.dtype
    counts = torch.zeros((table_size + 1,), dtype=dt, device=dev).index_add_(0, h, w)
    sum_pts = torch.zeros((table_size + 1, 3), dtype=dt, device=dev).index_add_(
        0, h, points * w[:, None])
    vshape = tuple(values.shape[1:])
    vw = w.reshape((-1,) + (1,) * len(vshape))
    sum_val = torch.zeros((table_size + 1,) + vshape, dtype=dt, device=dev).index_add_(
        0, h, values.to(dt) * vw)
    denom = torch.clamp(counts, min=1.0)
    return (
        (sum_pts / denom[:, None])[:-1],
        (sum_val / denom.reshape((-1,) + (1,) * len(vshape)))[:-1],
        counts[:-1],
    )
