"""Voxel-grid ops: hashing, one point a voxel, per-voxel means, random
sampling masks.

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


def _draws(n: int, device, generator, priorities, count: int):
    """``count`` (N,) f32 uniform draws in [0, 1): the given ``priorities``
    (JAX `jax.random.uniform` draws, say, so that a mask can be held to the
    JAX package's), else fresh ones from ``generator`` on ``device``."""
    if priorities is not None:
        if len(priorities) != count:
            raise ValueError(f"expected {count} priority arrays, got {len(priorities)}")
        return [torch.as_tensor(p, dtype=torch.float32, device=device).reshape(n)
                for p in priorities]
    return [torch.rand((n,), generator=generator, device=device) for _ in range(count)]


def randomgrid_sampling_mask(
    points: torch.Tensor,
    valid: torch.Tensor,
    voxel_resolution: float,
    sampling_rate: float,
    table_size: int | None = None,
    generator: torch.Generator | None = None,
    priorities=None,
) -> torch.Tensor:
    """Budgeted per-voxel random sampling — `randomgrid_sampling`
    (`frame_cpu.cpp:454-509`, JAX `voxel.py:90-141`) as a static-shape mask.

    Per-voxel budget ``ceil(rate * N / n_voxels)`` (:484), voxels at or
    under budget keep all points, over-budget voxels keep a uniform random
    subset (:492-497), and a global cap of ``1.2 * rate * N`` trims by a
    second uniform draw (:500-504); ``sampling_rate >= 0.99`` is a no-op
    (:455-458). N counts the valid points.

    The in-voxel ranking sorts by (voxel slot, priority), two stable sorts
    for JAX's ``lexsort``. The priorities are two (N,) uniform draws from
    ``generator`` on the points' device, or ``priorities`` = (pri, pri2)
    given: torch and ``jax.random`` draw different numbers, so a caller
    holding the mask to the JAX package's passes JAX's own draws."""
    if sampling_rate >= 0.99:
        return valid
    n = points.shape[0]
    dev = points.device
    table_size = table_size or max(4 * n, 1024)
    h = voxel_hash(voxel_coords(points, voxel_resolution), table_size).long()
    h = torch.where(valid, h, table_size)  # invalid -> sink bucket
    n_valid = torch.sum(valid.to(torch.int32))

    occupied = torch.zeros((table_size + 1,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, h, valid.to(torch.int32), reduce="amax")
    n_voxels = torch.clamp(torch.sum(occupied[:-1]), min=1)
    rate = torch.tensor(sampling_rate, dtype=torch.float32, device=dev)
    budget = torch.ceil(rate * n_valid.to(torch.float32) / n_voxels.to(torch.float32)).to(
        torch.int32)

    pri, pri2 = _draws(n, dev, generator, priorities, 2)
    by_pri = torch.sort(pri, stable=True).indices
    order = by_pri[torch.sort(h[by_pri], stable=True).indices]  # by voxel, then priority
    h_sorted = h[order]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rank_sorted = pos - torch.searchsorted(h_sorted, h_sorted)  # rank within the voxel
    rank = torch.zeros((n,), dtype=torch.int64, device=dev).scatter_(0, order, rank_sorted)
    keep = valid & (rank < budget)

    # Global cap: uniform re-draw down to 1.2*rate*N when over.
    cap = torch.tensor(1.2 * sampling_rate, dtype=torch.float32, device=dev)
    max_num = torch.floor(cap * n_valid.to(torch.float32)).to(torch.int64)
    pri2 = torch.where(keep, pri2, torch.full_like(pri2, torch.inf))
    kth = torch.sort(pri2).values[torch.clamp(max_num - 1, 0, n - 1)]
    over = torch.sum(keep.to(torch.int64)) > max_num
    return torch.where(over, keep & (pri2 <= kth), keep)


def random_sampling_mask(valid: torch.Tensor, num_samples: int,
                         generator: torch.Generator | None = None,
                         priorities=None) -> torch.Tensor:
    """Uniform random subset of valid points (mask with ~num_samples True)
    — analogue of `random_sampling` (`frame_cpu.cpp:346-360`, JAX
    `voxel.py:144-150`). The draw is an (N,) uniform from ``generator`` on
    the mask's device, or ``priorities`` = (draw,) given (JAX's, say)."""
    n = valid.shape[0]
    dev = valid.device
    n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    p = torch.clamp(torch.tensor(num_samples, dtype=torch.float32, device=dev)
                    / n_valid.to(torch.float32), max=1.0)
    (u,) = _draws(n, dev, generator, priorities, 1)
    return valid & (u < p)
