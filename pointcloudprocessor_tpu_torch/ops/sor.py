"""Statistical outlier removal on the hash grid.

Port of `pointcloudprocessor_tpu/ops/sor.py`: the semantics of
`pcl::StatisticalOutlierRemoval` as the reference runs it around its MLS
stage (`cloudSmooth.cpp:110-115,160-164`). Each point's mean distance to
its ``mean_k`` nearest neighbors within ``cell_size`` (itself excluded)
is compared with ``global_mean + std_mult * global_std`` over the valid
points that have a neighbor; points past it, and points with none, are
outliers.

The neighbor search is :func:`knn.radius_search`: the plain
``chunked_radius_neighbors`` on CPU tensors, the S1 kernel (`csrc/sor.cu`)
on CUDA tensors. The reductions after it are torch ops on both, in the JAX
package's order of operations; their sums may round otherwise than XLA's,
so a point whose mean distance lies within a few ulp of the threshold can
fall on the other side.
"""

from __future__ import annotations

import torch

from . import knn


def sor_mask(
    points: torch.Tensor,
    valid: torch.Tensor,
    mean_k: int = 60,
    std_mult: float = 0.7,
    cell_size: float = 0.5,
    table_size: int | None = None,
    bucket_capacity: int = 64,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """(N,) bool inlier mask."""
    stats = sor_stats(points, valid, mean_k, cell_size, table_size, bucket_capacity, chunk_size)
    return sor_threshold(stats, valid, std_mult)[0]


def sor_stats(
    points: torch.Tensor,
    valid: torch.Tensor,
    mean_k: int = 60,
    cell_size: float = 0.5,
    table_size: int | None = None,
    bucket_capacity: int = 64,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """(N,) mean distance of each point to its neighbors (+inf with none)."""
    n = points.shape[0]
    table_size = table_size or max(2 * n, 1024)
    grid = knn.build(points, valid, cell_size, table_size, bucket_capacity)
    _, dist, ok = knn.radius_search(grid, points, points, radius=cell_size,
                                    max_neighbors=mean_k, chunk_size=chunk_size,
                                    exclude_self=True, order=grid.order)
    cnt = torch.sum(ok, dim=1)
    total = torch.sum(torch.where(ok, dist, 0.0), dim=1)
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.inf)


def sor_threshold(mean_d: torch.Tensor, valid: torch.Tensor, std_mult: float):
    """(inlier mask, threshold as a 0-dim tensor) from :func:`sor_stats`."""
    finite = valid & torch.isfinite(mean_d)
    denom = torch.clamp(torch.sum(finite.to(mean_d.dtype)), min=1.0)
    mu = torch.sum(torch.where(finite, mean_d, 0.0)) / denom
    var = torch.sum(torch.where(finite, (mean_d - mu) ** 2, 0.0)) / denom
    thresh = mu + std_mult * torch.sqrt(var)
    return valid & finite & (mean_d <= thresh), thresh
