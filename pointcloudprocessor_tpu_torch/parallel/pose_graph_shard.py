"""The pose-graph smoother with its measurement factors assembled a keyframe
shard a rank.

Port of `pointcloudprocessor_tpu/parallel/pose_graph_shard.py`. Each
per-keyframe NID correction's unary normal-equation blocks, ``w J^T J``
(6x6) and ``-w J^T r`` (6,), assemble on the rank that holds its keyframe
(the ``kf`` axis) and all-gather, 42 floats a keyframe an iteration; the
block-tridiagonal Schur sweep (``opt/pose_graph.solve_block_tridiagonal``)
is O(K) 6x6 solves and runs replicated. The reference never reconciles
per-keyframe poses (`PointCloudProcessor.cpp:495-519`).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import se3
from ..opt import pose_graph
from . import mesh as mesh_lib


def absolute_blocks_sharded(mesh: DeviceMesh, poses: se3.SE3, meas: se3.SE3,
                            weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``opt/pose_graph.absolute_blocks`` of replicated (K,) inputs
    (`pose_graph_shard.py:32-46`): this rank's keyframe rows
    (:func:`mesh.keyframe_rows`), then all-gathered over ``kf``."""
    rows = mesh_lib.keyframe_rows(mesh, poses.q.shape[0])
    H, b = pose_graph.absolute_blocks(se3.SE3(poses.q[rows], poses.t[rows]),
                                      se3.SE3(meas.q[rows], meas.t[rows]), weight[rows])
    return mesh_lib.gather_kf(mesh, H), mesh_lib.gather_kf(mesh, b)


def optimize_sharded(
    mesh: DeviceMesh,
    poses: se3.SE3,  # (K,) initial camera-to-world trajectory, replicated
    odo_meas: se3.SE3,  # (K-1,)
    abs_meas: se3.SE3,  # (K,)
    *,
    abs_weight: torch.Tensor,  # (K,)
    odo_weight=1.0,
    anchor_weight: float = 1e4,
    damping: float = 1e-6,
    iterations: int = 8,
) -> pose_graph.PoseGraphResult:
    """``opt/pose_graph.optimize`` with the unary assembly over ``kf``
    (`pose_graph_shard.py:49-96`): the same Gauss-Newton steps, each
    :func:`absolute_blocks_sharded`; the states and the residual norms
    replicated. K must split evenly over ``kf``."""
    return pose_graph.gauss_newton(poses, odo_meas, abs_meas, abs_weight, odo_weight,
                                   anchor_weight, damping, iterations,
                                   partial(absolute_blocks_sharded, mesh))
