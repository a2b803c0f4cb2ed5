"""Keyframe selection from a pose track.

Semantics of `PointCloudProcessor::selectKeyframes` + ``markKeyframe``
(`PointCloudProcessor/src/PointCloudProcessor.cpp:1050-1075`,
`include/PointCloudProcessor.hpp:151-191`): greedy scan — a frame becomes a
keyframe when its translation distance to the LAST KEYFRAME reaches the
threshold; the first frame always does. The reference computes an angle
delta too but never uses it (hpp:182-190); honoured here behind a flag.

The scan is a sequential dependence (each decision moves the anchor), done
host-side in numpy: it is O(frames) trivial work over tiny data and is not
worth a `lax.scan`.
"""

from __future__ import annotations

import numpy as np

from ..io.odometry import Trajectory
from ..utils.config import KeyframeConfig


def select(traj: Trajectory, cfg: KeyframeConfig | None = None) -> np.ndarray:
    """Indices of selected keyframes into the trajectory."""
    cfg = cfg or KeyframeConfig()
    pos = np.asarray(traj.positions, np.float64)
    quat = np.asarray(traj.quats_wxyz, np.float64)
    selected = []
    last = None
    for i in range(len(traj)):
        if last is None:
            selected.append(i)
            last = i
            continue
        dist = np.linalg.norm(pos[i] - pos[last])
        take = dist >= cfg.distance_threshold
        if cfg.use_angle and not take:
            # angle between quats: 2*acos(|<q1,q2>|)
            d = abs(float(np.dot(quat[i], quat[last])))
            ang = 2.0 * np.degrees(np.arccos(min(d, 1.0)))
            take = ang >= cfg.angle_threshold
        if take:
            selected.append(i)
            last = i
    return np.asarray(selected, np.int64)
