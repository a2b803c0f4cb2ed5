"""Odometry / trajectory file IO and resampling.

PyTorch port of `pointcloudprocessor_tpu/io/odometry.py`: the pipeline's
``ts x y z qw qx qy qz`` odometry input (parsed by the reference at
`PointCloudProcessor.cpp:970-978`) and the VO resampling of
`scripts/make_vo_odom_for_fastlio.py:50-188`. Host-side numpy, with the
slerp in f32 torch on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3


class Trajectory(NamedTuple):
    """A timestamped pose track (host numpy arrays)."""

    times: np.ndarray  # (M,)
    positions: np.ndarray  # (M, 3)
    quats_wxyz: np.ndarray  # (M, 4)

    def __len__(self):
        return len(self.times)


def read(path: str) -> Trajectory:
    """Read ``ts x y z qw qx qy qz`` lines (the reference's odometry format)."""
    table = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if table.shape[1] < 8:
        raise ValueError(f"{path}: expected 8 columns 'ts x y z qw qx qy qz'")
    return Trajectory(
        times=table[:, 0],
        positions=table[:, 1:4].astype(np.float32),
        quats_wxyz=table[:, 4:8].astype(np.float32),
    )


def write(path: str, traj: Trajectory) -> None:
    """Write in the reference's odometry format (``ts`` with 6 decimals,
    pose with 8; `make_vo_odom_for_fastlio.py:111-126`)."""
    with open(path, "w") as f:
        for t, p, q in zip(traj.times, traj.positions, traj.quats_wxyz):
            f.write(
                f"{t:.6f} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} "
                f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n"
            )


def resample(traj: Trajectory, query_times: np.ndarray, device="cpu") -> Trajectory:
    """Interpolate the track at query timestamps (slerp + lerp).

    Bracket indices and fractions are computed in host float64 (epoch
    timestamps lose sub-second precision in f32); only the slerp runs in
    f32 torch, on ``device``. Queries outside the track span clamp to the
    ends."""
    times = np.asarray(traj.times, np.float64)
    t = np.clip(np.asarray(query_times, np.float64), times[0], times[-1])
    upper = np.clip(np.searchsorted(times, t, side="right"), 1, len(times) - 1)
    lower = upper - 1
    dt = times[upper] - times[lower]
    frac = np.where(dt > 0, (t - times[lower]) / np.maximum(dt, 1e-12), 0.0)

    q = se3.quat_normalize(se3.quat_slerp(
        torch.as_tensor(traj.quats_wxyz[lower], dtype=torch.float32, device=device),
        torch.as_tensor(traj.quats_wxyz[upper], dtype=torch.float32, device=device),
        torch.as_tensor(frac, dtype=torch.float32, device=device),
    ))
    p = (1.0 - frac)[:, None] * np.asarray(traj.positions[lower], np.float64) + frac[
        :, None
    ] * np.asarray(traj.positions[upper], np.float64)
    return Trajectory(
        times=np.asarray(query_times),
        positions=p.astype(np.float32),
        quats_wxyz=q.cpu().numpy(),
    )
