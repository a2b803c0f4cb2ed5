"""Resample a visual-odometry pose track onto target timestamps.

Port of `pointcloudprocessor_tpu/tools/vo_interp.py`, the rebuild of
`PointCloudProcessor/scripts/make_vo_odom_for_fastlio.py:50-188` (+ its
helper `scripts/pose_interp.py:25-138`): read a pose file in
``ts x y z qw qx qy qz`` form, interpolate (slerp rotations, lerp
translations) onto the timestamps of a second file, and write
``vo_interpolated_odom.txt`` in the same ``qw first`` format, the odometry
input the pipeline consumes (`PointCloudProcessor.cpp:970-978`).

The bracket search and fractions run on the host in float64
(`io/odometry.resample`); the slerp runs in f32 on ``--device`` (default
``cuda``)::

    python -m pointcloudprocessor_tpu_torch.tools.vo_interp \\
        --odometry vo.txt --timestamps stamps.txt --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def read_timestamps(path: str) -> np.ndarray:
    """First whitespace-separated column of every non-empty line."""
    ts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                ts.append(float(parts[0]))
    return np.asarray(ts, np.float64)


def resample(odometry_path: str, timestamps: np.ndarray, device="cuda"):
    """Interpolate the track at ``timestamps`` (clamped to the track span,
    as the reference's index search effectively does).

    Returns (times, positions (Q,3), quats_wxyz (Q,4)).
    """
    from ..io import odometry as odom_io

    traj = odom_io.read(odometry_path)
    out = odom_io.resample(traj, timestamps, device=device)
    return out.times, out.positions, out.quats_wxyz


def write_odometry(path: str, times, positions, quats_wxyz) -> None:
    """``ts x y z qw qx qy qz``, 6/8 decimals: the line format of
    `make_vo_odom_for_fastlio.py:111-126` consumed at
    `PointCloudProcessor.cpp:970-978`."""
    with open(path, "w") as f:
        for ts, p, q in zip(times, positions, quats_wxyz):
            f.write(
                f"{ts:.6f} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} "
                f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n"
            )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Interpolate a VO pose track onto target timestamps "
        "(produces vo_interpolated_odom.txt)"
    )
    ap.add_argument("--odometry", required=True,
                    help="source track: ts x y z qw qx qy qz per line")
    ap.add_argument("--timestamps", required=True,
                    help="file whose first column lists target timestamps")
    ap.add_argument("--output", default="",
                    help="output path (default: vo_interpolated_odom.txt next to source)")
    ap.add_argument("--device", default="cuda", help="torch device of the slerp (default cuda)")
    args = ap.parse_args(argv)

    out = args.output or os.path.join(
        os.path.dirname(os.path.abspath(args.odometry)), "vo_interpolated_odom.txt"
    )
    ts = read_timestamps(args.timestamps)
    times, pos, quat = resample(args.odometry, ts, args.device)
    write_odometry(out, times, pos, quat)
    print(f"wrote {len(times)} poses -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
