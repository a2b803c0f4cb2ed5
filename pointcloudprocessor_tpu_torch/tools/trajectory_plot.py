"""Headless trajectory / reconstruction visual check.

Port of `pointcloudprocessor_tpu/tools/trajectory_plot.py` (host code over
the port's `io/odometry` and `core/se3`, no device), the rebuild of
`PointCloudProcessor/scripts/gen_reconstruct_pose_plots.py:51-218`,
which opens an Open3D window showing VO vs LIO trajectories with pose axes
over the cloud and saves screenshots on a keypress. Pods have no display, so
this renders the same comparison straight to PNG with matplotlib: top-down
(x-y) and side (x-z) views, the cloud as a density-thinned scatter, each
trajectory as a colored polyline with start/end markers and sparse
orientation axes::

    python -m pointcloudprocessor_tpu_torch.tools.trajectory_plot \
        --odometry vo=vo_interpolated_odom.txt --cloud map.pcd --output traj.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_traj(path: str):
    from ..io import odometry as odom_io

    t = odom_io.read(path)
    return np.asarray(t.positions), np.asarray(t.quats_wxyz)


def plot(
    output_path: str,
    trajectories: list[tuple[str, str]],  # (label, odom path)
    cloud_path: str = "",
    max_cloud_points: int = 200_000,
    axis_stride: int = 25,
    axis_len: float = 0.2,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..core import se3

    fig, (ax_xy, ax_xz) = plt.subplots(1, 2, figsize=(14, 6))

    if cloud_path:
        from ..io import pcd

        data = pcd.read(cloud_path)
        pts = np.asarray(data.points)
        if len(pts) > max_cloud_points:
            pts = pts[np.linspace(0, len(pts) - 1, max_cloud_points).astype(np.int64)]
        for ax, (i, j) in ((ax_xy, (0, 1)), (ax_xz, (0, 2))):
            ax.scatter(pts[:, i], pts[:, j], s=0.1, c="#bbbbbb", rasterized=True)

    colors = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd"]
    import torch

    for k, (label, path) in enumerate(trajectories):
        pos, quat = _load_traj(path)
        c = colors[k % len(colors)]
        for ax, (i, j) in ((ax_xy, (0, 1)), (ax_xz, (0, 2))):
            ax.plot(pos[:, i], pos[:, j], color=c, lw=1.2, label=label)
            ax.scatter(*pos[0, [i, j]], color=c, marker="o", s=30)
            ax.scatter(*pos[-1, [i, j]], color=c, marker="s", s=30)
        # Sparse orientation triads (x axis red-ish shade of c kept simple:
        # draw camera +z (view) directions).
        sel = np.arange(0, len(pos), max(axis_stride, 1))
        zdir = se3.quat_rotate(
            torch.as_tensor(quat[sel]), torch.tensor([0.0, 0.0, 1.0])
        ).numpy()
        for ax, (i, j) in ((ax_xy, (0, 1)), (ax_xz, (0, 2))):
            ax.quiver(
                pos[sel, i], pos[sel, j], zdir[:, i], zdir[:, j],
                color=c, width=0.002, scale=1.0 / axis_len, scale_units="xy", alpha=0.6,
            )

    ax_xy.set_title("top view (x-y)")
    ax_xz.set_title("side view (x-z)")
    for ax in (ax_xy, ax_xz):
        ax.set_aspect("equal")
        ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(output_path, dpi=130)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Plot trajectories over the cloud (PNG)")
    ap.add_argument("--odometry", action="append", required=True,
                    metavar="LABEL=PATH", help="repeatable: e.g. vo=vo_interpolated_odom.txt")
    ap.add_argument("--cloud", default="")
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    trajs = []
    for spec in args.odometry:
        label, _, path = spec.partition("=")
        if not path:
            label, path = spec, spec
        trajs.append((label, path))
    plot(args.output, trajs, args.cloud)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
