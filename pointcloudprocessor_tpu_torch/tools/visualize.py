"""Visualization CLI: LiDAR-image overlay and cloud snapshot renders.

Port of `pointcloudprocessor_tpu/tools/visualize.py`, the headless
counterpart of the reference's interactive viewers
(`VisualLiDARVisualizer` + `PointsColorUpdater`,
`src/vlcal/common/visual_lidar_visualizer.cpp:9-102`, and
`visualizePointCloud`, `src/PointCloudProcessor.cpp:1077-1102`). The
overlay runs on ``--device`` (default ``cuda``); the cloud render is host
code:

    # TURBO-intensity overlay of a culled cloud on its keyframe image
    python -m pointcloudprocessor_tpu_torch.tools.visualize overlay \\
        --cloud filtered_pcd/<ts>_beforeNID.pcd --image images/<ts>.jpg \\
        --intrinsic FX FY CX CY --blend 0.65 --output overlay.png --device cuda

    # scatter snapshot of a (colorized) cloud
    python -m pointcloudprocessor_tpu_torch.tools.visualize cloud \\
        --cloud cloudInWorldWithRGB.pcd --output cloud.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def overlay(cloud_path: str, image_path: str, intrinsic, distortion=(0, 0, 0, 0, 0),
            width: int = 0, height: int = 0, pose: str = "", blend: float = 0.65,
            point_radius: int = 1, device="cuda"):
    """The (H, W, 3) f32 overlay of a cloud on its image, on ``device``
    (:func:`utils.viz.overlay_intensity`); ``pose`` is
    "tx,ty,tz,qw,qx,qy,qz", the camera <- cloud transform, identity if
    empty."""
    import torch

    from ..core import cloud as cl
    from ..core import se3
    from ..io import images as img_io
    from ..io import pcd
    from ..models import camera as cam
    from ..utils import viz

    rgb = img_io.load_rgb(image_path)
    h, w = rgb.shape[:2]
    camera = cam.create_camera("pinhole", intrinsic, distortion, width or w, height or h, device)
    cloud = cl.normalize_intensity(pcd.read_cloud(cloud_path, device))
    T = se3.identity(device)
    if pose:
        vals = [float(x) for x in pose.split(",")]
        T = se3.from_qt(torch.tensor(vals[3:7], dtype=torch.float32, device=device),
                        torch.tensor(vals[:3], dtype=torch.float32, device=device))
    return viz.overlay_intensity(
        camera, torch.from_numpy(rgb).to(device), cloud.points, cloud.intensity, cloud.valid,
        T_camera_points=T, blend=blend, point_radius=point_radius,
    )


def cmd_overlay(args) -> int:
    from ..utils import viz

    out = overlay(args.cloud, args.image, args.intrinsic, args.distortion, args.width,
                  args.height, args.pose, args.blend, args.point_radius, args.device)
    viz.save_overlay_png(args.output, out)
    print(args.output)
    return 0


def cmd_cloud(args) -> int:
    from ..io import pcd
    from ..utils import viz

    data = pcd.read(args.cloud)
    viz.render_cloud(
        args.output,
        np.asarray(data.points),
        rgb=None if data.rgb is None else np.asarray(data.rgb),
        intensity=None if data.intensity is None else np.asarray(data.intensity),
    )
    print(args.output)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="headless visualization")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ov = sub.add_parser("overlay", help="TURBO intensity overlay on an image")
    ov.add_argument("--cloud", required=True)
    ov.add_argument("--image", required=True)
    ov.add_argument("--intrinsic", type=float, nargs=4, required=True,
                    metavar=("FX", "FY", "CX", "CY"))
    ov.add_argument("--distortion", type=float, nargs=5, default=[0, 0, 0, 0, 0])
    ov.add_argument("--width", type=int, default=0)
    ov.add_argument("--height", type=int, default=0)
    ov.add_argument("--pose", default="",
                    help="tx,ty,tz,qw,qx,qy,qz camera<-cloud transform")
    ov.add_argument("--blend", type=float, default=0.65)
    ov.add_argument("--point-radius", type=int, default=1)
    ov.add_argument("--output", required=True)
    ov.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ov.set_defaults(fn=cmd_overlay)

    cd = sub.add_parser("cloud", help="scatter snapshot of a cloud")
    cd.add_argument("--cloud", required=True)
    cd.add_argument("--output", required=True)
    cd.set_defaults(fn=cmd_cloud)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
