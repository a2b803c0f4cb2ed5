"""NID precondition diagnostics for a culled cloud + image pair.

Port of `pointcloudprocessor_tpu/tools/nid_diagnostics.py`, the rebuild of
`PointCloudProcessor/scripts/computeNidForCloudAndImage.py:6-87`, which
plots the LiDAR-intensity and image-intensity histograms so a user can
judge whether NID refinement has signal. This version also computes the
joint histogram and the NID value with the optimizer's own path
(:func:`pointcloudprocessor_tpu_torch.opt.nid.nid_histograms` at one
keyframe: on the card one ``bin_pack``, one ``tap_take`` and one
``nid_hist_fwd`` launch), prints a JSON report, and optionally saves a
histogram figure::

    python -m pointcloudprocessor_tpu_torch.tools.nid_diagnostics \\
        --cloud filtered_pcd/<ts>_beforeNID.pcd --image images/<ts>.jpg \\
        --intrinsic FX FY CX CY --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def keyframe(cloud_path: str, image_path: str, bins: int, device):
    """(cloud with intensities min-max normalized, (H, W) gray image in [0,
    1], the NIDKeyframe batch of one) of a culled cloud and its image."""
    import torch

    from ..core import cloud as cl
    from ..io import images as img_io
    from ..io import pcd
    from ..opt import nid as nid_mod

    cloud = cl.normalize_intensity(pcd.read_cloud(cloud_path, device))
    gray = img_io.load_gray_normalized(image_path)
    kf = nid_mod.NIDKeyframe(
        points=cloud.points[None],
        intensity=cloud.intensity[None],
        valid=cloud.valid[None],
        bin_image=nid_mod.quantize_image(torch.from_numpy(gray).to(device), bins)[None],
    )
    return cloud, gray, kf


def analyze(cloud_path: str, image_path: str, bins: int = 16,
            intrinsic=None, width: int = 0, height: int = 0, device="cuda") -> dict:
    """The report of `nid_diagnostics.py:20-62`: both intensity histograms
    and spreads, and with ``intrinsic`` the inlier count and the NID under
    the identity pose (the cloud is in the keyframe camera frame, like the
    ``filtered_pcd/<ts>_beforeNID.pcd`` dumps the reference script reads),
    computed on ``device``."""
    from ..core import se3
    from ..models import camera as cam
    from ..opt import nid as nid_mod

    cloud, gray, kf = keyframe(cloud_path, image_path, bins, device)
    h_px, w_px = gray.shape

    inten = cloud.intensity[cloud.valid].cpu().numpy()
    hist_pts, _ = np.histogram(inten, bins=bins, range=(0.0, 1.0))
    hist_img, _ = np.histogram(gray.ravel(), bins=bins, range=(0.0, 1.0))

    report = {
        "num_points": int(inten.size),
        "image_size": [w_px, h_px],
        "bins": bins,
        "point_intensity_histogram": hist_pts.tolist(),
        "image_intensity_histogram": hist_img.tolist(),
        # Degenerate-histogram warnings: NID needs spread in BOTH signals.
        "point_intensity_spread": float(inten.std()) if inten.size else 0.0,
        "image_intensity_spread": float(gray.std()),
    }

    if intrinsic is not None:
        camera = cam.create_camera("pinhole", intrinsic, (0, 0, 0, 0, 0),
                                   width or w_px, height or h_px, device)
        hists = nid_mod.nid_histograms(camera, se3.identity(device), kf, bins)
        nid_value = nid_mod.nid_from_histograms(*hists)
        report["num_projected"] = int(hists[3][0])
        report["nid"] = float(nid_value[0])
    return report


def save_plot(report: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    x = np.arange(report["bins"])
    axes[0].bar(x, report["point_intensity_histogram"], color="#555")
    axes[0].set_title("LiDAR intensity bins")
    axes[1].bar(x, report["image_intensity_histogram"], color="#555")
    axes[1].set_title("image intensity bins")
    for ax in axes:
        ax.set_xlabel("bin")
        ax.set_ylabel("count")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="NID histogram diagnostics")
    ap.add_argument("--cloud", required=True, help="culled PCD (camera frame)")
    ap.add_argument("--image", required=True)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--intrinsic", type=float, nargs=4, default=None,
                    metavar=("FX", "FY", "CX", "CY"),
                    help="compute the actual NID under identity pose")
    ap.add_argument("--plot", default="", help="save histogram figure PNG")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    report = analyze(args.cloud, args.image, args.bins, args.intrinsic, device=args.device)
    if args.plot:
        save_plot(report, args.plot)
        report["plot"] = args.plot
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
