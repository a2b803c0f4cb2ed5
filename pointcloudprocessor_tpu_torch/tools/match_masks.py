"""CLI for the mask-PNG timestamp matcher.

Port of `pointcloudprocessor_tpu/tools/match_masks.py`, the rebuild of
`PointCloudProcessor/src/extractMaskImg.py:14-43`: copy each mask image to
the nearest odometry timestamp's filename within a tolerance (0.5 s
there). Host code; the matching lives in
:func:`pointcloudprocessor_tpu_torch.pipeline.ingest.match_masks_to_timestamps`.

    python -m pointcloudprocessor_tpu_torch.tools.match_masks \\
        --mask_folder masks --odometry_path odom.txt --output_folder out
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Match mask PNGs to odometry timestamps")
    ap.add_argument("--mask_folder", required=True)
    ap.add_argument("--odometry_path", required=True)
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--tolerance", type=float, default=0.5)
    args = ap.parse_args(argv)

    from ..pipeline import ingest

    n = ingest.match_masks_to_timestamps(
        args.mask_folder, args.odometry_path, args.output_folder, args.tolerance
    )
    print(f"matched {n} masks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
