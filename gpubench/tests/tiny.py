"""The tiny sizes the CPU tests run every cell at: the published widths of
the rig cut to 256 x 188 pixels, 4 keyframes, 20,000 map points and 4,096
culled points a keyframe, and the HPR cull forced to its grid form (the
port takes the dense form at or below 100,000 points)."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"scene": {"width": 256, "height": 188, "focal_px": 4818.2 * 256 / 4096,
                  "keyframes": 4, "map_points": 20_000},
        "pipeline": {"map_capacity": 20_000, "culled_capacity": 4096, "max_keyframes": 4,
                     "culling": {"hpr_impl": "grid"}}}
CELLS = ("calib.s1_k64", "colorize.s2_k64_hpr", "colorize.s1_k64")


def run(name, seed=7, seconds=0.5, trace=False, root=ROOT):
    from gpubench import harness

    return harness.execute(root, name, seed, seconds, trace, "cpu", overrides=TINY,
                           log=lambda line: None)
