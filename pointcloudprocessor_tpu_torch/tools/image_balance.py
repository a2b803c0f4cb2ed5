"""Batch image color balance: CLAHE + gamma + adaptive gamma correction.

A numpy + OpenCV copy of
`pointcloudprocessor_tpu/tools/image_balance.py` (host code, no device),
the rebuild of `PointCloudProcessor/scripts/image_color_balance_autonomous.py`
(and the interactive `image_color_balance.py`): CLAHE on the LAB L channel
(:17-23), gamma LUT (:25-28), and the optional AGC "mean mix" adaptive gamma
(:65-87) — whose reference implementation is two nested Python pixel loops
(`parallel_mix`/`parallel_bgr`, :30-63); here both are whole-array numpy
expressions. Defaults mirror the reference ``main`` (:116-124: clip 1.0,
tiles 8x8, gamma 0.8, AGC off) and its constants (:12-15).

    python -m pointcloudprocessor_tpu_torch.tools.image_balance images/ --agc
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

DEFAULT_KERNEL_FRAC = 0.06
DEFAULT_MEAN_V = 0.6
RESTRAIN_HIGHLIGHT = 6.0
DARK_EDGE = -0.8


def apply_clahe(image_bgr: np.ndarray, clip_limit: float = 2.0, tile_grid=(8, 8)) -> np.ndarray:
    """CLAHE on the L channel in LAB space (`:17-23`)."""
    import cv2

    lab = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2LAB)
    l, a, b = cv2.split(lab)
    clahe = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=tuple(tile_grid))
    return cv2.cvtColor(cv2.merge((clahe.apply(l), a, b)), cv2.COLOR_LAB2BGR)


def adjust_gamma(image: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """uint8 gamma LUT (`:25-28`)."""
    inv = 1.0 / gamma
    table = (np.power(np.arange(256) / 255.0, inv) * 255).astype(np.uint8)
    return table[image]


def agc_mean_mix(src_bgr: np.ndarray, kernel_size: int = -1, mean_v: float = DEFAULT_MEAN_V) -> np.ndarray:
    """Adaptive gamma correction driven by the local mean brightness
    (`agc_mean_mix` :65-87), vectorised.

    Bright-enough images (`mean_d > DARK_EDGE`): per-pixel gamma
    ``2^r`` on the HSV value channel with highlight restraint, then the
    result is saturate-doubled. Very dark images: per-pixel gamma on BGR
    directly with a global ``mean_d`` boost.
    """
    import cv2

    src = src_bgr.copy()
    hsv = cv2.cvtColor(src, cv2.COLOR_BGR2HSV)
    h, s, v = cv2.split(hsv)
    ksize = kernel_size if kernel_size != -1 else int(min(src.shape[:2]) * DEFAULT_KERNEL_FRAC)
    ksize = ksize if ksize % 2 else ksize - 1
    ksize = max(ksize, 1)
    v_blur = cv2.blur(v, (ksize, ksize)).astype(np.float64)

    mean_c = v_blur.mean() / 255.0
    mean_d = mean_c - mean_v

    delta = v_blur / 255.0 - mean_v
    r = delta / mean_v
    if mean_d > DARK_EDGE:
        # parallel_mix (:30-48). Per-pixel value-channel gamma; the
        # reference's per-pixel BGR writes in its `else` branch are dead
        # (overwritten by the HSV->BGR conversion at :83) so only the
        # v-channel math survives, exactly as replicated here.
        r_hl = np.where(delta > 0, r * np.power(1.0 + delta, RESTRAIN_HIGHLIGHT), r)
        gamma = np.exp2(r_hl)
        vf = v.astype(np.float64) / 255.0
        dd = -0.4 - r_hl
        v_new = np.where(
            delta > DARK_EDGE,
            np.power(vf, gamma) * 255.0,
            np.power(vf, gamma) * (1.0 - dd) * 255.0,
        )
        v_out = np.clip(v_new, 0, 255).astype(np.uint8)
        out = cv2.cvtColor(cv2.merge((h, s, v_out)), cv2.COLOR_HSV2BGR)
        return cv2.add(out, out)  # saturating double (:85)
    # parallel_bgr (:50-63): whole-image dark boost.
    gamma = np.exp2(r + mean_d)[..., None]
    out = np.power(src.astype(np.float64) / 255.0, gamma) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def balance_image(
    image_bgr: np.ndarray,
    clip_limit: float = 1.0,
    tile_grid=(8, 8),
    gamma: float = 0.8,
    agc: bool = False,
) -> np.ndarray:
    out = apply_clahe(image_bgr, clip_limit, tile_grid)
    out = adjust_gamma(out, gamma)
    if agc:
        out = agc_mean_mix(out)
    return out


def process_folder(
    input_folder: str,
    output_folder: str = "",
    clip_limit: float = 1.0,
    tile_grid=(8, 8),
    gamma: float = 0.8,
    agc: bool = False,
) -> int:
    """Balance every image in ``input_folder`` ->
    ``<parent>/image_balanced_color_auto/`` (`:89-114`). Returns count."""
    import cv2

    output_folder = output_folder or os.path.join(
        os.path.dirname(os.path.abspath(input_folder).rstrip(os.sep)),
        "image_balanced_color_auto",
    )
    os.makedirs(output_folder, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(input_folder)):
        path = os.path.join(input_folder, name)
        if not os.path.isfile(path):
            continue
        img = cv2.imread(path)
        if img is None:
            print(f"warning: could not load {path}", file=sys.stderr)
            continue
        cv2.imwrite(os.path.join(output_folder, name),
                    balance_image(img, clip_limit, tile_grid, gamma, agc))
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="CLAHE + gamma (+AGC) batch image balance")
    ap.add_argument("input_folder")
    ap.add_argument("--output", default="")
    ap.add_argument("--clip-limit", type=float, default=1.0)
    ap.add_argument("--tile", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=0.8)
    ap.add_argument("--agc", action="store_true", help="enable adaptive gamma mix")
    args = ap.parse_args(argv)
    n = process_folder(args.input_folder, args.output, args.clip_limit,
                       (args.tile, args.tile), args.gamma, args.agc)
    print(f"balanced {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
