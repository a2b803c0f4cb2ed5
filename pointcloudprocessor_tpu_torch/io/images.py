"""Host-side image loading/decoding for the pipeline.

The reference reads images with OpenCV (`cv::imread` at
`PointCloudProcessor/src/PointCloudProcessor.cpp:716`,
`visual_camera_calibration.cpp:171`, masks at `:775`). Decoding stays on
the host here; the decoded arrays are shipped to device once per keyframe
batch.

A copy of `pointcloudprocessor_tpu/io/images.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _imread(path: str):
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1].copy()  # BGR -> RGB
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    return np.asarray(_imread(path), dtype=np.uint8)


def load_gray_normalized(path: str) -> np.ndarray:
    """(H, W) float32 in [0, 1] — the NID cost's image input.

    The reference intends a normalized grayscale image
    (`visual_camera_calibration.cpp:169-173` divides by 255; NB the reference
    passes a 3-channel mat into a single-channel accessor there — a latent
    indexing bug — while its GUI path `visual_lidar_data.cpp` converts to
    grayscale properly. We implement the intended grayscale semantics.)
    """
    rgb = load_rgb(path).astype(np.float32)
    # ITU-R BT.601 luma, matching cv2.cvtColor(..., COLOR_RGB2GRAY).
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return (gray / 255.0).astype(np.float32)


def load_mask(path: str) -> np.ndarray:
    """(H, W) int32 segmentation label image (grayscale PNG), or raises."""
    try:
        import cv2

        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
    except ImportError:
        from PIL import Image

        m = np.asarray(Image.open(path).convert("L"))
    return np.asarray(m, dtype=np.int32)
