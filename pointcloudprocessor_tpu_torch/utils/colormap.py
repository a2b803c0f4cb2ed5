"""Colormaps for label and intensity visualization.

Port of `pointcloudprocessor_tpu/utils/colormap.py`: `jet` reproduces the
4-stop colormap of `generateSegmentMapWithColor`
(`PointCloudProcessor.cpp:818-864`); `turbo` serves the GUI-style intensity
overlay (`points_color_updater.cpp:37-61` uses OpenCV's TURBO).
"""

from __future__ import annotations

import torch

# 4-stop map from PointCloudProcessor.cpp:824-829.
_JET_STOPS = torch.tensor(
    [[0.0, 0.0, 0.5], [0.0, 0.5, 1.0], [0.5, 1.0, 0.5], [1.0, 0.5, 0.0]], dtype=torch.float32
)


def jet(value: torch.Tensor) -> torch.Tensor:
    """value (...,) in [0,1] -> (..., 3) rgb in [0,1] via piecewise lerp of
    the reference's 4 stops."""
    stops = _JET_STOPS.to(value.device)
    v = torch.clamp(value, 0.0, 1.0)
    n = stops.shape[0] - 1  # 3 segments
    x = v * n
    seg = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 1)
    frac = x - seg.to(v.dtype)
    lo = stops[seg]
    hi = stops[seg + 1]
    return lo + (hi - lo) * frac[..., None]


def turbo(value: torch.Tensor) -> torch.Tensor:
    """Polynomial approximation of the TURBO colormap (Google), used for
    intensity overlays. value in [0,1] -> rgb in [0,1]."""
    x = torch.clamp(value, 0.0, 1.0)
    r = 0.13572138 + x * (4.61539260 + x * (-42.66032258 + x * (132.13108234 + x * (-152.94239396 + x * 59.28637943))))
    g = 0.09140261 + x * (2.19418839 + x * (4.84296658 + x * (-14.18503333 + x * (4.27729857 + x * 2.82956604))))
    b = 0.10667330 + x * (12.64194608 + x * (-60.58204836 + x * (110.36276771 + x * (-89.90310912 + x * 27.34824973))))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)
