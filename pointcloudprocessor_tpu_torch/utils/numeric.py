"""Numeric conversions whose semantics the port must share with XLA."""

from __future__ import annotations

import torch

_INT32_MAX = 2147483647
# The largest float32 below 2**31: float32(2**31 - 1) rounds up to 2**31.
_F32_BELOW_2_31 = 2147483520.0


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: truncate toward zero, saturate at the
    int32 range, NaN -> 0.

    torch's own cast of an out-of-range or NaN float is undefined (it differs
    between the CPU and CUDA), so projections of points far outside the
    image, or of degenerate points, are clamped in float first. That keeps
    inlier sets, anchors and z-buffer cells bit-equal to the JAX package's."""
    x = torch.nan_to_num(x, nan=0.0)
    above = x >= 2147483648.0
    out = torch.clamp(x, -2147483648.0, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(above, _INT32_MAX, out)


def bits_to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern (its low 32 bits) -> the int32
    with the same bits, as XLA's uint32 -> int32 convert gives them."""
    w = w & 0xFFFFFFFF
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
