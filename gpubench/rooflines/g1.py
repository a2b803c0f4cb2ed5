"""G1, ``tap_take`` (`csrc/tap_gather.cu`): each point's 4 x 4 window of
bins assembled from the packed tiles. Each knot read (8 B) and each row
written (8 B) once, and each distinct pixel of the windows read once at 4
bits: the pixels depend on where the knots fall, so they are counted from
the knots (:func:`window_pixels`). Memory-bound."""

import torch

from gpubench import peaks


def window_pixels(knot: torch.Tensor, width: int, height: int) -> int:
    """Distinct pixels of the clipped 4 x 4 windows at the (K, N, 2) int
    knots, summed over the keyframes (each reads its own image): rows and
    columns -1..2 around the anchor clamped into the image, each clamped."""
    u = torch.clamp(knot[..., 0].long(), 0, width - 1)
    v = torch.clamp(knot[..., 1].long(), 0, height - 1)
    d = torch.arange(-1, 3, device=knot.device)
    total = 0
    for j in range(knot.shape[0]):
        cols = torch.clamp(u[j, :, None] + d, 0, width - 1)
        rows = torch.clamp(v[j, :, None] + d, 0, height - 1)
        seen = torch.zeros(height * width, dtype=torch.bool, device=knot.device)
        seen[(rows[:, :, None] * width + cols[:, None, :]).reshape(-1)] = True
        total += int(seen.sum())
    return total


def nbytes(k: int, n: int, pixels: int) -> float:
    return 16 * k * n + pixels / 2


def bound_s(k: int, n: int, pixels: int) -> float:
    return peaks.bound_s(nbytes=nbytes(k, n, pixels))
