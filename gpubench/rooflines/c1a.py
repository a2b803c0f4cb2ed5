"""C1a, ``colorize_scatter`` (`csrc/colorize.cu`): one launch for up to 32
views of the map, each view's cell minima of range. Bytes: the points and
their validity read once (13 B a point) and each view's key buffer (4 B a
cell of the ds-downsampled grid) written once. f32 operations, counted from
the kernel: for each valid point and view the transform (9 products, 9
sums); in front of the camera the projection (2 divisions, 32 products and
sums) and the gate and cell (2 floors, 2 divisions); for each point gated
in its range (3 products, 2 sums, a square root); a division or square root
counted as one. Operation-bound at the main path's sizes."""

from gpubench import peaks

OPS_VALID, OPS_FRONT, OPS_GATED = 18, 38, 6


def f32_ops(point_views_valid: int, point_views_front: int, point_views_gated: int) -> int:
    return (OPS_VALID * point_views_valid + OPS_FRONT * point_views_front
            + OPS_GATED * point_views_gated)


def nbytes(n: int, views: int, cells: int) -> int:
    return 13 * n + 4 * views * cells


def bound_s(n: int, views: int, cells: int, valid: int, front: int, gated: int) -> float:
    return peaks.bound_s(nbytes=nbytes(n, views, cells), f32_ops=f32_ops(valid, front, gated))
