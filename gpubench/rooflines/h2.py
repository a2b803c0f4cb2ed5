"""H2, ``hpr_bounds`` + ``hpr_scatter`` + ``hpr_erode`` + ``hpr_test``
(`csrc/hpr.cu`), the views form that the colorize culls take: V views of N
world points in one memset and four launches. Bytes: the points and their
validity read once (13 B a point) and each view's mask written (1 B a point
and view). f32 operations, counted from the kernels: 64 a point and view
(the transform 18, the pixel 34, the range 6, the bearing 2, the cell 4; a
division or square root counted as one) and the erosion, 2 axes x 33 taps x
(a sum and a min) a cell of the 512 x 512 grid, for each view.
Operation-bound."""

from gpubench import peaks

OPS_A_POINT_VIEW = 64
GRID = 512
ERODE_OPS_A_CELL = 2 * 33 * 2


def f32_ops(n: int, views: int) -> int:
    return views * n * OPS_A_POINT_VIEW + views * GRID * GRID * ERODE_OPS_A_CELL


def nbytes(n: int, views: int) -> int:
    return 13 * n + views * n


def bound_s(n: int, views: int) -> float:
    return peaks.bound_s(nbytes=nbytes(n, views), f32_ops=f32_ops(n, views))
