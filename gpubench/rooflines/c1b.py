"""C1b, ``colorize_update`` (`csrc/colorize.cu`): one keyframe fused into the
top-K registers. Bytes: the points and their validity (13 B a point) and
the keyframe's cull (its key buffer of 4 B a cell under the z-buffer, its
mask of 1 B a point under HPR) read once; a visible point's K scores and
its count read and written (4 K + 8 B); each distinct pixel whose sample a
slot takes read once (3 B); each slot replaced written (8 B: score and
color). The counts depend on the data: the reference counts them on the
traced jobs' own inputs. Memory-bound."""

from gpubench import peaks


def nbytes(n: int, cull_bytes: int, visible: int, top_k: int, pixels: int, replaced: int) -> int:
    return 13 * n + cull_bytes + 3 * pixels + visible * (4 * top_k + 8) + 8 * replaced


def bound_s(n: int, cull_bytes: int, visible: int, top_k: int, pixels: int,
            replaced: int) -> float:
    return peaks.bound_s(nbytes=nbytes(n, cull_bytes, visible, top_k, pixels, replaced))
