"""B1, ``bin_pack`` (`csrc/tap_gather.cu`): the (K, H, W) int32 bin images
packed at 4 bits a pixel into 8 x 8-pixel tiles of 32 B placed every 5
pixels, (H - 2) // 5 + 1 by (W - 2) // 5 + 1 of them. Each pixel read once
(4 B), each tile written once (32 B); memory-bound."""

from gpubench import peaks

STRIDE, TILE_BYTES = 5, 32


def tiles(height: int, width: int) -> int:
    return ((height - 2) // STRIDE + 1) * ((width - 2) // STRIDE + 1)


def nbytes(k: int, height: int, width: int) -> int:
    return k * (4 * height * width + TILE_BYTES * tiles(height, width))


def bound_s(k: int, height: int, width: int) -> float:
    return peaks.bound_s(nbytes=nbytes(k, height, width))
