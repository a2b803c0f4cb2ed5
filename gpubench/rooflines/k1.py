"""K1, ``nid_hist_fwd`` (`csrc/nid_hist.cu`): the joint histogram of a
(K, N) batch. Each point's 16 packed taps (8 B), its two offsets (8 B), its
intensity bin (4 B) and its gate (4 B) are read once; the (K, bins, bins)
histogram written is negligible. 24 B a point; memory-bound."""

from gpubench import peaks

BYTES_A_POINT = 24


def bound_s(k: int, n: int) -> float:
    return peaks.bound_s(nbytes=BYTES_A_POINT * k * n)
