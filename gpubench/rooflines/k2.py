"""K2, ``nid_hist_bwd`` (`csrc/nid_hist.cu`): the adjoint of K1. It reads
what K1 reads (24 B a point) and writes the offsets' gradient (8 B): 32 B
a point; memory-bound."""

from gpubench import peaks

BYTES_A_POINT = 32


def bound_s(k: int, n: int) -> float:
    return peaks.bound_s(nbytes=BYTES_A_POINT * k * n)
