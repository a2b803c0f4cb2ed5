"""The roofline counts reproduce the 8-keyframe figures measured on the
card before this benchmark (K1, K2, B1, G1, C1a, H2 at 4096 x 3000, 8 x
262,144 points, a 1M-point map)."""

import pytest
import torch

from gpubench import peaks
from gpubench.rooflines import b1, c1a, c1b, g1, h2, k1, k2


def us(s):
    return s * 1e6


def test_k1_k2():
    assert us(k1.bound_s(8, 262_144)) == pytest.approx(15.0, abs=0.05)
    assert us(k2.bound_s(8, 262_144)) == pytest.approx(20.0, abs=0.05)


def test_b1():
    assert b1.nbytes(8, 3000, 4096) / 1e6 == pytest.approx(519.0, abs=0.5)
    assert b1.bound_s(8, 3000, 4096) * 1e3 == pytest.approx(0.155, abs=0.0005)


def test_g1():
    assert us(g1.bound_s(8, 262_144, 27_768_749)) == pytest.approx(14.2, abs=0.05)


def test_g1_window_pixels():
    # Two points a pixel apart share 12 of their 16 window pixels; a point
    # at the corner reads a clamped 3 x 3 block of distinct pixels.
    knot = torch.tensor([[[5, 5], [6, 5], [0, 0]]], dtype=torch.int32)
    assert g1.window_pixels(knot, 20, 20) == 20 + 9
    assert g1.window_pixels(knot[:, :1], 20, 20) == 16


def test_c1a():
    ops = c1a.f32_ops(1_000_000 * 8, 8_000_000, 5_258_982)
    assert ops == 479_553_892
    cells = (4096 // 14) * (3000 // 14)
    assert c1a.nbytes(1_000_000, 8, cells) / 1e6 == pytest.approx(15.0, abs=0.05)
    assert us(c1a.bound_s(1_000_000, 8, cells, 8_000_000, 8_000_000, 5_258_982)) == \
        pytest.approx(7.16, abs=0.01)


def test_c1b_counts_each_part_once():
    n, k = 1000, 5
    base = c1b.nbytes(n, 4, 0, k, 0, 0)
    assert base == 13 * n + 4
    assert c1b.nbytes(n, 4, 10, k, 3, 2) - base == 10 * (4 * k + 8) + 3 * 3 + 8 * 2


def test_h2_views_form():
    assert us(h2.bound_s(1_000_000, 8)) == pytest.approx(11.8, abs=0.05)
    assert h2.nbytes(1_000_000, 8) == 21_000_000


def test_peaks_pick_the_larger_bound():
    assert peaks.bound_s(nbytes=peaks.HBM_BYTES_S) == 1.0
    assert peaks.bound_s(nbytes=1.0, f32_ops=peaks.F32_OPS_S) == 1.0
