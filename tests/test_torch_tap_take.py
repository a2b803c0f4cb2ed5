"""PyTorch port vs the JAX package: the direct tap-row take (G1,
`csrc/tap_gather.cu` ``tap_take``) and the packer of the bin image it reads
(``bin_pack``), through their plain twins, and the dispatch around them.

The JAX package's `opt/nid._gather_taps` (``use_grouped=False``) clips each
(u, v) knot into the image and takes its keyframe's row of the tap table
(`build_tap_table`) with a vmap'd ``jnp.take``. The port builds no table on
that path: `ops/tap_gather.pack_bins` packs the bin image at 4 bits a pixel
in 8x8-pixel tiles and `direct_take` assembles each row from its window's
16 nibbles, G1 on CUDA tensors and `direct_take_plain` on CPU ones. The
kernels run only on the card, where `chip_smoke.py` holds them to the
twins. Tolerance class: bit-exact (integer data movement)."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.ops import tap_gather as ttg
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.opt import refine as trefine
from pointcloudprocessor_tpu_torch.utils import interop

from test_torch_nid import _cameras, _keyframes

CPU = "cpu"
W, H = 128, 96


def _bins(k, seed=0, h=H, w=W, bins=16):
    """(K, H, W) int32 bin images in [0, bins), from a seed."""
    return np.random.default_rng(seed).integers(0, bins, (k, h, w)).astype(np.int32)


def _jax_rows(bins):
    """The JAX package's (K, H*W, 2) tap tables of the bin images."""
    return np.stack([np.asarray(jnid.build_tap_table(jnp.asarray(b))) for b in bins])


def _knots(name, k, seed=0, w=W, h=H):
    """(K, N, 2) int32 (u, v) knots of each regime."""
    rs = np.random.default_rng(seed)
    ends = np.asarray([0, 1, w - 1, w, w + 1, -1, -7], np.int64)
    if name == "inside":
        kn = np.stack([rs.integers(0, w, (k, 1000)), rs.integers(0, h, (k, 1000))], -1)
    elif name == "edges":  # the image's borders, one past them and negative, crossed
        vs = np.asarray([0, 1, h - 1, h, h + 1, -1, -7], np.int64)
        uu, vv = np.meshgrid(ends, vs)
        kn = np.broadcast_to(np.stack([uu.ravel(), vv.ravel()], -1), (k, uu.size, 2))
    elif name == "last row and column":  # every pixel of the first and last rows and columns
        us, vs = np.arange(w), np.arange(h)
        kn = np.concatenate([np.stack([us, np.full(w, v)], -1) for v in (0, h - 1)]
                            + [np.stack([np.full(h, u), vs], -1) for u in (0, w - 1)])
        kn = np.broadcast_to(kn, (k, *kn.shape))
    elif name == "behind camera":  # projections of points behind the camera reach +-1e9
        kn = rs.choice(np.asarray([-10**9, 10**9, -999_999_937, 10**9 + 7, 5, -3]), (k, 777, 2))
    elif name == "int32 extremes":
        kn = rs.choice(np.asarray([-(2**31), 2**31 - 1, 0, w - 1, h - 1]), (k, 513, 2))
    else:  # "mixed": a ragged count of everything above
        kn = np.concatenate([_knots(x, k, seed, w, h) for x in
                             ("inside", "edges", "behind camera", "int32 extremes")], axis=1)
        kn = kn[:, rs.permutation(kn.shape[1])][:, :-5]
    return np.ascontiguousarray(kn).astype(np.int32)


def _jax_take(rows, knot, w=W, h=H):
    """The JAX package's direct take: `_gather_taps(..., use_grouped=False)`,
    which reads only the keyframes' tap tables."""
    cj, _ = _cameras()
    cam = types.SimpleNamespace(width=w, height=h) if (w, h) != (cj.width, cj.height) else cj
    kfs = types.SimpleNamespace(tap_rows=jnp.asarray(rows), tap_slabs=None)
    return np.asarray(jnid._gather_taps(cam, kfs, jnp.asarray(knot), None, use_grouped=False))


@pytest.mark.parametrize("name", ["inside", "edges", "behind camera", "int32 extremes", "mixed",
                                  "last row and column"])
@pytest.mark.parametrize("k", [1, 3])
def test_direct_take_twin_matches_jax(name, k):
    """The take over the packed tiles of seeded bin images equals JAX's
    take of its tap tables on every knot."""
    bins, knot = _bins(k), _knots(name, k)
    want = _jax_take(_jax_rows(bins), knot)
    tiles = ttg.pack_bins(torch.from_numpy(bins))
    got = ttg.direct_take(tiles, torch.from_numpy(knot), W, H)
    assert got.dtype == torch.int32 and tuple(got.shape) == knot.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttg.direct_take_plain(tiles, torch.from_numpy(knot), W, H).numpy(), want)


@pytest.mark.parametrize("h, w", [(13, 21), (1, 1), (16, 24), (9, 8)])
@pytest.mark.parametrize("bins", [1, 15, 16])
def test_pack_bins_read_back_matches_jax_table(h, w, bins):
    """Every pixel's row read back from the packed tiles through the twin
    is the JAX package's `build_tap_table` row, at image sizes that are and
    are not multiples of 8 and at 1, 15 and 16 bins."""
    b = _bins(2, seed=h * w + bins, h=h, w=w, bins=bins)
    tiles = ttg.pack_bins(torch.from_numpy(b))
    th, tw = (max(h - 2, 0) // 5 + 1, max(w - 2, 0) // 5 + 1)
    assert tuple(tiles.shape) == (2, th, tw, 8) and tiles.dtype == torch.int32
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    every = np.ascontiguousarray(np.broadcast_to(
        np.stack([uu.ravel(), vv.ravel()], -1), (2, h * w, 2))).astype(np.int32)
    got = ttg.direct_take_plain(tiles, torch.from_numpy(every), w, h).numpy()
    np.testing.assert_array_equal(got, _jax_rows(b))
    knot = _knots("mixed", 2, w=w, h=h)
    np.testing.assert_array_equal(ttg.direct_take(tiles, torch.from_numpy(knot), w, h).numpy(),
                                  _jax_take(_jax_rows(b), knot, w, h))


def test_pack_bins_layout():
    """Word r of tile (ty, tx) holds in nibble c the bin at pixel
    (5 ty + r, 5 tx + c), the tiles overlapping by 3 pixels; the pixels past
    H and W hold 0; every anchor's 4x4 window lies in tile (max(v - 1, 0) //
    5, max(u - 1, 0) // 5)."""
    h, w = 13, 21
    b = _bins(2, seed=5, h=h, w=w)
    tiles = ttg.pack_bins_plain(torch.from_numpy(b)).numpy().view(np.uint32)
    assert tiles.shape == (2, 3, 4, 8)
    want = np.zeros_like(tiles)
    for kf in range(2):
        for ty in range(3):
            for tx in range(4):
                for r in range(8):
                    for c in range(8):
                        y, x = 5 * ty + r, 5 * tx + c
                        if y < h and x < w:
                            want[kf, ty, tx, r] |= np.uint32(b[kf, y, x]) << np.uint32(4 * c)
    np.testing.assert_array_equal(tiles, want)
    for v in range(h):
        for u in range(w):
            ty, tx = max(v - 1, 0) // 5, max(u - 1, 0) // 5
            for y in (max(v - 1, 0), min(v + 2, h - 1)):
                assert 5 * ty <= y < 5 * ty + 8
            for x in (max(u - 1, 0), min(u + 2, w - 1)):
                assert 5 * tx <= x < 5 * tx + 8


def test_anchors_clip_as_jax():
    """`tap_gather.anchors` is the JAX clip."""
    knot = _knots("mixed", 2)
    want = (np.clip(knot[..., 1].astype(np.int64), 0, H - 1) * W
            + np.clip(knot[..., 0].astype(np.int64), 0, W - 1))
    got = ttg.anchors(torch.from_numpy(knot), W, H)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("xi", [(0.0,) * 6, (0.04, -0.02, 0.0, 0.01, 0.0, 0.01),
                                (0.0, 0.0, -6.0, 0.0, 0.0, 0.0)])
def test_gather_taps_direct_matches_jax(xi):
    """`_gather_taps`'s direct branch on the NID test keyframes, at the
    origin, after a pose step and with every point behind the camera (no
    point gated in): the port's rows are the JAX package's on every point,
    gated in or not, and the direct path reads no tap table."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU))
    assert kt.tap_rows is None and kt.bin_tiles is not None
    _, knot, inl = tnid._project_all(ct, tse3.exp(torch.tensor(xi)), kt)
    ttg.reset_launch_counts()
    got = tnid._gather_taps(ct, kt, knot, inl, use_grouped=False)
    assert ttg.launch_counts["tap_take"] == 0  # the twin, on the CPU
    np.testing.assert_array_equal(got.numpy(), _jax_take(_jax_rows(bins), knot.numpy()))
    if xi[2] == -6.0:
        assert not inl.any()


def test_prepare_keyframes_builds_rows_only_for_grouped():
    """The direct path packs the bin image and builds no tap table; a
    grouped request builds the table K3/K4 read, bit-equal to JAX's."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kfs = interop.nid_keyframes(pts, inten, valid, bins, CPU)
    direct = tnid.prepare_keyframes(kfs)
    assert direct.tap_rows is None and direct.tap_slabs is None
    np.testing.assert_array_equal(direct.bin_tiles.numpy(),
                                  ttg.pack_bins_plain(torch.from_numpy(bins)).numpy())
    grouped = tnid.prepare_keyframes(direct, grouped=True)
    assert grouped.bin_tiles is direct.bin_tiles and grouped.tap_slabs is None
    np.testing.assert_array_equal(grouped.tap_rows.numpy(), _jax_rows(bins))
    _, knot, inl = tnid._project_all(ct, tse3.identity(CPU), direct)
    with pytest.raises(ValueError, match="grouped=True"):
        tnid._gather_taps(ct, direct, knot, inl, use_grouped=True)


def test_bins_over_16_refused():
    """A tap holds 4 bits: the objectives and the solve refuse 17 bins
    before any gather (JAX's table would OR bin 16 into the next nibble)."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU))
    T = tse3.identity(CPU)
    cache = tnid.make_tap_cache(ct, T, kt)
    for call in (lambda: tnid.multi_nid_loss(ct, T, kt, bins=17),
                 lambda: tnid.multi_nid_loss_cached(ct, T, kt, cache, bins=17),
                 lambda: trefine.refine_pose(ct, kt, T, bins=17),
                 lambda: tnid.multi_nid_loss(ct, T, kt, bins=0)):
        with pytest.raises(ValueError, match=r"bins must be in \[1, 16\]"):
            call()
    assert np.isfinite(float(tnid.multi_nid_loss(ct, T, kt, bins=16)))


def test_tile_shape_at_the_main_path_size():
    """A 4096x3000 keyframe packs into 600 x 819 tiles of 32 bytes (15.7 MB),
    against the tap table's 98 MB."""
    assert ttg.bin_tile_shape(3000, 4096) == (600, 819)
    assert 600 * 819 * 32 == 15_724_800 < 4096 * 3000 * 8


def test_direct_take_dispatch():
    """CPU tensors take the twins and launch nothing; the kernel wrappers
    refuse CPU tensors; other devices raise; no knots give no rows."""
    bins = torch.from_numpy(_bins(2))
    tiles = ttg.pack_bins(bins)
    knot = torch.from_numpy(_knots("mixed", 2))
    ttg.reset_launch_counts()
    ttg.direct_take(tiles, knot, W, H)
    assert ttg.launch_counts == dict.fromkeys(
        ("tap_take", "bin_pack", "tap_select", "tap_streamed", "tap_take_blocks", "wide_take",
         "wide_take_blocks", "wide_select"), 0)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.direct_take_cuda(tiles, knot, W, H)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.pack_bins_cuda(bins)
    with pytest.raises(NotImplementedError, match="no kernel"):
        ttg.direct_take(tiles.to("meta"), knot.to("meta"), W, H)
    with pytest.raises(NotImplementedError, match="no kernel"):
        ttg.pack_bins(bins.to("meta"))
    with pytest.raises(ValueError, match="bin tiles"):
        ttg.direct_take(tiles[:, :-1], knot, W, H)
    empty = ttg.direct_take(tiles, knot[:, :0], W, H)
    assert tuple(empty.shape) == (2, 0, 2)
