"""G2's addressing (``ops/tap_gather.wide_take_plan``, the torch model of
how kernel G2 ``wide_take`` reads B1's packed tiles) against the JAX
package's wide table and the twin ``wide_take_plain``.

The model reads each point's window from at most 2 x 2 tiles: the tile row
of its first clamped row and, only where needed, the one below; the tile of
its first clamped column and, only where needed, the one after. Its words
come from the needed 16-byte halves only (a half not needed reads as the
complement of its words). Tolerance: bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.ops import tap_gather as tg

from test_torch_wide_cache import _edge_knots

# The shapes of test_torch_wide_cache.py, one with each side 3 mod 5 and
# one with each side 4 mod 5 (the last tile row and column end at the
# image's last pixel, or one past it), and two that give each side the
# residues mod 5 the others miss, 0 and 2.
SHAPES = [(13, 21), (1, 1), (16, 24), (9, 8), (18, 23), (19, 24), (20, 22), (22, 25)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_wide_take_plan_is_jax_wide_table_at_every_pixel(shape, margin):
    """The model's planes against JAX's ``build_wide_tap_table(bins,
    m)[anchor]`` (transposed) and the twin, at every pixel, 3 past each
    border and on +-1e9 and +-2^31 knots, at 1, 15 and 16 bins; no point
    reads more than 2 x 2 tiles, or more than 2 halves a tile."""
    h, w = shape
    rs = np.random.default_rng(h * 100 + w + margin)
    kn = _edge_knots(w, h)
    knots = torch.from_numpy(np.stack([kn, kn[::-1]]))
    th, tw = tg.bin_tile_shape(h, w)
    for bins in (1, 15, 16):
        b = rs.integers(0, bins, (2, h, w)).astype(np.int32)
        tiles = tg.pack_bins(torch.from_numpy(b))
        planes, sectors, loads, read = tg.wide_take_plan(tiles, knots, w, h, margin)
        assert planes.shape == (2, 4 + 2 * margin, knots.shape[1])
        assert planes.dtype == torch.int32
        assert torch.equal(planes, tg.wide_take_plain(tiles, knots, w, h, margin))
        for j in range(2):
            table = np.asarray(jnid.build_wide_tap_table(jnp.asarray(b[j]), margin))
            anchor = (np.clip(kn if j == 0 else kn[::-1], 0, [w - 1, h - 1]).astype(np.int64)
                      @ np.asarray([1, w]))
            np.testing.assert_array_equal(planes[j].numpy(), table[anchor].T)
        assert int(sectors.min()) >= 1 and int(sectors.max()) <= min(4, th * tw)
        assert bool((loads >= sectors).all()) and bool((loads <= 2 * sectors).all())
        # The tiles read: the sectors counted, inside the plane, and at most
        # 2 tile rows by 2 tile columns.
        assert torch.equal((read >= 0).sum(-1).to(torch.int32), sectors)
        assert int(read.max()) < th * tw and int(read[..., 0].min()) >= 0
        for a, b, along in ((0, 1, read % tw), (2, 3, read % tw), (0, 2, read // tw),
                            (1, 3, read // tw)):
            both = (read[..., a] >= 0) & (read[..., b] >= 0)
            assert bool((along[..., b] - along[..., a])[both].eq(1).all())


@pytest.mark.parametrize("margin, sectors_mean, loads_mean, loads_max",
                         [(1, 1.96, 3.36, 6), (2, 3.24, 5.76, 8)])
def test_wide_take_plan_counts_on_uniform_knots(margin, sectors_mean, loads_mean, loads_max):
    """Every knot of a 500 x 500 block inside a 4096 x 3000 image, so that
    every residue mod 5 is equally frequent: the sectors and 16-byte loads
    a point the kernel's design needs, against 16 (m = 2) and 12 (m = 1)
    4-byte loads over up to 2 x 3 tiles in the first design."""
    tiles = torch.zeros((1, *tg.bin_tile_shape(3000, 4096), tg.TILE), dtype=torch.int32)
    uu, vv = np.meshgrid(np.arange(1000, 1500), np.arange(1000, 1500))
    knots = torch.from_numpy(np.stack([uu.ravel(), vv.ravel()], -1).astype(np.int32))[None]
    _, sectors, loads, _ = tg.wide_take_plan(tiles, knots, 4096, 3000, margin)
    assert float(sectors.double().mean()) == pytest.approx(sectors_mean, abs=1e-9)
    assert float(loads.double().mean()) == pytest.approx(loads_mean, abs=1e-9)
    assert int(sectors.max()) == 4 and int(loads.max()) == loads_max

