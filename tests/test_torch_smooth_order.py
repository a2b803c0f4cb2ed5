"""PyTorch port vs the JAX package: local color smoothing
(`ops/fusion.smooth_colors_local`, JAX fusion.py:196-226) on clouds built
for N1's selection, and the schedule N1 takes.

On the card N1 takes its queries in the order of a grid built with
``valid_first`` (the colored points first, grouped by cell) and stages each
cell's window once; its plain version is the JAX package's form. Here the
plain version is held to the JAX package's on edge clouds (ties at equal
distance with distinct colors at the 32nd neighbor, cells sharing a bucket,
buckets over capacity, points on cell faces, all or no point colored, a
ragged n: ``bench_scene.smooth_edge_clouds``, which chip_smoke.py holds
N1 to on the card), and shown not to depend on the order its queries go
in.
Tolerance class: colors within 1e-3 of 0..255 (f32 summation order); the
grid's tables and orders bit-exact. The JAX search runs op by op
(``jax.disable_jit``): under ``lax.map`` XLA divides by the cell size
through the reciprocal, which moves a face point's cells (ROADMAP.md §3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import fusion as jfus
from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu_torch.ops import fusion as tfus
from pointcloudprocessor_tpu_torch.ops import knn as tknn
from pointcloudprocessor_tpu_torch.ops.voxel import voxel_coords, voxel_hash
from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

RADIUS, STEP = bs.SMOOTH_EDGE_RADIUS, bs.SMOOTH_EDGE_STEP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLOUDS = bs.smooth_edge_clouds()


def _rgb(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, 3)).astype(np.float32)


def _jax(p, colored, rgb, radius):
    with jax.disable_jit():
        return np.asarray(jfus.smooth_colors_local(jnp.asarray(p), jnp.asarray(rgb),
                                                   jnp.asarray(colored), radius))


@pytest.mark.parametrize("name", list(CLOUDS))
def test_plain_matches_jax_on_edge_clouds(name):
    p, colored, radius = CLOUDS[name]
    rgb = _rgb(len(p))
    got = tfus.smooth_colors_local_plain(torch.from_numpy(p), torch.from_numpy(rgb),
                                         torch.from_numpy(colored), radius).numpy()
    np.testing.assert_allclose(got, _jax(p, colored, rgb, radius), atol=1e-3)
    np.testing.assert_array_equal(got[~colored], rgb[~colored])
    if colored.any():
        assert np.abs(got[colored] - rgb[colored]).max() > 1.0  # it smooths


def test_edge_clouds_hold_their_edges():
    """Each edge cloud has the case it is named for."""
    p, colored, _ = CLOUDS["ties at the 32nd"]
    q = torch.from_numpy(p)
    d2 = ((q[:, None] - q[None]) ** 2).sum(-1)
    inner = d2[len(p) // 2]
    assert int((inner <= (2.56 * STEP) ** 2).sum()) > 32
    assert int((inner < 4 * STEP**2).sum()) == 27 and int((inner == 4 * STEP**2).sum()) == 6
    p, colored, _ = CLOUDS["shared buckets"]
    grid = tknn.build(torch.from_numpy(p), torch.from_numpy(colored), RADIUS, 1024)
    hashes = tknn._neighbor_hashes(grid, torch.from_numpy(p))
    assert any(len(set(row.tolist())) < 27 for row in hashes)
    p, colored, _ = CLOUDS["over capacity"]
    grid = tknn.build(torch.from_numpy(p), torch.from_numpy(colored), RADIUS, 2 * len(p))
    assert int(grid.counts.max()) > 32
    p, _, radius = CLOUDS["cell faces"]
    assert (p / np.float32(radius) == np.floor(p / np.float32(radius))).any(axis=1).mean() > 0.5


@pytest.mark.parametrize("name", ["ties at the 32nd", "shared buckets", "ragged n"])
def test_plain_does_not_depend_on_the_query_order(name):
    """The plain version fed three query orders (the identity, the grid's
    order with the colored points first, as N1 takes them, and the reverse)
    gives each point the same color bit for bit."""
    p, colored, radius = CLOUDS[name]
    pts, col, rgb = torch.from_numpy(p), torch.from_numpy(colored), torch.from_numpy(_rgb(len(p)))
    want = tfus.smooth_colors_local_plain(pts, rgb, col, radius)
    grid = tknn.build(pts, col, radius, max(2 * len(p), 1024), valid_first=True)
    n = len(p)
    for order in (torch.arange(n, dtype=torch.int32), grid.order,
                  torch.arange(n, dtype=torch.int32).flip(0)):
        got = tfus.smooth_colors_local_plain(pts, rgb, col, radius, order=order)
        assert torch.equal(got, want)


@pytest.mark.parametrize("table", [13, 1024, 2_000_003])
def test_valid_first_build_keeps_jax_tables(table):
    """``knn.build(valid_first=True)`` gives JAX's tables and an order that
    lists every valid point first, each part by hash, in index order within
    a hash (stable): N1's schedule."""
    p, colored, _ = CLOUDS["ragged n"]
    pts, col = torch.from_numpy(p), torch.from_numpy(colored)
    grid = tknn.build(pts, col, RADIUS, table, 32, valid_first=True)
    gj = jknn.build(jnp.asarray(p), jnp.asarray(colored), RADIUS, table, 32)
    np.testing.assert_array_equal(grid.buckets.numpy(), np.asarray(gj.buckets))
    np.testing.assert_array_equal(grid.counts.numpy(), np.asarray(gj.counts))
    order = grid.order.long()
    n_col = int(col.sum())
    assert torch.equal(torch.sort(order).values, torch.arange(len(p)))
    assert bool(col[order[:n_col]].all()) and not bool(col[order[n_col:]].any())
    key = voxel_hash(voxel_coords(pts, RADIUS), table).long() + (~col).long() * table
    key = key[order]
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


def test_smooth_local_wrapper_refuses_a_bad_order():
    """N1's wrapper checks its schedule before anything else: a missing one,
    one of the wrong type, shape or device; then the device of the points."""
    p, colored, _ = CLOUDS["ragged n"]
    pts, col = torch.from_numpy(p), torch.from_numpy(colored)
    rgb = torch.from_numpy(_rgb(len(p)))
    grid = tknn.build(pts, col, RADIUS, 2048, valid_first=True)
    args = (grid, pts, rgb, col, RADIUS, 32)
    with pytest.raises(ValueError, match="order"):
        tknn.smooth_local_cuda(*args, None)
    with pytest.raises(TypeError, match="order"):
        tknn.smooth_local_cuda(*args, grid.order.long())
    with pytest.raises(ValueError, match="order"):
        tknn.smooth_local_cuda(*args, grid.order[:-1])
    with pytest.raises(ValueError, match="order"):
        tknn.smooth_local_cuda(*args, torch.zeros(len(p), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tknn.smooth_local_cuda(*args, grid.order)
