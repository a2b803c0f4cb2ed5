"""PyTorch port vs the JAX package: voxel hashing and sampling
(`ops/voxel.py`), the grid-hash neighbor search (`ops/knn.py`), local color
smoothing and the observation scores of `ops/fusion.py`.

Tolerance classes: hashes, voxel coords, bucket tables, counts, masks and
neighbor indices bit-exact; neighbor distances within f32 rounding, rtol
1e-6 (the JAX search's square roots are not always correctly rounded: a
few entries an ulp or more apart); smoothed colors within 1e-3 of 0..255 (f32 summation
order); voxel means and scores within f32 rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import fusion as jfus
from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu.ops import voxel as jvox
from pointcloudprocessor_tpu_torch.ops import fusion as tfus
from pointcloudprocessor_tpu_torch.ops import knn as tknn
from pointcloudprocessor_tpu_torch.ops import voxel as tvox


def _cloud(n=3000, seed=0):
    """Random points in a 2 m cube, the first 200 snapped to a 0.1 m
    lattice (exact duplicates and equal distances), 80% colored."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    p[:200] = (np.round(p[:200] * 10) / 10).astype(np.float32)
    colored = rs.uniform(size=n) > 0.2
    rgb = rs.uniform(0, 255, (n, 3)).astype(np.float32)
    return p, colored, rgb


@pytest.mark.parametrize("table", [7, 1024, 2_000_003])
def test_voxel_hash_bit_equal(table):
    rs = np.random.default_rng(table)
    c = rs.integers(-(2**31), 2**31, (5000, 3)).astype(np.int32)
    c[:4] = [[-1, -1, -1], [2**31 - 1, 0, -(2**31)], [0, 0, 0], [-(2**31), -(2**31), 2**31 - 1]]
    c[4:1000] = rs.integers(-40, 40, (996, 3))
    want = np.asarray(jvox.voxel_hash(jnp.asarray(c), table))
    got = tvox.voxel_hash(torch.from_numpy(c), table).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < table


def test_voxel_coords_bit_equal():
    rs = np.random.default_rng(3)
    p = rs.uniform(-50, 50, (4000, 3)).astype(np.float32)
    p[:300] = (rs.integers(-400, 400, (300, 3)) * np.float32(0.15)).astype(np.float32)  # faces
    p[300:303] = [[np.nan, np.inf, -np.inf], [1e30, -1e30, 0.0], [-0.0, 1e-30, -1e-30]]
    for size in (0.15, 0.1, 1.0):
        want = np.asarray(jvox.voxel_coords(jnp.asarray(p), size))
        got = tvox.voxel_coords(torch.from_numpy(p), size).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table, cap", [(6000, 32), (97, 4), (13, 32)])
def test_build_bit_equal(table, cap):
    """Buckets and counts equal JAX's: a roomy table; buckets overflowing a
    capacity of 4; a table of 13, where most cells collide."""
    p, colored, _ = _cloud()
    gj = jknn.build(jnp.asarray(p), jnp.asarray(colored), 0.1, table, cap)
    gt = tknn.build(torch.from_numpy(p), torch.from_numpy(colored), 0.1, table, cap)
    np.testing.assert_array_equal(gt.buckets.numpy(), np.asarray(gj.buckets))
    np.testing.assert_array_equal(gt.counts.numpy(), np.asarray(gj.counts))
    assert gt.counts.sum() == colored.sum()
    if table < 100:
        assert int(gt.counts.max()) > cap  # overflow past the capacity


def _neighbors_both(table, cap, k, q=None, exclude_self=False, seed=0):
    p, colored, _ = _cloud(seed=seed)
    if q is None:
        rs = np.random.default_rng(seed + 1)
        q = np.concatenate([p[:1000], rs.uniform(-1, 1, (500, 3)).astype(np.float32)])
    gj = jknn.build(jnp.asarray(p), jnp.asarray(colored), 0.1, table, cap)
    gt = tknn.build(torch.from_numpy(p), torch.from_numpy(colored), 0.1, table, cap)
    excl = np.arange(len(q), dtype=np.int32) if exclude_self else None
    want = jknn.radius_neighbors(gj, jnp.asarray(p), jnp.asarray(q), 0.1, k,
                                 None if excl is None else jnp.asarray(excl))
    got = tknn.radius_neighbors(gt, torch.from_numpy(p), torch.from_numpy(q), 0.1, k,
                                None if excl is None else torch.from_numpy(excl))
    return [np.asarray(w) for w in want], [g.numpy() for g in got], gj, p, q


def _assert_neighbors_equal(want, got):
    (iw, dw, ow), (ig, dg, og) = want, got
    np.testing.assert_array_equal(ig, iw)
    np.testing.assert_array_equal(og, ow)
    np.testing.assert_allclose(dg[og], dw[ow], rtol=1e-6)
    assert np.isinf(dg[~og]).all() and np.isinf(dw[~ow]).all()


@pytest.mark.parametrize("table, cap, k", [(6000, 32, 32), (97, 4, 32), (13, 32, 8)])
def test_radius_neighbors_bit_equal(table, cap, k):
    """Indices equal JAX's (nearest first, ties to the lower candidate
    position), with lattice duplicates at equal distances, overflowing
    buckets, and a table of 13 where two of a query's 27 cells share a
    bucket, so a neighbor fills two slots."""
    want, got, gj, _, q = _neighbors_both(table, cap, k)
    _assert_neighbors_equal(want, got)
    idx, ok = got[0], got[2]
    if table == 13:
        dup = [len(set(row[o])) < o.sum() for row, o in zip(idx, ok)]
        assert any(dup)  # a bucket listed twice: one neighbor in two slots
        assert ok.sum(1).max() == k  # more in radius than k: the selection ran


def test_radius_neighbors_exclude_self():
    want, got, _, _, _ = _neighbors_both(6000, 32, 16, exclude_self=True)
    _assert_neighbors_equal(want, got)
    assert not (got[0][:1000] == np.arange(1000)[:, None]).any()


def test_radius_neighbors_on_cell_faces():
    """Queries exactly on cell faces (multiples of the 0.1 m cell): the
    port divides exactly, as the JAX package's op-by-op query does."""
    rs = np.random.default_rng(5)
    q = (rs.integers(-9, 10, (600, 3)) * np.float32(0.1)).astype(np.float32)
    want, got, _, _, _ = _neighbors_both(6000, 32, 32, q=q)
    _assert_neighbors_equal(want, got)


def test_chunked_radius_neighbors_matches_jax():
    p, colored, _ = _cloud(seed=2)
    gj = jknn.build(jnp.asarray(p), jnp.asarray(colored), 0.1, 6000, 32)
    gt = tknn.build(torch.from_numpy(p), torch.from_numpy(colored), 0.1, 6000, 32)
    want = jknn.chunked_radius_neighbors(gj, jnp.asarray(p), jnp.asarray(p), 0.1, 32,
                                         chunk_size=700, exclude_self=True)
    got = tknn.chunked_radius_neighbors(gt, torch.from_numpy(p), torch.from_numpy(p), 0.1, 32,
                                        chunk_size=700, exclude_self=True)
    _assert_neighbors_equal([np.asarray(w) for w in want], [g.numpy() for g in got])
    cand_j = np.asarray(jknn.gather_candidates(gj, jnp.asarray(p[:500])))
    cand_t = tknn.gather_candidates(gt, torch.from_numpy(p[:500])).numpy()
    np.testing.assert_array_equal(cand_t, cand_j)


def test_jax_query_cell_under_lax_map_uses_the_reciprocal():
    """A reference-side difference (ROADMAP.md §3): inside ``lax.map`` (the
    JAX package's chunked search) XLA divides by the cell size as a product
    with its reciprocal, so a coordinate on a cell face can land in the
    cell before; op by op, and in the port, the division is exact."""
    rs = np.random.default_rng(6)
    q = (rs.integers(-400, 400, (4000, 3)) * np.float32(0.15)).astype(np.float32)
    eager = np.asarray(jvox.voxel_coords(jnp.asarray(q), 0.15))
    mapped = np.asarray(jax.lax.map(lambda a: jvox.voxel_coords(a, 0.15),
                                    jnp.asarray(q).reshape(8, -1, 3))).reshape(-1, 3)
    port = tvox.voxel_coords(torch.from_numpy(q), 0.15).numpy()
    np.testing.assert_array_equal(port, eager)
    assert (mapped != eager).any()
    assert np.abs(mapped - eager).max() == 1


@pytest.mark.parametrize("radius", [0.1, 0.25])
def test_smooth_colors_local_matches_jax(radius):
    """Within 1e-3 on a cloud where the 0.25 m radius holds more than 32
    colored points (the nearest 32 are taken)."""
    p, colored, rgb = _cloud(seed=4)
    want = np.asarray(jfus.smooth_colors_local(jnp.asarray(p), jnp.asarray(rgb),
                                               jnp.asarray(colored), radius))
    got = tfus.smooth_colors_local(torch.from_numpy(p), torch.from_numpy(rgb),
                                   torch.from_numpy(colored), radius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got[~colored], rgb[~colored])
    assert np.abs(got[colored] - rgb[colored]).max() > 1.0  # it smooths


def test_smooth_colors_local_inverse_distance_blend():
    """The cases of tests/test_culling_fusion.py::TestLocalColorSmoothing,
    held against JAX too."""
    pts = np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [5, 5, 5], [5.1, 5, 5], [9, 9, 9]],
                   np.float32)
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [100, 100, 100], [200, 200, 200],
                    [7, 7, 7]], np.float32)
    colored = np.array([True, True, True, True, True, False])
    out = tfus.smooth_colors_local(torch.from_numpy(pts), torch.from_numpy(rgb),
                                   torch.from_numpy(colored), radius=0.5).numpy()
    want = np.asarray(jfus.smooth_colors_local(jnp.asarray(pts), jnp.asarray(rgb),
                                               jnp.asarray(colored), radius=0.5))
    np.testing.assert_allclose(out, want, atol=1e-3)
    for i in range(3):
        assert np.all(out[i] > 20) and np.all(out[i] < 235)
    assert 100 < out[3].mean() < 200
    np.testing.assert_array_equal(out[5], rgb[5])
    w_self, w_n = 1.0, 1.0 / (1.0 + 0.1**2)
    np.testing.assert_allclose(out[4], (200 * w_self + 100 * w_n) / (w_self + w_n), atol=0.5)


def test_smooth_colors_local_device_dispatch():
    """CPU tensors take the plain version; a CUDA kernel wrapper refuses CPU
    tensors, and another device raises."""
    p, colored, rgb = _cloud(n=300)
    args = (torch.from_numpy(p), torch.from_numpy(rgb), torch.from_numpy(colored), 0.1)
    assert torch.equal(tfus.smooth_colors_local(*args), tfus.smooth_colors_local_plain(*args))
    grid = tknn.build(args[0], args[2], 0.1, 1024, valid_first=True)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.smooth_local_cuda(grid, args[0], args[1], args[2], 0.1, 32, grid.order)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(NotImplementedError):
        tfus.smooth_colors_local(meta, meta, torch.ones((4,), dtype=torch.bool, device="meta"),
                                 0.1)


def test_voxel_downsample_mask_matches_jax():
    p, valid, _ = _cloud(seed=7)
    p[:4] = [[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [1.5, 1.5, 1.5], [2.5, 0.0, 0.0]]
    valid[:4] = True
    for size, table in ((0.05, None), (0.2, 512), (1.0, None)):
        want = np.asarray(jvox.voxel_downsample_mask(jnp.asarray(p), jnp.asarray(valid), size,
                                                     table))
        got = tvox.voxel_downsample_mask(torch.from_numpy(p), torch.from_numpy(valid), size,
                                         table).numpy()
        np.testing.assert_array_equal(got, want)
    assert got[0] and not got[1] and got[3]  # one representative, the first


def test_voxel_average_matches_jax():
    p, valid, rgb = _cloud(seed=8)
    for values in (rgb[:, 0], rgb):
        want = jvox.voxel_average(jnp.asarray(p), jnp.asarray(values), jnp.asarray(valid), 0.2,
                                  4096)
        got = tvox.voxel_average(torch.from_numpy(p), torch.from_numpy(values),
                                 torch.from_numpy(valid), 0.2, 4096)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    pts = np.asarray([[0.1, 0, 0], [0.3, 0, 0], [5.0, 5, 5]], np.float32)
    _, means, counts = tvox.voxel_average(torch.from_numpy(pts), torch.tensor([1.0, 3.0, 10.0]),
                                          torch.ones(3, dtype=torch.bool), 1.0, 64)
    nz = counts.numpy() > 0
    assert nz.sum() == 2
    np.testing.assert_allclose(sorted(means.numpy()[nz].tolist()), [2.0, 10.0])


def test_scores_and_sampling_match_jax():
    rs = np.random.default_rng(9)
    pts = rs.uniform(-3, 6, (500, 3)).astype(np.float32)
    pts[0] = 0.0
    cam_pos = np.asarray([0.3, -0.2, 0.1], np.float32)
    pj, pt = jnp.asarray(pts), torch.from_numpy(pts)
    for compat in (False, True):
        for jf, tf in ((jfus.orientation_score, tfus.orientation_score),):
            np.testing.assert_allclose(
                tf(pt, torch.from_numpy(cam_pos), reference_compat=compat).numpy(),
                np.asarray(jf(pj, jnp.asarray(cam_pos), reference_compat=compat)), atol=1e-6)
        np.testing.assert_allclose(
            tfus.final_score(pt, torch.from_numpy(cam_pos), reference_compat=compat).numpy(),
            np.asarray(jfus.final_score(pj, jnp.asarray(cam_pos), reference_compat=compat)),
            atol=1e-6)
    np.testing.assert_allclose(tfus.distance_score(pt, 3.0, 0.1).numpy(),
                               np.asarray(jfus.distance_score(pj, 3.0, 0.1)), atol=1e-6)
    np.testing.assert_allclose(tfus.gaussian_distance_score(pt, 2.5, 0.7).numpy(),
                               np.asarray(jfus.gaussian_distance_score(pj, 2.5, 0.7)), atol=1e-6)
    s = tfus.gaussian_distance_score(torch.tensor([[0, 0, 2.0], [0, 0, 4.0]]), 2.0, 1.0).numpy()
    np.testing.assert_allclose(s, [1.0, np.exp(-2.0)], atol=1e-6)
    img = rs.integers(0, 256, (6, 7, 3)).astype(np.uint8)
    pix = rs.uniform(-2, 9, (300, 2)).astype(np.float32)
    pix[:3] = [[np.nan, 1.0], [1e12, -1e12], [6.99, 5.99]]
    for im in (img, img[..., 0]):
        np.testing.assert_array_equal(
            tfus.sample_nearest(torch.from_numpy(im), torch.from_numpy(pix)).numpy(),
            np.asarray(jfus.sample_nearest(jnp.asarray(im), jnp.asarray(pix))))
