"""PyTorch port vs the JAX package: the binary frame-directory codec
(`io/frame_bin`, a numpy copy: the files the two packages write are
byte-equal, each loads the other's) and the random sampling masks of
`ops/voxel` (`randomgrid_sampling_mask`, `random_sampling_mask`).

torch and ``jax.random`` draw different numbers, so the masks take their
draws as explicit priority arrays: filled with JAX's own draws
(``jax.random.split`` then ``uniform``, as the JAX functions draw them) the
masks are bit-equal to JAX's; under a ``torch.Generator`` they keep JAX's
structure (per-voxel budget, global cap, the no-op at rate >= 0.99)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.io import frame_bin as jfb
from pointcloudprocessor_tpu.ops import voxel as jvoxel
from pointcloudprocessor_tpu_torch.io import frame_bin as tfb
from pointcloudprocessor_tpu_torch.ops import voxel as tvoxel

import test_frame_bin_sampling

CPU = "cpu"


def _frame(n, seed, cls):
    f = test_frame_bin_sampling._frame(n, seed)
    return cls(points=f.points, times=f.times, normals=f.normals, covs=f.covs,
               intensities=f.intensities, aux=f.aux)


@pytest.mark.parametrize("compact", [True, False])
def test_frame_bin_files_byte_equal(tmp_path, compact):
    """save() writes the same files byte for byte; each package loads the
    other's directory to the same arrays; take / sort_by_time agree."""
    for name, mod in (("j", jfb), ("t", tfb)):
        mod.save(str(tmp_path / name), _frame(100, 3, mod.FrameBin), compact=compact)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    a, b = tfb.load(str(tmp_path / "j")), jfb.load(str(tmp_path / "t"))
    for key in ("points", "times", "normals", "covs", "intensities"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(a.aux["label"], b.aux["label"])
    sa, sb = tfb.sort_by_time(a), jfb.sort_by_time(b)
    np.testing.assert_array_equal(sa.points, sb.points)
    np.testing.assert_array_equal(sa.aux["label"], sb.aux["label"])


def test_frame_bin_precedence_and_missing(tmp_path):
    f = _frame(50, 2, tfb.FrameBin)
    tfb.save(str(tmp_path), f, compact=False)
    tfb.save(str(tmp_path), tfb.FrameBin(points=f.points[:10] + 100.0), compact=True)
    loaded = tfb.load(str(tmp_path))
    assert loaded.size == 50
    np.testing.assert_array_equal(loaded.points, f.points)
    with pytest.raises(FileNotFoundError):
        tfb.load(str(tmp_path / "empty"))


def _budget_scene():
    """test_frame_bin_sampling's scene: 10 voxels of 100 points + 100 voxels
    of 1 point."""
    rng = np.random.default_rng(0)
    centers = rng.integers(100, 200, (10, 3)).astype(np.float64) * 0.1
    dense = np.repeat(centers, 100, axis=0) + rng.uniform(0.005, 0.095, (1000, 3))
    sparse = np.arange(100)[:, None] * np.array([1.0, 0, 0]) + 0.05
    return np.vstack([dense, sparse]).astype(np.float32)


def _jax_draws(key, n, count):
    """The uniform draws the JAX masks make from ``key``."""
    if count == 1:
        return (np.array(jax.random.uniform(key, (n,))),)
    k1, k2 = jax.random.split(key)
    return np.array(jax.random.uniform(k1, (n,))), np.array(jax.random.uniform(k2, (n,)))


@pytest.mark.parametrize("case", [
    dict(scene="budget", rate=0.2, res=0.1, seed=0),
    dict(scene="budget", rate=0.05, res=0.1, seed=1),  # the global cap trims
    dict(scene="random", rate=0.3, res=0.25, seed=2),
    dict(scene="random", rate=0.6, res=0.5, seed=3),
])
def test_randomgrid_mask_bit_equal_under_jax_draws(case):
    """With JAX's draws as priorities the mask equals JAX's bit for bit, a
    quarter of the points invalid on the random scene."""
    if case["scene"] == "budget":
        pts = _budget_scene()
        valid = np.ones(len(pts), bool)
    else:
        rng = np.random.default_rng(case["seed"])
        pts = rng.normal(0, 1.0, (4000, 3)).astype(np.float32)
        valid = rng.uniform(size=4000) > 0.25
    key = jax.random.key(case["seed"])
    want = np.asarray(jvoxel.randomgrid_sampling_mask(
        key, jnp.asarray(pts), jnp.asarray(valid), case["res"], case["rate"]))
    got = tvoxel.randomgrid_sampling_mask(
        torch.from_numpy(pts), torch.from_numpy(valid), case["res"], case["rate"],
        priorities=_jax_draws(key, len(pts), 2))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def test_random_sampling_mask_bit_equal_under_jax_draws():
    rng = np.random.default_rng(8)
    valid = rng.uniform(size=5000) > 0.3
    for num, seed in ((700, 0), (100_000, 1), (1, 2)):
        key = jax.random.key(seed)
        want = np.asarray(jvoxel.random_sampling_mask(key, jnp.asarray(valid), num))
        got = tvoxel.random_sampling_mask(torch.from_numpy(valid), num,
                                          priorities=_jax_draws(key, 5000, 1))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_masks_structure_under_a_generator():
    """test_frame_bin_sampling's budget semantics under a torch.Generator:
    dense voxels trimmed to the budget, sparse voxels kept whole, the global
    cap; one generator seed gives one mask; the no-op at rate >= 0.99."""
    pts = torch.from_numpy(_budget_scene())
    valid = torch.ones(len(pts), dtype=torch.bool)
    rate, n = 0.2, len(pts)
    mask = tvoxel.randomgrid_sampling_mask(pts, valid, 0.1, rate,
                                           generator=torch.Generator().manual_seed(0))
    again = tvoxel.randomgrid_sampling_mask(pts, valid, 0.1, rate,
                                            generator=torch.Generator().manual_seed(0))
    other = tvoxel.randomgrid_sampling_mask(pts, valid, 0.1, rate,
                                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(mask, again) and not torch.equal(mask, other)
    m = mask.numpy()
    budget = int(np.ceil(rate * n / 110))
    assert m[1000:].sum() >= 95
    kept = m[:1000].reshape(10, 100).sum(1)
    assert (kept <= budget).all() and (kept == budget).sum() >= 8
    assert m.sum() <= int(1.2 * rate * n)
    half = torch.arange(64) % 2 == 0
    p64 = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tvoxel.randomgrid_sampling_mask(p64, half, 0.1, 1.0), half)
    r = tvoxel.random_sampling_mask(valid, 300, generator=torch.Generator().manual_seed(3))
    assert 200 < int(r.sum()) < 400
    with pytest.raises(ValueError, match="priority"):
        tvoxel.randomgrid_sampling_mask(pts, valid, 0.1, rate, priorities=(np.zeros(n),))
