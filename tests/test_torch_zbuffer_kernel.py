"""PyTorch port vs the JAX package: the z-buffer scatter-min (K5 /
`tools/zbuffer_probe._zmin_kernel`) and the dispatch of the cull (Z1).

On the CPU the port's wrappers take their plain twins; the JAX Pallas
kernel runs in interpret mode. Tolerance class: bit-exact buffers and
masks (a minimum does not depend on the order of its operands)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.tools import zbuffer_probe as jprobe
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.ops import zbuffer as tzb
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.tools import colorize_anatomy as tanat
from pointcloudprocessor_tpu_torch.tools import zbuffer_probe as tprobe


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("lo, hi", [(2.0, 12.0), (-5.0, 12.0)])
def test_zmin_tiles_matches_pallas_at_probe_quick_size(lo, hi):
    """The probe's --quick size, 65,536 points into 64x48 cells, with the
    probe's ranges and with negative ranges and exact zeros."""
    n, gw, gh = tprobe.QUICK
    n_cells = gw * gh
    rs = np.random.default_rng(0)
    cell = rs.integers(0, n_cells, n).astype(np.int32)
    rng = rs.uniform(lo, hi, n).astype(np.float32)
    rng[rs.uniform(size=n) < 0.05] = 0.0
    want = jprobe.pallas_zmin(jnp.asarray(cell), jnp.asarray(rng), n_cells, interpret=True)
    got = tprobe.zmin_tiles(torch.from_numpy(cell), torch.from_numpy(rng), n_cells)
    assert tuple(got.shape) == tuple(want.shape) == (tprobe.n_rows(n_cells), 128)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # Slots past the cells, and cells no point hit, keep the TPU's 3.0e38.
    flat = got.numpy().reshape(-1)
    assert (flat[n_cells:] == np.float32(3.0e38)).all()


def test_zmin_tiles_matches_pallas_on_anatomy_construction():
    """The anatomy's sink cell and 2048-padding (`colorize_anatomy.py:
    88-103`) on a bench-scene projection whose size is not a multiple of
    2048; the tile-form mask equals the production cull's."""
    scene = bench_scene.build(512, 384, 20_000, 2, "cpu")
    x, y, z, rng, u, v = tanat._project(scene, 1)
    ok, cell, cell_p, rng_p, n_slots = tanat.tiles_inputs(scene.camera, u, v, z, rng, scene.valid)
    assert cell_p.shape[0] == 20_480 and n_slots == (512 // 14) * (384 // 14) + 1
    want = jprobe.pallas_zmin(jnp.asarray(cell_p.numpy()), jnp.asarray(rng_p.numpy()), n_slots,
                              interpret=True)
    got = tprobe.zmin_tiles(cell_p, rng_p, n_slots)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    vis = tanat.tiles_cull(scene.camera, u, v, z, rng, scene.valid)
    assert torch.equal(vis, tzb.cull_mask_uv(scene.camera, u, v, z, rng, scene.valid, 14, 0.05))
    assert 0 < int(vis.sum()) < int(ok.sum())


def test_zmin_tiles_rejects_n_not_multiple_of_2048():
    """The TPU kernel silently drops the last N % 2048 points; the port
    raises instead."""
    with pytest.raises(ValueError, match="multiple of 2048"):
        tprobe.zmin_tiles(torch.zeros(2049, dtype=torch.int32), torch.zeros(2049), 10)


def test_zmin_drops_out_of_range_cells():
    """Cells at or past the buffer are dropped, as XLA's mode="drop" drops
    them (held against it); negative cells are dropped too, where JAX's
    ``.at[]`` would wrap them numpy-style (the cull never makes one)."""
    rs = np.random.default_rng(3)
    n, slots = 5000, 97
    cell = rs.integers(0, 2 * slots, n).astype(np.int32)
    rng = rs.uniform(-3.0, 9.0, n).astype(np.float32)
    want = jnp.full((slots,), 3.0e38, jnp.float32).at[jnp.asarray(cell)].min(
        jnp.asarray(rng), mode="drop")
    got = tzb.zmin(torch.from_numpy(cell), torch.from_numpy(rng), 3.0e38, slots)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    neg = tzb.zmin(torch.tensor([-1, -slots, 0], dtype=torch.int32),
                   torch.tensor([-9.0, -8.0, 1.5]), 3.0e38, slots)
    assert float(neg[0]) == 1.5 and (neg[1:] == np.float32(3.0e38)).all()


@pytest.mark.parametrize("order", [(-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0)])
def test_zmin_stores_negative_zero_as_positive_zero(order):
    """A cell whose minimum is a zero holds +0.0 whatever the signs and the
    order of its zeros (the kernel adds +0.0 to each range too), and a
    -0.0 fill becomes +0.0; equal in value to the JAX scatter-min."""
    rng = torch.tensor([*order, 4.0, -0.0], dtype=torch.float32)
    cell = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    got = tzb.zmin(cell, rng, 3.0e38, 3)
    want = jnp.full((3,), 3.0e38, jnp.float32).at[jnp.asarray(cell.numpy())].min(
        jnp.asarray(rng.numpy()), mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _bits(got.numpy())[:2].tolist() == [0, 0]
    assert _bits(tzb.zmin(cell[:0], rng[:0], -0.0, 2).numpy()).tolist() == [0, 0]


def test_visible_twin_is_the_cull_test():
    rs = np.random.default_rng(4)
    n, slots = 3000, 50
    cell = torch.from_numpy(rs.integers(0, slots, n).astype(np.int32))
    rng = torch.from_numpy(rs.uniform(1.0, 3.0, n).astype(np.float32))
    ok = torch.from_numpy(rs.uniform(size=n) > 0.2)
    buf = tzb.zmin(cell, torch.where(ok, rng, 3.0e38), 3.0e38, slots)
    got = tzb.visible(ok, rng, buf, cell, 0.05)
    want = np.asarray(jnp.asarray(ok.numpy()) & (jnp.asarray(rng.numpy())
                      <= jnp.asarray(buf.numpy())[jnp.asarray(cell.numpy())] + 0.05))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any() and not got[~ok].any()


def _meta(*shapes_dtypes):
    return [torch.empty(s, dtype=d, device="meta") for s, d in shapes_dtypes]


def test_unknown_device_raises():
    """The dispatch names the device it has no kernel for."""
    camera = tcam.create_camera("pinhole", (100.0, 100.0, 32.0, 24.0), (0.0,) * 5, 64, 48, "meta")
    u, v, z, rng = _meta(*[((16,), torch.float32)] * 4)
    (valid,) = _meta(((16,), torch.bool))
    (cell,) = _meta(((16,), torch.int32))
    with pytest.raises(NotImplementedError, match="no kernel"):
        tzb.cull_mask_uv(camera, u, v, z, rng, valid)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tzb.zmin(cell, rng, 3.0e38, 8)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tzb.visible(valid, rng, rng, cell, 0.05)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernels' argument checks run before any build or launch."""
    cell = torch.zeros(8, dtype=torch.int32)
    rng = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        tzb.zmin_cuda(cell, rng, 3.0e38, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tzb.visible_cuda(torch.ones(8, dtype=torch.bool), rng, rng, cell, 0.05)
    assert tzb.launch_counts == {"zmin": 0, "zbuffer_visible": 0}
