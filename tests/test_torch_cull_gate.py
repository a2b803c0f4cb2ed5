"""PyTorch port vs the JAX package: the z-buffer cull at the edges of its
gate and grid, the runner's strided inputs, and the bookkeeping around the
fused CUDA cull (the grid, the argument checks).

The fused kernels of `csrc/zbuffer.cu` run only on the card, where
chip_smoke.py holds them to ``cull_mask_uv_plain`` on the same edge set;
here the twin is held to the JAX cull on it. Tolerance class: bit-exact
masks (a minimum does not depend on the order of its operands)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.ops import zbuffer as jzb
from pointcloudprocessor_tpu_torch.ops import zbuffer as tzb
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.utils import interop

W, H = bench_scene.WIDTH, bench_scene.HEIGHT


def _cams(width=W, height=H):
    f = bench_scene.focal(width)
    intr, dist = (f, f, width / 2.0, height / 2.0), (0.0,) * 5
    return (jcam.create_camera("pinhole", intr, dist, width, height),
            interop.camera(np.asarray(intr, np.float32), np.asarray(dist, np.float32), width,
                           height, "cpu"))


def _edge_inputs(ds, n_bulk=20_000, seed=0):
    pts = bench_scene.cull_edge_points(W, H, ds, n_bulk, seed)
    return pts, {k: torch.from_numpy(a) for k, a in pts.items()}


@pytest.mark.parametrize("ds, eps", [(14, 0.05), (4, 0.05), (14, 0.3)])
def test_cull_twin_matches_jax_on_edge_points(ds, eps):
    """NaN and +-inf in u, v and z, u and v at 0, -0, -1e-7, a cell edge,
    W - 1e-3 and W, z at +-0, +inf ranges, a crowded cell of equal ranges
    and ranges at the test's edge: the twin's mask is the JAX cull's."""
    cj, ct = _cams()
    pts, t = _edge_inputs(ds)
    want = np.asarray(jzb.cull_mask_uv(cj, *(jnp.asarray(pts[k]) for k in
                                             ("u", "v", "z", "rng", "valid")), ds, eps))
    got = tzb.cull_mask_uv_plain(ct, t["u"], t["v"], t["z"], t["rng"], t["valid"], ds, eps)
    np.testing.assert_array_equal(got.numpy(), want)
    # The dispatch takes the twin on CPU tensors.
    assert torch.equal(tzb.cull_mask_uv(ct, t["u"], t["v"], t["z"], t["rng"], t["valid"], ds, eps),
                       got)
    ok, _, _ = tzb.cells(ct, t["u"], t["v"], t["z"], t["valid"], ds)
    assert 0 < int(got.sum()) < int(ok.sum())
    # A gated-in point with an infinite range is never visible.
    inf = ok & torch.isinf(t["rng"])
    assert int(inf.sum()) > 0 and not got[inf].any()


def test_edge_points_reach_every_edge():
    """The edge set holds what the cull's contract names, and the crowded
    cell keeps exactly its ranges within eps of the minimum 3.0."""
    pts, t = _edge_inputs(14)
    u, z = pts["u"], pts["z"]
    for a in (u, pts["v"], z):
        assert np.isnan(a).any() and np.isposinf(a).any() and np.isneginf(a).any()
        assert (np.signbit(a) & (a == 0)).any() and ((a == 0) & ~np.signbit(a)).any()
    assert (u == W).any() and (u == np.float32(W - 1e-3)).any() and (u == np.float32(-1e-7)).any()
    _, ct = _cams()
    vis = tzb.cull_mask_uv_plain(ct, t["u"], t["v"], t["z"], t["rng"], t["valid"], 14, 0.05)
    ok, cell, _ = tzb.cells(ct, t["u"], t["v"], t["z"], t["valid"], 14)
    crowded = ok & (cell == 2 * (W // 14) + 2)
    r = t["rng"][crowded]
    assert int(crowded.sum()) > 500 and float(r.min()) == 3.0
    assert torch.equal(vis[crowded], r <= np.float32(3.0) + np.float32(0.05))
    assert 0 < int((r == np.float32(3.0) + np.float32(0.05)).sum()) == int(
        vis[crowded & (t["rng"] > 3.0)].sum())


@pytest.mark.parametrize("width, height, ds, want", [
    (4096, 3000, 14, (292, 214)), (4096, 3000, 7, (585, 428)), (64, 48, 14, (4, 3)),
    (20, 20, 20, (1, 1)),
])
def test_grid_is_floor_division(width, height, ds, want):
    _, ct = _cams(width, height)
    assert tzb.grid(ct, ds) == want


@pytest.mark.parametrize("ds", [0, -3, 21])
def test_grid_without_a_cell_raises(ds):
    _, ct = _cams(20, 30)
    with pytest.raises(ValueError, match="leaves no cell"):
        tzb.grid(ct, ds)


@pytest.mark.parametrize("ds", [14, 7])
def test_cull_of_camera_points_matches_jax_on_strided_views(ds):
    """cull_mask, as the runner's cull calls it: z a strided view of the
    (N, 3) camera-frame points, the range computed from them. The mask is
    the JAX cull's and the one from contiguous copies of the same inputs."""
    cj, ct = _cams()
    rs = np.random.default_rng(ds)
    n = 30_000
    f = bench_scene.focal(W)
    z = rs.uniform(-0.5, 10.0, n).astype(np.float32)
    x = ((rs.uniform(-0.05 * W, 1.05 * W, n) - W / 2) * z / f).astype(np.float32)
    y = ((rs.uniform(-0.05 * H, 1.05 * H, n) - H / 2) * z / f).astype(np.float32)
    pts = np.stack([x, y, z], -1)
    pts[rs.integers(0, n, 2_000)] = pts[rs.integers(0, n, 2_000)]  # shared cells, tied ranges
    valid = rs.uniform(size=n) > 0.05
    want = np.asarray(jzb.cull_mask(cj, jnp.asarray(pts), jnp.asarray(valid), ds, 0.05))
    t_pts, t_valid = torch.from_numpy(pts), torch.from_numpy(valid)
    got = tzb.cull_mask(ct, t_pts, t_valid, ds, 0.05)
    np.testing.assert_array_equal(got.numpy(), want)
    u, v = tzb.cam.project_uv(ct, t_pts)
    xs, ys, zs = t_pts.unbind(-1)
    assert zs.stride(0) == 3
    r = torch.sqrt(xs * xs + ys * ys + zs * zs)
    flat = tzb.cull_mask_uv(ct, u, v, zs.contiguous(), r, t_valid, ds, 0.05)
    assert torch.equal(flat, got) and 0 < int(got.sum()) < n


def test_cull_cuda_wrapper_checks_before_any_launch():
    """The fused cull's device checks run before any build or launch: CPU
    and meta tensors raise."""
    _, ct = _cams(64, 48)
    u = v = z = r = torch.zeros(8)
    valid = torch.ones(8, dtype=torch.bool)
    counts = dict(tzb.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        tzb.cull_mask_uv_cuda(ct, u, v, z, r, valid)
    meta = [torch.empty(8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        tzb.cull_mask_uv_cuda(ct, *meta, torch.empty(8, dtype=torch.bool, device="meta"))
    assert tzb.launch_counts == counts


@pytest.mark.parametrize("ds", [14, 7, 3])
def test_cells_divide_exactly_at_cell_edges(ds):
    """u and v exactly on every cell edge and one float either side: each
    point's cell is the truncated IEEE f32 quotient (the fused kernels'
    __fdiv_rn), as op-by-op JAX divides, not a product with the reciprocal."""
    _, ct = _cams()
    gw, gh = tzb.grid(ct, ds)
    edges = np.arange(gw + 1, dtype=np.float32) * np.float32(ds)
    u = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                        np.nextafter(edges, np.float32(W))]).astype(np.float32)
    u = u[(u >= 0) & (u < W)]
    v = np.resize(np.arange(gh + 1, dtype=np.float32) * np.float32(ds), u.size)
    v = np.minimum(v, np.float32(H - 1))
    ones = np.ones(u.size, np.float32)
    ok, cell, _ = tzb.cells(ct, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(ones),
                            torch.ones(u.size, dtype=torch.bool), ds)
    assert bool(ok.all())
    ui = np.minimum((u / np.float32(ds)).astype(np.int32), gw - 1)
    vi = np.minimum((v / np.float32(ds)).astype(np.int32), gh - 1)
    np.testing.assert_array_equal(cell.numpy(), vi * gw + ui)
    want = np.asarray((jnp.asarray(u) / ds).astype(jnp.int32))
    np.testing.assert_array_equal(np.minimum(want, gw - 1), ui)
