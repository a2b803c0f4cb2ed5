"""PyTorch port vs the JAX package: the MLS map stage (`ops/mls.py`,
`ops/sor.py`) and the rest of the grid-hash search (`ops/knn.py`).

The cases of tests/test_neighbors_mls.py run on the port, then the port is
held against the JAX package on the same inputs. Tolerance classes: bucket
tables, cell keys, candidate planes, neighbor indices, in-radius counts
and fit flags bit-exact; SOR masks equal but for points whose mean
neighbor distance lies within 4 ulp of the threshold (counted); smoothed
positions within 2e-6 m of JAX's jitted pass and normals within 1e-5 in
1 - |cos| (the sums round in another order; the fit's 6x6 system is
ill-conditioned, so the coefficients are not held).

Two reference-side roundings (ROADMAP.md §3, each with its test here): the
jitted JAX pass and its chunked search divide by the cell size through the
reciprocal, and XLA contracts d2 = dx*dx + dy*dy + dz*dz into
fma(dz, dz, fma(dx, dx, dy*dy)); op by op, and in the port, both round
exactly step by step. So in-radius counts are held against JAX's own
candidate planes taken op by op, and the jitted pass's outputs within the
bounds above."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import cloud as jcl
from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu.ops import mls as jmls
from pointcloudprocessor_tpu.ops import sor as jsor
from pointcloudprocessor_tpu.ops import voxel as jvox
from pointcloudprocessor_tpu.utils.config import MLSConfig as JMLSConfig
from pointcloudprocessor_tpu_torch.core import cloud as tcl
from pointcloudprocessor_tpu_torch.ops import knn as tknn
from pointcloudprocessor_tpu_torch.ops import mls as tmls
from pointcloudprocessor_tpu_torch.ops import sor as tsor
from pointcloudprocessor_tpu_torch.ops import voxel as tvox
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.utils import interop
from pointcloudprocessor_tpu_torch.utils.config import MLSConfig

CPU = "cpu"
POS_TOL = 2e-6  # m, against JAX's jitted pass (jit vs op by op in JAX: 4.8e-7)
NRM_TOL = 1e-5  # 1 - |cos|
N_CORNER = 20_000



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: the suite runs several
    workers on the machine's cores, and under that load a pool of threads
    over many small ops runs ~50x slower (and slows its neighbours)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_cloud(n=500, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)


def _mls_both(pts, valid, cfg_kw, **kw):
    """(JAX (pos, nrm, ok, surf), port (pos, nrm, ok, surf)) as numpy."""
    pj = jmls.mls_smooth(jnp.asarray(pts), jnp.asarray(valid), JMLSConfig(**cfg_kw), **kw)
    pt = tmls.mls_smooth(_t(pts), _t(valid), MLSConfig(**cfg_kw), **kw)
    return ([np.asarray(a) for a in pj[:3]] + [pj[3]],
            [a.numpy() for a in pt[:3]] + [pt[3]])


def _assert_fit_close(jax_out, port_out, cnt=None, max_flips=0):
    """ok equal; positions within POS_TOL; normals within NRM_TOL.

    A degenerate fit's inverse iteration can end with a solution whose
    squared norm passes the f32 range: the normal is then 0 and the point
    goes to its neighborhood's mean. Where that happens in one package and
    not the other (a neighborhood of 2-3 points, whose covariance is rank
    1-2, so its solutions sit at ~1e19: a knife's edge of f32 overflow,
    ROADMAP.md §3), the row is counted, its in-radius count ``cnt`` must be
    at most 3, and at most ``max_flips`` may occur; the other rows are held
    to the bounds. Returns (max position error, max 1 - |cos|, flips)."""
    (pj, nj, oj, _), (pt, nt, ot, _) = jax_out, port_out
    np.testing.assert_array_equal(ot, oj)
    zero_j, zero_t = ~np.any(nj != 0, axis=1), ~np.any(nt != 0, axis=1)
    flip = zero_j != zero_t
    assert int(flip.sum()) <= max_flips, int(flip.sum())
    if flip.any():
        assert (cnt[flip] <= 3).all(), cnt[flip]
    err = float(np.abs(pt - pj)[~flip].max())
    cos = 1.0 - np.abs(np.sum(nt * nj, axis=1))[~zero_j & ~flip]
    assert err <= POS_TOL, err
    assert cos.max(initial=0.0) <= NRM_TOL, cos.max()
    return err, float(cos.max(initial=0.0)), int(flip.sum())


def _jax_counts(pts, valid, cfg):
    """In-radius counts of the moments fit from JAX's own grid and candidate
    planes, op by op (exact division and rounding, as the port)."""
    n = len(pts)
    grid = jknn.build(jnp.asarray(pts), jnp.asarray(valid), cfg.search_radius,
                      max(n // 2, 1024), cfg.bucket_capacity, store_points=True)
    out = []
    for s in range(0, n, 4096):
        q = jnp.asarray(pts[s: s + 4096])
        cx, cy, cz = jknn.candidate_points(grid, q)
        dx, dy, dz = cx - q[:, 0:1], cy - q[:, 1:2], cz - q[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        r2 = cfg.search_radius * cfg.search_radius
        out.append(np.asarray(jnp.sum(jnp.isfinite(cz) & (d2 <= r2), axis=1)))
    return np.concatenate(out).astype(np.int32), grid


# ---------------------------------------------------------------------------
# The cases of tests/test_neighbors_mls.py, on the port
# ---------------------------------------------------------------------------


class TestRadiusNeighbors:
    def test_matches_bruteforce(self):
        pts = _random_cloud(400)
        radius = 0.5
        grid = tknn.build(_t(pts), torch.ones(len(pts), dtype=torch.bool), cell_size=radius,
                          table_size=2048, bucket_capacity=64)
        idx, dist, ok = (a.numpy() for a in tknn.radius_neighbors(
            grid, _t(pts), _t(pts[:50]), radius, max_neighbors=64))
        d_all = np.linalg.norm(pts[None, :50] - pts[:, None], axis=-1).T
        for q in range(50):
            assert set(idx[q][ok[q]]) == set(np.flatnonzero(d_all[q] <= radius))
            assert np.all(np.diff(dist[q][ok[q]]) >= -1e-6)

    def test_invalid_points_excluded(self):
        pts = _random_cloud(100)
        valid = np.ones(100, bool)
        valid[::2] = False
        grid = tknn.build(_t(pts), _t(valid), 0.7, 512, 32)
        idx, _, ok = tknn.radius_neighbors(grid, _t(pts), _t(pts[:10]), 0.7, 32)
        assert np.all(idx.numpy()[ok.numpy()] % 2 == 1)

    def test_exclude_self(self):
        pts = _random_cloud(64)
        grid = tknn.build(_t(pts), torch.ones(64, dtype=torch.bool), 0.5, 256, 32)
        idx, _, ok = tknn.radius_search(grid, _t(pts), _t(pts), 0.5, 16, chunk_size=32,
                                        exclude_self=True)
        for q in range(64):
            assert q not in set(idx[q][ok[q]].tolist())


class TestSOR:
    def test_removes_isolated_outliers(self):
        rng = np.random.default_rng(1)
        plane = rng.uniform(-1, 1, size=(800, 3)).astype(np.float32)
        plane[:, 2] = 0.0
        outliers = np.array([[5.0, 5.0, 5.0], [-6.0, 2.0, 9.0]], np.float32)
        pts = np.concatenate([plane, outliers])
        mask = tsor.sor_mask(_t(pts), torch.ones(len(pts), dtype=torch.bool), mean_k=20,
                             std_mult=2.0, cell_size=0.5).numpy()
        assert not mask[-1] and not mask[-2]
        assert mask[:800].mean() > 0.9
        want = np.asarray(jsor.sor_mask(jnp.asarray(pts), jnp.ones(len(pts), bool), mean_k=20,
                                        std_mult=2.0, cell_size=0.5))
        np.testing.assert_array_equal(mask, want)


class TestMLS:
    def test_plane_denoising(self):
        rng = np.random.default_rng(2)
        n = 1500
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = rng.uniform(-1, 1, size=(n, 2))
        pts[:, 2] = rng.normal(0, 0.01, size=n)
        cfg = dict(search_radius=0.25, sqr_gauss_param=0.25**2, max_neighbors=48,
                   bucket_capacity=64)
        out_j, out_t = _mls_both(pts, np.ones(n, bool), cfg, chunk_size=512)
        pos, nrm, ok, _ = out_t
        assert ok.mean() > 0.95
        assert np.abs(pos[ok, 2]).mean() < 0.5 * np.abs(pts[ok, 2]).mean()
        interior = ok & (np.abs(pts[:, 0]) < 0.7) & (np.abs(pts[:, 1]) < 0.7)
        assert np.abs(nrm[interior, 2]).mean() > 0.98
        _assert_fit_close(out_j, out_t)

    def test_moments_fit_matches_topk_when_capacity_covers(self):
        rng = np.random.default_rng(7)
        n = 1200
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = rng.uniform(-1, 1, size=(n, 2))
        pts[:, 2] = (0.2 * pts[:, 0] ** 2 - 0.1 * pts[:, 1] ** 2
                     + rng.normal(0, 0.004, size=n)).astype(np.float32)
        cfg = MLSConfig(search_radius=0.2, sqr_gauss_param=0.04, max_neighbors=96,
                        bucket_capacity=96)
        out = {impl: [a.numpy() for a in tmls.mls_smooth(
            _t(pts), torch.ones(n, dtype=torch.bool), cfg, chunk_size=512, fit_impl=impl)[:3]]
            for impl in ("moments", "topk")}
        (pm, nm, om), (pt_, nt, ot) = out["moments"], out["topk"]
        both = om & ot
        assert both.mean() > 0.95
        d = np.linalg.norm(pm[both] - pt_[both], axis=1)
        assert np.median(d) < 5e-4 and np.quantile(d, 0.95) < 5e-3
        assert np.median(np.abs(np.sum(nm[both] * nt[both], axis=1))) > 0.9999
        # The top-K fit against JAX's (its approx_min_k is exact on the CPU).
        out_j = jmls.mls_smooth(jnp.asarray(pts), jnp.ones(n, bool),
                                JMLSConfig(**{f: getattr(cfg, f) for f in (
                                    "search_radius", "sqr_gauss_param", "max_neighbors",
                                    "bucket_capacity")}), chunk_size=512, fit_impl="topk")
        _assert_fit_close([np.asarray(a) for a in out_j[:3]] + [None],
                          [pt_, nt, ot, None])

    def test_moments_dedup_candidates_bit_exact(self):
        """Dedup on and off are bit-equal in the port, also where tiny
        chunks overflow the run capacity and take the per-query fetch."""
        rng = np.random.default_rng(11)
        a = np.stack([rng.uniform(0, 0.5, 6000), rng.uniform(0, 0.5, 6000),
                      0.02 * rng.standard_normal(6000)], -1)
        b = np.stack([rng.uniform(-2, 0, 2000), rng.uniform(-2, 0, 2000),
                      0.02 * rng.standard_normal(2000)], -1)
        pts = _t(np.concatenate([a, b]).astype(np.float32))
        valid = torch.ones(len(pts), dtype=torch.bool)
        valid[::97] = False
        cfg = MLSConfig(search_radius=0.03, sqr_gauss_param=0.0009)
        for chunk in (2048, 64):
            on, off = (tmls.mls_smooth(pts, valid, cfg, chunk_size=chunk, dedup_candidates=d)
                       for d in (True, False))
            for x, y in zip(on[:3], off[:3]):
                assert torch.equal(x, y)
            for x, y in zip(on[3], off[3]):
                assert torch.equal(x, y)

    def test_quadric_recovery(self):
        rng = np.random.default_rng(3)
        n = 2000
        xy = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
        pts = np.concatenate([xy, (xy**2).sum(-1, keepdims=True)], -1).astype(np.float32)
        cfg = dict(search_radius=0.15, sqr_gauss_param=0.15**2, max_neighbors=48,
                   bucket_capacity=64)
        out_j, out_t = _mls_both(pts, np.ones(n, bool), cfg, chunk_size=512)
        pos, _, ok, _ = out_t
        assert np.abs(pos[ok, 2] - (pos[ok, 0] ** 2 + pos[ok, 1] ** 2)).mean() < 5e-3
        _assert_fit_close(out_j, out_t)

    def test_upsample_local_plane_on_surface(self):
        rng = np.random.default_rng(4)
        n = 600
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = rng.uniform(-1, 1, size=(n, 2))
        cfg = MLSConfig(search_radius=0.3, sqr_gauss_param=0.09, upsampling="sample_local_plane",
                        slp_upsampling_radius=0.05, slp_upsampling_stepsize=0.025,
                        max_neighbors=32, bucket_capacity=64)
        _, _, ok, surf = tmls.mls_smooth(_t(pts), torch.ones(n, dtype=torch.bool), cfg,
                                         chunk_size=512)
        up_pos, _, up_ok, _ = tmls.upsample_local_plane(surf, ok, cfg)
        up_pos, up_ok = up_pos.numpy(), up_ok.numpy()
        assert up_ok.sum() > n
        assert np.abs(up_pos[up_ok, 2]).max() < 0.02

    def test_smooth_cloud_end_to_end(self):
        rng = np.random.default_rng(5)
        n = 800
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = rng.uniform(-1, 1, size=(n, 2))
        pts[:, 2] = rng.normal(0, 0.005, size=n)
        pts[0] = [9, 9, 9]
        inten = np.arange(n, dtype=np.float32)
        cfg = dict(search_radius=0.25, sqr_gauss_param=0.0625, upsampling="none",
                   sor_mean_k=15, sor_std_dev=2.0, max_neighbors=32, bucket_capacity=64)
        out = tmls.smooth_cloud(tcl.make(pts, CPU, intensity=inten), MLSConfig(**cfg))
        v = out.valid.numpy()
        assert not v[0] and v.mean() > 0.9
        assert np.abs(out.points.numpy()[v, 2]).mean() < 0.003
        want = jmls.smooth_cloud(jcl.make(pts, intensity=inten), JMLSConfig(**cfg))
        np.testing.assert_array_equal(v, np.asarray(want.valid))
        assert np.abs(out.points.numpy() - np.asarray(want.points)).max() <= POS_TOL
        np.testing.assert_array_equal(out.intensity.numpy(), np.asarray(want.intensity))

    def test_smooth_cloud_vgd(self):
        """As JAX's test, and positions within 2e-6 m of JAX's. The masks are
        not compared: on this exactly flat patch the three dilated voxel
        layers project to (nearly) one point, so the second SOR ranks ties
        among triplicates and lattice neighbors, and sub-nm differences in
        the positions (3.7e-9 m here) move its decisions. The dilation and
        its owners are held in test_upsample_voxel_grid_dilation_matches_jax."""
        rng = np.random.default_rng(6)
        n = 300
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = rng.uniform(-0.5, 0.5, size=(n, 2))
        cfg = dict(search_radius=0.3, sqr_gauss_param=0.09, upsampling="voxel_grid_dilation",
                   vgd_voxel_size=0.05, vgd_iterations=1, sor_mean_k=10, sor_std_dev=3.0,
                   max_neighbors=32, bucket_capacity=64)
        out = tmls.smooth_cloud(tcl.make(pts, CPU, intensity=np.ones(n, np.float32)),
                                MLSConfig(**cfg))
        v = out.valid.numpy()
        assert v.sum() > n
        assert np.abs(out.points.numpy()[v, 2]).max() < 0.02
        want = jmls.smooth_cloud(jcl.make(pts, intensity=np.ones(n, np.float32)),
                                 JMLSConfig(**cfg))
        assert want.points.shape == out.points.shape
        assert np.abs(out.points.numpy() - np.asarray(want.points)).max() <= POS_TOL


# ---------------------------------------------------------------------------
# The grid: bucket planes, cell keys, candidate fetches, "approx" selection
# ---------------------------------------------------------------------------


def _grid_cloud(n=3000, seed=0):
    """A 2 m cube of points, the first 200 on a 0.1 m lattice, 90% valid."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    p[:200] = (np.round(p[:200] * 10) / 10).astype(np.float32)
    return p, rs.uniform(size=n) > 0.1


@pytest.mark.parametrize("table, cap", [(6000, 32), (97, 4), (13, 32)])
def test_bucket_points_bit_equal(table, cap):
    """The (T, 3B) coordinate planes equal JAX's, +inf in empty slots: a
    roomy table, overflowing buckets, a table where most cells collide."""
    p, valid = _grid_cloud()
    gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), 0.1, table, cap, store_points=True)
    gt = tknn.build(_t(p), _t(valid), 0.1, table, cap, store_points=True)
    np.testing.assert_array_equal(gt.bucket_points.numpy(), np.asarray(gj.bucket_points))
    np.testing.assert_array_equal(gt.buckets.numpy(), np.asarray(gj.buckets))
    assert np.isinf(gt.bucket_points.numpy()).any() == (table == 6000)


def test_pack_cell_key_bit_equal():
    """Keys and the extent flag equal JAX's inside the 1,024-cell extent and
    outside it (int32 wrapping included)."""
    rs = np.random.default_rng(1)
    inside = rs.integers(-512, 512, (4000, 3)).astype(np.int32)
    inside[:2] = [[-512, -512, -512], [511, 511, 511]]
    outside = inside.copy()
    outside[:6] = [[512, 0, 0], [0, -513, 0], [0, 0, 2**31 - 1], [-(2**31), 0, 0],
                   [2**31 - 600, 5, 5], [3, 1 << 22, -(1 << 25)]]
    for cells, fits in ((inside, True), (outside, False)):
        kj, fj = jknn.pack_cell_key(jnp.asarray(cells))
        kt, ft = tknn.pack_cell_key(_t(cells))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        assert bool(ft) == bool(fj) == fits
    assert len(np.unique(tknn.pack_cell_key(_t(inside))[0].numpy())) == len(
        np.unique(inside, axis=0))


def test_candidate_points_and_dedup_bit_equal():
    """candidate_points and candidate_points_dedup equal JAX's on queries in
    cell order, with a chunk that holds fewer runs than the capacity and one
    that holds more (ok False); the dedup planes equal the per-query ones."""
    p, valid = _grid_cloud(seed=3)
    cell, table, cap = 0.1, 1500, 16
    gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), cell, table, cap, store_points=True)
    gt = tknn.build(_t(p), _t(valid), cell, table, cap, store_points=True)
    key = tknn.pack_cell_key(tvox.voxel_coords(_t(p), cell))[0].numpy()
    order = np.argsort(key, kind="stable")
    q, k = p[order][:1024], key[order][:1024]
    want = jknn.candidate_points(gj, jnp.asarray(q))
    got = tknn.candidate_points(gt, _t(q))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    runs = 1 + int((k[1:] != k[:-1]).sum())
    for run_cap in (runs + 3, runs - 5):
        wj = jknn.candidate_points_dedup(gj, jnp.asarray(q), jnp.asarray(k), run_cap)
        wt = tknn.candidate_points_dedup(gt, _t(q), _t(k), run_cap)
        assert bool(wt[3]) == bool(wj[3]) == (runs <= run_cap)
        for w, g, full in zip(wj[:3], wt[:3], got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            if runs <= run_cap:
                assert torch.equal(g, full)


def test_approx_select_is_exact_on_cpu():
    """``lax.approx_min_k`` equals ``lax.top_k`` on the CPU, so the port's
    "approx" (its exact selection) equals JAX's "approx", with bucket_points
    in the grid."""
    p, valid = _grid_cloud(seed=4)
    rs = np.random.default_rng(5)
    d2 = jnp.asarray(rs.uniform(0, 1, (300, 500)).astype(np.float32))
    d2 = d2.at[:, ::7].set(0.25)  # ties
    va, ia = jax.lax.approx_min_k(d2, 40)
    vt, it = jax.lax.top_k(-d2, 40)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(it))
    np.testing.assert_array_equal(np.asarray(va), -np.asarray(vt))
    gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), 0.1, 6000, 32, store_points=True)
    gt = tknn.build(_t(p), _t(valid), 0.1, 6000, 32, store_points=True)
    want = jknn.radius_neighbors_with_points(gj, jnp.asarray(p), jnp.asarray(p[:800]), 0.1, 24,
                                             select="approx")
    got = tknn.radius_neighbors_with_points(gt, _t(p), _t(p[:800]), 0.1, 24, select="approx")
    for name, w, g in zip(("idx", "pts", "dist", "ok"), want, got):
        if name == "dist":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="select"):
        tknn.radius_neighbors_with_points(gt, _t(p), _t(p[:8]), 0.1, 24, select="fast")


def test_jax_jit_contracts_d2_and_divides_by_the_reciprocal():
    """The two reference-side roundings of the jitted MLS pass (ROADMAP.md
    §3): XLA computes d2 as fma(dz, dz, fma(dx, dx, dy*dy)), which moves
    about a fifth of the values an ulp off the step-by-step sum the port
    and op-by-op JAX take; and it divides by the 0.03 m cell through the
    reciprocal, which puts coordinates on cell faces in the cell before."""
    rs = np.random.default_rng(0)
    d = rs.uniform(-0.03, 0.03, (100_000, 3)).astype(np.float32)

    def sq(a):
        return a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2]

    jitted = np.asarray(jax.jit(sq)(jnp.asarray(d)))
    eager = np.asarray(sq(jnp.asarray(d)))
    port = sq(_t(d)).numpy()
    np.testing.assert_array_equal(port, eager)
    dx, dy, dz = (d[:, i].astype(np.float64) for i in range(3))
    inner = (dx * dx + (dy * dy).astype(np.float32)).astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(jitted, (dz * dz + inner).astype(np.float32))
    assert 0.1 < (jitted != eager).mean() < 0.4
    faces = (rs.integers(-300, 300, (4000, 3)) * np.float32(0.03)).astype(np.float32)
    exact = tvox.voxel_coords(_t(faces), 0.03).numpy()
    np.testing.assert_array_equal(exact, np.asarray(jvox.voxel_coords(jnp.asarray(faces), 0.03)))
    under_jit = np.asarray(jax.jit(lambda a: jvox.voxel_coords(a, 0.03))(jnp.asarray(faces)))
    assert (under_jit != exact).any() and np.abs(under_jit - exact).max() == 1


# ---------------------------------------------------------------------------
# SOR on the reference's parameters
# ---------------------------------------------------------------------------


def _outlier_scene(n=6000, seed=8):
    """A noisy plane with 2% of the points scattered up to 1 m off it."""
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(0, 3, n), rs.uniform(0, 2, n),
                  5.0 + 0.005 * rs.standard_normal(n)], -1).astype(np.float32)
    out = rs.choice(n, n // 50, replace=False)
    p[out, 2] += rs.uniform(-1.0, 1.0, len(out)).astype(np.float32)
    return p, out


@pytest.mark.parametrize("scene", ["hardened corner", "outliers"])
def test_sor_matches_jax(scene):
    """Neighbor indices bit-equal to JAX's search (op by op: the jitted
    chunked search contracts d2 into FMAs, which reorders near-ties); the
    inlier mask equal to JAX's ``sor_mask``; a point on the other side would
    have to lie within 4 ulp of the threshold (counted: none here). The
    reference's SOR: k = 60, 0.7 sigma, 0.25 m cells, 60 a bucket, 2n
    buckets, 1% of the points invalid."""
    if scene == "hardened corner":
        p = bench_scene.mls_scene(N_CORNER)
    else:
        p, out = _outlier_scene()
    n = len(p)
    valid = np.ones(n, bool)
    valid[::101] = False
    kw = dict(mean_k=60, cell_size=0.25, bucket_capacity=60)
    mean_d = tsor.sor_stats(_t(p), _t(valid), chunk_size=4096, **kw)
    mask, thresh = tsor.sor_threshold(mean_d, _t(valid), 0.7)
    want = np.asarray(jsor.sor_mask(jnp.asarray(p), jnp.asarray(valid), std_mult=0.7, **kw))
    ulp = float(np.spacing(np.float32(thresh)))
    near = np.abs(mean_d.numpy() - float(thresh)) <= 4 * ulp
    differ = mask.numpy() != want
    assert not (differ & ~near).any()
    assert int(differ.sum()) == 0
    assert 0.5 < mask.numpy().mean() < 0.97
    if scene == "outliers":
        assert mask.numpy()[out].mean() < 0.2
    # The search itself, against JAX's op-by-op radius_neighbors.
    gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), 0.25, 2 * n, 60)
    gt = tknn.build(_t(p), _t(valid), 0.25, 2 * n, 60)
    for s in range(0, n, 5000):
        q = p[s: s + 5000]
        self_idx = np.arange(s, s + len(q), dtype=np.int32)
        ij, dj, oj = jknn.radius_neighbors(gj, jnp.asarray(p), jnp.asarray(q), 0.25, 60,
                                           jnp.asarray(self_idx))
        it, dt, ot = tknn.radius_neighbors(gt, _t(p), _t(q), 0.25, 60, _t(self_idx))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


# ---------------------------------------------------------------------------
# The moments fit on the reference's parameters
# ---------------------------------------------------------------------------


def _planar_patch(n=12_000, seed=9):
    """Exactly planar (z = 6 m, as bench scene 1's wall): the covariance is
    singular and the heights all 0, so the eigen shift and the ridge carry
    the solves."""
    rs = np.random.default_rng(seed)
    side = float(np.sqrt(n / 30000.0))
    return np.stack([rs.uniform(0, side, n), rs.uniform(0, side, n), np.full(n, 6.0)],
                    -1).astype(np.float32)


def _face_lattice(seed=10):
    """Points with x on the 0.015 m lattice (every other one on a face of
    the 0.03 m cells), y random, z on a plane with 1 mm noise; sparse enough
    that no bucket overflows."""
    rs = np.random.default_rng(seed)
    ix = rs.integers(150, 200, 4000)
    p = np.stack([ix * 0.015, rs.uniform(0, 0.6, 4000),
                  2.0 + 0.001 * rs.standard_normal(4000)], -1)
    p[:, 0] = (ix * np.float32(0.015)).astype(np.float32)
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def corner_fit():
    """The hardened corner at 20,000 points, the default MLSConfig, through
    JAX's jitted pass and the port's pass (as ``mls_smooth`` runs it) with
    dedup on and off: {dedup: (positions, normals, surfaces, counts)}."""
    p = bench_scene.mls_scene(N_CORNER)
    valid = np.ones(N_CORNER, bool)
    valid[::89] = False
    cfg = MLSConfig()
    out_j = jmls.mls_smooth(jnp.asarray(p), jnp.asarray(valid), JMLSConfig())
    kw = dict(search_radius=cfg.search_radius, sqr_gauss_param=cfg.sqr_gauss_param,
              polynomial_order=2, bucket_capacity=cfg.bucket_capacity,
              table_size=N_CORNER // 2, chunk_size=4096)
    ports = {dedup: tmls.mls_pass_plain(_t(p), _t(valid), dedup_candidates=dedup, **kw)
             for dedup in (True, False)}
    return p, valid, cfg, [np.asarray(a) for a in out_j[:3]] + [out_j[3]], ports


def test_moments_corner_matches_jax(corner_fit):
    """ok equal, positions within 2e-6 m and normals within 1e-5 of JAX's
    jitted pass (but for the overflow knife's edge of _assert_fit_close);
    in-radius counts bit-equal to JAX's op-by-op count; the SOR-free corner
    keeps nearly every point."""
    p, valid, cfg, out_j, ports = corner_fit
    pos, nrm, surf, cnt_t = ports[True]
    ok = (surf.ok & _t(valid)).numpy()
    cnt_j, _ = _jax_counts(p, valid, cfg)
    # Measured: 4.8e-7 m, 1.4e-6, 2 rows with the normal 0 in JAX alone (in-radius
    # counts 3 and 2).
    err, cos, _ = _assert_fit_close(out_j, [pos.numpy(), nrm.numpy(), ok, None], cnt_j,
                                    max_flips=2)
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    np.testing.assert_array_equal(surf.ok.numpy(), cnt_j >= 3)
    assert ok.mean() > 0.95 and err < POS_TOL and cos < NRM_TOL
    # The surfaces' origins too (the neighborhood means).
    assert np.abs(surf.origin.numpy() - np.asarray(out_j[3].origin)).max() <= POS_TOL


def test_moments_corner_dedup_bit_equal(corner_fit):
    _, _, _, _, ports = corner_fit
    (pos, nrm, surf, cnt), (pos_o, nrm_o, surf_o, cnt_o) = ports[True], ports[False]
    assert torch.equal(pos, pos_o) and torch.equal(nrm, nrm_o) and torch.equal(cnt, cnt_o)
    for x, y in zip(surf, surf_o):
        assert torch.equal(x, y)


def test_moments_planar_patch_matches_jax():
    """An exactly planar patch (bench scene 1's wall: the shift and the
    ridge carry the solves, every height 0): positions within 2e-6 m of
    JAX's jitted pass, normals within 1e-5, z kept, ok and counts equal."""
    p = _planar_patch()
    valid = np.ones(len(p), bool)
    out_j, out_t = _mls_both(p, valid, {}, chunk_size=4096)
    cnt_j, _ = _jax_counts(p, valid, MLSConfig())
    _assert_fit_close(out_j, out_t, cnt_j)
    np.testing.assert_array_equal(out_t[3].ok.numpy(), cnt_j >= 3)
    np.testing.assert_array_equal(out_t[0][:, 2], p[:, 2])
    assert (np.abs(out_t[3].normal.numpy()[:, 2]) == 1.0).mean() > 0.99


def test_moments_face_lattice_matches_jax_op_by_op():
    """A cell-face lattice: the port within 2e-6 m / 1e-5 of JAX run op by
    op (``jax.disable_jit``), ok and counts equal. Against JAX's jitted
    pass the positions differ by up to ~6e-5 m, a reference-side rounding
    (ROADMAP.md §3): a neighborhood spans 3 lattice lines, so u takes 3
    values and the quadratic's 6x6 system is ill-conditioned, and the jit's
    FMA-contracted d2 and reciprocal cells move its solution; JAX's own jit
    and op-by-op passes differ by as much. Here no bucket overflows, so the
    cells the jitted build moves keep their in-radius sets."""
    p = _face_lattice()
    n = len(p)
    valid = np.ones(n, bool)
    cfg = MLSConfig()
    out_j, out_t = _mls_both(p, valid, {}, chunk_size=4096)
    with jax.disable_jit():
        eager = jmls.mls_smooth(jnp.asarray(p), jnp.asarray(valid), JMLSConfig(), chunk_size=4096)
    eager = [np.asarray(a) for a in eager[:3]] + [eager[3]]
    cnt_j, gj = _jax_counts(p, valid, cfg)
    _assert_fit_close(eager, out_t, cnt_j)
    np.testing.assert_array_equal(out_t[3].ok.numpy(), cnt_j >= 3)
    np.testing.assert_array_equal(out_t[2], out_j[2])
    jit_gap = float(np.abs(out_j[0] - eager[0]).max())
    assert jit_gap > POS_TOL, jit_gap
    assert int(np.asarray(gj.counts).max()) <= cfg.bucket_capacity
    jitted = np.asarray(jax.jit(lambda a: jvox.voxel_coords(a, 0.03))(jnp.asarray(p)))
    assert (jitted != tvox.voxel_coords(_t(p), 0.03).numpy()).any(axis=1).sum() > 20


# ---------------------------------------------------------------------------
# project_onto, the top-K fit and the upsamplers on JAX's own surfaces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plane_surfaces():
    """JAX's fit of a gently curved noisy patch, carried across."""
    rng = np.random.default_rng(12)
    n = 800
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.uniform(-0.5, 0.5, size=(n, 2))
    p[:, 2] = (0.3 * p[:, 0] ** 2 + 0.002 * rng.standard_normal(n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::13] = False
    cfg = dict(search_radius=0.12, sqr_gauss_param=0.0144, bucket_capacity=64,
               slp_upsampling_radius=0.02, slp_upsampling_stepsize=0.01,
               rud_point_density=6, vgd_voxel_size=0.04, vgd_iterations=1)
    _, _, ok, sj = jmls.mls_smooth(jnp.asarray(p), jnp.asarray(valid), JMLSConfig(**cfg),
                                   chunk_size=512)
    st = interop.mls_surface(*(np.asarray(a) for a in sj), CPU)
    return p, valid, cfg, np.asarray(ok), sj, st


def test_project_onto_and_topk_fit_match_jax(plane_surfaces):
    p, valid, cfg, _, sj, st = plane_surfaces
    rs = np.random.default_rng(13)
    q = (p + 0.003 * rs.standard_normal(p.shape)).astype(np.float32)
    owner = rs.integers(0, len(p), len(p)).astype(np.int32)
    for own in (None, owner):
        pj, nj = jmls.project_onto(sj, jnp.asarray(q), None if own is None else jnp.asarray(own))
        pt, nt = tmls.project_onto(st, _t(q), None if own is None else _t(own))
        assert np.abs(pt.numpy() - np.asarray(pj)).max() <= POS_TOL
        assert (1 - np.abs(np.sum(nt.numpy() * np.asarray(nj), 1))).max() <= NRM_TOL
    # The top-K fit on JAX's grid and neighbors, carried across.
    grid = jknn.build(jnp.asarray(p), jnp.asarray(valid), 0.12, 1024, 64)
    idx, dist, ok = jknn.radius_neighbors(grid, jnp.asarray(p), jnp.asarray(p), 0.12, 32)
    gt = interop.hash_grid(np.asarray(grid.buckets), np.asarray(grid.counts), 0.12, 1024, CPU)
    it, _, ot = tknn.radius_neighbors(gt, _t(p), _t(p), 0.12, 32)
    np.testing.assert_array_equal(it.numpy(), np.asarray(idx))
    fj = jmls.fit_surfaces(jnp.asarray(p), jnp.asarray(p), idx, ok, 0.0144)
    ft = tmls.fit_surfaces(_t(p), _t(p), it, ot, 0.0144)
    np.testing.assert_array_equal(ft.ok.numpy(), np.asarray(fj.ok))
    assert np.abs(ft.origin.numpy() - np.asarray(fj.origin)).max() <= POS_TOL
    assert (1 - np.abs(np.sum(ft.normal.numpy() * np.asarray(fj.normal), 1))).max() <= NRM_TOL


def test_upsample_local_plane_matches_jax(plane_surfaces):
    """Base points bit-equal (the disc offsets and their sums as JAX
    orders them), positions within 2e-6 m, owners and flags equal."""
    _, valid, cfg, ok, sj, st = plane_surfaces
    pj, nj, oj, wj = jmls.upsample_local_plane(sj, jnp.asarray(ok), JMLSConfig(**cfg))
    pt, nt, ot, wt = tmls.upsample_local_plane(st, _t(ok), MLSConfig(**cfg))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert np.abs(pt.numpy() - np.asarray(pj)).max() <= POS_TOL
    offs = jnp.asarray(jmls._disc_offsets(0.02, 0.01))
    np.testing.assert_array_equal(tmls._disc_offsets(0.02, 0.01), np.asarray(offs))
    base_j = sj.origin[:, None, :] + (offs[None, :, 0:1] * sj.tangent_u[:, None, :]
                                      + offs[None, :, 1:2] * sj.tangent_v[:, None, :])
    o = torch.from_numpy(np.asarray(offs))
    base_t = st.origin[:, None, :] + (o[None, :, 0:1] * st.tangent_u[:, None, :]
                                      + o[None, :, 1:2] * st.tangent_v[:, None, :])
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))


def test_upsample_voxel_grid_dilation_matches_jax(plane_surfaces):
    """The dilated voxel set equal; owners (nearest source, S1's search on
    the card) bit-equal; positions within 2e-6 m."""
    p, valid, cfg, ok, sj, st = plane_surfaces
    jc, tc = JMLSConfig(**cfg), MLSConfig(**cfg)
    occ = np.floor(p[valid] / np.float32(0.04)).astype(np.int64)
    np.testing.assert_array_equal(tmls._dilate_voxels_host(occ, 1),
                                  jmls._dilate_voxels_host(occ, 1))
    pj, nj, oj, wj = jmls.upsample_voxel_grid_dilation(p, sj, valid, jc)
    pt, nt, ot, wt = tmls.upsample_voxel_grid_dilation(_t(p), st, _t(valid), tc)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert np.abs(pt.numpy() - np.asarray(pj)).max() <= POS_TOL
    assert len(wt) > len(p)


def test_upsample_random_density_structure(plane_surfaces):
    """jax.random and torch draw differently (ROADMAP.md §3): counts,
    owners, flags, every sample within the search radius of its owner's
    origin in the tangent plane and on its owner's surface; a generator
    gives the same samples again."""
    _, _, cfg, ok, _, st = plane_surfaces
    c = MLSConfig(**cfg)
    g = torch.Generator().manual_seed(3)
    pos, nrm, up_ok, owner = tmls.upsample_random_density(st, _t(ok), c, g)
    n, s = len(ok), c.rud_point_density
    assert pos.shape == (n * s, 3) and nrm.shape == (n * s, 3)
    np.testing.assert_array_equal(owner.numpy(), np.repeat(np.arange(n), s))
    np.testing.assert_array_equal(up_ok.numpy(), np.repeat(ok & st.ok.numpy(), s))
    o = owner.long()
    rel = pos - st.origin[o]
    u = torch.sum(rel * st.tangent_u[o], 1)
    v = torch.sum(rel * st.tangent_v[o], 1)
    assert float(torch.sqrt(u * u + v * v)[up_ok].max()) <= c.search_radius * (1 + 1e-4)
    again, _ = tmls.project_onto(st, pos, owner)
    assert float((again - pos)[up_ok].abs().max()) <= 1e-6
    pos2 = tmls.upsample_random_density(st, _t(ok), c, torch.Generator().manual_seed(3))[0]
    assert torch.equal(pos, pos2)


def test_device_dispatch():
    """CPU tensors take the plain versions; the kernel wrappers refuse CPU
    tensors; another device raises; an unknown upsampling raises."""
    p = _random_cloud(300, seed=14)
    pts, valid = _t(p), torch.ones(300, dtype=torch.bool)
    grid = tknn.build(pts, valid, 0.5, 1024, 32)
    want = tknn.chunked_radius_neighbors(grid, pts, pts, 0.5, 8, exclude_self=True)
    got = tknn.radius_search(grid, pts, pts, 0.5, 8, exclude_self=True)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_select_cuda(grid, pts, pts, 0.5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tmls.mls_moments_cuda(pts, valid, search_radius=0.5, sqr_gauss_param=0.25,
                              polynomial_order=2, bucket_capacity=32, table_size=1024)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(NotImplementedError):
        tmls.mls_smooth(meta, torch.ones(4, dtype=torch.bool, device="meta"), MLSConfig())
    with pytest.raises(NotImplementedError):
        tknn.radius_search(grid, meta, meta, 0.5, 8)
    with pytest.raises(ValueError, match="upsampling"):
        tmls.smooth_cloud(tcl.make(p, CPU), MLSConfig(upsampling="poisson"))


def test_mls_scene_reproduces_bench():
    """tools/bench_scene.mls_scene is bench.py's hardened corner
    (bench.py:553-578), loaded here by file path, for two seeds."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("_bench_for_mls_scene", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for n, seed in ((10_001, 1), (4_000, 7)):
        np.testing.assert_array_equal(bench_scene.mls_scene(n, seed), bench._mls_scene(n, seed))
