"""PyTorch port vs the JAX package: the MLS measurement harnesses —
`tools/mls_anatomy`'s nested stages and `tools/mls_dedup_probe`'s two plain
passes — on the MLS bench's hardened corner (`bench_scene.mls_scene`,
numpy from a seed), on the CPU.

Tolerance classes: each stage's reduced value against the composition of
the JAX package's public functions (`knn.build`, `candidate_points`,
`_candidates_with_points`, `radius_neighbors_with_points`,
`mls.fit_surfaces[_moments]`, `project_onto`, run op by op) within f32
summation order (1e-5 relative; the candidate planes and the grid counts
bit-equal); the dedup and per-query passes bit-identical to each other in
each package, and the port's positions within M1's class of JAX's (2e-6 m)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu.ops import mls as jmls
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.tools import mls_anatomy as tanat
from pointcloudprocessor_tpu_torch.tools import mls_dedup_probe as tdedup

CPU = "cpu"
# 3,000 corner points in chunks of 1,024: three chunks, the last padded.
N_PTS, CHUNK = 3_000, 1_024
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corner():
    pts = bench_scene.mls_scene(N_PTS)
    kw = dict(tanat.mls_kw(N_PTS), chunk_size=CHUNK)
    return pts, kw


def _jax_stage(points, stage, kw):
    """JAX's ``stage_fn`` (`mls_anatomy.py:74-158`), composed from the JAX
    package's public functions, op by op."""
    radius = kw["search_radius"]
    p = jnp.asarray(points)
    n = p.shape[0]
    grid = jknn.build(p, jnp.ones((n,), bool), cell_size=radius, table_size=kw["table_size"],
                      bucket_capacity=kw["bucket_capacity"], store_points=True)
    if stage == "grid":
        return grid.counts.sum().astype(jnp.float32)
    pad = (-n) % kw["chunk_size"]
    qc = jnp.pad(p, ((0, pad), (0, 0))).reshape(-1, kw["chunk_size"], 3)

    def one(q):
        if stage.startswith("m_"):
            cx, cy, cz = jknn.candidate_points(grid, q)
            if stage == "m_cand":
                return jnp.sum(jnp.where(jnp.isfinite(cz), cx + cy + cz, 0.0))
            surf = jmls.fit_surfaces_moments(q, cx, cy, cz, radius, kw["sqr_gauss_param"],
                                             kw["polynomial_order"])
            if stage == "m_fit":
                return jnp.sum(surf.origin) + jnp.sum(surf.coeffs) + jnp.sum(surf.normal)
            pos, nrm = jmls.project_onto(surf, q)
            return jnp.sum(pos) + jnp.sum(nrm)
        if stage == "cand":
            cand, cx, cy, cz = jknn._candidates_with_points(grid, p, q)
            dx, dy, dz = cx - q[:, 0:1], cy - q[:, 1:2], cz - q[:, 2:3]
            d2 = dx * dx + dy * dy + dz * dz
            inr = (cand >= 0) & (d2 <= radius * radius)
            return jnp.sum(jnp.where(inr, d2, 0.0)) + jnp.sum(cand.astype(jnp.float32))
        if stage == "cand_pts":
            neigh_c = jknn.voxel_coords(q, grid.cell_size)[:, None, :] + jknn._OFFSETS[None]
            rows = grid.bucket_points[jknn.voxel_hash(neigh_c, grid.table_size)]
            return jnp.sum(jnp.where(jnp.isfinite(rows), rows, 0.0))
        idx, npts, _, ok = jknn.radius_neighbors_with_points(grid, p, q, radius,
                                                             kw["max_neighbors"], select="approx")
        if stage == "neigh":
            return jnp.sum(ok.astype(jnp.float32)) + jnp.sum(jnp.where(ok[..., None], npts, 0.0))
        surf = jmls.fit_surfaces(p, q, idx, ok, kw["sqr_gauss_param"], kw["polynomial_order"],
                                 neigh_pts=npts)
        if stage == "fit":
            return jnp.sum(surf.origin) + jnp.sum(surf.coeffs) + jnp.sum(surf.normal)
        pos, nrm = jmls.project_onto(surf, q)
        return jnp.sum(pos) + jnp.sum(nrm)

    return jnp.sum(jnp.stack([one(q) for q in qc]))


@pytest.mark.parametrize("stage", tanat.STAGES)
def test_anatomy_stage_matches_jax(corner, stage):
    pts, kw = corner
    got = tanat.stage_value(torch.from_numpy(pts), torch.ones(N_PTS, dtype=torch.bool), stage, kw)
    with jax.disable_jit():
        want = float(_jax_stage(pts, stage, kw))
    assert got.dtype == torch.float32
    if stage in ("grid", "m_cand", "cand_pts"):
        # Counts and candidate coordinates: the same values, summed in
        # another order only.
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    else:
        np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_anatomy_rejects_unknown_stage(corner):
    pts, kw = corner
    with pytest.raises(ValueError):
        tanat.stage_value(torch.from_numpy(pts), torch.ones(N_PTS, dtype=torch.bool), "nope", kw)


def test_dedup_passes_bit_identical_in_both_packages(corner):
    """The plain moments pass with and without the dedup fetch: the same
    bits in the port and in JAX's jitted pass; the port's positions and
    normals within M1's class of JAX's."""
    pts, kw = corner
    valid = torch.ones(N_PTS, dtype=torch.bool)
    pa, na = tdedup.run_pass(torch.from_numpy(pts), valid, False, kw)
    pb, nb = tdedup.run_pass(torch.from_numpy(pts), valid, True, kw)
    assert torch.equal(pa, pb) and torch.equal(na, nb)
    jkw = {k: kw[k] for k in ("search_radius", "max_neighbors", "sqr_gauss_param",
                              "polynomial_order", "bucket_capacity", "table_size", "chunk_size")}
    out = [jmls._mls_smooth_jit(jnp.asarray(pts), jnp.ones((N_PTS,), bool), fit_impl="moments",
                                dedup_candidates=d, **jkw) for d in (False, True)]
    (ja, jna, _), (jb, jnb, _) = out
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))
    np.testing.assert_array_equal(np.asarray(jna), np.asarray(jnb))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=2e-6)
