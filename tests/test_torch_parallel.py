"""PyTorch port vs the JAX package: the sharded paths of ``parallel/`` on
four Gloo CPU ranks, a (kf 2 x pt 2) mesh.

One spawn of four ranks (tests/torch_parallel_worker.py, mode "mesh4") runs
every check of this file while the JAX references run here on the conftest's
virtual CPU devices, each under ``jax.jit`` (JAX's sharded solves are not
run: their compile takes 30-170 s). Inputs come from numpy seeds.

Tolerances: the sharded loss and gradient at JAX's own (value rtol 2e-4,
gradient rtol 1e-3 / atol 1e-5, `test_parallel.py:38-61`); the frozen
cache's taps, knots, gate and counters bit for bit; solves at the objective
level (final NIDs within 1e-3, CLAUDE.md "Sharded vs unsharded BFGS"); the
fuse's colored set, counts and labels bit for bit and its colors at 1e-3;
the pose graph at 1e-5 against JAX; every replicated result the same bits
on every rank; the per-keyframe lanes and the pose graph bit for bit
against the port's serial paths."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu.opt import pose_graph as jpg
from pointcloudprocessor_tpu.opt import refine as jrefine
from pointcloudprocessor_tpu.parallel import fusion_shard as jfusion_shard
from pointcloudprocessor_tpu.parallel import mesh as jmesh
from pointcloudprocessor_tpu.parallel import nid_shard as jnid_shard
from pointcloudprocessor_tpu.parallel import pose_graph_shard as jpg_shard

import torch_parallel_worker as worker
from synthetic import simple_camera
from test_nid import nid_scene
from test_parallel import batched_keyframes
from test_refine_per_keyframe import _batched_scene

WORLD, KF, PT = 4, 2, 2
NID_TOL = 1e-3
XI_A = ((0.02, -0.01, 0.0, 0.003, 0.0, -0.004), (-0.01, 0.015, 0.01, -0.002, 0.003, 0.001))
XI_C = (0.02, -0.015, 0.01, 0.006, -0.004, 0.008)
PK_PERTURBS = [
    [0.02, -0.01, 0.005, 0.004, -0.002, 0.003],
    [-0.015, 0.02, -0.01, -0.003, 0.004, -0.002],
    [0.01, 0.01, -0.01, 0.002, 0.002, -0.003],
    [-0.01, -0.015, 0.01, -0.002, -0.003, 0.002],
]
# A (K,) correction for the fuse: keyframe j's own row.
K_CORRECTIONS = np.asarray([[0.01 * j, -0.005, 0.0, 0.002 * j, 0.0, -0.001] for j in range(4)],
                           np.float32)
FUSE_KW = dict(downsample_factor=4, depth_epsilon=0.3, with_masks=True)
B_CASES = ("m0_both", "m0_mixed", "m2_both", "m2_mixed")


def _camera_arrays(prefix, c):
    return {prefix + "intr": np.asarray(c.intrinsic), prefix + "dist": np.asarray(c.distortion),
            prefix + "wh": np.asarray([c.width, c.height])}


def _kf_arrays(prefix, kfs):
    return {prefix + "pts": np.asarray(kfs.points), prefix + "inten": np.asarray(kfs.intensity),
            prefix + "valid": np.asarray(kfs.valid), prefix + "bins": np.asarray(kfs.bin_image)}


def _pose_arrays(name, T):
    return {name + "_q": np.asarray(T.q), name + "_t": np.asarray(T.t)}


def _translation(x):
    return jse3.SE3(jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32),
                    jnp.asarray([x, 0.0, 0.0], jnp.float32))


def frozen_scene(c, mixed):
    """Two keyframes of 4,096 points on the textured wall's rays: 512 at 2 m
    (the wall scaled by 0.4) and the rest at 1,000 km, so that a sideways
    step of the camera drifts only the near points' anchors. The near points
    sit in the first pt shard's first 4 blocks of 128 in keyframe 0 and, in
    the mixed case, in the second shard's first 8 blocks in keyframe 1, so
    one shard's refresh outgrows the 0.25 partial capacity (4 of 16)."""
    pts, inten, img = nid_scene(c, n_side=64)
    bins = jnid.quantize_image(jnp.asarray(img), 16)
    kfs = []
    for near in ((0, 512), (2048, 3072) if mixed else (0, 512)):
        scale = np.full((len(pts), 1), 2e5, np.float32)
        scale[near[0]:near[1]] = 0.4
        kfs.append((pts * scale, inten))
    return jnid.NIDKeyframe(
        points=jnp.asarray(np.stack([p for p, _ in kfs])),
        intensity=jnp.asarray(np.stack([i for _, i in kfs])),
        valid=jnp.ones((2, len(pts)), bool),
        bin_image=jnp.stack([bins, bins]),
    )


def wall_fuse_scene(c, occluder=False):
    """`test_parallel.test_sharded_fusion_matches_unsharded`'s wall seen
    from 4 shifted cameras, with masks. ``occluder``: the first 2,048 of the
    4,096 points (the first pt shard's) become a patch at 2.5 m in front of
    the image's centre, so they hide wall points that the second shard
    holds."""
    rng = np.random.default_rng(0)
    n, k = 4096, 4
    u = rng.uniform(4, c.width - 4, n)
    v = rng.uniform(4, c.height - 4, n)
    z = np.full(n, 5.0)
    if occluder:
        u[:2048] = rng.uniform(c.width * 0.3, c.width * 0.7, 2048)
        v[:2048] = rng.uniform(c.height * 0.3, c.height * 0.7, 2048)
        z[:2048] = 2.5
    f = float(c.intrinsic[0])
    pts = np.stack([(u - c.width / 2) / f * z, (v - c.height / 2) / f * z, z], -1)
    images = rng.integers(0, 255, (k, c.height, c.width, 3)).astype(np.uint8)
    masks = rng.integers(0, 3, (k, c.height, c.width)).astype(np.int32)
    poses = jse3.SE3(
        q=jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (k, 1)),
        t=jnp.asarray(np.stack([[0.05 * i, 0, 0] for i in range(k)]).astype(np.float32)),
    )
    return pts.astype(np.float32), np.ones(n, bool), images, masks, poses


def pose_graph_inputs():
    """`multihost_worker.py`'s chain: 4 nodes, noisy absolute measurements."""
    rng = np.random.default_rng(7)
    tang = np.cumsum(rng.uniform(-0.2, 0.4, size=(4, 6)).astype(np.float32), axis=0)
    c2w = jse3.exp(jnp.asarray(tang))
    noise = rng.normal(0, 0.01, size=(4, 6)).astype(np.float32)
    meas = jse3.compose(c2w, jse3.exp(jnp.asarray(noise)))
    return c2w, jpg.relative_measurements(c2w), meas, np.ones(4, np.float32)


def build_inputs():
    c = simple_camera()
    inputs = {}
    # (a) the loss and gradient.
    kfs_a = batched_keyframes(c, k=4)
    inputs.update(**_camera_arrays("a_", c), **_kf_arrays("a_", kfs_a), a_xi=np.asarray(XI_A))
    # (b) the frozen cache through a forced refresh.
    inputs.update(**_camera_arrays("b_", c), **_pose_arrays("b_Ta", _translation(0.0)),
                  **_pose_arrays("b_Tb0", _translation(0.035)),
                  **_pose_arrays("b_Tb2", _translation(0.075)))
    scenes_b = {case: frozen_scene(c, mixed=case.endswith("mixed")) for case in B_CASES}
    for case, kfs in scenes_b.items():
        inputs.update(_kf_arrays(f"b_{case}_", kfs))
    # (c) the solves.
    kfs_c = batched_keyframes(c, k=2)
    inputs.update(**_camera_arrays("c_", c), **_kf_arrays("c_", kfs_c),
                  **_pose_arrays("c_T0", jse3.exp(jnp.asarray(XI_C, jnp.float32))))
    # (d) the fuse, the occluder case, and a correction a keyframe.
    for prefix, occ in (("d_", False), ("o_", True), ("k_", False)):
        pts, valid, images, masks, poses = wall_fuse_scene(c, occ)
        T = jse3.exp(jnp.asarray(K_CORRECTIONS)) if prefix == "k_" else jse3.identity()
        inputs.update(**_camera_arrays(prefix, c), **_pose_arrays(prefix + "poses", poses),
                      **_pose_arrays(prefix + "T", T))
        inputs.update({prefix + "points": pts, prefix + "valid_map": valid,
                       prefix + "images": images, prefix + "masks": masks,
                       prefix + "ds": np.asarray(FUSE_KW["downsample_factor"]),
                       prefix + "eps": np.asarray(FUSE_KW["depth_epsilon"])})
    # (e) the per-keyframe solve.
    c_e, kfs_e = _batched_scene(PK_PERTURBS)
    inputs.update(**_camera_arrays("e_", c_e), **_kf_arrays("e_", kfs_e),
                  **_pose_arrays("e_T0", jse3.identity()))
    # (f) the pose graph.
    c2w, odo, meas, w = pose_graph_inputs()
    inputs.update(**_pose_arrays("f_c2w", c2w), **_pose_arrays("f_odo", odo),
                  **_pose_arrays("f_meas", meas), f_w=w)
    return c, kfs_a, scenes_b, kfs_c, inputs


def jax_references(c, kfs_a, scenes_b, kfs_c, inputs):
    """Every JAX reference of this file, each jitted."""
    m = jmesh.make_mesh(kf=KF, pt=PT, devices=jax.devices()[:WORLD])
    refs = {}
    vg = jax.jit(jax.value_and_grad(
        lambda xi: jnid_shard.sharded_multi_nid_loss(c, jse3.exp(xi), kfs_a, m)))
    for j, xi in enumerate(XI_A):
        v, g = vg(jnp.asarray(xi, jnp.float32))
        refs[f"a_value{j}"], refs[f"a_grad{j}"] = np.asarray(v), np.asarray(g)

    make_cache, cached_loss = jnid_shard.make_sharded_frozen(m, partial_frac=0.25)
    mk = jax.jit(lambda T, kfs: make_cache(c, T, kfs))
    cl = jax.jit(lambda T, kfs, cache: cached_loss(c, T, kfs, cache, 16, guard_frac=0.25))
    Ta = _translation(0.0)
    for case, kfs in scenes_b.items():
        margin = int(case[1])
        kfs = jnid.prepare_keyframes(kfs, wide_margin=margin)
        loss, cache = cl(_translation(0.035 if margin == 0 else 0.075), kfs, mk(Ta, kfs))
        refs[f"b_{case}_loss"] = np.asarray(loss)
        for field in cache._fields:
            refs[f"b_{case}_{field}"] = np.asarray(getattr(cache, field))

    T0 = jse3.exp(jnp.asarray(XI_C, jnp.float32))
    for name in ("plain", "frozen", "c2f"):
        kw = dict(dict(max_inner_iterations=worker.C_INNER,
                       max_outer_iterations=worker.C_OUTER), **worker.SOLVES[name])
        res = jrefine.refine_pose(c, kfs_c, T0, **kw)
        refs[f"c_jax_{name}_nid"] = float(res.nid)

    fuse = jax.jit(lambda pts, valid, images, q, t, masks, cq, ct: jfusion_shard.fuse_sharded(
        c, pts, valid, images, jse3.SE3(q, t), jse3.SE3(cq, ct), m, mask_images=masks,
        **FUSE_KW))
    for prefix in ("d_", "o_", "k_"):
        got = fuse(*(inputs[prefix + k] for k in ("points", "valid_map", "images", "poses_q",
                                                  "poses_t", "masks", "T_q", "T_t")))
        for field in ("rgb", "colored", "best_label", "observation_count"):
            refs[f"{prefix}jax_{field}"] = np.asarray(getattr(got, field))

    c2w, odo, meas, w = pose_graph_inputs()
    pg = jpg_shard.optimize_sharded(m, c2w, odo, meas, abs_weight=jnp.asarray(w), iterations=4)
    refs["f_jax_poses_q"], refs["f_jax_poses_t"] = np.asarray(pg.poses.q), np.asarray(pg.poses.t)
    refs["f_jax_res"] = np.asarray([pg.residual_norm, pg.initial_residual_norm])
    return refs


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_parallel_mesh4")
    c, kfs_a, scenes_b, kfs_c, inputs = build_inputs()
    np.savez(work / "inputs.npz", **inputs)
    results, refs = worker.spawn("mesh4", WORLD, work, timeout=300,
                                 during=lambda: jax_references(c, kfs_a, scenes_b, kfs_c, inputs))
    for r, (rc, out) in enumerate(results):
        assert rc == 0 and "RANK_OK" in out, f"rank {r} failed (rc {rc}):\n{out}"
    return worker.load_ranks(work, WORLD), refs


def _coords(r):
    return r // PT, r % PT


def test_mesh_coordinates_groups_and_round_trips(mesh4):
    ranks, _ = mesh4
    for r, got in enumerate(ranks):
        a, b = _coords(r)
        assert tuple(got["coordinate"]) == (a, b)
        assert list(got["kf_group"]) == [b, PT + b]
        assert list(got["pt_group"]) == [a * PT, a * PT + 1]
        assert got["roundtrip_kf"] and got["roundtrip_pt"]
        assert int(got["kf_rows"]) == 2 * a and int(got["pt_rows"]) == 3 * b
        assert int(got["world_after_init"]) == WORLD


def test_mesh_refusals(mesh4):
    ranks, _ = mesh4
    for got in ranks:
        assert got["refuses_meta"] and got["refuses_uneven"]
        assert got["refuses_grouped"] and got["refuses_stride"]


@pytest.mark.parametrize("j", range(len(XI_A)))
def test_sharded_value_and_grad_match_jax(mesh4, j):
    ranks, refs = mesh4
    v, g = ranks[0][f"a_value{j}"], ranks[0][f"a_grad{j}"]
    np.testing.assert_allclose(float(v), float(refs[f"a_value{j}"]), rtol=2e-4)
    np.testing.assert_allclose(g, refs[f"a_grad{j}"], rtol=1e-3, atol=1e-5)
    # The serial port at the same point: the sharding changes only the
    # histograms' summation order.
    np.testing.assert_allclose(float(v), float(ranks[0][f"a_serial_value{j}"]), rtol=2e-4)
    np.testing.assert_allclose(g, ranks[0][f"a_serial_grad{j}"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", B_CASES)
def test_sharded_frozen_cache_matches_jax(mesh4, case):
    ranks, refs = mesh4
    wide = case.startswith("m2")
    for r, got in enumerate(ranks):
        a, b = _coords(r)
        n = got[f"b_{case}_knot"].shape[1]
        rows, pts = slice(a, a + 1), slice(b * n, (b + 1) * n)
        taps = refs[f"b_{case}_taps"]
        np.testing.assert_array_equal(got[f"b_{case}_taps"],
                                      taps[rows, :, pts] if wide else taps[rows, pts])
        np.testing.assert_array_equal(got[f"b_{case}_knot"], refs[f"b_{case}_knot"][rows, pts])
        np.testing.assert_array_equal(got[f"b_{case}_inlier"],
                                      refs[f"b_{case}_inlier"][rows, pts])
        for field in ("refreshes", "partials", "drift_accum"):
            assert got[f"b_{case}_{field}"] == refs[f"b_{case}_{field}"], (r, field)
        np.testing.assert_allclose(float(got[f"b_{case}_loss"]), float(refs[f"b_{case}_loss"]),
                                   rtol=1e-5)
    # The refresh was forced, and partial only where every shard's was.
    assert int(refs[f"b_{case}_refreshes"]) == 2
    assert int(refs[f"b_{case}_partials"]) == (1 if case.endswith("both") else 0)


@pytest.mark.parametrize("name", ("plain", "frozen", "c2f"))
def test_sharded_solve_matches_jax_serial(mesh4, name):
    ranks, refs = mesh4
    got = float(ranks[0][f"c_sharded_{name}_nid"])
    assert abs(got - refs[f"c_jax_{name}_nid"]) < NID_TOL, (got, refs[f"c_jax_{name}_nid"])
    serial = next(r[f"c_serial_{name}_nid"] for r in ranks if f"c_serial_{name}_nid" in r)
    assert abs(got - float(serial)) < NID_TOL, (got, float(serial))
    q, t = ranks[0][f"c_sharded_{name}_T_q"], ranks[0][f"c_sharded_{name}_T_t"]
    dt, dr = jse3.delta_magnitudes(jse3.SE3(jnp.asarray(q), jnp.asarray(t)), jse3.identity())
    assert float(dt) < 0.02 and float(dr) < 0.017453
    if name != "plain":
        assert int(ranks[0][f"c_sharded_{name}_gathers"]) < int(
            ranks[0][f"c_sharded_{name}_evaluations"])


@pytest.mark.parametrize("prefix", ("d_", "o_", "k_"))
def test_sharded_fuse_matches_jax_sharded(mesh4, prefix):
    ranks, refs = mesh4
    got = ranks[0]
    for field in ("colored", "observation_count", "best_label"):
        np.testing.assert_array_equal(got[f"{prefix}sharded_{field}"],
                                      refs[f"{prefix}jax_{field}"], err_msg=field)
    np.testing.assert_allclose(got[f"{prefix}sharded_rgb"], refs[f"{prefix}jax_rgb"], atol=1e-3)


@pytest.mark.parametrize("prefix", ("d_", "k_"))
def test_sharded_fuse_wall_matches_serial(mesh4, prefix):
    ranks, _ = mesh4
    got = ranks[0]
    for field in ("colored", "observation_count", "best_label"):
        np.testing.assert_array_equal(got[f"{prefix}sharded_{field}"],
                                      got[f"{prefix}serial_{field}"])
    np.testing.assert_allclose(got[f"{prefix}sharded_rgb"], got[f"{prefix}serial_rgb"],
                               atol=1e-3)


def test_point_sharded_cull_misses_other_shards_occluders(mesh4):
    """The reference-side quirk the port follows: with pt > 1 each shard's
    z-buffer sees only its own points, so the wall points behind the first
    shard's occluder stay visible to the sharded fuse (JAX's and the
    port's alike) and hidden to the serial one."""
    ranks, refs = mesh4
    got = ranks[0]
    n = len(got["o_sharded_observation_count"])
    wall = slice(n // 2, n)
    more = got["o_sharded_observation_count"][wall] > got["o_serial_observation_count"][wall]
    assert more.sum() > 0
    np.testing.assert_array_equal(got["o_sharded_observation_count"][: n // 2],
                                  got["o_serial_observation_count"][: n // 2])
    assert (refs["o_jax_observation_count"] != got["o_serial_observation_count"]).any()


def test_sharded_per_keyframe_lanes_bit_equal_serial(mesh4):
    ranks, _ = mesh4
    got = ranks[0]
    want = ranks[1]
    for field in ("T_q", "T_t", "nid", "outer_iterations", "converged", "evaluations"):
        np.testing.assert_array_equal(got[f"e_sharded_pk_{field}"], want[f"e_serial_pk_{field}"],
                                      err_msg=field)
    assert int(got["e_sharded_pk_lockstep"]) <= int(want["e_serial_pk_lockstep"])


def test_sharded_pose_graph_matches_serial_and_jax(mesh4):
    ranks, refs = mesh4
    got, want = ranks[0], ranks[2]
    assert got["f_blocks_equal"]
    for key in ("f_sharded_poses_q", "f_sharded_poses_t", "f_sharded_res"):
        np.testing.assert_array_equal(got[key], want[key.replace("sharded", "serial")])
    np.testing.assert_allclose(got["f_sharded_poses_q"], refs["f_jax_poses_q"], atol=1e-5)
    np.testing.assert_allclose(got["f_sharded_poses_t"], refs["f_jax_poses_t"], atol=1e-5)
    np.testing.assert_allclose(got["f_sharded_res"], refs["f_jax_res"], rtol=1e-5, atol=1e-6)


def test_replicated_results_identical_bits_on_every_rank(mesh4):
    """Every host branch of the sharded solve reads all-reduced values, so
    every rank must end with the same bits (else the ranks' collectives
    would part ways)."""
    ranks, _ = mesh4
    keys = [k for k in ranks[0] if k.startswith(("a_value", "a_grad", "c_sharded_", "d_sharded_",
                                                "o_sharded_", "k_sharded_", "e_sharded_",
                                                "f_sharded_"))]
    keys += [k for k in ranks[0] if k.startswith("b_") and k.endswith(
        ("_loss", "_refreshes", "_partials", "_drift_accum"))]
    assert len(keys) > 60
    for r in range(1, WORLD):
        for key in keys:
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r} {key}")
