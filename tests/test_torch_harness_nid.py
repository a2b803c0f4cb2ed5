"""PyTorch port vs the JAX package: the NID measurement harnesses —
`tools/nid_locality`, `tools/nid_bisect`, `tools/solver_sweep`,
`tools/frozen_guard_sweep`, `tools/tap_cache_probe` and
`tools/slab_gather_probe` — on the same inputs (JAX's own draws passed in,
or the port's seeded scene handed to JAX), on the CPU, where the wrappers
take their kernels' plain twins.

Tolerance classes: the scene's points and intensities within an f32 ulp
(1e-6; XLA's and torch's sin / cos), its bins bit-equal; the chained
accumulators of the evaluation, gather and variant loops within f32
summation order (1e-5 relative); the grouped, streamed and direct chains
bit-equal to each other; the frozen cache's refreshes, partial refreshes
and drift bit-equal, its summed losses within f32 order; the group spans
and overflow shares bit-equal; the sweeps' solves at the objective level
(final NID within 1e-3 of JAX's and no worse than JAX's + 1e-3)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu.opt import refine as jrefine
from pointcloudprocessor_tpu.tools import nid_bisect as jbisect
from pointcloudprocessor_tpu.tools import nid_locality as jloc
from pointcloudprocessor_tpu.tools import tap_cache_probe as jprobe
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.tools import bench_scene
from pointcloudprocessor_tpu_torch.tools import frozen_guard_sweep as tguard
from pointcloudprocessor_tpu_torch.tools import nid_bisect as tbisect
from pointcloudprocessor_tpu_torch.tools import nid_locality as tloc
from pointcloudprocessor_tpu_torch.tools import slab_gather_probe as tslab
from pointcloudprocessor_tpu_torch.tools import solver_sweep as tsweep
from pointcloudprocessor_tpu_torch.tools import tap_cache_probe as tprobe

CPU = "cpu"
W, H, N, K = 128, 96, 2048, 2  # the harness scene: width, height, points a keyframe, keyframes
REPS = 2
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(seed=0):
    """The (u, v, z) draws of JAX's `nid_locality.build_scene`, (K, N) each."""
    out = [[], [], []]
    for key in jax.random.split(jax.random.PRNGKey(seed), K):
        k1, k2, k3 = jax.random.split(key, 3)
        out[0].append(jax.random.uniform(k1, (N,), jnp.float32, 2.0, W - 3.0))
        out[1].append(jax.random.uniform(k2, (N,), jnp.float32, 2.0, H - 3.0))
        out[2].append(jax.random.uniform(k3, (N,), jnp.float32, 4.0, 8.0))
    return tuple(np.stack([np.asarray(a) for a in d]) for d in out)


@pytest.fixture(scope="module")
def scenes():
    """JAX's harness scene and the port's from JAX's draws, each in map
    order and raster-sorted at the identity, prepared as the harnesses
    prepare them (the row tables built)."""
    cj, kj = jloc.build_scene(W, H, N, K)
    ct, kt = tloc.build_scene(W, H, N, K, CPU, draws=_jax_draws())
    prep = jax.jit(functools.partial(jnid.prepare_keyframes, build_slabs=True))
    kjs = prep(jnid.sort_by_raster(cj, jse3.identity(), kj))
    kts = tnid.prepare_keyframes(tnid.sort_by_raster(ct, tse3.identity(CPU), kt), grouped=True)
    return dict(cj=cj, kj=prep(kj), kjs=kjs, kj_raw=kj, ct=ct,
                kt=tnid.prepare_keyframes(kt, grouped=True), kts=kts, kt_raw=kt)


def test_build_scene_matches_jax(scenes):
    kj, kt = scenes["kj_raw"], scenes["kt_raw"]
    np.testing.assert_allclose(kt.points.numpy(), np.asarray(kj.points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(kt.intensity.numpy(), np.asarray(kj.intensity), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(kt.bin_image.numpy(), np.asarray(kj.bin_image))
    np.testing.assert_array_equal(scenes["ct"].intrinsic.numpy(),
                                  np.asarray(scenes["cj"].intrinsic))


@pytest.mark.parametrize("grouped", [None, True, "streamed"])
def test_timed_val_grad_matches_jax(scenes, grouped):
    """The chained value+grad accumulator and the last iterate at reps 2 on
    the raster-sorted scene; the grouped chains bit-equal to the direct."""
    x0 = jnp.zeros(6, jnp.float32)
    xj, aj = jloc.timed_val_grad(scenes["cj"], scenes["kjs"], x0, REPS, use_grouped=grouped)
    xt, at = tloc.timed_val_grad(scenes["ct"], scenes["kts"], torch.zeros(6), REPS, grouped)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-9)
    _, direct = tloc.timed_val_grad(scenes["ct"], scenes["kts"], torch.zeros(6), REPS, None)
    assert float(at) == float(direct)


@pytest.mark.parametrize("grouped", [False, True, "streamed"])
def test_timed_gather_flat_matches_jax(scenes, grouped):
    x0 = jnp.zeros(6, jnp.float32)
    _, aj = jloc.timed_gather_flat(scenes["cj"], scenes["kjs"], x0, REPS, use_grouped=grouped)
    _, at = tloc.timed_gather_flat(scenes["ct"], scenes["kts"], torch.zeros(6), REPS, grouped)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


@pytest.mark.parametrize("order", ["kj", "kjs"])
def test_timed_gather_matches_jax(scenes, order):
    """``index_select`` of the port's tap table against JAX's ``jnp.take``."""
    _, aj = jloc.timed_gather(scenes["cj"], scenes[order], jnp.zeros(6, jnp.float32), REPS)
    kt = scenes["kt" if order == "kj" else "kts"]
    _, at = tloc.timed_gather(scenes["ct"], kt, torch.zeros(6), REPS)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


@pytest.mark.parametrize("variant,order", [
    ("project", "map"), ("gather_take", "map"), ("gather_take", "sorted"),
    ("gather_sorted_hint", "sorted"), ("onehot_marginal", "map"), ("forward", "map"),
    ("forward", "sorted")])
def test_bisect_variants_match_jax(scenes, variant, order):
    """Each variant's chained sums at reps 2 against JAX's ``make_variant``
    / ``forward_only``; the sorted hint's stand-in (G1 on sorted knots)
    against JAX's ``lax.gather`` with the hint."""
    kj = scenes["kj" if order == "map" else "kjs"]
    kt = scenes["kt" if order == "map" else "kts"]
    if variant == "forward":
        fj, ft = jbisect.forward_only, tbisect.forward_only
    else:
        fj, ft = jbisect.make_variant(variant), tbisect.make_variant(variant)
    xj, aj = fj(scenes["cj"], kj, jnp.zeros(6, jnp.float32), REPS)
    xt, at = ft(scenes["ct"], kt, torch.zeros(6), REPS)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def test_bisect_evaluations_run(scenes):
    """The guarded, frozen and per-keyframe evaluations the split times:
    the guarded value equals ``multi_nid_loss`` bit for bit, the frozen one
    at its cache's pose too, the per-keyframe values sum to it."""
    ct, kt = scenes["ct"], scenes["kt"]
    xi = torch.zeros(6)
    want = tnid.multi_nid_loss(ct, tse3.exp(xi), kt)
    v, g = tbisect.guarded_value_grad(ct, kt)(xi)
    assert torch.equal(v, want.detach()) and g.shape == (6,)
    v, g = tbisect.frozen_value_grad(ct, kt)(xi)
    assert torch.equal(v, want.detach())
    vals, grads = tbisect.per_keyframe_value_grad(ct, kt)(torch.zeros((K, 6)))
    assert vals.shape == (K,) and grads.shape == (K, 6)
    np.testing.assert_allclose(float(vals.sum()), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# solver_sweep / frozen_guard_sweep
# ---------------------------------------------------------------------------

SWEEP_SCENE = (128, 96, 8_000, 2048, 2)  # width, height, map points, culled points, keyframes
INNER = 3


@pytest.fixture(scope="module")
def sweep_scene():
    """The port's bench scene 1 and the same keyframes handed to JAX."""
    camera, kfs, T0 = bench_scene.nid_scene(*SWEEP_SCENE, device=CPU)
    cj = jcam.PinholeCamera(jnp.asarray(camera.intrinsic.numpy()),
                            jnp.asarray(camera.distortion.numpy()), camera.width, camera.height)
    kj = jnid.NIDKeyframe(points=jnp.asarray(kfs.points.numpy()),
                          intensity=jnp.asarray(kfs.intensity.numpy()),
                          valid=jnp.asarray(kfs.valid.numpy()),
                          bin_image=jnp.asarray(kfs.bin_image.numpy()))
    Tj = jse3.SE3(jnp.asarray(T0.q.numpy()), jnp.asarray(T0.t.numpy()))
    return camera, kfs, T0, cj, kj, Tj


@pytest.mark.parametrize("harness", ["solver_sweep", "frozen_guard_sweep"])
def test_sweep_row_matches_jax_refine(sweep_scene, harness):
    """One row of each sweep against JAX's ``refine_pose`` under the same
    schedule (inner iterations cut to 3), ftol and guard: the final NID
    within 1e-3 and no worse than JAX's + 1e-3; evaluations and gathers
    reported beside JAX's."""
    camera, kfs, T0, cj, kj, Tj = sweep_scene
    if harness == "solver_sweep":
        kw = dict(tsweep.SCHEDULE, max_inner_iterations=INNER, ftol=3e-4, frozen_guard_frac=0.75)
    else:
        kw = dict(tguard.SCHEDULE, max_inner_iterations=INNER, frozen_guard_frac=0.5)
    row = tsweep.run_row(camera, kfs, T0, kw, 1, CPU, harness)
    want = jrefine.refine_pose(cj, kj, Tj, **kw)
    print(f"{harness}: port {row['evaluations']} evaluations, {row['gathers']} gathers; "
          f"JAX {int(want.evaluations)}, {int(want.gathers)}")
    assert row["refine_s"] is None and row["refine_s_calls"] == []  # no time off the card
    assert abs(row["nid"] - float(want.nid)) <= 1e-3
    assert row["nid"] <= float(want.nid) + 1e-3
    assert row["evaluations"] > 0 and row["gathers"] >= 1


def test_best_row_rule():
    rows = [
        {"scene": "s1", "ftol": 0.0, "refine_s": 0.9, "pose_err_cm": 0.1, "pose_err_deg": 0.01},
        {"scene": "s2", "ftol": 0.0, "refine_s": 0.9, "pose_err_cm": 0.2, "pose_err_deg": 0.01},
        {"scene": "s1", "ftol": 1e-4, "refine_s": 0.5, "pose_err_cm": 0.3, "pose_err_deg": 0.02},
        {"scene": "s2", "ftol": 1e-4, "refine_s": 0.6, "pose_err_cm": 0.9, "pose_err_deg": 0.9},
        {"scene": "s1", "ftol": 3e-4, "refine_s": 0.2, "pose_err_cm": 0.3, "pose_err_deg": 0.02},
        {"scene": "s2", "ftol": 3e-4, "refine_s": 0.2, "pose_err_cm": 1.5, "pose_err_deg": 0.1},
        {"scene": "s1", "ftol": 1e-3, "refine_s": None, "pose_err_cm": 0.1, "pose_err_deg": 0.0},
        {"scene": "s2", "ftol": 1e-3, "refine_s": 0.1, "pose_err_cm": 0.1, "pose_err_deg": 0.0},
    ]
    best = tsweep.best_row(rows, "ftol")
    # 3e-4 misses the bar on scene 2; 1e-3 has a row without a time.
    assert best["ftol"] == 1e-4 and [r["scene"] for r in best["rows"]] == ["s1", "s2"]
    none = tsweep.best_row([dict(r, pose_err_deg=2.0) for r in rows], "ftol")
    assert none["ftol"] is None and "note" in none
    guards = [dict(r, guard=r.pop("ftol")) for r in [dict(r) for r in rows[:4]]]
    assert tsweep.best_row(guards, "guard")["metric"] == "solver_guard_sweep_best"


# ---------------------------------------------------------------------------
# tap_cache_probe / slab_gather_probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partial", [0.0, 1.0])
def test_timed_refresh_matches_jax(scenes, partial):
    """The chained cached evaluations at 0.33 px an evaluation, guard 0:
    refreshes and partial refreshes equal to JAX's, the summed losses
    within f32 order. The drift sum (the drifted share of the live points
    at each refresh) is JAX's within one point a refresh: the projections
    agree to f32 rounding (1.5e-5 px here), and at this scene's second pose
    one point projects to v = 89.0 in JAX and to the float below in the
    port, so its knot, and whether it drifted, differ."""
    reps, px = 4, 0.33
    xi = jnp.asarray(tprobe.XI_BASE, jnp.float32)
    _, aj, cj = jprobe.timed_refresh(scenes["cj"], scenes["kj"], xi, reps, partial, px)
    _, at, ct = tprobe.timed_refresh(scenes["ct"], scenes["kt"], torch.tensor(tprobe.XI_BASE),
                                     reps, partial, px)
    assert ct.refreshes == int(cj.refreshes) > 1
    assert ct.partials == int(cj.partials)
    one_point = float(torch.sum(ct.inlier) ** -1)
    assert abs(float(ct.drift_accum) - float(cj.drift_accum)) <= ct.refreshes * one_point * 1.01
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def test_timed_take_width_matches_jax():
    rs = np.random.default_rng(2)
    table = rs.integers(-(2**31), 2**31 - 1, (5000, 4), dtype=np.int32)
    idx = np.sort(rs.integers(0, 5000, 3000)).astype(np.int32)
    ij, aj = jprobe.timed_take_width(jnp.asarray(table), jnp.asarray(idx), 3, 4)
    it, at = tprobe.timed_take_width(torch.from_numpy(table), torch.from_numpy(idx).long(), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # JAX sums in int32 (wrapping), the port in int64: equal modulo 2^32.
    assert int(at) % 2**32 == int(aj) % 2**32


def _jax_span_stats(camera, kfs, T, stride, group=16, slabs=tslab.SLABS):
    """JAX's group-span statistics (`slab_gather_probe.py:186-216`)."""

    def one(pts, vld):
        pts_cam = jse3.transform_points(T, pts[::stride])
        knot = jnp.floor(jcam.project(camera, pts_cam)).astype(jnp.int32)
        inb = (vld[::stride] & (knot[:, 0] >= 0) & (knot[:, 0] < camera.width)
               & (knot[:, 1] >= 0) & (knot[:, 1] < camera.height) & (pts_cam[:, 2] > 0))
        return knot[:, 1] * camera.width + knot[:, 0], inb

    anchors, inb = jax.vmap(one)(kfs.points, kfs.valid)
    n = anchors.shape[1] - anchors.shape[1] % group
    a = anchors[:, :n].reshape(-1, group)
    ok = inb[:, :n].reshape(-1, group)
    lo = jnp.min(jnp.where(ok, a, jnp.int32(2**31 - 1)), axis=1)
    hi = jnp.max(jnp.where(ok, a, jnp.int32(-1)), axis=1)
    has = jnp.any(ok, axis=1)
    span = jnp.where(has, hi - lo, 0)
    ovf = {}
    for slab in slabs:
        base = (lo // slab) * slab
        bad = jnp.any(ok & (a >= base[:, None] + 2 * slab), axis=1) & has
        ovf[slab] = jnp.mean(bad.astype(jnp.float32))
    return span, ovf


def test_span_stats_match_jax(sweep_scene):
    """The spans and overflow shares of raster-sorted bench-scene points at
    the sort pose (stride 1 and 4) and drifted to the identity, bit for bit
    on the same keyframes; the printed percentiles too."""
    camera, kfs, T0, cj, kj, Tj = sweep_scene
    kts = tnid.sort_by_raster(camera, T0, kfs)
    kjs = jnid.sort_by_raster(cj, Tj, kj)
    np.testing.assert_array_equal(kts.points.numpy(), np.asarray(kjs.points))
    poses = {"sort_pose": Tj, "drifted_to_identity": jse3.identity()}
    for tag, stride, anchor, inb in tslab.span_cases(camera, kts, T0):
        span_t, ovf_t = tslab.span_stats(anchor, inb)
        span_j, ovf_j = _jax_span_stats(cj, kjs, poses[tag], stride)
        np.testing.assert_array_equal(span_t.numpy(), np.asarray(span_j))
        for slab in tslab.SLABS:
            assert float(ovf_t[slab]) == float(ovf_j[slab]), (tag, stride, slab)
        row = tslab.span_row(span_t, ovf_t, tag, stride)
        assert row["p50"] == int(np.sort(np.asarray(span_j))[len(span_j) // 2])
    # The drifted case must overflow somewhere for the test to bite.
    assert max(float(v) for v in ovf_t.values()) > 0
