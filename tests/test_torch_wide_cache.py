"""PyTorch port vs the JAX package: the frozen-tap cache's wide window and
partial refresh (kernels G2 ``wide_take``, W1 ``wide_select`` and the block
forms of G1 and G2, through their plain twins on the CPU), the cached loss
over drift steps, and the solves that use them.

Tolerance classes: bit for bit for the twins, the cache's taps, knots, gate
and counters; rtol 1e-5 for NID values and 1e-4 of the norm for pose
gradients (f32 summation order, as in tests/test_torch_frozen.py); the
objective level for solves (final NIDs within 1e-3), and bit for bit
between the port's own partial and full-refresh solves."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu.opt import refine as jrefine
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.ops import tap_gather as tg
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.opt import refine as trefine
from pointcloudprocessor_tpu_torch.utils import interop

from test_nid import nid_scene
from test_torch_nid import _cameras

CPU = "cpu"
NID_TOL = 1e-3
T0_XI = (0.02, -0.01, 0.01, 0.004, -0.002, 0.004)
EDGE = (0, 1, -1, -7, 10**9, -10**9, 2**31 - 1, -2**31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(margin, k=2):
    """K keyframes of 64 x 64 = 4096 wall points (32 refresh blocks) in both
    packages, with the wide window of ``margin`` attached."""
    cj, ct = _cameras()
    arrays = [[], [], []]
    for i in range(k):
        pts, inten, img = nid_scene(cj, wall_z=5.0 + 0.3 * i, n_side=64, seed=i)
        arrays[0].append(pts + np.asarray([0.1 * i, 0.05 * i, 0.0], np.float32))
        arrays[1].append(inten)
        arrays[2].append(np.asarray(jnid.quantize_image(jnp.asarray(img), 16)))
    pts, inten, bins = (np.stack(a) for a in arrays)
    valid = np.ones(inten.shape, bool)
    kj = jnid.prepare_keyframes(
        jnid.NIDKeyframe(jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid),
                         jnp.asarray(bins)), build_slabs=False, wide_margin=margin)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU),
                                wide_margin=margin)
    return cj, ct, kj, kt


def _poses(xi):
    Tj = jse3.exp(jnp.asarray(np.asarray(xi, np.float32)))
    return Tj, interop.pose(np.asarray(Tj.q), np.asarray(Tj.t), CPU)


def _shifted(cj, px):
    """The start pose moved by ``px`` pixels along u on the wall at 5 m."""
    fx = float(cj.intrinsic[0])
    Tj, _ = _poses(T0_XI)
    T1 = jse3.compose(Tj, jse3.exp(jnp.asarray([px * 5.0 / fx, 0, 0, 0, 0, 0], jnp.float32)))
    return T1, interop.pose(np.asarray(T1.q), np.asarray(T1.t), CPU)


def _edge_knots(w, h):
    """Every pixel, 3 past each border, and the edge values crossed."""
    uu, vv = np.meshgrid(np.arange(-3, w + 3), np.arange(-3, h + 3))
    ee = np.asarray(EDGE + (w - 1, w, h - 1, h), np.int64)
    eu, ev = np.meshgrid(ee, ee)
    kn = np.concatenate([np.stack([uu.ravel(), vv.ravel()], -1),
                         np.stack([eu.ravel(), ev.ravel()], -1)])
    return np.clip(kn, -2**31, 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("shape", [(13, 21), (1, 1), (16, 24), (9, 8)])
def test_wide_take_twin_is_jax_wide_table_at_every_pixel(shape, margin):
    """G2's twin (over the packed bin tiles) against JAX's
    ``build_wide_tap_table(bins, m)[anchor]``, transposed, at every pixel and
    off the image, on edge and +-1e9 knots, at 1, 15 and 16 bins."""
    h, w = shape
    rs = np.random.default_rng(h * 100 + w)
    kn = _edge_knots(w, h)
    knots = np.stack([kn, kn[::-1]])
    for bins in (1, 15, 16):
        b = rs.integers(0, bins, (2, h, w)).astype(np.int32)
        tiles = tg.pack_bins(torch.from_numpy(b))
        got = tg.wide_take(tiles, torch.from_numpy(knots), w, h, margin).numpy()
        assert got.shape == (2, 4 + 2 * margin, knots.shape[1]) and got.dtype == np.int32
        for j in range(2):
            table = np.asarray(jnid.build_wide_tap_table(jnp.asarray(b[j]), margin))
            anchor = (np.clip(knots[j, :, 1], 0, h - 1).astype(np.int64) * w
                      + np.clip(knots[j, :, 0], 0, w - 1))
            np.testing.assert_array_equal(got[j], table[anchor].T)


def test_wide_take_refuses_a_margin_outside_1_2():
    tiles = tg.pack_bins(torch.zeros((1, 8, 8), dtype=torch.int32))
    for m in (0, 3, -1):
        with pytest.raises(ValueError, match="margin"):
            tg.wide_take(tiles, torch.zeros((1, 4, 2), dtype=torch.int32), 8, 8, m)


@pytest.mark.parametrize("margin", [1, 2])
def test_wide_select_twin_is_jax_select_bit_for_bit(margin):
    """W1's twin against JAX's ``_select_from_wide`` at dk = clip(knot_true
    - knot_cache, -m, m) and the effective knot knot_cache + dk
    (`nid.py:641-667, 858-860`), int32 differences that wrap included."""
    rs = np.random.default_rng(margin)
    k, n, rows = 2, 3000, 4 + 2 * margin
    wide = rs.integers(-2**31, 2**31, (k, rows, n), dtype=np.int64).astype(np.int32)
    kc = rs.integers(-50, 50, (k, n, 2)).astype(np.int32)
    kt = (kc + rs.integers(-4, 5, (k, n, 2))).astype(np.int32)
    wrap = np.asarray([[2**31 - 1, -5], [-2**31, 3], [10**9, -10**9], [-2**31, 2**31 - 1],
                       [2**31 - 2, -2**31 + 1]], np.int64)
    kt[:, :5] = wrap.astype(np.int32)
    kc[:, :5] = wrap[::-1].astype(np.int32)
    dk = jnp.clip(jnp.asarray(kt) - jnp.asarray(kc), -margin, margin)
    want = np.asarray(jnid._select_from_wide(jnp.asarray(wide), dk, margin))
    want_knot = np.asarray(jnp.asarray(kc) + dk)
    taps, eff = tg.wide_select(torch.from_numpy(wide), torch.from_numpy(kt),
                               torch.from_numpy(kc), margin)
    np.testing.assert_array_equal(taps.numpy(), want)
    np.testing.assert_array_equal(eff.numpy(), want_knot)


def _block_list(dirty, cap):
    nb = dirty.shape[1]
    iota = torch.arange(nb, dtype=torch.int32)
    return torch.sort(torch.where(torch.from_numpy(dirty), iota, nb), dim=1).values[:, :cap]


@pytest.mark.parametrize("margin", [0, 1, 2])
def test_block_forms_match_jax_partial_refresh(margin):
    """G1's and G2's block forms (twins, in place) against JAX's
    ``_partial_refresh_taps`` / ``_partial_refresh_wide`` on a random dirty
    set (an all-clean keyframe included), the padded ids dropped; the list
    is JAX's ``sort(where(dirty, iota, nb))[:cap]``."""
    cj, ct, kj, kt = _scene(margin)
    k, n = kt.points.shape[:2]
    nb = n // tg.PARTIAL_BLOCK
    rs = np.random.default_rng(3 + margin)
    dirty = rs.random((k, nb)) < 0.3
    dirty[1] = False
    cap = int(dirty.sum(1).max()) + 2
    knot = rs.integers(-20, 140, (k, n, 2)).astype(np.int32)
    knot[:, :8] = np.asarray(EDGE, np.int64).astype(np.int32)[:, None]
    shape = (k, 4 + 2 * margin, n) if margin else (k, n, 2)
    cache = rs.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    if margin:
        want = jnid._partial_refresh_wide(cj, kj, jnp.asarray(cache), jnp.asarray(knot),
                                          jnp.asarray(dirty), cap)
        got = tg.wide_take_blocks(kt.bin_tiles, torch.from_numpy(knot), _block_list(dirty, cap),
                                  torch.from_numpy(cache.copy()), ct.width, ct.height, margin)
    else:
        want = jnid._partial_refresh_taps(cj, kj, jnp.asarray(cache), jnp.asarray(knot),
                                          jnp.asarray(dirty), cap)
        got = tg.tap_take_blocks(kt.bin_tiles, torch.from_numpy(knot), _block_list(dirty, cap),
                                 torch.from_numpy(cache.copy()), ct.width, ct.height)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != cache).any()


def _cached_both(cj, ct, kj, kt, px, partial_frac, guard_frac=0.0):
    """The cached loss at the start pose moved ``px`` pixels, from a cache
    gathered at the start pose, in both packages: ((loss, cache, select) of
    JAX, (loss, cache, select) of the port); ``select`` is the evaluated
    taps (the cache's rows, or W1's sub-windows under a margin)."""
    Tj0, Tt0 = _poses(T0_XI)
    Tj, Tt = _shifted(cj, px)
    cj_ = jnid.make_tap_cache(cj, Tj0, kj)
    lj, cj2 = jnid.multi_nid_loss_cached(cj, Tj, kj, cj_, guard_frac=guard_frac,
                                         partial_frac=partial_frac, use_pallas=False,
                                         use_grouped=False)
    lt, ct2 = tnid.multi_nid_loss_cached(ct, Tt, kt, tnid.make_tap_cache(ct, Tt0, kt),
                                         guard_frac=guard_frac, partial_frac=partial_frac)
    margin = kt.wide_margin
    knot_true = tnid._project_all(ct, Tt, kt)[1]
    if margin:
        dk = jnp.clip(jnp.asarray(knot_true.numpy()) - cj2.knot, -margin, margin)
        sel_j = np.asarray(jnid._select_from_wide(cj2.taps, dk, margin))
        sel_t = tg.wide_select(ct2.taps, knot_true, ct2.knot, margin)[0].numpy()
    else:
        sel_j, sel_t = np.asarray(cj2.taps), ct2.taps.numpy()
    return (lj, cj2, sel_j), (lt, ct2, sel_t)


@pytest.mark.parametrize("px", [0.5, 1.5, 2.5, 4.5])
@pytest.mark.parametrize("margin, partial_frac", [(0, 0.0), (0, 1.0), (1, 1.0), (2, 0.0),
                                                  (2, 1.0)])
def test_cached_loss_matches_jax_over_drift(px, margin, partial_frac):
    """`tests/test_nid.py:403-581` in both packages: after a uniform drift of
    ``px`` pixels the refresh and partial counters are equal, the cache's
    taps, knots and gate and the evaluated taps bit-equal, the NID at rtol
    1e-5; a refresh equals the exact loss at the new pose in each package."""
    cj, ct, kj, kt = _scene(margin)
    (lj, cj2, sel_j), (lt, ct2, sel_t) = _cached_both(cj, ct, kj, kt, px, partial_frac)
    assert ct2.refreshes == int(cj2.refreshes)
    assert ct2.partials == int(cj2.partials)
    np.testing.assert_allclose(float(ct2.drift_accum), float(cj2.drift_accum), rtol=1e-6)
    np.testing.assert_array_equal(ct2.knot.numpy(), np.asarray(cj2.knot))
    np.testing.assert_array_equal(ct2.inlier.numpy(), np.asarray(cj2.inlier))
    np.testing.assert_array_equal(ct2.taps.numpy(), np.asarray(cj2.taps))
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    if margin and np.ceil(px) <= margin:  # within the margin: no refresh, the exact taps
        assert ct2.refreshes == 1
        _, Tt = _shifted(cj, px)
        exact = tg.direct_take(kt.bin_tiles, tnid._project_all(ct, Tt, kt)[1], ct.width,
                               ct.height).numpy()
        live = (ct2.inlier.numpy() > 0) & tnid._project_all(ct, Tt, kt)[2].numpy()
        np.testing.assert_array_equal(sel_t[live], exact[live])
    if px == 4.5:  # a refresh of every point
        assert ct2.refreshes == 2
        assert ct2.partials == (1 if partial_frac else 0)
        _, Tt = _shifted(cj, px)
        with torch.no_grad():
            assert float(lt) == float(tnid.multi_nid_loss(ct, Tt, kt))


@pytest.mark.parametrize("margin, px", [(0, 0.5), (1, 2.5)])
def test_partial_refresh_equals_full_refresh(margin, px):
    """A refresh served by the block forms gives the full refresh's loss
    bit for bit, and at margin 0 its taps on every live point, its knots
    and its gate (`tests/test_nid.py:403-433, 538-557`)."""
    cj, ct, kj, kt = _scene(margin)
    (_, _, _), (l_full, c_full, s_full) = _cached_both(cj, ct, kj, kt, px, 0.0)
    (_, _, _), (l_part, c_part, s_part) = _cached_both(cj, ct, kj, kt, px, 1.0)
    assert c_full.partials == 0 and c_part.partials == 1 and c_part.refreshes == 2
    assert float(l_part) == float(l_full)
    live = c_full.inlier.numpy() > 0
    np.testing.assert_array_equal(s_part[live], s_full[live])
    if not margin:
        np.testing.assert_array_equal(c_part.knot.numpy(), c_full.knot.numpy())
        np.testing.assert_array_equal(c_part.inlier.numpy(), c_full.inlier.numpy())


def test_partial_capacity_fallback_is_full_gather():
    """More dirty blocks than the capacity: the full gather, partials
    untouched, in both packages (`tests/test_nid.py:436-454`)."""
    cj, ct, kj, kt = _scene(0)
    (lj, cj2, _), (lt, ct2, _) = _cached_both(cj, ct, kj, kt, 1.5, 0.25)
    assert ct2.refreshes == int(cj2.refreshes) == 2
    assert ct2.partials == int(cj2.partials) == 0
    _, Tt = _shifted(cj, 1.5)
    with torch.no_grad():
        assert float(lt) == float(tnid.multi_nid_loss(ct, Tt, kt))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_stale_row_on_a_clean_block_matches_jax():
    """JAX's margin-0 partial refresh re-centres every point, re-taking only
    the dirty blocks (`nid.py:823-833`): a point that enters the gate on a
    clean block with an unchanged knot keeps the row it was cached with.
    Constructed: the point's cached row is garbage, its cached knot its
    true one, its cached gate 0; a drift elsewhere forces the refresh. The
    port keeps the same stale row and gives JAX's loss."""
    cj, ct, kj, kt = _scene(0, k=1)
    Tj, Tt = _shifted(cj, 0.5)
    _, knot, inl = tnid._project_all(ct, Tt, kt)
    p = int(torch.nonzero(inl[0])[5])  # a live point of block 0
    rows = tg.direct_take(kt.bin_tiles, knot, ct.width, ct.height).numpy()
    knots, gate = knot.numpy().copy(), inl.numpy().astype(np.float32)
    rows[0, p] = [0x12345678, 0x0ABCDEF0]
    gate[0, p] = 0.0
    # Drift every point of the last block by 3 px, so one block is dirty.
    knots[0, -tg.PARTIAL_BLOCK:, 0] += 3
    cache_j = jnid.TapCache(jnp.asarray(rows), jnp.asarray(knots), jnp.asarray(gate),
                            jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
                            jnp.asarray(0.0, jnp.float32))
    cache_t = tnid.TapCache(torch.from_numpy(rows.copy()), torch.from_numpy(knots),
                            torch.from_numpy(gate), 1, 0, torch.zeros(()))
    lj, cj2 = jnid.multi_nid_loss_cached(cj, Tj, kj, cache_j, guard_frac=0.0, partial_frac=1.0,
                                         use_pallas=False, use_grouped=False)
    lt, ct2 = tnid.multi_nid_loss_cached(ct, Tt, kt, cache_t, guard_frac=0.0, partial_frac=1.0)
    assert ct2.partials == int(cj2.partials) == 1
    np.testing.assert_array_equal(ct2.taps.numpy(), np.asarray(cj2.taps))
    assert list(ct2.taps.numpy()[0, p]) == [0x12345678, 0x0ABCDEF0]  # stale in both
    assert float(ct2.inlier[0, p]) == float(cj2.inlier[0, p]) == 1.0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_prepare_keyframes_margin():
    """``wide_margin`` sets the keyframes' window (no table is built), a set
    margin stays, and a margin outside 0..2 raises ValueError."""
    _, _, _, kt = _scene(0, k=1)
    assert kt.wide_margin == 0 and kt.tap_rows is None
    k2 = tnid.prepare_keyframes(kt, wide_margin=2)
    assert k2.wide_margin == 2 and k2.tap_rows is None
    assert tnid.prepare_keyframes(k2, wide_margin=1).wide_margin == 2
    for m in (3, -1):
        with pytest.raises(ValueError, match="margin"):
            tnid.prepare_keyframes(kt, wide_margin=m)


KW = dict(max_inner_iterations=30, max_outer_iterations=3, frozen_taps=True)
XI_START = (0.02, -0.015, 0.01, 0.006, -0.004, 0.008)


@pytest.fixture(scope="module")
def solves():
    """The JAX solves of one keyframe from a 2-3 cm / 0.6 deg offset with
    margin 2 and with partial 1.0 (jitted once each)."""
    cj, ct, kj, kt = _scene(0, k=1)
    Tj, _ = _poses(XI_START)
    kj = kj._replace(tap_wide=None)
    out = {name: jrefine.refine_pose(cj, kj, Tj, **KW, **kw) for name, kw in (
        ("margin2", dict(frozen_margin=2)), ("partial", dict(frozen_partial_frac=1.0)))}
    return cj, ct, kt, out


@pytest.mark.parametrize("name, kw", [("margin2", dict(frozen_margin=2)),
                                      ("partial", dict(frozen_partial_frac=1.0))])
def test_refine_cache_options_match_jax(solves, name, kw):
    """``refine_pose`` with margin 2, and with every refresh partial,
    reaches JAX's objective within 1e-3, at most the truth's (identity) NID
    + 1e-3, and the truth within 1 cm / 1 deg; the partial solve counts
    partial gathers, as JAX's."""
    cj, ct, kt, jax_runs = solves
    _, Tt = _poses(XI_START)
    rt = trefine.refine_pose(ct, kt, Tt, **KW, **kw)
    rj = jax_runs[name]
    assert abs(float(rt.nid) - float(rj.nid)) <= NID_TOL
    with torch.no_grad():
        truth = float(tnid.multi_nid_loss(ct, tse3.identity(CPU), kt))
    assert float(rt.nid) <= truth + NID_TOL
    dt, dr = tse3.delta_magnitudes(rt.T_camera_lidar, tse3.identity(CPU))
    assert float(dt) < 0.01 and float(dr) < np.radians(1.0)
    assert rt.partial_gathers <= rt.gathers
    if name == "partial":
        assert rt.partial_gathers >= 1 and int(rj.partial_gathers) >= 1
    else:
        assert rt.partial_gathers == 0 == int(rj.partial_gathers)


def test_refine_partial_solve_is_bit_identical_to_full():
    """JAX's `test_refine_partial_refresh_solve_is_bit_identical` on the
    port: partial 1.0 against 0.0 (the sort pinned off for both), the same
    pose bits, NID and evaluation count."""
    _, ct, _, kt = _scene(0, k=1)
    _, Tt = _poses(XI_START)
    kw = dict(KW, sort_points=False)
    full = trefine.refine_pose(ct, kt, Tt, **kw)
    part = trefine.refine_pose(ct, kt, Tt, frozen_partial_frac=1.0, **kw)
    assert torch.equal(full.T_camera_lidar.q, part.T_camera_lidar.q)
    assert torch.equal(full.T_camera_lidar.t, part.T_camera_lidar.t)
    assert float(full.nid) == float(part.nid)
    assert full.evaluations == part.evaluations and full.gathers == part.gathers
    assert part.partial_gathers >= 1 and full.partial_gathers == 0


def test_refine_sort_default_follows_partial():
    """``sort_points`` None sorts for a partial refresh (JAX `refine.py:
    179-189`): the solve equals the one with the sort asked for."""
    _, ct, _, kt = _scene(0, k=1)
    _, Tt = _poses(XI_START)
    kw = dict(KW, frozen_partial_frac=0.5, max_outer_iterations=1, max_inner_iterations=6)
    a = trefine.refine_pose(ct, kt, Tt, **kw)
    b = trefine.refine_pose(ct, kt, Tt, sort_points=True, **kw)
    assert torch.equal(a.T_camera_lidar.q, b.T_camera_lidar.q) and float(a.nid) == float(b.nid)
    # Inert without frozen taps: no margin is read, and no sort is made.
    c = trefine.refine_pose(ct, kt, Tt, frozen_margin=7, frozen_partial_frac=0.5,
                            max_outer_iterations=1, max_inner_iterations=6)
    d = trefine.refine_pose(ct, kt, Tt, max_outer_iterations=1, max_inner_iterations=6)
    assert torch.equal(c.T_camera_lidar.t, d.T_camera_lidar.t) and c.gathers == 0
