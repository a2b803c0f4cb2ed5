"""PyTorch port vs the JAX package: the dense HPR cull's tiled plan (H1).

On the card H1 takes, for each block of directions, only the flipped points
of the subtiles that its skip rule cannot drop (`csrc/hpr.cu` proves the
rule). `ops/hpr.hpr_support_tiled_plain` runs the same plan and rule in
torch, each dot rounded as the kernel rounds it, over the kept pairs only.
Tolerance class: bit-exact. Its mask equals the jitted JAX `hpr_mask` and
the dense twin's; its supports equal the twin's wherever a point is ok; it
keeps every pair whose dot reaches the direction's own (the needed pairs).
Inputs are made from a seed with numpy and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import hpr as jhpr
from pointcloudprocessor_tpu_torch.ops import hpr as thpr
from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

R_DEFAULT = 90000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mask(points, valid, radius, tol):
    return np.asarray(jhpr.hpr_mask(jnp.asarray(points), jnp.asarray(valid), radius=radius,
                                    tolerance=tol))


def _needed_pairs(points, valid, radius):
    """Pairs (i, j) of ok points whose dot <f_j, u_i> (the twin's product,
    the kernel's FMA chain on the CPU) reaches i's self dot."""
    pt, vt = torch.from_numpy(points), torch.from_numpy(valid)
    u4, f4, ok, _, _ = thpr.hpr_flip_plain(pt, vt, radius)
    u, f, self_dot = u4[ok, :3], f4[ok, :3], f4[ok, 3]
    ft = f.T.contiguous()
    return sum(int((u[s: s + 2048] @ ft >= self_dot[s: s + 2048, None]).sum())
               for s in range(0, u.shape[0], 2048))


def _check(points, valid, radius=R_DEFAULT, tol=0.05):
    """The dense twin's mask and the tiled plan's against JAX's, the plan's
    supports against the twin's, its kept pairs against the needed ones.
    Returns its mask and stats."""
    pt, vt = torch.from_numpy(points), torch.from_numpy(valid)
    want = _jax_mask(points, valid, radius, tol)
    ok_t, sup_t, self_t = thpr.hpr_support_plain(pt, vt, radius)
    np.testing.assert_array_equal((ok_t & (sup_t - self_t <= tol)).numpy(), want)
    ok, support, self_support, stats = thpr.hpr_support_tiled_plain(pt, vt, radius)
    got = (ok & (support - self_support <= tol)).numpy()
    np.testing.assert_array_equal(got, want)
    assert torch.equal(ok, ok_t)
    assert torch.equal(support[ok], sup_t[ok_t]) or bool(
        torch.isnan(support[ok]).all() and torch.isnan(sup_t[ok_t]).all())
    assert stats[0] >= _needed_pairs(points, valid, radius)
    return got, stats


def _walls(n, seed=0, jitter=0.3, invalid=0.02):
    return bs.two_walls(n, seed=seed, z_jitter=jitter, invalid=invalid)


def _octants(n=4096, seed=1):
    """Points on every octant, behind the camera included: bearings uniform
    on the sphere, ranges 1-12 m, 3% invalid."""
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = d * rs.uniform(1.0, 12.0, (n, 1))
    return p.astype(np.float32), rs.uniform(size=n) > 0.03


def _ray_and_duplicates(seed=2):
    """400 points on one ray, 300 exact duplicates of wall points, a bulk
    of 3,000 wall points."""
    pts, valid = _walls(3000, seed=seed)
    ray = np.outer(np.linspace(1.0, 9.0, 400), [0.1, -0.05, 1.0]).astype(np.float32)
    dup = pts[:300].copy()
    p = np.concatenate([pts, ray, dup])
    v = np.concatenate([valid, np.ones(700, bool)])
    order = np.random.default_rng(seed).permutation(len(p))
    return p[order], v[order]


def _near_ties(seed=3):
    """A wall bulk and, for 40 of its points i, planted points j at 0.2 mrad
    from i's bearing whose support along u_i, s_j cos(theta), lies from 2
    deltas below i's self support to 1 above it (the rule's delta is 2^-17
    s_max, ~1.37 m at R = 90,000), a few at the tie and at the tolerance:
    subtiles whose bound falls within delta of a block's L_b."""
    pts, valid = _walls(4096, seed=seed)
    rs = np.random.default_rng(seed)
    rows = rs.choice(np.flatnonzero(valid), 40, replace=False)
    delta = 2 * R_DEFAULT * 2.0**-17
    offsets = np.concatenate([np.linspace(-2 * delta, delta, 34), [0.0, 0.0, 0.05, 0.05,
                                                                   -0.05, 1e-3]])
    planted = []
    for i, offset in zip(rows, offsets):
        p = pts[i].astype(np.float64)
        r = np.linalg.norm(p)
        u = p / r
        w = np.cross(u, [0.0, 1.0, 0.0])
        w /= np.linalg.norm(w)
        theta = 2e-4
        s_j = (2 * R_DEFAULT - r + offset) / np.cos(theta)
        planted.append((np.cos(theta) * u + np.sin(theta) * w) * (2 * R_DEFAULT - s_j))
    p = np.concatenate([pts, np.asarray(planted, np.float32)])
    return p, np.concatenate([valid, np.ones(len(planted), bool)])


def _nonfinite():
    return bs.hpr_edge_sets(n_bulk=2048)["non-finite"]


def _all_invalid():
    p, _ = _walls(2048, seed=5)
    return p, np.zeros(len(p), bool)


CASES = {
    "walls 4096": lambda: _walls(4096),
    "walls 8192": lambda: _walls(8192, seed=1),
    "walls 20000": lambda: _walls(20000, seed=2),
    "R 100": lambda: (*_walls(4096, seed=3), 100.0),
    "R 1": lambda: (*_walls(4096, seed=4), 1.0),
    "tol 0.5": lambda: (*_walls(8192, seed=5), R_DEFAULT, 0.5),
    "octants": _octants,
    "ray and duplicates": _ray_and_duplicates,
    "near ties": _near_ties,
    "non-finite": _nonfinite,
    "all invalid": _all_invalid,
    "below a subtile": lambda: _walls(20, seed=6, invalid=0.1),
    "ragged blocks": lambda: _walls(1001, seed=7),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_plan_bit_equal(name):
    """The tiled plan's mask equals JAX's and the dense twin's and its
    supports the twin's; it keeps at least the needed pairs."""
    args = CASES[name]()
    got, stats = _check(*args)
    if name in ("non-finite", "all invalid"):
        assert not got.any()
    if name.startswith("walls"):
        n = len(args[0])
        assert 0.3 * n < got.sum() < 0.9 * n
        # The rule drops all but a few percent of the pairs.
        assert stats[0] < 0.05 * n * n, stats


def test_tiled_plan_shuffled():
    """The same cloud in another order gives the same mask, point for
    point, and the same supports."""
    pts, valid = _walls(6000, seed=8)
    perm = np.random.default_rng(8).permutation(len(pts))
    a, _ = _check(pts, valid)
    b, _ = _check(pts[perm], valid[perm])
    np.testing.assert_array_equal(b, a[perm])


@pytest.mark.parametrize("k", [1, 3])
def test_tiled_plan_batch(k):
    """K keyframes in one plan (the keyframe in the key's high bits, one
    sort): each row equals that keyframe's JAX mask and its own one-keyframe
    plan's supports."""
    clouds = [_walls(3000, seed=10 + j) for j in range(k)]
    if k == 3:
        clouds[1] = (clouds[1][0], np.zeros(3000, bool))  # an empty gate
        clouds[2] = (clouds[2][0], np.ones(3000, bool))  # no point loose
    pts = torch.from_numpy(np.stack([c[0] for c in clouds]))
    valid = torch.from_numpy(np.stack([c[1] for c in clouds]))
    ok, support, self_support, stats = thpr.hpr_support_tiled_plain(pts, valid)
    assert ok.shape == support.shape == (k, 3000)
    total = 0
    for j, (p, v) in enumerate(clouds):
        np.testing.assert_array_equal((ok[j] & (support[j] - self_support[j] <= 0.05)).numpy(),
                                      _jax_mask(p, v, R_DEFAULT, 0.05))
        ok1, sup1, _, stats1 = thpr.hpr_support_tiled_plain(torch.from_numpy(p),
                                                            torch.from_numpy(v))
        assert torch.equal(ok1, ok[j]) and torch.equal(sup1[ok1], support[j][ok1])
        total += stats1[0]
    assert stats[0] == total


PADDING = {
    "n 1000, all valid": (1000, 0),
    "n 16384, all valid": (16384, 0),
    "n 1000, one invalid": (1000, 1),
}


@pytest.mark.parametrize("name", list(PADDING))
def test_padding_zero(name):
    """JAX pads the flipped points with zeros to a multiple of 16384
    (hpr.py:111-112), so its max takes a 0 wherever n % 16384 != 0. In a
    4 x 4 x 2 m box centred 6 m ahead at R = 1 every range exceeds 2R and
    every dot is negative: the padding's 0 then hides each point. The twin
    and the tiled plan take the 0 where JAX does, and only there; the
    maximum over the points alone (the twin before the repair) keeps points
    visible at n = 1000. (At n = 16384 the plan keeps all 2.7e8 pairs: the
    twin alone is held to JAX there.)"""
    n, n_invalid = PADDING[name]
    rs = np.random.default_rng(11)
    pts = (rs.uniform(-1.0, 1.0, (n, 3)) * [2.0, 2.0, 1.0] + [0.0, 0.0, 6.0]).astype(np.float32)
    valid = np.ones(n, bool)
    valid[:n_invalid] = False
    pt, vt = torch.from_numpy(pts), torch.from_numpy(valid)
    if n % thpr.JAX_CHUNK:
        got, _ = _check(pts, valid, radius=1.0)
    else:
        got = thpr.hpr_mask_plain(pt, vt, 1.0).numpy()
        np.testing.assert_array_equal(got, _jax_mask(pts, valid, 1.0, 0.05))
    r = torch.linalg.vector_norm(pt, dim=-1)
    u = pt / r[:, None]
    points_only = torch.amax(u @ (u * (2.0 - r)[:, None]).T, dim=1)
    unpadded = int((vt & (points_only - (2.0 - r) <= 0.05)).sum())
    if name == "n 1000, all valid":
        assert not got.any() and unpadded >= 1
    elif name == "n 16384, all valid":
        assert got.sum() == unpadded >= 1
    else:
        assert not got.any()


def test_flip_plain_matches_twin():
    """The tiled plan's flip rounds as the twin's norm and products do on
    the CPU (its norm and self dot through exact FMAs): the same bearings,
    self supports and flipped points; every ok point's self dot is the
    twin's dot of its own pair."""
    pts, valid = _walls(5000, seed=12)
    pt, vt = torch.from_numpy(pts), torch.from_numpy(valid)
    u4, f4, ok, _, flags = thpr.hpr_flip_plain(pt, vt, R_DEFAULT)
    r = torch.linalg.vector_norm(pt, dim=-1)
    u = pt / r[:, None]
    assert torch.equal(u4[ok, :3], u[ok]) and torch.equal(u4[ok, 3], (2 * R_DEFAULT - r)[ok])
    assert torch.equal(f4[ok, :3], (u * (2 * R_DEFAULT - r)[:, None])[ok])
    rows = torch.nonzero(ok).flatten()[:500]
    twin_self = (u[rows] @ f4[rows, :3].T).diagonal()  # the twin's product
    assert torch.equal(f4[rows, 3], twin_self)
    assert int(flags[0]) == 2  # 2% invalid: the zero rows join the max


def test_plan_segments():
    """Blocks hold at most 128 directions and subtiles at most 32 points,
    neither crossing a cell; every chord radius bounds its members; a
    block is whole subtiles; each ok point sits in exactly one of each."""
    pts, valid = _walls(8000, seed=13)
    u4, f4, ok, key, _ = thpr.hpr_flip_plain(torch.from_numpy(pts), torch.from_numpy(valid),
                                             R_DEFAULT)
    plan = thpr.dense_plan(key, u4, f4, 1)
    n_ok = int(ok.sum())
    nb, nt = int(plan.n_blocks), int(plan.kf_sub[1])
    bs_, ts_ = plan.block_start[: nb + 1].long(), plan.sub_start[: nt + 1].long()
    assert bs_[0] == ts_[0] == 0 and bs_[nb] == ts_[nt] == n_ok
    assert int((bs_[1:] - bs_[:-1]).max()) <= thpr.BLOCK_DIRS
    assert int((ts_[1:] - ts_[:-1]).max()) <= thpr.SUBTILE
    assert bool(torch.isin(bs_, ts_).all())
    for start, desc in ((bs_, plan.block), (ts_, plan.sub)):
        seg = torch.repeat_interleave(torch.arange(start.numel() - 1), start[1:] - start[:-1])
        d = (plan.u[:n_ok, :3].double() - desc[seg, :3].double()).norm(dim=1)
        assert bool((d <= desc[seg, 3].double()).all())
    # No segment crosses a cell: the cells of consecutive members agree.
    o = plan.u[:n_ok, :2] / plan.u[:n_ok, :3].abs().sum(1, keepdim=True)
    cell = ((o + 1.0) * (thpr.GRID / 2)).clamp(0, thpr.GRID - 1).long()
    same = (cell[1:] == cell[:-1]).all(1)
    inner = torch.ones(n_ok - 1, dtype=torch.bool)
    inner[ts_[1:-1] - 1] = False
    assert bool(same[inner].all())


def test_skip_rule_margin():
    """A subtile is kept where the bound reaches L_b less its delta, and
    skipped only where the bound plus delta stays below it; a block's own
    subtile is never skipped."""
    c = torch.tensor([[0.0, 0.0, 1.0, 1e-4]])
    s = torch.tensor([179990.0])
    assert not bool(thpr.skip_rule(c, torch.tensor([179990.0]), c, s))
    delta = float(s) * thpr.SKIP_DELTA
    assert not bool(thpr.skip_rule(c, torch.tensor([float(s) + delta * 0.9]), c, s))
    assert bool(thpr.skip_rule(c, torch.tensor([float(s) + delta * 1.1]), c, s))
    # A far subtile: its bound falls with the chord (here to ~179,096); an
    # s_min <= 0 (s_max read as +inf) keeps it.
    far = torch.tensor([[0.0, 0.1, 1.0, 1e-4]])
    assert bool(thpr.skip_rule(c, torch.tensor([179500.0]), far, s))
    assert not bool(thpr.skip_rule(c, torch.tensor([179000.0]), far, s))
    assert not bool(thpr.skip_rule(c, torch.tensor([179500.0]), far, torch.tensor([np.inf])))
