"""PyTorch port: the NID evaluation's per-point chain, kernels P1/P2
(`ops/nid_project`, `csrc/nid_project.cu`) and their dispatch.

On the CPU (tier-1): ``opt/nid.project_points`` takes the eager chain
(``project_points_plain``) on CPU tensors and launches nothing, and the
evaluations' values are those of the eager composition they replaced, bit
for bit; P2's arithmetic in torch (``project_bwd_plain``) equals autograd
through the eager chain to 1e-5 of the gradient's norm, with shared and
per-keyframe poses, clamped and not; the kernels' grid covers every point.

On the card (marked ``card``, skipped without CUDA): P1 bit-equal to the
eager chain run on the card (``s`` with NaN where it is NaN, knots, gates,
bins, the point histogram, its count and the guard's counts) at K in
{1, 3}, shared and per-keyframe poses, on points behind the camera, at
|z| < 1e-9, outside the image, on pixel boundaries, non-finite, under
nonzero distortion; ``multi_nid_loss``, ``multi_nid_loss_cached`` (with and
without a refresh) and ``multi_nid_per_keyframe`` values bit-equal to the
eager path's at the same pose; the pose gradient within 1e-4 of autograd's
through the eager chain, in norm, with points the frozen clamp clips; one
P1 and one P2 launch a value-and-gradient evaluation (one more P1 on a
refresh). On the card, without the suite's conftest (it imports JAX):
``python -m pytest --noconftest -m card tests/test_torch_nid_project.py``.
"""

import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu_torch.core import se3
from pointcloudprocessor_tpu_torch.models import camera as cam
from pointcloudprocessor_tpu_torch.ops import nid_project
from pointcloudprocessor_tpu_torch.opt import nid

W, H, BINS = 640, 480, 16
GRID_SHAPES = [(1, 1), (3, 1), (1, 3), (2, 1037), (64, 16_384), (64, 262_144), (1, 262_144),
               (8, 262_143)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _camera(device, boundary=False):
    """A 640x480 camera. ``boundary``: f = 512 and no distortion, so a point
    at z = 1 with x, y multiples of 1/512 projects exactly onto pixel
    boundaries; else nonzero plumb_bob terms."""
    if boundary:
        return cam.create_camera("pinhole", [512.0, 512.0, 320.0, 240.0], [0.0] * 5, W, H,
                                 device)
    return cam.create_camera("pinhole", [500.0, 510.0, 321.5, 239.25],
                             [0.05, -0.02, 0.001, -0.002, 0.003], W, H, device)


def _edge_points(edges: bool):
    """Rows of (x, y, z) that probe the chain's branches: behind the camera,
    at |z| < 1e-9 (the f32 1e-9 itself, 0 and -0), outside the image, on
    pixel boundaries at z = 1. With ``edges`` also points whose distortion
    saturates the knots (s ~ 1e12 and more) or overflows (z = 0 off the
    axis), and non-finite ones: gated out, they still make the plain
    histogram twin's NID and the eager chain's gradient NaN (0 x inf), so
    only P1's own outputs are compared on them."""
    f9 = float(np.float32(1e-9))
    below = float(np.nextafter(np.float32(1e-9), np.float32(0)))
    rows = [(0.0, 0.0, z) for z in (0.0, -0.0, f9, -f9, below, -below, 5e-10, -5e-10)]
    rows += [(0.3, -0.2, -2.0), (3.0, 0.0, 1.0), (0.0, -2.5, 1.0), (0.02, 0.01, 1e-2)]
    rows += [(j / 512.0, i / 512.0, 1.0) for j in range(-3, 4) for i in (-2, 0, 5)]
    if edges:
        rows += [(50.0, 0.0, 1.0), (0.0, -40.0, 1.0), (1.0, 1.0, -1e-3), (0.1, 0.1, 1e-3),
                 (float("nan"), 0.0, 2.0), (0.0, 0.0, float("inf")), (1e30, 0.0, 1.0),
                 (0.5, 0.2, 0.0)]
    return torch.tensor(rows, dtype=torch.float32)


def _scene(k, n, device, seed=0, edges=True):
    """K keyframes of N points in front of the camera, the edge rows first;
    a smooth bin image each; intensities that follow the image."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(k, n, 3, generator=g) * torch.tensor([0.9, 0.7, 0.4]) + torch.tensor(
        [0.0, 0.0, 3.0])
    e = _edge_points(edges)
    pts[:, : e.shape[0]] = e
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    img = torch.stack([0.5 + 0.25 * torch.sin(7e-3 * (j + 1) * xx) * torch.cos(9e-3 * yy)
                       for j in range(k)])
    bins = nid.quantize_image(img, BINS)
    inten = (0.5 + 0.2 * torch.sin(pts[..., 0] * 3) + 0.05 * torch.rand(k, n, generator=g))
    valid = torch.rand(k, n, generator=g) > 0.1
    kfs = nid.NIDKeyframe(points=pts.to(device), intensity=inten.clamp(0, 1).to(device),
                          valid=valid.to(device), bin_image=bins.to(device))
    return nid.prepare_keyframes(kfs)


def _pose(rows, device, seed=1, scale=0.01):
    xi = torch.randn(rows, 6, generator=torch.Generator().manual_seed(seed)) * scale
    return se3.exp(xi.to(device) if rows > 1 else xi[0].to(device))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def _blocks(k, n):
    """(keyframe, first point, end) of every block of P1/P2's grid, as
    csrc/nid_project.cu takes them."""
    per_kf, ppb = nid_project.grid(k, n)
    return [(kf, bx * ppb, min(n, (bx + 1) * ppb)) for kf in range(k) for bx in range(per_kf)]


@pytest.mark.parametrize("k,n", GRID_SHAPES)
def test_grid_covers_every_point_once(k, n):
    """Each block holds at least one point of its keyframe, the blocks of a
    keyframe tile [0, N) in order, and the grid stays inside CUDA's limits."""
    per_kf, ppb = nid_project.grid(k, n)
    assert 1 <= per_kf < 2**31 and 1 <= ppb and per_kf * ppb >= n > (per_kf - 1) * ppb
    blocks = _blocks(k, n) if k * per_kf <= 20_000 else _blocks(1, n)
    for kf in {b[0] for b in blocks}:
        spans = [(lo, hi) for b, lo, hi in blocks if b == kf]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(hi > lo for lo, hi in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_grid_fills_the_card_at_both_phases():
    """The coarse (64 x 16,384) and fine (64 x 262,144) shapes get at least
    4 blocks for each of the H100's 132 SMs."""
    for n in (16_384, 262_144):
        per_kf, ppb = nid_project.grid(64, n)
        assert 64 * per_kf >= 4 * 132 and ppb >= nid_project.THREADS


def _eager_loss(camera, T, kfs, bins=BINS):
    """``multi_nid_loss`` as the port wrote it before P1/P2, op for op."""
    proj, knot, inl = nid._project_all(camera, T, kfs)
    s = proj - knot.to(proj.dtype)
    with torch.no_grad():
        taps = nid._gather_taps(camera, kfs, knot, inl)
    bin_pts = torch.clamp(nid.to_int32(kfs.intensity * bins), 0, bins - 1)
    return torch.sum(nid.nid_from_histograms(
        *nid._histograms_from_taps(taps, s, bin_pts, inl.to(proj.dtype), bins)))


@pytest.mark.parametrize("rows", [1, 3])
def test_cpu_dispatch_takes_the_eager_twin(rows):
    """CPU tensors take the eager chain: nothing launches, and the value and
    gradient of ``multi_nid_loss`` equal the eager composition's bit for
    bit (per-keyframe poses through ``multi_nid_per_keyframe``)."""
    nid_project.reset_launch_counts()
    camera = _camera("cpu")
    kfs = _scene(3, 3000, "cpu", edges=False)
    xi = (torch.randn(rows, 6, generator=torch.Generator().manual_seed(5)) * 0.01)
    xi = xi[0] if rows == 1 else xi
    got = nid.project_points(camera, se3.exp(xi), kfs, BINS)
    want = nid.project_points_plain(camera, se3.exp(xi), kfs, BINS)
    for a, b in zip(got, want):
        assert a is None and b is None or torch.equal(a, b)
    x = xi.clone().requires_grad_(True)
    if rows == 1:
        v = nid.multi_nid_loss(camera, se3.exp(x), kfs, BINS)
    else:
        v = nid.multi_nid_per_keyframe(camera, se3.exp(x), kfs, BINS).sum()
    (g,) = torch.autograd.grad(v, x)
    x2 = xi.clone().requires_grad_(True)
    v2 = _eager_loss(camera, se3.exp(x2), kfs)
    (g2,) = torch.autograd.grad(v2, x2)
    assert torch.equal(v, v2) and torch.equal(g, g2)
    assert nid_project.launch_counts == {"nid_project_fwd": 0, "nid_project_bwd": 0}


def test_cpu_guard_counts_are_the_eager_guard():
    """The twin's guard counts and point histogram against a cache made at
    another pose: the eager guard's sums, and the histogram under the
    cache's gate."""
    camera = _camera("cpu")
    kfs = _scene(2, 4000, "cpu")
    cache = nid.make_tap_cache(camera, _pose(1, "cpu", seed=2), kfs)
    T = _pose(1, "cpu", seed=3, scale=0.03)
    p = nid.project_points(camera, T, kfs, BINS, cache.knot, cache.inlier, 1.0)
    _, knot, inl = nid._project_all(camera, T, kfs)
    shift = torch.amax(torch.abs(knot.float() - cache.knot.float()), dim=-1)
    care = inl | (cache.inlier > 0)
    want = [int(care.sum()), int(((shift >= 1.0) & care).sum()), int(((shift >= 2.0) & care).sum())]
    assert p.counts.tolist() == want and p.counts.dtype == torch.int64 and want[1] > 0
    assert torch.equal(p.num, cache.inlier.sum(-1))
    assert float(p.hist_points.sum()) == float(cache.inlier.sum())


@pytest.mark.parametrize("rows,clamp", [(1, False), (1, True), (3, False), (3, True)])
def test_p2_twin_matches_autograd(rows, clamp):
    """P2's arithmetic (the projection's Jacobian, the clamp's mask, the 12
    sums and their map to dL/dq, dL/dt) against autograd through the eager
    chain for an upstream ds on the gated points: within 1e-5 of the
    gradient's norm. ``clamp``: s against knots up to 2 px off, so the
    clamp clips some points."""
    camera = _camera("cpu")
    kfs = _scene(3, 2000, "cpu", edges=False)
    T = _pose(rows, "cpu")
    q, t = T.q.reshape(-1, 4), T.t.reshape(-1, 3)
    qd, td = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
    Td = se3.SE3(qd, td) if rows > 1 else se3.SE3(qd[0], td[0])
    ref = None
    if clamp:
        off = torch.randint(-2, 3, (3, 2000, 2), generator=torch.Generator().manual_seed(4))
        ref = nid._project_all(camera, T, kfs)[1] + off.to(torch.int32)
    p = nid.project_points_plain(camera, Td, kfs, BINS, ref_knot=ref)
    ds = torch.randn(3, 2000, 2, generator=torch.Generator().manual_seed(6)) * p.inlier[..., None]
    gq, gt = torch.autograd.grad(torch.sum(ds * p.s), (qd, td))
    dq, dt = nid_project.project_bwd_plain(ds, camera, q, t, kfs.points, ref)
    want = torch.cat([gq, gt], -1)
    assert torch.linalg.norm(torch.cat([dq, dt], -1) - want) <= 1e-5 * torch.linalg.norm(want)
    if clamp:
        raw = nid._project_all(camera, T, kfs)[0] - ref.float()
        assert bool(((raw < -1.5) | (raw > 2.5)).any())


def test_cuda_checks_reject_bad_inputs():
    """The kernels' wrappers refuse what they cannot take, before a launch."""
    kfs = _scene(2, 100, "cpu", edges=False)
    q, t = torch.tensor([[1.0, 0, 0, 0]]), torch.zeros(1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        nid_project._check(kfs.points, kfs.intensity, kfs.valid, q, t, None, None, BINS)
    meta = torch.empty((2, 100, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nid_project._check(meta, None, None, q, t, None, None, BINS)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _same(a, b):
    """Bit-equal, NaN where NaN."""
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))
    return torch.equal(a, b)


def _holds(got, want):
    for name, a, b in zip(nid_project.Projected._fields, got, want):
        assert (a is None) == (b is None), name
        assert a is None or _same(a, b), (name, (a != b).sum().item())


@pytest.mark.card
@pytest.mark.parametrize("k,rows", [(1, 1), (3, 1), (3, 3)])
@pytest.mark.parametrize("boundary", [False, True])
def test_p1_bit_equal_to_the_eager_chain(card, k, rows, boundary):
    """P1 against the eager chain on the card, exact and with the frozen
    cache's knot, gate and guard; the pose the identity on the boundary
    camera (every boundary row lands on a pixel edge), else a small one."""
    camera = _camera(card, boundary)
    kfs = _scene(k, 5000, card)
    T = se3.identity(card, batch_shape=(rows,) if rows > 1 else ()) if boundary else \
        _pose(rows, card)
    _holds(nid.project_points(camera, T, kfs, BINS), nid.project_points_plain(camera, T, kfs, BINS))
    if boundary:
        e = _edge_points(True)
        u = nid._project_all(camera, T, kfs)[0][0, : e.shape[0], 0]
        assert bool((u == torch.floor(u)).any())
    cache = nid.make_tap_cache(camera, _pose(rows, card, seed=7, scale=0.02), kfs)
    for thr in (1.0, 3.0):
        args = (camera, T, kfs, BINS, cache.knot, cache.inlier, thr)
        _holds(nid.project_points(*args), nid.project_points_plain(*args))
    args = (camera, T, kfs, BINS, cache.knot, cache.inlier)
    _holds(nid.project_points(*args), nid.project_points_plain(*args))


def _eager(monkeypatch):
    monkeypatch.setattr(nid, "project_points", nid.project_points_plain)


def _value_grad(fn, xi):
    x = xi.clone().requires_grad_(True)
    v = fn(x)
    (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def _close(g, want):
    return float(torch.linalg.norm(g - want)) <= 1e-4 * float(torch.linalg.norm(want))


@pytest.mark.card
@pytest.mark.parametrize("which", ["exact", "per_keyframe", "cached", "cached_refresh"])
def test_evaluations_equal_the_eager_path(card, monkeypatch, which):
    """The value bit-equal and the 6-vector gradient within 1e-4 of the eager
    path's (autograd through the chain, K1/K2 alike) at the same pose; one
    P1 and one P2 launch an evaluation, one P1 more on a refresh. The
    cached cases evaluate 2-3 px from the cache's pose, so the clamp clips
    points; ``cached_refresh`` lets the guard refresh."""
    camera = _camera(card)
    kfs = _scene(3, 20_000, card, edges=False)
    rows = 3 if which == "per_keyframe" else 1
    xi = torch.randn(rows, 6, generator=torch.Generator().manual_seed(8)) * 0.01
    xi = (xi if rows > 1 else xi[0]).to(card)
    T0 = se3.exp(xi + 0.004)

    def fn(x):
        if which == "exact":
            return nid.multi_nid_loss(camera, se3.exp(x), kfs, BINS)
        if which == "per_keyframe":
            return nid.multi_nid_per_keyframe(camera, se3.exp(x), kfs, BINS).sum()
        cache = nid.make_tap_cache(camera, T0, kfs)
        return nid.multi_nid_loss_cached(camera, se3.exp(x), kfs, cache, BINS, guard_frac=0.0,
                                         allow_refresh=which == "cached_refresh")[0]

    nid_project.reset_launch_counts()
    v, g = _value_grad(fn, xi)
    cached = which.startswith("cached")
    fwd = 1 + cached + (which == "cached_refresh")
    assert nid_project.launch_counts == {"nid_project_fwd": fwd, "nid_project_bwd": 1}
    if cached:
        raw = nid._project_all(camera, se3.exp(xi), kfs)[0] - nid.make_tap_cache(
            camera, T0, kfs).knot.float()
        assert bool(((raw < -1.5) | (raw > 2.5)).any())
    with monkeypatch.context() as m:
        _eager(m)
        v2, g2 = _value_grad(fn, xi)
    assert torch.equal(v, v2), (float(v), float(v2))
    assert _close(g, g2), (g, g2)
