"""PyTorch port: the NID joint-histogram twin (the CPU side of kernels K1/K2)
against the JAX package's Pallas kernels run in interpret mode.

Shapes: K=3 keyframes, N=5000 points (not a multiple of the Pallas block of
2048), s uniform in [-1.5, 2.5] (the frozen cache's extrapolation range),
~30% of points gated out. Tolerance class: f32 summation order, rtol 1e-5,
atol 1e-4 (histogram masses are O(100) sums of O(0.1) weights).

Scene-like inputs (the smoke scene's structure, built from a numpy seed: a
smooth bin image, each point's 4x4 window packed with pack_tap_nibbles,
point bins near the diagonal) at a ragged coarse-like size and a mid size,
with the tolerances chip_smoke.py holds the kernels to on the card:
|twin - Pallas| <= 1e-5 * max|hist| and <= 1e-5 * max|ds|. Also the CUDA
wrappers' pure-Python parts: the launch grid and the cached scratch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import nid_hist as jhist
from pointcloudprocessor_tpu_torch.ops import nid_hist as thist
from pointcloudprocessor_tpu_torch.opt import nid as tnid

K, N, BINS = 3, 5000, 16
RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    taps16 = rng.integers(0, BINS, (K, N, 16))
    words = np.zeros((K, N, 2), np.uint32)
    for t in range(16):
        words[..., t // 8] |= taps16[..., t].astype(np.uint32) << np.uint32(4 * (t % 8))
    taps = words.view(np.int32)
    s = rng.uniform(-1.5, 2.5, (K, N, 2)).astype(np.float32)
    bp = rng.integers(0, BINS, (K, N)).astype(np.int32)
    il = (rng.uniform(size=(K, N)) > 0.3).astype(np.float32)
    return taps, s, bp, il, taps16


def _jax_hist(taps, s, bp, il):
    return np.stack([
        np.asarray(jhist.joint_histogram(
            jnp.asarray(taps[k]), jnp.asarray(s[k]), jnp.asarray(bp[k]),
            jnp.asarray(il[k]), BINS, True,
        ))
        for k in range(taps.shape[0])
    ])


def _scene_like(k, n, seed):
    """Inputs shaped like the smoke scene's at its start pose: the wall
    texture of tools/bench_scene (0.5 + 0.25 sin 7x + 0.25 cos 9y, 2.5 mm a
    pixel; 1.25 mm at the smoke scene's 4096 px) quantized to BINS bins as the bin image; each point at a random
    sub-pixel position, its taps the bins of its clamped 4x4 window; its
    point bin the texture's bin 0.4 px away (the start pose's error), so the
    joint histogram lies near its diagonal; ~5% gated out."""
    rng = np.random.default_rng(seed)
    h, w = 256, 384

    def tex_bin(x, y):
        tex = 0.5 + 0.25 * np.sin(7.0 * 0.0025 * x) + 0.25 * np.cos(9.0 * 0.0025 * y)
        return np.clip((tex * BINS).astype(np.int64), 0, BINS - 1)

    yy, xx = np.mgrid[0:h, 0:w]
    image = tex_bin(xx, yy)
    u = rng.uniform(0.0, w, (k, n)).astype(np.float32)
    v = rng.uniform(0.0, h, (k, n)).astype(np.float32)
    ku, kv = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    taps16 = np.stack([
        image[np.clip(kv + t // 4 - 1, 0, h - 1), np.clip(ku + t % 4 - 1, 0, w - 1)]
        for t in range(16)
    ], axis=-1)
    taps = tnid.pack_tap_nibbles(torch.from_numpy(taps16.reshape(-1, 16))).numpy()
    s = np.stack([u - ku, v - kv], axis=-1).astype(np.float32)
    bp = tex_bin(u + 0.3, v - 0.25).astype(np.int32)
    il = (rng.uniform(size=(k, n)) > 0.05).astype(np.float32)
    return taps.reshape(k, n, 2), s, bp, il, taps16


SCENE_SHAPES = [(3, 1037), (2, 6000)]


@pytest.mark.parametrize("k,n", SCENE_SHAPES)
def test_scene_like_inputs_are_smooth(k, n):
    """Most points hold one or two bins in their window (as on the smoke
    scene) and most of the histogram's mass lies within one bin of the
    diagonal; the packing is the numpy packing."""
    taps, s, bp, il, taps16 = _scene_like(k, n, k)
    np.testing.assert_array_equal(thist.unpack_tap_nibbles(_torch(taps)).numpy(), taps16)
    srt = np.sort(taps16, axis=-1)
    distinct = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
    assert (distinct <= 2).mean() > 0.8
    hist = thist.joint_histogram_plain(_torch(taps), _torch(s), _torch(bp), _torch(il), BINS)
    band = sum(torch.diagonal(hist, d, dim1=-2, dim2=-1).sum() for d in (-1, 0, 1))
    assert float(band / hist.sum()) > 0.9


@pytest.mark.parametrize("k,n", SCENE_SHAPES)
def test_forward_twin_matches_pallas_interpret_scene_like(k, n):
    taps, s, bp, il, _ = _scene_like(k, n, k)
    want = _jax_hist(taps, s, bp, il)
    got = thist.joint_histogram_plain(_torch(taps), _torch(s), _torch(bp), _torch(il), BINS)
    assert got.shape == (k, BINS, BINS)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n", SCENE_SHAPES)
def test_backward_twin_matches_pallas_adjoint_scene_like(k, n):
    """d/ds of sum(G * hist) on scene-like inputs: the twin's autograd
    against jax.grad through the Pallas custom_vjp (interpret mode)."""
    taps, s, bp, il, _ = _scene_like(k, n, k + 10)
    g = np.random.default_rng(k).normal(size=(k, BINS, BINS)).astype(np.float32)

    def jloss(s_all):
        return sum(
            jnp.sum(jnp.asarray(g[i]) * jhist.joint_histogram(
                jnp.asarray(taps[i]), s_all[i], jnp.asarray(bp[i]), jnp.asarray(il[i]), BINS,
                True,
            ))
            for i in range(k)
        )

    want = np.asarray(jax.grad(jloss)(jnp.asarray(s)))
    st = _torch(s).requires_grad_(True)
    h = thist.joint_histogram_plain(_torch(taps), st, _torch(bp), _torch(il), BINS)
    (torch.sum(_torch(g) * h)).backward()
    got = st.grad.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.all(got[il == 0] == 0)


GRID_SHAPES = [(8, 262_144), (8, 16_384), (3, 1037), (1, 1), (5, 7), (2, 130), (8, 2**30 - 1),
               (65_535, 3)]


def _pair_range(kf, bx, n, ppb):
    """(pairs, points) of block ``bx`` of keyframe ``kf`` as csrc/nid_hist.cu's
    ``block_range`` computes them: pairs j of the flattened arrays (points
    2j and 2j+1) from the keyframe's first pair floor(kf*N/2), of which the
    block handles the points inside the keyframe's [kf*N, (kf+1)*N). On the
    card, chip_smoke.py holds the kernels to their twin at ragged N."""
    lo, hi = kf * n, (kf + 1) * n
    j0 = (lo >> 1) + bx * ppb
    j1 = min((hi + 1) >> 1, j0 + ppb)
    return range(j0, j1), range(max(lo, 2 * j0), min(hi, 2 * j1))


@pytest.mark.parametrize("k,n", GRID_SHAPES)
def test_grid_covers_every_point_once(k, n):
    """K1/K2's grid: the blocks of each keyframe cover its points exactly
    once, each block has work, and the launch stays inside CUDA's limits
    (grid y = K <= 65,535, blocks and pairs a block in int32)."""
    per_kf, ppb = thist.grid(k, n)
    assert 1 <= k <= 65_535 and 1 <= per_kf < 2**31 and 1 <= ppb < 2**31
    assert per_kf * ppb >= (n + 1) // 2
    spans = []
    for kf in range(k):
        for bx in range(per_kf):
            pairs, pts = _pair_range(kf, bx, n, ppb)
            assert len(pairs) >= 1 and len(pts) >= 1
            assert kf * n <= pts.start and pts.stop <= (kf + 1) * n
            assert 2 * pairs.start <= pts.start and pts.stop <= 2 * pairs.stop
            spans.append((pts.start, pts.stop))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == k * n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_grid_fills_the_card_at_both_headline_shapes():
    """The coarse shape (8 x 16,384) gets at least two blocks for each of
    the H100's 132 SMs, and the fine one (8 x 262,144) no more blocks."""
    coarse, fine = thist.grid(8, 16_384), thist.grid(8, 262_144)
    assert 8 * coarse[0] >= 2 * 132
    assert 8 * fine[0] <= 8 * coarse[0] and fine[1] >= thist.THREADS


def test_scratch_cached_per_key():
    """K1's scratch is allocated once per (device, stream, K, N), sized to
    the grid, with its arrival counters at 0; a new K, N or stream gets new
    buffers."""
    cpu = torch.device("cpu")
    thist._scratch_cache.clear()
    a = thist._scratch(cpu, 0, 8, 16_384)
    assert thist._scratch(cpu, 0, 8, 16_384) is a
    partial, arrive = a
    assert partial.shape == (8, thist.grid(8, 16_384)[0], 256) and partial.dtype == torch.float32
    assert arrive.shape == (8,) and arrive.dtype == torch.int32 and not arrive.any()
    for key in ((cpu, 0, 4, 16_384), (cpu, 0, 8, 262_144), (cpu, 1, 8, 16_384)):
        b = thist._scratch(*key)
        assert b is not a and b[0].data_ptr() != partial.data_ptr()
    assert thist._scratch(cpu, 0, 4, 16_384)[0].shape[:2] == (4, thist.grid(4, 16_384)[0])
    thist._scratch_cache.clear()


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_unpack_tap_nibbles_bit_exact():
    taps, _, _, _, taps16 = _inputs()
    np.testing.assert_array_equal(thist.unpack_tap_nibbles(_torch(taps)).numpy(), taps16)


def test_forward_twin_matches_pallas_interpret():
    taps, s, bp, il, _ = _inputs()
    want = _jax_hist(taps, s, bp, il)
    got = thist.joint_histogram_plain(_torch(taps), _torch(s), _torch(bp), _torch(il), BINS)
    assert got.shape == (K, BINS, BINS)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The dispatching wrapper takes the twin for CPU tensors.
    via = thist.joint_histogram(_torch(taps), _torch(s), _torch(bp), _torch(il), BINS)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_backward_twin_matches_pallas_adjoint():
    """d/ds of sum(G * hist) for a random upstream G: the twin's autograd
    against jax.grad through the Pallas custom_vjp (kernel K2's TPU twin)."""
    taps, s, bp, il, _ = _inputs(1)
    g = np.random.default_rng(7).normal(size=(K, BINS, BINS)).astype(np.float32)

    def jloss(s_all):
        return sum(
            jnp.sum(jnp.asarray(g[k]) * jhist.joint_histogram(
                jnp.asarray(taps[k]), s_all[k], jnp.asarray(bp[k]),
                jnp.asarray(il[k]), BINS, True,
            ))
            for k in range(K)
        )

    want = np.asarray(jax.grad(jloss)(jnp.asarray(s)))
    st = _torch(s).requires_grad_(True)
    h = thist.joint_histogram_plain(_torch(taps), st, _torch(bp), _torch(il), BINS)
    (torch.sum(_torch(g) * h)).backward()
    np.testing.assert_allclose(st.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    # Gated-out points get exactly zero gradient.
    assert np.all(st.grad.numpy()[il == 0] == 0)


def test_spline_weights_partition_of_unity():
    s = torch.linspace(-1.5, 2.5, 101)
    w = thist.spline_weights(s)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


def test_cuda_check_rejects_bad_inputs():
    """The kernel wrapper's argument checks (run before any launch)."""
    taps, s, bp, il, _ = _inputs()
    args = [_torch(taps), _torch(s), _torch(bp), _torch(il)]
    with pytest.raises(ValueError, match="CUDA"):
        thist._check(*args, BINS)
    with pytest.raises(ValueError, match="bins"):
        thist._check(*args, 17)


def test_unknown_device_raises():
    taps, s, bp, il, _ = _inputs()
    meta = [torch.empty(a.shape, dtype=_torch(a).dtype, device="meta") for a in (taps, s, bp, il)]
    with pytest.raises(NotImplementedError, match="no kernel"):
        thist.joint_histogram(*meta, BINS)
