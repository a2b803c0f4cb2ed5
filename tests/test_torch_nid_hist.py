"""PyTorch port: the NID joint-histogram twin (the CPU side of kernels K1/K2)
against the JAX package's Pallas kernels run in interpret mode.

Shapes: K=3 keyframes, N=5000 points (not a multiple of the Pallas block of
2048), s uniform in [-1.5, 2.5] (the frozen cache's extrapolation range),
~30% of points gated out. Tolerance class: f32 summation order, rtol 1e-5,
atol 1e-4 (histogram masses are O(100) sums of O(0.1) weights)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import nid_hist as jhist
from pointcloudprocessor_tpu_torch.ops import nid_hist as thist

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
        for k in range(K)
    ])


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
