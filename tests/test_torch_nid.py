"""PyTorch port vs the JAX package: the NID objective and the BFGS solver.

Tolerance classes: bit-exact for the tap table, nibble packing and bin
maps; f32 summation order for NID values (1e-5 absolute on a sum of
per-keyframe NIDs in [0, 2]) and their pose gradients (1e-4 relative to
the gradient's norm)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import bfgs as jbfgs
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.opt import bfgs as tbfgs
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import simple_camera
from test_nid import nid_scene

CPU = "cpu"


def _cameras():
    cj = simple_camera()
    ct = interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion),
                        cj.width, cj.height, CPU)
    return cj, ct


def _keyframes(cj, k=3, cap=4000):
    """K keyframes of the textured wall seen from shifted poses, padded to
    ``cap`` (padding and off-image points exercise the inlier gate)."""
    pts_l, int_l, val_l, bin_l = [], [], [], []
    for i in range(k):
        pts, inten, img = nid_scene(cj, wall_z=5.0 + 0.3 * i, seed=i)
        pts = pts + np.asarray([0.15 * i - 0.2, 0.05 * i, 0.0], np.float32)
        n = len(pts)
        p = np.zeros((cap, 3), np.float32)
        p[:n] = pts
        it = np.zeros(cap, np.float32)
        it[:n] = inten
        v = np.zeros(cap, bool)
        v[:n] = True
        pts_l.append(p)
        int_l.append(it)
        val_l.append(v)
        bin_l.append(np.asarray(jnid.quantize_image(jnp.asarray(img), 16)))
    return [np.stack(a) for a in (pts_l, int_l, val_l, bin_l)]


def test_quantize_image_bit_exact():
    img = np.random.default_rng(0).uniform(-0.1, 1.1, (96, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        tnid.quantize_image(torch.from_numpy(img)).numpy(),
        np.asarray(jnid.quantize_image(jnp.asarray(img))),
    )


def test_tap_table_bit_exact():
    b = np.random.default_rng(1).integers(0, 16, (37, 53)).astype(np.int32)
    want = np.asarray(jnid.build_tap_table(jnp.asarray(b)))
    got = tnid.build_tap_table(torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_bit_exact():
    taps = np.random.default_rng(2).integers(0, 16, (777, 16)).astype(np.int32)
    want = np.asarray(jnid.pack_tap_nibbles(jnp.asarray(taps)))
    got = tnid.pack_tap_nibbles(torch.from_numpy(taps))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tnid.unpack_tap_nibbles(got).numpy(), taps)


@pytest.mark.parametrize(
    "xi",
    [
        (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
        (0.03, -0.02, 0.01, 0.004, -0.006, 0.005),
        (-0.05, 0.04, -0.03, -0.01, 0.008, -0.012),
    ],
)
def test_multi_nid_loss_value_and_grad_match_jax(xi):
    """multi_nid_loss at T = exp(xi): value within 1e-5, d/dxi within 1e-4
    of the gradient norm, against the JAX XLA path (use_pallas=False; its
    joint is [image_bin, point_bin], the port's [point_bin, image_bin] —
    the entropies are orientation-free)."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kj = jnid.NIDKeyframe(jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid),
                          jnp.asarray(bins))
    kj = jnid.prepare_keyframes(kj, build_slabs=False)
    kt = interop.nid_keyframes(pts, inten, valid, bins, CPU)
    xi = np.asarray(xi, np.float32)

    def jf(x):
        return jnid.multi_nid_loss(cj, jse3.exp(x), kj, 16, use_pallas=False,
                                   use_grouped=False)

    vj, gj = jax.value_and_grad(jf)(jnp.asarray(xi))
    x = torch.from_numpy(xi).requires_grad_(True)
    vt = tnid.multi_nid_loss(ct, tse3.exp(x), kt, 16)
    (gt,) = torch.autograd.grad(vt, x)
    np.testing.assert_allclose(float(vt.detach()), float(vj), atol=1e-5)
    gj = np.asarray(gj)
    assert np.linalg.norm(gt.numpy() - gj) <= 1e-4 * np.linalg.norm(gj)


def test_histograms_transpose_of_jax_xla_branch():
    """The port's joint (kernel orientation [point_bin, image_bin]) is the
    transpose of the JAX XLA branch's; marginals agree."""
    rng = np.random.default_rng(3)
    n = 3000
    taps = rng.integers(0, 16, (n, 16)).astype(np.int32)
    packed = np.array(jnid.pack_tap_nibbles(jnp.asarray(taps)))
    s = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    bp = rng.integers(0, 16, n).astype(np.int32)
    il = (rng.uniform(size=n) > 0.2).astype(np.float32)
    jj, ji, jp, jn = jnid._histograms_from_taps(
        jnp.asarray(packed), jnp.asarray(s), jnp.asarray(bp), jnp.asarray(il), 16, False
    )
    tj, ti, tp, tn = tnid._histograms_from_taps(
        *(torch.from_numpy(a[None]) for a in (packed, s, bp, il)), 16
    )
    np.testing.assert_allclose(tj[0].numpy(), np.asarray(jj).T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ti[0].numpy(), np.asarray(ji), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    assert float(tn[0]) == float(jn)


def test_bfgs_matches_jax_on_quadratic():
    """A smooth convex problem: both solvers take the same path (same
    iteration and evaluation counts) to the same minimizer."""
    A = np.asarray([[3.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 1.0]], np.float32)
    b = np.asarray([1.0, -2.0, 0.5], np.float32)

    rj = jbfgs.minimize(lambda x: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x,
                        jnp.zeros(3, jnp.float32), max_iterations=50)

    def vg(x):
        x = x.detach().requires_grad_(True)
        v = 0.5 * x @ torch.from_numpy(A) @ x - torch.from_numpy(b) @ x
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    rt = tbfgs.minimize(vg, torch.zeros(3), max_iterations=50)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    assert rt.iterations == int(rj.iterations)
    assert rt.evaluations == int(rj.evaluations)


def test_bfgs_respects_inf_regions():
    """+inf iterates are backtracked out of (the trust-region semantics)."""

    def vg(x):
        x = x.detach().requires_grad_(True)
        v = torch.sum((x - 3.0) ** 2)
        (g,) = torch.autograd.grad(v, x)
        if float(torch.linalg.norm(x.detach())) > 1.0:
            return torch.tensor(float("inf")), torch.zeros_like(x)
        return v.detach(), g

    res = tbfgs.minimize(vg, torch.zeros(2), max_iterations=50)
    assert float(torch.linalg.norm(res.x)) <= 1.0 + 1e-5
    assert float(res.value) < 18.0


def test_bfgs_rosenbrock():
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    res = tbfgs.minimize(vg, torch.tensor([-1.2, 1.0]), max_iterations=200)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-2)
