"""PyTorch port vs the JAX package: the direct tap-row take (G1,
`csrc/tap_gather.cu` ``tap_take``) through its plain twin, and the dispatch
around it.

The JAX package's `opt/nid._gather_taps` (``use_grouped=False``) clips each
(u, v) knot into the image and takes its keyframe's row with a vmap'd
``jnp.take``; the port's `ops/tap_gather.direct_take` is that take, G1 on
CUDA tensors and `direct_take_plain` on CPU ones. The kernel runs only on the
card, where `chip_smoke.py` holds it to the twin. Tolerance class: bit-exact
(integer data movement)."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.ops import tap_gather as ttg
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.utils import interop

from test_torch_nid import _cameras, _keyframes

CPU = "cpu"
W, H = 128, 96


def _rows(k, seed=0):
    """(K, H*W, 2) int32 tables of full 32-bit patterns."""
    rs = np.random.default_rng(seed)
    return rs.integers(-(2**31), 2**31, (k, H * W, 2), dtype=np.int64).astype(np.int32)


def _knots(name, k, seed=0):
    """(K, N, 2) int32 (u, v) knots of each regime."""
    rs = np.random.default_rng(seed)
    ends = np.asarray([0, 1, W - 1, W, W + 1, -1, -7], np.int64)
    if name == "inside":
        kn = np.stack([rs.integers(0, W, (k, 1000)), rs.integers(0, H, (k, 1000))], -1)
    elif name == "edges":  # the image's borders, one past them and negative, crossed
        vs = np.asarray([0, 1, H - 1, H, H + 1, -1, -7], np.int64)
        uu, vv = np.meshgrid(ends, vs)
        kn = np.broadcast_to(np.stack([uu.ravel(), vv.ravel()], -1), (k, uu.size, 2))
    elif name == "behind camera":  # projections of points behind the camera reach +-1e9
        kn = rs.choice(np.asarray([-10**9, 10**9, -999_999_937, 10**9 + 7, 5, -3]), (k, 777, 2))
    elif name == "int32 extremes":
        kn = rs.choice(np.asarray([-(2**31), 2**31 - 1, 0, W - 1, H - 1]), (k, 513, 2))
    else:  # "mixed": a ragged count of everything above
        kn = np.concatenate([_knots(x, k, seed) for x in
                             ("inside", "edges", "behind camera", "int32 extremes")], axis=1)
        kn = kn[:, rs.permutation(kn.shape[1])][:, :-5]
    return np.ascontiguousarray(kn).astype(np.int32)


def _jax_take(rows, knot):
    """The JAX package's direct take: `_gather_taps(..., use_grouped=False)`,
    which reads only the keyframes' tap tables."""
    cj, _ = _cameras()
    kfs = types.SimpleNamespace(tap_rows=jnp.asarray(rows), tap_slabs=None)
    return np.asarray(jnid._gather_taps(cj, kfs, jnp.asarray(knot), None, use_grouped=False))


@pytest.mark.parametrize("name", ["inside", "edges", "behind camera", "int32 extremes", "mixed"])
@pytest.mark.parametrize("k", [1, 3])
def test_direct_take_twin_matches_jax(name, k):
    rows, knot = _rows(k), _knots(name, k)
    want = _jax_take(rows, knot)
    got = ttg.direct_take(torch.from_numpy(rows), torch.from_numpy(knot), W, H)
    assert got.dtype == torch.int32 and tuple(got.shape) == knot.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttg.direct_take_plain(torch.from_numpy(rows), torch.from_numpy(knot), W, H).numpy(), want)


def test_anchors_clip_as_jax():
    """`tap_gather.anchors` is the JAX clip."""
    knot = _knots("mixed", 2)
    want = (np.clip(knot[..., 1].astype(np.int64), 0, H - 1) * W
            + np.clip(knot[..., 0].astype(np.int64), 0, W - 1))
    got = ttg.anchors(torch.from_numpy(knot), W, H)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("xi", [(0.0,) * 6, (0.04, -0.02, 0.0, 0.01, 0.0, 0.01),
                                (0.0, 0.0, -6.0, 0.0, 0.0, 0.0)])
def test_gather_taps_direct_matches_jax(xi):
    """`_gather_taps`'s direct branch on the NID test keyframes, at the
    origin, after a pose step and with every point behind the camera (no
    point gated in): the port's rows are the JAX package's on every point,
    gated in or not."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU))
    _, knot, inl = tnid._project_all(ct, tse3.exp(torch.tensor(xi)), kt)
    ttg.reset_launch_counts()
    got = tnid._gather_taps(ct, kt, knot, inl, use_grouped=False)
    assert ttg.launch_counts["tap_take"] == 0  # the twin, on the CPU
    np.testing.assert_array_equal(got.numpy(), _jax_take(kt.tap_rows.numpy(), knot.numpy()))
    if xi[2] == -6.0:
        assert not inl.any()


def test_direct_take_dispatch():
    """CPU tensors take the twin and launch nothing; the kernel wrapper
    refuses CPU tensors; other devices raise; no knots give no rows."""
    rows = torch.from_numpy(_rows(2))
    knot = torch.from_numpy(_knots("mixed", 2))
    ttg.reset_launch_counts()
    ttg.direct_take(rows, knot, W, H)
    assert ttg.launch_counts == {"tap_take": 0, "tap_select": 0, "tap_streamed": 0}
    with pytest.raises(ValueError, match="CUDA"):
        ttg.direct_take_cuda(rows, knot, W, H)
    with pytest.raises(NotImplementedError, match="no kernel"):
        ttg.direct_take(rows.to("meta"), knot.to("meta"), W, H)
    empty = ttg.direct_take(rows, knot[:, :0], W, H)
    assert tuple(empty.shape) == (2, 0, 2)
