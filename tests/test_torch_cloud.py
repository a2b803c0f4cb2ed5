"""PyTorch port vs the JAX package: ``core/cloud.transform`` and ``pad_to``
(`pointcloudprocessor_tpu/core/cloud.py:92-97, 154-177`).

``pad_to`` is bit for bit (it only copies and fills); ``transform`` at f32
rounding (atol 1e-5 on metre-scale points: torch's CPU cross product
contracts into an FMA where XLA rounds each step, as
tests/test_torch_recull.py notes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import cloud as jcl
from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu_torch.core import cloud as tcl
from pointcloudprocessor_tpu_torch.utils import interop

CPU = "cpu"
FIELDS = ("points", "intensity", "valid", "rgb", "mask_label", "normals")


def _clouds(n=1000, seed=3, extras=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, n).astype(np.float32)
    kw = {}
    if extras:
        normals = rng.normal(size=(n, 3)).astype(np.float32)
        kw = dict(rgb=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                  mask_label=rng.integers(0, 9, n).astype(np.int32),
                  normals=normals / np.linalg.norm(normals, axis=1, keepdims=True))
    return jcl.make(pts, inten, **kw), tcl.make(pts, CPU, inten, **kw)


def _equal_fields(tc, jc, **tol):
    for f in FIELDS:
        a, b = getattr(tc, f), getattr(jc, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if tol and f in ("points", "normals"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f, **tol)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("extras", (True, False))
@pytest.mark.parametrize("capacity", (1000, 1024, 4096))
def test_pad_to_matches_jax(extras, capacity):
    cj, ct = _clouds(extras=extras)
    _equal_fields(tcl.pad_to(ct, capacity), jcl.pad_to(cj, capacity))


def test_pad_to_refuses_a_smaller_capacity():
    _, ct = _clouds()
    with pytest.raises(ValueError):
        tcl.pad_to(ct, 999)


@pytest.mark.parametrize("extras", (True, False))
def test_transform_matches_jax(extras):
    cj, ct = _clouds(extras=extras)
    xi = np.asarray([0.3, -1.2, 2.0, 0.4, -0.2, 0.9], np.float32)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = interop.pose(np.asarray(Tj.q), np.asarray(Tj.t), CPU)
    _equal_fields(tcl.transform(ct, Tt), jcl.transform(cj, Tj), atol=1e-5, rtol=0)
    # The padded cloud transforms row for row as the unpadded one.
    got = tcl.transform(tcl.pad_to(ct, 1024), Tt)
    assert torch.equal(got.points[:1000], tcl.transform(ct, Tt).points)
