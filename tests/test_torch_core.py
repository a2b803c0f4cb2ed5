"""PyTorch port vs the JAX package: SE(3), camera, point cloud, I/O.

Inputs come from numpy seeds and go through both packages (the port's via
utils/interop). Tolerance classes: f32 elementwise arithmetic agrees to a
few ulps (atol 1e-6 on O(1) values, rtol 1e-6 on pixels); masks and
integer outputs are bit-exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import cloud as jcl
from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu_torch.core import cloud as tcl
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.io import odometry as todom
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.pipeline import keyframes as tkf
from pointcloudprocessor_tpu_torch.utils import interop

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_pose(rng, n, rot_scale):
    xi = np.concatenate(
        [rng.normal(0, 0.5, (n, 3)), rng.normal(0, rot_scale, (n, 3))], -1
    ).astype(np.float32)
    return xi


@pytest.mark.parametrize("rot_scale", [1e-4, 0.03, 0.8])
def test_exp_log_match_jax(rot_scale):
    """Both Taylor and exact branches of exp/log (the wide window at
    theta < 0.1 rad is kept): f32 ulp class, atol 2e-6."""
    xi = _rand_pose(np.random.default_rng(0), 64, rot_scale)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = tse3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.q.numpy(), np.asarray(Tj.q), atol=2e-6)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=2e-6)
    lj = jse3.log(Tj)
    lt = tse3.log(Tt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-6)
    np.testing.assert_allclose(lt.numpy(), xi, atol=5e-5)


def test_exp_grad_finite_at_identity():
    """The NaN-safe `where` pattern: d exp(xi)/d xi at xi = 0 is finite."""
    xi = torch.zeros(6, requires_grad=True)
    T = tse3.exp(xi)
    (T.q.sum() + T.t.sum()).backward()
    assert torch.isfinite(xi.grad).all()


def test_group_ops_match_jax():
    rng = np.random.default_rng(1)
    a = _rand_pose(rng, 16, 0.5)
    b = _rand_pose(rng, 16, 0.5)
    pts = rng.normal(0, 3, (16, 50, 3)).astype(np.float32)
    Aj, Bj = jse3.exp(jnp.asarray(a)), jse3.exp(jnp.asarray(b))
    At, Bt = tse3.exp(torch.from_numpy(a)), tse3.exp(torch.from_numpy(b))
    Cj, Ct = jse3.compose(Aj, Bj), tse3.compose(At, Bt)
    np.testing.assert_allclose(Ct.q.numpy(), np.asarray(Cj.q), atol=2e-6)
    np.testing.assert_allclose(Ct.t.numpy(), np.asarray(Cj.t), atol=4e-6)
    Ij, It = jse3.inverse(Aj), tse3.inverse(At)
    np.testing.assert_allclose(It.t.numpy(), np.asarray(Ij.t), atol=4e-6)
    pj = jse3.transform_points(Aj, jnp.asarray(pts))
    pt = tse3.transform_points(At, torch.from_numpy(pts))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    xj = jse3.transform_xyz(jse3.SE3(Aj.q[0], Aj.t[0]), *(jnp.asarray(pts[0, :, i]) for i in range(3)))
    xt = tse3.transform_xyz(tse3.SE3(At.q[0], At.t[0]), *(torch.from_numpy(pts[0, :, i]) for i in range(3)))
    for u, w in zip(xt, xj):
        np.testing.assert_allclose(u.numpy(), np.asarray(w), atol=1e-5)
    dj, rj = jse3.delta_magnitudes(Aj, Bj)
    dt, rt = tse3.delta_magnitudes(At, Bt)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    Mj = jse3.matrix(Aj)
    Mt = tse3.matrix(At)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=2e-6)
    Fj, Ft = jse3.from_matrix(Mj), tse3.from_matrix(Mt)
    np.testing.assert_allclose(Ft.q.numpy(), np.asarray(Fj.q), atol=2e-6)


def test_quat_slerp_matches_jax():
    rng = np.random.default_rng(2)
    q0 = rng.normal(size=(40, 4)).astype(np.float32)
    q1 = rng.normal(size=(40, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    f = rng.uniform(0, 1, 40).astype(np.float32)
    qj = jse3.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(f))
    qt = tse3.quat_slerp(*(torch.from_numpy(a) for a in (q0, q1, f)))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=2e-6)


@pytest.mark.parametrize("distorted", [False, True])
def test_projection_matches_jax(distorted):
    """Pinhole + plumb_bob: pixels within f32 rounding (rtol 1e-6 of the
    pixel value); the in-image mask bit-exact."""
    d = (0.003, 0.066, -0.0002, -0.0007, 0.01) if distorted else (0.0,) * 5
    intr = (120.0, 121.0, 64.0, 48.0)
    cj = jcam.create_camera("pinhole", intr, d, 128, 96)
    ct = interop.camera(intr, d, 128, 96, CPU)
    rng = np.random.default_rng(3)
    pts = np.concatenate(
        [rng.uniform(-3, 3, (500, 2)), rng.uniform(-1, 6, (500, 1))], -1
    ).astype(np.float32)
    pts[:5, 2] = 0.0  # z == 0 guard
    uj, vj = jcam.project_uv(cj, jnp.asarray(pts))
    ut, vt = tcam.project_uv(ct, torch.from_numpy(pts))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6)
    np.testing.assert_array_equal(
        tcam.in_image_uv(ct, ut, vt).numpy(), np.asarray(jcam.in_image_uv(cj, uj, vj))
    )
    np.testing.assert_allclose(
        tcam.distort(ct, torch.from_numpy(pts[:, :2])).numpy(),
        np.asarray(jcam.distort(cj, jnp.asarray(pts[:, :2]))), rtol=1e-6, atol=1e-7,
    )


def test_cloud_crop_and_normalize_match_jax():
    """Trajectory crop mask bit-exact; normalized intensity within f32
    rounding (atol 1e-6)."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    inten = rng.uniform(3, 90, 3000).astype(np.float32)
    traj = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    cj0, ct0 = jcl.make(pts, inten, capacity=4096), tcl.make(pts, CPU, inten, capacity=4096)
    # The JAX cloud handed over through interop is the port's own make().
    handed = interop.cloud(*(np.asarray(a) for a in (cj0.points, cj0.intensity, cj0.valid)), CPU)
    for f in ("points", "intensity", "valid"):
        np.testing.assert_array_equal(getattr(handed, f).numpy(), getattr(ct0, f).numpy())
    cj = jcl.trajectory_crop(cj0, jnp.asarray(traj), 2.5)
    ct = tcl.trajectory_crop(ct0, torch.from_numpy(traj), 2.5)
    np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
    nj, nt = jcl.normalize_intensity(cj), tcl.normalize_intensity(ct)
    np.testing.assert_allclose(nt.intensity.numpy(), np.asarray(nj.intensity), atol=1e-6)
    kt = tcl.compact(nt)
    kj = jcl.compact(nj)
    np.testing.assert_array_equal(kt.points.numpy(), np.asarray(kj.points))


def test_odometry_resample_and_keyframes(tmp_path):
    from pointcloudprocessor_tpu.io import odometry as jodom
    from pointcloudprocessor_tpu.pipeline import keyframes as jkf

    rng = np.random.default_rng(5)
    m = 12
    q = rng.normal(size=(m, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    traj = todom.Trajectory(
        times=100.0 + 0.3 * np.arange(m),
        positions=np.cumsum(rng.uniform(0, 0.08, (m, 3)), 0).astype(np.float32),
        quats_wxyz=q,
    )
    path = str(tmp_path / "odom.txt")
    todom.write(path, traj)
    back = todom.read(path)
    jback = jodom.read(path)
    np.testing.assert_array_equal(back.positions, jback.positions)
    qt = np.linspace(99.0, 104.5, 31)
    rt, rj = todom.resample(back, qt, device="cpu"), jodom.resample(jback, qt)
    np.testing.assert_allclose(rt.quats_wxyz, np.asarray(rj.quats_wxyz), atol=2e-6)
    np.testing.assert_allclose(rt.positions, rj.positions, atol=1e-6)
    np.testing.assert_array_equal(tkf.select(back), jkf.select(jback))


def test_pcd_codec_builds_without_openmp(monkeypatch, tmp_path):
    """Where g++ cannot link OpenMP, the native PCD codec is built without
    it (not left to the numpy fallback), and ASCII PCDs written and read by
    it match the JAX package's reader bit for bit."""
    import shutil
    import subprocess

    from pointcloudprocessor_tpu.io import pcd as jpcd
    from pointcloudprocessor_tpu_torch.io import native, pcd

    src = tmp_path / "native"
    src.mkdir()
    for name in ("Makefile", "pcd_codec.cpp"):
        shutil.copy(os.path.join(REPO, "native", name), src / name)
    real_run = subprocess.run
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if not any(a.startswith("CXXFLAGS=") for a in cmd):
            return subprocess.CompletedProcess(
                cmd, 2, "", "g++: fatal error: cannot read spec file 'libgomp.spec'"
            )
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(native, "_LIB_PATH", str(src / "libpcdcodec.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()
    assert len(calls) == 2 and "-fopenmp" not in " ".join(calls[1])

    rng = np.random.default_rng(6)
    pts = rng.uniform(-50, 50, (2000, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 2000).astype(np.float32)
    path = str(tmp_path / "c.pcd")
    pcd.write(path, pts, intensity=inten)
    got, want = pcd.read(path), jpcd.read(path)
    for f in ("x", "y", "z", "intensity"):
        np.testing.assert_array_equal(got.fields[f], want.fields[f])
