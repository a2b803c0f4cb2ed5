"""PyTorch port vs the JAX package: the offline tools around the main path
and their helpers — `core/se3.interpolate_trajectory`, `tools/vo_interp`,
`tools/match_masks`, `tools/image_balance`, `opt/nid.nid_histograms` /
`nid_loss`, `tools/nid_diagnostics`, `utils/viz.overlay_intensity` and
`tools/visualize`, `tools/trajectory_plot`, `tools/pick_tool`, `opt/dfo`
and `utils/console`, on the same seeded numpy inputs, on the CPU (the
wrappers take their kernels' plain twins there).

Tolerance classes: byte-equal files (vo_interp, match_masks,
image_balance); bit-equal overlays (duplicate pixels included) and
histogram counts; f32 transcendental differences between XLA and torch
(1e-6) for interpolated poses; f32 summation order (1e-5) for NIDs and
joint histograms (1e-4 absolute on counts of ~3,600 points); DFO minima
at the JAX tests' tolerances."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import dfo as jdfo
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.models import camera as tcam
from pointcloudprocessor_tpu_torch.opt import dfo as tdfo
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.utils import interop

from synthetic import simple_camera
from test_nid import make_keyframe, nid_scene

CPU = "cpu"
cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcamera(cj):
    return interop.camera(np.asarray(cj.intrinsic), np.asarray(cj.distortion), cj.width,
                          cj.height, CPU)


# ---------------------------------------------------------------------------
# interpolate_trajectory, vo_interp
# ---------------------------------------------------------------------------


def _track():
    """tests/test_se3.py:101's track."""
    times = np.asarray([0.0, 1.0, 2.0], np.float32)
    quats = np.asarray([[1.0, 0, 0, 0], [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)],
                        [0.0, 0, 0, 1.0]], np.float32)
    pos = np.asarray([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    return times, quats, pos


@pytest.mark.parametrize("queries", [[0.5, 1.5], [-1.0, 0.0, 0.25, 1.0, 1.999, 2.0, 3.5]])
def test_interpolate_trajectory_matches_jax(queries):
    """The test_se3 track at its queries and at the ends and past them (the
    brackets clamp): positions and quaternions within 1e-6 of JAX (slerp's
    arccos / sin in XLA and in torch)."""
    times, quats, pos = _track()
    qt = np.asarray(queries, np.float32)
    qj, pj = jse3.interpolate_trajectory(jnp.asarray(times), jnp.asarray(quats),
                                         jnp.asarray(pos), jnp.asarray(qt))
    q, p = tse3.interpolate_trajectory(*(torch.from_numpy(a) for a in (times, quats, pos, qt)))
    assert q.dtype == p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-6)
    if queries == [0.5, 1.5]:
        np.testing.assert_allclose(p[:, 0].numpy(), [0.5, 1.5], atol=1e-6)
        np.testing.assert_allclose(float(tse3.quat_angle(q[0])), np.pi / 4, atol=1e-4)


def test_interpolate_trajectory_keeps_f64_epoch_times():
    """f64 timestamps near 1.6e9 s stay f64: the fraction at t0 + 0.25 s is
    0.25 (f32 times are 128 s apart there and give 0), against JAX under
    x64 within 1e-6 and against the f64 numpy lerp."""
    t0 = 1_600_000_000.0
    times = np.asarray([t0, t0 + 1.0, t0 + 2.0])
    _, quats, pos = _track()
    qt = np.asarray([t0 + 0.25, t0 + 1.001, t0 + 1.75])
    q, p = tse3.interpolate_trajectory(torch.from_numpy(times), torch.from_numpy(quats),
                                       torch.from_numpy(pos), torch.from_numpy(qt))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p[:, 0].numpy(), [0.25, 1.001, 1.75], atol=1e-6)
    with jax.enable_x64(True):
        qj, pj = jse3.interpolate_trajectory(jnp.asarray(times), jnp.asarray(quats),
                                             jnp.asarray(pos), jnp.asarray(qt))
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-6)
        np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-6)
    _, p32 = tse3.interpolate_trajectory(torch.from_numpy(times.astype(np.float32)),
                                         torch.from_numpy(quats), torch.from_numpy(pos),
                                         torch.from_numpy(qt.astype(np.float32)))
    assert abs(float(p32[0, 0]) - 0.25) > 0.2  # what f32 times would lose


def _vo_files(tmp_path, t0):
    lines = []
    for i in range(7):
        th = 0.13 * i
        lines.append(f"{t0 + 0.5 * i:.6f} {0.5 * i:.8f} {0.1 * i * i:.8f} {-0.2 * i:.8f} "
                     f"{np.cos(th / 2):.8f} {0.3 * np.sin(th / 2):.8f} 0.0 "
                     f"{np.sqrt(0.91) * np.sin(th / 2):.8f}")
    src = tmp_path / "vo.txt"
    src.write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(4)
    stamps = np.sort(t0 - 0.2 + rng.uniform(0, 3.6, 25))
    tgt = tmp_path / "stamps.txt"
    tgt.write_text("".join(f"{s:.6f} junk\n" for s in stamps))
    return src, tgt


@pytest.mark.parametrize("t0", [100.0, 1_690_000_000.0])
def test_vo_interp_file_byte_equal(tmp_path, t0):
    """The port's vo_interp file equals the JAX tool's byte for byte on the
    same inputs (25 stamps, some outside the track)."""
    from pointcloudprocessor_tpu.tools import vo_interp as jvo
    from pointcloudprocessor_tpu_torch.tools import vo_interp as tvo

    src, tgt = _vo_files(tmp_path, t0)
    assert jvo.main(["--odometry", str(src), "--timestamps", str(tgt),
                     "--output", str(tmp_path / "j.txt")]) == 0
    assert tvo.main(["--odometry", str(src), "--timestamps", str(tgt),
                     "--output", str(tmp_path / "t.txt"), "--device", CPU]) == 0
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_vo_interp_halfway_rotations(tmp_path):
    """The JAX test's track (tests/test_dfo_tools.py TestVOInterp) through
    the port: halfway positions and rotations."""
    from pointcloudprocessor_tpu_torch.io import odometry as todom
    from pointcloudprocessor_tpu_torch.tools import vo_interp as tvo

    src = tmp_path / "vo.txt"
    src.write_text("".join(
        f"{100 + i:.6f} {0.5 * i:.8f} 0.0 0.0 {np.cos(0.05 * i):.8f} 0.0 0.0 "
        f"{np.sin(0.05 * i):.8f}\n" for i in range(5)))
    tgt = tmp_path / "stamps.txt"
    tgt.write_text("100.500000 junk\n102.500000 junk\n")
    assert tvo.main(["--odometry", str(src), "--timestamps", str(tgt), "--output",
                     str(tmp_path / "out.txt"), "--device", CPU]) == 0
    out = todom.read(str(tmp_path / "out.txt"))
    np.testing.assert_allclose(out.positions[:, 0], [0.25, 1.25], atol=1e-5)
    np.testing.assert_allclose(out.quats_wxyz[:, 3], [np.sin(0.025), np.sin(0.125)], atol=1e-5)


# ---------------------------------------------------------------------------
# match_masks, image_balance (host tools)
# ---------------------------------------------------------------------------


def test_match_masks_same_files(tmp_path):
    from pointcloudprocessor_tpu.tools import match_masks as jmm
    from pointcloudprocessor_tpu_torch.tools import match_masks as tmm

    masks = tmp_path / "masks"
    masks.mkdir()
    rng = np.random.default_rng(5)
    for k, ts in enumerate((99.8, 100.31, 101.0, 103.7, 104.2)):
        cv2.imwrite(str(masks / f"{ts:.6f}.png"), rng.integers(0, 255, (8, 9), dtype=np.uint8))
    (masks / "notes.txt").write_text("x")
    odom = tmp_path / "odom.txt"
    odom.write_text("".join(f"{100.0 + 0.5 * i:.6f} 0 0 0 1 0 0 0\n" for i in range(8)))
    for mod, out in ((jmm, "j"), (tmm, "t")):
        assert mod.main(["--mask_folder", str(masks), "--odometry_path", str(odom),
                         "--output_folder", str(tmp_path / out)]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


@pytest.mark.parametrize("agc", [False, True])
def test_image_balance_same_bytes(tmp_path, agc):
    from pointcloudprocessor_tpu.tools import image_balance as jib
    from pointcloudprocessor_tpu_torch.tools import image_balance as tib

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(6)
    cv2.imwrite(str(src / "a.png"), rng.uniform(0, 80, (40, 56, 3)).astype(np.uint8))
    cv2.imwrite(str(src / "b.png"), rng.uniform(0, 255, (40, 56, 3)).astype(np.uint8))
    assert jib.process_folder(str(src), str(tmp_path / "j"), agc=agc) == 2
    assert tib.process_folder(str(src), str(tmp_path / "t"), agc=agc) == 2
    for n in ("a.png", "b.png"):
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
    dark = rng.uniform(10, 60, (30, 30, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tib.agc_mean_mix(dark), jib.agc_mean_mix(dark))


# ---------------------------------------------------------------------------
# nid_histograms, nid_loss, nid_diagnostics
# ---------------------------------------------------------------------------

POSES = [(0.0, 0.0, 0.0, 0.0, 0.0, 0.0), (0.01, -0.005, 0.002, 0.003, -0.001, 0.002)]


def _nid_inputs(cj):
    pts, inten, img = nid_scene(cj)
    kj = make_keyframe(cj, pts, inten, img)
    kt = tnid.NIDKeyframe(points=torch.from_numpy(pts), intensity=torch.from_numpy(inten),
                          valid=torch.ones(len(pts), dtype=torch.bool),
                          bin_image=torch.from_numpy(np.array(kj.bin_image)))
    return kj, kt


def _patch_interpret(monkeypatch):
    """Run JAX's Pallas histogram in interpret mode, as tests/test_nid.py does."""
    from pointcloudprocessor_tpu.ops import nid_hist

    orig = nid_hist.joint_histogram

    def interp(taps, s, bin_pts, inlier, bins=16, interpret=False):
        return orig(taps, s, bin_pts, inlier, bins, True)

    monkeypatch.setattr(nid_hist, "joint_histogram", interp)


@pytest.mark.parametrize("xi", POSES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_nid_histograms_match_jax(monkeypatch, xi, use_pallas):
    """One keyframe (3,600 wall points, 128x96) under a pose: the port's
    joint is the transpose of JAX's XLA branch ([point_bin, image_bin]
    against [image_bin, point_bin]) and equals the Pallas branch's
    orientation; joints and the image marginal within 1e-4, the point
    marginal and the inlier count exact, the NID within 1e-5."""
    if use_pallas:
        _patch_interpret(monkeypatch)
    cj = simple_camera()
    kj, kt = _nid_inputs(cj)
    ct = _tcamera(cj)
    x = np.asarray(xi, np.float32)
    hj = jnid.nid_histograms(cj, jse3.exp(jnp.asarray(x)), kj, 16, use_pallas=use_pallas)
    ht = tnid.nid_histograms(ct, tse3.exp(torch.from_numpy(x)), kt, 16)
    joint_j = np.asarray(hj[0]) if use_pallas else np.asarray(hj[0]).T
    assert ht[0].shape == (16, 16)
    np.testing.assert_allclose(ht[0].numpy(), joint_j, atol=1e-4)
    np.testing.assert_allclose(ht[1].numpy(), np.asarray(hj[1]), atol=1e-4)
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    assert float(ht[3]) == float(hj[3])
    nid_j = jnid.nid_loss(cj, jse3.exp(jnp.asarray(x)), kj, 16, use_pallas=use_pallas)
    nid_t = tnid.nid_loss(ct, tse3.exp(torch.from_numpy(x)), kt, 16)
    np.testing.assert_allclose(float(nid_t), float(nid_j), atol=1e-5)


def test_nid_loss_is_multi_nid_loss_at_one_keyframe():
    """nid_loss of one keyframe is multi_nid_loss of the batch of one, bit
    for bit, with its gradient; the batched form keeps its leading axis and
    no tap table is built; bins above 16 are refused."""
    cj = simple_camera()
    _, kt = _nid_inputs(cj)
    ct = _tcamera(cj)
    batch = tnid.NIDKeyframe(kt.points[None], kt.intensity[None], kt.valid[None],
                             kt.bin_image[None])
    x = torch.tensor(POSES[1], requires_grad=True)
    v1 = tnid.nid_loss(ct, tse3.exp(x), kt, 16)
    (g1,) = torch.autograd.grad(v1, x)
    v2 = tnid.multi_nid_loss(ct, tse3.exp(x), batch, 16)
    (g2,) = torch.autograd.grad(v2, x)
    assert v1.item() == v2.item() and torch.equal(g1, g2)
    hb = tnid.nid_histograms(ct, tse3.exp(x.detach()), batch, 16)
    assert hb[0].shape == (1, 16, 16) and hb[3].shape == (1,)
    prepared = tnid.prepare_keyframes(batch)
    assert prepared.tap_rows is None and prepared.bin_tiles is not None
    with pytest.raises(ValueError, match="bins"):
        tnid.nid_histograms(ct, tse3.identity(CPU), kt, 17)


def _diag_data(tmp_path):
    """The JAX test's data (tests/test_dfo_tools.py TestDiagnosticsAndPlots):
    a camera-frame cloud at z = 5 whose intensity equals the image gray."""
    from pointcloudprocessor_tpu_torch.io import pcd

    rng = np.random.default_rng(2)
    n = 500
    u = rng.uniform(5, 123, n)
    v = rng.uniform(5, 91, n)
    pts = np.stack([(u - 64) / 120 * 5, (v - 48) / 120 * 5, np.full(n, 5.0)], -1)
    inten = (u / 128).astype(np.float32)
    pcd.write(str(tmp_path / "c.pcd"), pts.astype(np.float32), intensity=inten)
    img = np.tile((np.arange(128) * 2).astype(np.uint8), (96, 1))
    cv2.imwrite(str(tmp_path / "i.png"), img)
    return str(tmp_path / "c.pcd"), str(tmp_path / "i.png")


@pytest.mark.parametrize("intrinsic", [None, (120.0, 120.0, 64.0, 48.0), (110.0, 125.0, 60.0, 50.0)])
def test_nid_diagnostics_report_matches_jax(tmp_path, intrinsic):
    """The same keys and values as JAX's report: histograms, counts and
    spreads equal, the NID within 1e-5."""
    from pointcloudprocessor_tpu.tools import nid_diagnostics as jdiag
    from pointcloudprocessor_tpu_torch.tools import nid_diagnostics as tdiag

    cloud, image = _diag_data(tmp_path)
    rj = jdiag.analyze(cloud, image, 16, intrinsic)
    rt = tdiag.analyze(cloud, image, 16, intrinsic, device=CPU)
    assert set(rt) == set(rj)
    nid_j = rj.pop("nid", None)
    nid_t = rt.pop("nid", None)
    assert rt == rj
    if intrinsic is not None:
        np.testing.assert_allclose(nid_t, nid_j, atol=1e-5)
        assert rt["num_projected"] > 0.9 * rt["num_points"]


def test_nid_diagnostics_cli(tmp_path, capsys):
    from pointcloudprocessor_tpu_torch.tools import nid_diagnostics as tdiag

    cloud, image = _diag_data(tmp_path)
    rc = tdiag.main(["--cloud", cloud, "--image", image, "--intrinsic", "120", "120", "64",
                     "48", "--plot", str(tmp_path / "h.png"), "--device", CPU])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["num_points"] == 500 and rep["nid"] < 0.4
    assert os.path.exists(str(tmp_path / "h.png"))


# ---------------------------------------------------------------------------
# overlay_intensity, visualize, trajectory_plot
# ---------------------------------------------------------------------------


def _overlay_inputs(n, seed, crowd=0):
    """n points in front of a 64x48 camera (some behind it, some invalid,
    some off the image) over a random image; ``crowd`` more points all on
    one pixel, with distinct intensities."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(-0.5, 4.0, n)], -1).astype(np.float32)
    if crowd:
        c = np.tile(np.asarray([[0.21, -0.13, 2.0]], np.float32), (crowd, 1))
        c[:, 2] += rng.uniform(0, 1e-3, crowd).astype(np.float32)
        pts = np.concatenate([pts, c])
    m = len(pts)
    inten = rng.uniform(0, 1, m).astype(np.float32)
    valid = rng.uniform(size=m) > 0.1
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    return pts, inten, valid, img


@pytest.mark.parametrize("case", [
    dict(n=2000, seed=0, crowd=0, blend=0.65, radius=1, pose=None),
    dict(n=3000, seed=1, crowd=64, blend=0.65, radius=1, pose=None),
    dict(n=1500, seed=2, crowd=16, blend=0.3, radius=2,
         pose=(0.02, -0.01, 0.05, 0.995, 0.05, -0.03, 0.08)),
    dict(n=500, seed=3, crowd=8, blend=1.0, radius=3, pose=None),
])
def test_overlay_intensity_bit_equal(case):
    """The port's overlay equals the JAX function's run op by op
    (``jax.disable_jit``, as the mask path is held) bit for bit, with many
    points on one pixel (the largest point index wins, JAX's rule on the
    CPU) and footprints that overlap; and the jitted function's within 5e-3
    of 255 (XLA contracts TURBO's polynomial and the blend into fused
    multiply-adds), on the same pixels."""
    from pointcloudprocessor_tpu.utils import viz as jviz
    from pointcloudprocessor_tpu_torch.utils import viz as tviz

    pts, inten, valid, img = _overlay_inputs(case["n"], case["seed"], case["crowd"])
    cj = simple_camera(w=64, h=48, f=60.0)
    ct = _tcamera(cj)
    Tj = Tt = None
    if case["pose"] is not None:
        p = np.asarray(case["pose"], np.float32)
        Tj = jse3.from_qt(jnp.asarray(p[3:]), jnp.asarray(p[:3]))
        Tt = tse3.from_qt(torch.from_numpy(p[3:]), torch.from_numpy(p[:3]))
    def jax_overlay():
        return np.asarray(jviz.overlay_intensity(
            cj, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid),
            T_camera_points=Tj, blend=case["blend"], point_radius=case["radius"]))

    with jax.disable_jit():
        oj = jax_overlay()
    oj_jit = jax_overlay()
    ot = tviz.overlay_intensity(ct, torch.from_numpy(img), torch.from_numpy(pts),
                                torch.from_numpy(inten), torch.from_numpy(valid),
                                T_camera_points=Tt, blend=case["blend"],
                                point_radius=case["radius"])
    assert ot.dtype == torch.float32 and ot.shape == (48, 64, 3)
    np.testing.assert_array_equal(ot.numpy(), oj)
    np.testing.assert_allclose(ot.numpy(), oj_jit, atol=5e-3, rtol=0)
    src = img.astype(np.float32)
    np.testing.assert_array_equal(np.any(oj_jit != src, -1), np.any(ot.numpy() != src, -1))
    if case["crowd"]:
        changed = np.any(ot.numpy() != img.astype(np.float32), axis=-1)
        assert changed.sum() > 10


def test_overlay_last_point_wins_a_shared_pixel():
    """JAX's rule found on the CPU: of the points on one pixel, the one of
    largest index sets it (blend 1: the pixel is that point's color)."""
    from pointcloudprocessor_tpu_torch.utils import colormap
    from pointcloudprocessor_tpu_torch.utils import viz as tviz

    ct = _tcamera(simple_camera(w=64, h=48, f=60.0))
    pts = torch.tensor([[0.0, 0.0, 2.0]] * 5)
    inten = torch.tensor([0.1, 0.9, 0.5, 0.3, 0.7])
    out = tviz.overlay_intensity(ct, torch.zeros((48, 64, 3), dtype=torch.uint8), pts, inten,
                                 torch.tensor([True, True, True, True, False]), blend=1.0)
    np.testing.assert_array_equal(out[24, 32].numpy(),
                                  (colormap.turbo(inten[3:4]) * 255.0)[0].numpy())
    assert float(out.sum()) == float(out[24, 32].sum())


def test_visualize_cli(tmp_path):
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.tools import visualize

    rng = np.random.default_rng(0)
    n = 300
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), np.full(n, 3.0)],
                   -1).astype(np.float32)
    pcd.write(str(tmp_path / "c.pcd"), pts, intensity=rng.uniform(0, 1, n).astype(np.float32))
    cv2.imwrite(str(tmp_path / "i.jpg"), np.full((48, 64, 3), 30, np.uint8))
    rc = visualize.main(["overlay", "--cloud", str(tmp_path / "c.pcd"), "--image",
                         str(tmp_path / "i.jpg"), "--intrinsic", "60", "60", "32", "24",
                         "--output", str(tmp_path / "ov.png"), "--device", CPU])
    assert rc == 0
    ov = cv2.imread(str(tmp_path / "ov.png"))
    assert ov.shape == (48, 64, 3) and ov.max() > 60
    rc = visualize.main(["cloud", "--cloud", str(tmp_path / "c.pcd"), "--output",
                         str(tmp_path / "cl.png")])
    assert rc == 0 and os.path.getsize(str(tmp_path / "cl.png")) > 5_000


def test_trajectory_plot(tmp_path):
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.tools import trajectory_plot

    odom = tmp_path / "o.txt"
    odom.write_text("".join(f"{100 + i:.6f} {0.1 * i:.6f} 0 0 1 0 0 0\n" for i in range(10)))
    pts = np.random.default_rng(0).uniform(-1, 1, size=(200, 3)).astype(np.float32)
    pcd.write(str(tmp_path / "m.pcd"), pts)
    rc = trajectory_plot.main(["--odometry", f"vo={odom}", "--odometry", str(odom), "--cloud",
                               str(tmp_path / "m.pcd"), "--output", str(tmp_path / "plot.png")])
    assert rc == 0 and os.path.getsize(str(tmp_path / "plot.png")) > 10_000


# ---------------------------------------------------------------------------
# pick_tool
# ---------------------------------------------------------------------------


def _embedded(html_path):
    m = re.search(r"const DATA = (\{.*?\});\n", open(html_path).read(), re.S)
    assert m, "embedded DATA block missing"
    return json.loads(m.group(1))


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """The port's runner on the CPU over tests/test_pipeline_e2e.py's dataset
    (its <ts>_beforeNID.pcd dumps feed the pick tool)."""
    from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
    from pointcloudprocessor_tpu_torch.utils import config as tcfg

    from test_pipeline_e2e import small_config, write_dataset

    root = tmp_path_factory.mktemp("picks")
    write_dataset(root)
    cfg = tcfg.PipelineConfig.from_json(small_config(root).to_json())
    trunner.process(cfg, CPU)
    return root, cfg


def test_pick_tool_embeds_jax_points_and_drives_manual_guess(pipeline_run, tmp_path, capsys):
    """On the same dumps the port's page embeds JAX's points, intensities
    and camera exactly and its pixels within 1e-3 px (3 decimals of an f32
    projection); the page equals JAX's outside the pixels. An export drawn
    from its embedded data loads into the port's manual_guess, recovers the
    identity, and drives --enableInitialGuessManual through the port's
    CLI."""
    from pointcloudprocessor_tpu.tools import pick_tool as jpick
    from pointcloudprocessor_tpu_torch import cli
    from pointcloudprocessor_tpu_torch.pipeline import ingest, manual_guess
    from pointcloudprocessor_tpu_torch.tools import pick_tool as tpick

    from test_pipeline_e2e import F, H, W

    root, cfg = pipeline_run
    dumps = os.path.join(cfg.output_path, "filtered_pcd")
    args = (dumps, cfg.images_folder, (F, F, W / 2, H / 2), (0, 0, 0, 0, 0))
    ts_j = jpick.generate(*args, str(tmp_path / "j.html"), max_points=500)
    ts_t = tpick.generate(*args, str(tmp_path / "t.html"), max_points=500, device=CPU)
    assert ts_t == ts_j and len(ts_t) == 3
    dj, dt = _embedded(tmp_path / "j.html"), _embedded(tmp_path / "t.html")
    assert set(dt) == set(dj)
    for ts in dj:
        for key in ("image", "x", "y", "z", "i", "cam"):
            assert dt[ts][key] == dj[ts][key], (ts, key)
        for key in ("u", "v"):
            np.testing.assert_allclose(dt[ts][key], dj[ts][key], atol=1.001e-3)
    page = lambda p: re.sub(r"const DATA = \{.*?\};\n", "", open(p).read(), flags=re.S)
    assert page(tmp_path / "t.html") == page(tmp_path / "j.html")

    picks = {}
    for ts, entry in dt.items():
        sel = np.linspace(0, len(entry["u"]) - 1, 8).astype(int)
        picks[ts] = {"pixels": [[entry["u"][i], entry["v"][i]] for i in sel],
                     "points": [[entry["x"][i], entry["y"][i], entry["z"][i]] for i in sel]}
    picks_path = tmp_path / "picks.json"
    picks_path.write_text(json.dumps(picks))
    camera = tcam.create_camera("pinhole", (F, F, W / 2, H / 2), (0, 0, 0, 0, 0), W, H, CPU)
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder, "")
    corr, have = manual_guess.estimate_keyframe_corrections(camera, frames, [0, 1, 2],
                                                            str(picks_path))
    assert all(have)
    dtr, drr = tse3.delta_magnitudes(corr, tse3.identity(CPU, batch_shape=(3,)))
    assert float(dtr.max()) < 0.02 and np.degrees(float(drr.max())) < 0.5

    cfg_path = tmp_path / "config.json"
    cfg2 = type(cfg).from_json(cfg.to_json())
    cfg2.output_path = str(tmp_path / "out") + os.sep
    cfg_path.write_text(cfg2.to_json())
    rc = cli.main(["--config", str(cfg_path), "--enableInitialGuessManual", "--correspondences",
                   str(picks_path), "--device", CPU])
    assert rc == 0
    assert '"manual_guess"' in capsys.readouterr().out
    saved = json.loads((tmp_path / "out" / "manual_poses.json").read_text())
    assert sorted(saved) == sorted(dt)


def test_pick_tool_preview_matches_camera_model():
    """`preview_project`, the Python twin of the page's JS, against the
    port's camera on random distorted points (tests/test_pick_tool.py's
    check, through the port)."""
    from pointcloudprocessor_tpu_torch.tools import pick_tool as tpick

    rng = np.random.default_rng(5)
    intrinsic = (430.0, 410.0, 320.0, 240.0)
    distortion = (-0.28, 0.07, 1.8e-4, -2.1e-4, 0.002)
    camera = tcam.create_camera("pinhole", intrinsic, distortion, 640, 480, CPU)
    pts = np.stack([rng.uniform(-1.5, 1.5, 300), rng.uniform(-1.0, 1.0, 300),
                    rng.uniform(2.0, 8.0, 300)], -1)
    for pose6 in (np.zeros(6), np.array([0.05, -0.12, 0.2, np.radians(1.5), np.radians(-2.0),
                                         np.radians(0.8)])):
        u, v, z = tpick.preview_project(pts, pose6, intrinsic, distortion)
        rot = tse3.exp(torch.tensor(np.concatenate([np.zeros(3), pose6[3:]]),
                                    dtype=torch.float32))
        T = tse3.SE3(q=rot.q, t=torch.tensor(pose6[:3], dtype=torch.float32))
        moved = tse3.transform_points(T, torch.tensor(pts, dtype=torch.float32))
        uv = tcam.project(camera, moved).numpy().astype(np.float64)
        np.testing.assert_allclose(u, uv[:, 0], atol=5e-2)
        np.testing.assert_allclose(v, uv[:, 1], atol=5e-2)
        np.testing.assert_allclose(z, moved[:, 2].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# dfo
# ---------------------------------------------------------------------------


def _rosen_t(x):
    return (1.0 - x[..., 0]) ** 2 + 100.0 * (x[..., 1] - x[..., 0] ** 2) ** 2


def _rosen_j(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


CENTER = np.asarray([1.5, -2.0, 0.5], np.float32)
DFO_CASES = {
    "nm_quadratic": (
        lambda x: torch.sum((x - torch.from_numpy(CENTER)) ** 2, dim=-1),
        lambda x: jnp.sum((x - jnp.asarray(CENTER)) ** 2),
        np.zeros(3, np.float32), dict(init_step=0.5, max_iterations=400), 1e-3),
    "nm_rosenbrock": (_rosen_t, _rosen_j, np.asarray([-1.0, 1.0], np.float32),
                      dict(init_step=0.5, max_iterations=800, xtol=1e-10), 1e-2),
    "dds_quadratic": (lambda x: torch.sum((x - 0.7) ** 2, dim=-1),
                      lambda x: jnp.sum((x - 0.7) ** 2), np.zeros(4, np.float32),
                      dict(init_step=1.0, max_iterations=500), 1e-3),
}


@pytest.mark.parametrize("name", sorted(DFO_CASES))
def test_dfo_matches_jax_problems(name):
    """JAX's test problems (tests/test_dfo_tools.py:20-55): the port reaches
    the JAX minimizer within the JAX test's tolerance, and a batch of one
    is the unbatched call."""
    ft, fj, x0, kw, atol = DFO_CASES[name]
    opt_t = tdfo.directional_direct_search if name.startswith("dds") else tdfo.nelder_mead
    opt_j = jdfo.directional_direct_search if name.startswith("dds") else jdfo.nelder_mead
    rt = opt_t(ft, torch.from_numpy(x0), **kw)
    rj = opt_j(fj, jnp.asarray(x0), **kw)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=atol)
    assert float(rt.value) < 1e-4 + float(rj.value) * 10
    rb = opt_t(ft, torch.from_numpy(x0)[None], **kw)
    assert torch.equal(rb.x[0], rt.x) and int(rb.iterations[0]) == int(rt.iterations)


def test_dfo_batched_problems_stop_on_their_own():
    """A batch of independent problems equals each problem alone (what JAX's
    vmap of a while_loop gives): a problem that has met its exit does not
    move while the others go on."""
    f = lambda x: torch.sum(x * x, dim=-1)
    x0 = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.1, 0.1], [1e-9, 0.0]])
    batch = tdfo.nelder_mead(f, x0, max_iterations=100)
    assert torch.all(batch.value < 1e-4)
    its = []
    for i in range(4):
        one = tdfo.nelder_mead(f, x0[i], max_iterations=100)
        assert torch.equal(batch.x[i], one.x) and batch.value[i] == one.value
        its.append(int(one.iterations))
    assert batch.iterations.tolist() == its and len(set(its)) > 1
    ds = tdfo.directional_direct_search(f, x0, init_step=1.0, max_iterations=60)
    for i in range(4):
        one = tdfo.directional_direct_search(f, x0[i], init_step=1.0, max_iterations=60)
        assert torch.equal(ds.x[i], one.x) and int(ds.iterations[i]) == int(one.iterations)
    vals = jax.vmap(lambda x: jdfo.nelder_mead(lambda y: jnp.sum(y * y), x,
                                               max_iterations=100).value)(jnp.asarray(x0.numpy()))
    assert np.all(np.asarray(vals) < 1e-4)


def test_estimate_direction_matches_closed_form():
    """The Nelder-Mead projection inversion agrees with the closed-form
    bearing, for one pixel and for a batch (one problem a pixel)."""
    cj = simple_camera(w=640, h=480, f=400.0, distortion=[0.03, -0.01, 0.0005, -0.001, 0.0])
    ct = _tcamera(cj)
    px = torch.tensor([[123.0, 401.0], [600.0, 20.0], [320.0, 240.0]])
    d_one = tdfo.estimate_direction_nm(ct, px[0])
    assert float(torch.dot(d_one, tcam.bearing(ct, px[0]))) > 0.99999
    d = tdfo.estimate_direction_nm(ct, px)
    assert torch.all(torch.sum(d * tcam.bearing(ct, px), dim=-1) > 0.99999)
    d_j = jdfo.estimate_direction_nm(cj, jnp.asarray([123.0, 401.0]))
    np.testing.assert_allclose(d_one.numpy(), np.asarray(d_j), atol=1e-4)


def test_console_is_a_copy():
    from pointcloudprocessor_tpu.utils import console as jcon
    from pointcloudprocessor_tpu_torch.utils import console as tcon

    names = [n for n in dir(jcon) if n.isupper()]
    assert names and all(getattr(tcon, n) == getattr(jcon, n) for n in names)
    assert all(callable(getattr(tcon, n)) for n in ("info", "warn", "error"))
