"""The plain reference imports nothing of the program, and agrees with the
port at a tiny size on the CPU: one solve's NID and one fuse."""

import ast
import json
import os

import pytest
import torch

from gpubench.reference import colorize as ref_colorize
from gpubench.reference import geometry as g
from gpubench.reference import nid as ref_nid
from gpubench.scenes import bench_scene
from tiny import ROOT, TINY

BANNED = ("jax", "jaxlib", "flax", "pointcloudprocessor_tpu", "pointcloudprocessor_tpu_torch")


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "gpubench", "reference")
    files = [f for f in os.listdir(ref) if f.endswith(".py")]
    assert "nid.py" in files and "colorize.py" in files
    for f in files:
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.ImportFrom):
                assert node.module in (None, "geometry", "nid", "colorize"), (f, node.module)
            for n in names:
                assert n.split(".")[0] not in BANNED, (f, n)


def _config(kind):
    with open(os.path.join(ROOT, "gpubench", "configs", f"{kind}.json")) as f:
        c = json.load(f)
    return {**c["scene"], **TINY["scene"]}, c["pipeline"]


def test_nid_matches_the_port():
    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.opt import nid, refine

    sc, _ = _config("s1_k64_zbuffer")
    s = bench_scene.build(sc, 3, "cpu", bins=16)
    pts, inten, valid = bench_scene.nid_keyframes(sc, s, 4096, 3)
    c = s.camera
    camera = cam.create_camera("pinhole", c["intrinsic"].tolist(), c["distortion"].tolist(),
                               sc["width"], sc["height"], "cpu")
    kfs = nid.NIDKeyframe(points=pts, intensity=inten, valid=valid, bin_image=s.bin_image)
    q, t = bench_scene.draw_corrections(3, 0, 1, (0.01, 0.03), (0.1, 0.5), True)
    for i in range(3):
        T = se3.SE3(q[i], t[i])
        port = float(nid.multi_nid_loss(camera, T, kfs))
        ref = float(ref_nid.nid_sum(c["intrinsic"], c["distortion"], sc["width"], sc["height"],
                                    q[i], t[i], pts, inten, valid, s.bin_image))
        assert abs(port - ref) <= 1e-5 * abs(ref)
    # One solve: the NID it reports at its pose is the reference's there.
    res = refine.refine_pose(camera, kfs, se3.SE3(q[0], t[0]), max_outer_iterations=2,
                             max_inner_iterations=5, frozen_taps=True, frozen_guard_frac=0.75)
    T = res.T_camera_lidar
    ref = float(ref_nid.nid_sum(c["intrinsic"], c["distortion"], sc["width"], sc["height"],
                                T.q, T.t, pts, inten, valid, s.bin_image))
    assert abs(float(res.nid) - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("kind", ["s1_k64_zbuffer", "s2_k64_hpr"])
def test_fuse_matches_the_port_bit_for_bit(kind):
    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    sc, pipe = _config(kind)
    s = bench_scene.build(sc, 4, "cpu", rgb=True)
    c = s.camera
    camera = cam.create_camera("pinhole", c["intrinsic"].tolist(), c["distortion"].tolist(),
                               sc["width"], sc["height"], "cpu")
    q, t = bench_scene.draw_corrections(1, 9, 1, (0.0, 0.01), (0.0, 0.1), False)
    cul = pipe["culling"]
    kw = dict(top_k=5, culling_method=cul["method"], downsample_factor=14, depth_epsilon=0.05,
              hpr_radius=90000.0, hpr_tolerance=0.05, hpr_impl="grid")
    out = colorize.fuse(camera, s.points, s.valid, s.images, se3.SE3(s.kf_q, s.kf_t),
                        se3.SE3(q[0], t[0]), **kw)
    fus = {"top_k": 5, "optimal_distance": 2.0, "score_floor": 0.2}
    cull = {"method": cul["method"], "downsample_factor": 14, "depth_epsilon": 0.05,
            "hidden_points_removal_max_z": 90000.0, "hpr_tolerance": 0.05}
    rgb, colored, count = ref_colorize.fuse(c, s.points, s.valid, s.images, s.kf_q, s.kf_t,
                                            q[0], t[0], fus, cull)
    assert torch.equal(out.observation_count, count)
    assert torch.equal(out.colored, colored)
    assert torch.equal(out.rgb, rgb)
    assert 0 < int(colored.sum()) < colored.numel()


def test_pose_error():
    q, t = g.exp(torch.tensor([[0.03, 0.0, 0.04, 0.0, 0.0, 0.01]], dtype=torch.float64))
    cm, deg = g.pose_error(q[0], t[0])
    assert cm == pytest.approx(5.0, rel=1e-3) and deg == pytest.approx(0.5729578, rel=1e-6)
