"""The scene generator repeats bit for bit per seed and spans every view."""

import json
import os

import torch

from gpubench.scenes import bench_scene
from tiny import ROOT, TINY


def _scene(kind="s1_k64_zbuffer"):
    with open(os.path.join(ROOT, "gpubench", "configs", f"{kind}.json")) as f:
        sc = json.load(f)["scene"]
    return {**sc, **TINY["scene"]}


def _build(sc, seed):
    s = bench_scene.build(sc, seed, "cpu", rgb=True, bins=16)
    kf = bench_scene.nid_keyframes(sc, s, 1024, seed)
    return [s.points, s.intensity, s.images, s.bin_image, s.kf_q, s.kf_t, *kf]


def test_same_seed_same_bits():
    for kind in ("s1_k64_zbuffer", "s2_k64_hpr"):
        sc = _scene(kind)
        a, b = _build(sc, 2**31 + 11), _build(sc, 2**31 + 11)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_seeds_differ():
    sc = _scene()
    a, b = _build(sc, 1), _build(sc, 2)
    assert not torch.equal(a[0], b[0])  # the map
    assert torch.equal(a[4], b[4])  # the trajectory is the scene's own


def test_corrections_repeat_and_keep_their_ranges():
    q1, t1 = bench_scene.draw_corrections(64, 5, 1, (0.01, 0.03), (0.1, 0.5), stratified=True)
    q2, t2 = bench_scene.draw_corrections(64, 5, 1, (0.01, 0.03), (0.1, 0.5), stratified=True)
    assert torch.equal(q1, q2) and torch.equal(t1, t2)
    cm = torch.linalg.norm(t1.double(), dim=-1) * 100
    qd = q1.double()
    deg = torch.rad2deg(2 * torch.atan2(torch.linalg.norm(qd[:, 1:], dim=-1), qd[:, 0].abs()))
    # exp's translation is V rho: within a few ppm of |rho| at these angles.
    assert cm.min() > 0.999 and cm.max() < 3.001
    assert deg.min() > 0.099 and deg.max() < 0.501


def test_wall_spans_every_view():
    for kind in ("s1_k64_zbuffer", "s2_k64_hpr"):
        with open(os.path.join(ROOT, "gpubench", "configs", f"{kind}.json")) as f:
            sc = json.load(f)["scene"]
        x0, x1, y0, y1 = bench_scene.wall_extent(sc)
        assert x1 - x0 > 0.12 * 63  # wider than the pass
        if kind == "s1_k64_zbuffer":  # bench.py's density, ~3e4 points a square metre
            assert 2.5e4 < bench_scene.density(sc) < 3.5e4
        s = {**sc, "map_points": 50_000, "width": 512, "height": 375,
             "focal_px": sc["focal_px"] * 512 / 4096}
        scene = bench_scene.build(s, 3, "cpu")
        # Every keyframe sees wall points across its whole image.
        for i in range(0, s["keyframes"], 9):
            R = bench_scene.g.quat_to_matrix(scene.kf_q[i])
            pc = (scene.points - scene.kf_t[i]) @ R
            u = s["focal_px"] * pc[:, 0] / pc[:, 2] + s["width"] / 2
            v = s["focal_px"] * pc[:, 1] / pc[:, 2] + s["height"] / 2
            inside = (u >= 0) & (u < s["width"]) & (v >= 0) & (v < s["height"])
            hist = torch.histc(u[inside], bins=8, min=0, max=s["width"])
            assert hist.min() > 0, (kind, i)
            hist = torch.histc(v[inside], bins=8, min=0, max=s["height"])
            assert hist.min() > 0, (kind, i)
