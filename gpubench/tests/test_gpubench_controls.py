"""The check reads the controls (the reference in bfloat16 in the port's
place) and each fault planted in the timed path as not correct, and a sound
run as correct. Each run drives the harness as run.py does, less the look
for a card, at the tiny size on the CPU."""

import pytest
import torch

from gpubench import controls
from tiny import run


@pytest.mark.parametrize("cell", ["calib.s1_k64", "colorize.s2_k64_hpr", "colorize.s1_k64"])
def test_control_is_not_correct(cell):
    kind = cell.split(".")[0]
    restore = controls.install(kind)
    try:
        res = run(cell, seed=21)["result"]
    finally:
        restore()
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert run(cell, seed=21)["result"]["correct"] is True


def _calib_fault(fault):
    """A substitute for the runner's solve with ``fault`` planted."""
    from pointcloudprocessor_tpu_torch.opt import nid, refine
    from pointcloudprocessor_tpu_torch.pipeline import runner

    solve = runner._refine

    def faulty(cfg, camera, kfs, T0, outer):
        if fault == "unchanged":
            # The solve's state returned as it came: the start pose and its
            # own NID, as a solve that rejects every step reports them.
            return refine.RefineResult(T0, nid.multi_nid_loss(camera, T0, kfs, cfg.nid.bins), 0,
                                       False, 0)
        if fault == "half_batch":
            k = kfs.points.shape[0] // 2
            half = nid.NIDKeyframe(points=kfs.points[:k], intensity=kfs.intensity[:k],
                                   valid=kfs.valid[:k], bin_image=kfs.bin_image[:k])
            res = solve(cfg, camera, half, T0, outer)
            # The mean over the half, scaled to the whole batch.
            return res._replace(nid=res.nid * (kfs.points.shape[0] / k))
        res = solve(cfg, camera, kfs, T0, outer)
        if fault == "altered":
            T = res.T_camera_lidar
            T.t = T.t + torch.tensor([0.002, 0.0, 0.0])
            return res._replace(T_camera_lidar=T)
        raise ValueError(fault)

    return runner, "_refine", faulty


def _colorize_fault(fault):
    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    fuse = colorize.fuse

    def faulty(camera, points, valid, images, kf_poses, T, **kw):
        if fault == "unchanged":
            n = points.shape[0]
            return colorize.FusionResult(torch.zeros((n, 3)), torch.zeros(n, dtype=torch.bool),
                                         None, torch.zeros(n, dtype=torch.int32))
        if fault == "half_batch":
            k = images.shape[0] // 2
            return fuse(camera, points, valid, images[:k], se3.SE3(kf_poses.q[:k], kf_poses.t[:k]),
                        T, **kw)
        out = fuse(camera, points, valid, images, kf_poses, T, **kw)
        if fault == "altered":
            rgb = out.rgb.clone()
            rgb[:, 0] += 1.0
            return out._replace(rgb=rgb)
        raise ValueError(fault)

    return colorize, "fuse", faulty


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["calib.s1_k64", "colorize.s2_k64_hpr", "colorize.s1_k64"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    mod, attr, faulty = (_calib_fault if cell.startswith("calib") else _colorize_fault)(fault)
    monkeypatch.setattr(mod, attr, faulty)
    res = run(cell, seed=22)["result"]
    assert res["correct"] is False
