"""Headless manual initial guess: a pose a keyframe from picked 2D-3D pairs.

Port of `pointcloudprocessor_tpu/pipeline/manual_guess.py`. The reference's
`InitialGuessManual` (`include/vlcal/initial_guess_manual.hpp:29-355`) is an
interactive viewer: the user picks >= 3 pixel <-> 3D point pairs a
keyframe, presses "Estimate" (RANSAC + reprojection LSQ, :61-72) and "Save"
(the pose goes into the keyframe, :232-250, and colorization uses it,
`PointCloudProcessor.cpp:510-519`). Here the picks arrive in a JSON file and
the estimate and save run in batch. Schema, keyed by the keyframe timestamp
strings of the file names (C++ ``std::to_string``, 6 decimals):

    {
      "100.500000": {
        "pixels": [[u, v], ...],          # >= 3 picked image pixels
        "points": [[x, y, z], ...]        # the matching 3D points in the
      },                                  # keyframe CAMERA frame
      ...
    }

Each keyframe's estimate plays the role of its ``T_correction`` in fusion
(``T_c2w * T``), as the saved manual pose does in the reference.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import se3
from ..models import camera as cam
from ..opt import pnp
from ..utils.config import PnPConfig
from . import ingest


def load_correspondences(path: str) -> Dict[str, dict]:
    """{timestamp: {"pixels": (n, 2) f32, "points": (n, 3) f32}}; raises on a
    keyframe whose pixel and point counts differ."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for ts, entry in raw.items():
        px = np.asarray(entry["pixels"], np.float32).reshape(-1, 2)
        pt = np.asarray(entry["points"], np.float32).reshape(-1, 3)
        if px.shape[0] != pt.shape[0]:
            raise ValueError(
                f"correspondence count mismatch for {ts}: "
                f"{px.shape[0]} pixels vs {pt.shape[0]} points"
            )
        out[ts] = {"pixels": px, "points": pt}
    return out


def estimate_keyframe_corrections(
    camera: cam.PinholeCamera,
    frames: Sequence[ingest.FrameRecord],
    kf_idx: Sequence[int],
    correspondences_path: str,
    cfg: Optional[PnPConfig] = None,
) -> tuple[se3.SE3, List[bool]]:
    """The (K,) corrections of the keyframes from the correspondence file,
    on the camera's device, and a flag a keyframe for "estimated".
    Keyframes without an entry, or with fewer than 3 pairs (the GUI's gate,
    `initial_guess_manual.hpp:61-66`), get the identity. Keyframe j's
    RANSAC draws from a generator seeded with ``cfg.seed + j``."""
    cfg = cfg or PnPConfig()
    device = camera.intrinsic.device
    table = load_correspondences(correspondences_path)
    T = se3.identity(device, batch_shape=(len(kf_idx),))
    qs, ts, have = list(T.q.unbind(0)), list(T.t.unbind(0)), []
    for j, i in enumerate(kf_idx):
        entry = table.get(ingest.cpp_timestamp(frames[i].timestamp))
        if entry is None or entry["pixels"].shape[0] < 3:
            have.append(False)
            continue
        res = pnp.estimate_pose(
            camera, entry["pixels"], entry["points"],
            generator=torch.Generator().manual_seed(cfg.seed + j),
            num_ransac_iterations=cfg.ransac_iterations,
            error_thresh_px=cfg.error_thresh_px,
            cauchy_kernel=cfg.cauchy_kernel_px,
            lsq_iterations=cfg.lsq_iterations,
        )
        qs[j], ts[j] = res.T_camera_target.q, res.T_camera_target.t
        have.append(True)
    return se3.SE3(torch.stack(qs), torch.stack(ts)), have


def save_corrections_json(path: str, frames, kf_idx, corrections: se3.SE3, have) -> None:
    """Writes the estimated poses, keyed by timestamp (the GUI's intended
    calib.json save, `initial_guess_manual.hpp:96-113`)."""
    q = corrections.q.detach().cpu().numpy()
    t = corrections.t.detach().cpu().numpy()
    out = {}
    for j, i in enumerate(kf_idx):
        if have[j]:
            out[ingest.cpp_timestamp(frames[i].timestamp)] = {
                "quat_wxyz": q[j].tolist(),
                "translation": t[j].tolist(),
            }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
