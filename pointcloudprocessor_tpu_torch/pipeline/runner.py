"""Pipeline orchestration — the `PointCloudProcessor::process()` equivalent.

Port of `pointcloudprocessor_tpu/pipeline/runner.py` (stage sequence of
`PointCloudProcessor.cpp:1007-1032`):

    loadImagesAndOdometry -> loadPointCloud (crop) -> [MLS map stage:
    SOR -> MLS (+ upsampling) -> SOR] -> selectKeyframes -> per-keyframe
    cull (z-buffer or HPR) -> [NID refine of the shared correction]
    -> colorize + top-K fuse -> [local color smoothing] -> save outputs

Stages hand off device tensors on the ``device`` the caller names; nothing
falls back to another device. The NID stage refines the shared correction,
or with ``nid.per_keyframe`` one correction a keyframe in one lockstep
solve (then, with ``nid.smooth_trajectory``, fused with the odometry by the
pose graph); with ``nid.recull_every_outer_iter`` it re-culls the keyframes
at the current correction between outer iterations (JAX `runner.py:
370-482`). The shared correction's frozen-tap solve takes the cache's wide
window and partial refresh (`runner.py:384-390`). With picked 2D-3D
correspondences the manual initial guess overrides the correction of each
keyframe that has picks (`runner.py:491-512`). With a mask folder, the mask
path runs as the JAX runner's does (`runner.py:517-526, 585-649`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core import cloud as cl
from ..core import se3
from ..io import images as img_io
from ..io import pcd
from ..models import camera as cam
from ..ops import fusion, hpr, mls, zbuffer
from ..opt import nid as nid_mod
from ..opt import pose_graph, refine
from ..utils import profiling
from ..utils.config import PipelineConfig
from . import colorize, ingest, keyframes, manual_guess


@dataclass
class PipelineResult:
    colored_cloud_path: str = ""
    mask_cloud_path: str = ""
    num_keyframes: int = 0
    num_colored_points: int = 0
    T_correction: Optional[se3.SE3] = None
    nid_value: float = float("nan")
    # Objective evaluations of the NID stage, each one of every keyframe
    # (per keyframe: the lockstep solve's; summed over re-cull passes).
    nid_evaluations: int = 0
    nid_outer_iterations: object = 0  # an int, or a list of one a keyframe
    timings: dict = field(default_factory=dict)


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for a configured value that no branch can run, before any stage
    starts: an unknown MLS upsampling method, or a frozen-tap margin
    outside 0..2 where the solve reads it (the JAX package asserts 1 <= m <=
    2 where it builds the wide table, `nid.py:154`). Every branch of the
    JAX runner runs in the port."""
    n = cfg.nid
    if n.frozen_taps and not n.per_keyframe and not 0 <= n.frozen_margin <= 2:
        raise ValueError(f"nid.frozen_margin must be in 0..2, got {n.frozen_margin}")
    if cfg.enable_mls and cfg.mls.upsampling.lower() not in mls.UPSAMPLING:
        raise ValueError(f"unknown MLS upsampling method: {cfg.mls.upsampling!r}")


def _make_camera(cfg: PipelineConfig, device) -> cam.PinholeCamera:
    return cam.create_camera(
        cfg.camera.model, cfg.camera.intrinsic, cfg.camera.distortion,
        cfg.camera.width, cfg.camera.height, device,
    )


def _extrinsic_lidar_to_cam(cfg: PipelineConfig, device) -> Optional[se3.SE3]:
    """T_camera<-lidar from config, or None when ``extrinsic.apply`` is off
    (the reference initializes but never applies it,
    `PointCloudProcessor.cpp:51-54`)."""
    if not cfg.extrinsic.apply:
        return None
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = torch.as_tensor(cfg.extrinsic.rotation, dtype=torch.float32, device=device)
    m[:3, 3] = torch.as_tensor(cfg.extrinsic.translation, dtype=torch.float32, device=device)
    return se3.from_matrix(m)


def _camera_to_world(frames, idx, T_l2c: Optional[se3.SE3], device) -> se3.SE3:
    """Batched camera-to-world poses of frames ``idx`` (odometry, composed
    with the inverse mounting transform when it applies)."""
    q = np.stack([frames[i].quat_wxyz for i in idx]).astype(np.float32)
    t = np.stack([frames[i].position for i in idx]).astype(np.float32)
    base = se3.SE3(
        q=se3.quat_normalize(torch.as_tensor(q, device=device)),
        t=torch.as_tensor(t, device=device),
    )
    return base if T_l2c is None else se3.compose(base, se3.inverse(T_l2c))


def _culling_kwargs(cfg: PipelineConfig) -> dict:
    """The culling options colorize takes (JAX `runner.py:546-553`)."""
    c = cfg.culling
    return dict(
        downsample_factor=c.downsample_factor, depth_epsilon=c.depth_epsilon,
        culling_method=c.method, hpr_radius=c.hidden_points_removal_max_z,
        hpr_tolerance=c.hpr_tolerance, hpr_impl=c.hpr_impl, hpr_dense_cutoff=c.hpr_dense_cutoff,
    )


def _culls(camera, T_c2w: se3.SE3, points, valid, cfg: PipelineConfig):
    """(points_camera, mask) of each keyframe's cull by ``cfg.culling.method``
    (JAX `_cull_device`, `runner.py:122-132`), for the batch of camera ->
    world poses ``T_c2w``: under HPR all of them in one batch
    (``hpr.cull_world_points_batch``: on the card one H2 call), each
    keyframe's the bits of its own cull; under the z-buffer one at a time."""
    c = cfg.culling
    if c.method == "hpr":
        pts_cam, masks = hpr.cull_world_points_batch(
            camera, se3.inverse(T_c2w), points, valid, radius=c.hidden_points_removal_max_z,
            tolerance=c.hpr_tolerance, impl=c.hpr_impl, dense_cutoff=c.hpr_dense_cutoff)
        return zip(pts_cam, masks)
    if c.method == "zbuffer":
        return (zbuffer.cull_world_points(
            camera, se3.inverse(se3.SE3(T_c2w.q[j], T_c2w.t[j])), points, valid,
            downsample_factor=c.downsample_factor, depth_epsilon=c.depth_epsilon)
            for j in range(T_c2w.q.shape[0]))
    raise ValueError(f"culling.method must be 'zbuffer' or 'hpr', got {c.method!r}")


def build_nid_keyframes(camera, map_cloud, frames, kf_idx, cfg, save_dir: str = "",
                        T_correction: Optional[se3.SE3] = None,
                        bins_of: Optional[nid_mod.NIDKeyframe] = None):
    """Cull per keyframe and assemble the padded NIDKeyframe batch
    (`viewCullingAndSaveFilteredPcds` :178-224 + the loading in
    `estimate_pose_bfgs` :160-178, without the disk round-trip; the
    ``<ts>_beforeNID.pcd`` dumps are written when ``save_dir`` is set).

    A keyframe with more visible points than ``culled_capacity`` keeps an
    evenly spaced subset, the same indices as the JAX runner picks. Under
    ``culling.method="hpr"`` all the keyframes are culled in one batch
    (:func:`_culls`).

    ``T_correction`` (scalar or (K,), JAX `runner.py:174-250`) re-culls at
    the corrected poses ``T_c2w ∘ T_correction``
    (`PointCloudProcessor.cpp:507`) for ``nid.recull_every_outer_iter``: the
    visibility follows the correction, while the points stay in the raw
    keyframe camera frame, so the refine composes its correction the same
    way in every outer iteration. ``bins_of``: keyframes whose bin images
    (and packed bin tiles) to reuse, since they do not depend on the pose:
    no JPEG is decoded and no ``bin_pack`` runs."""
    device = map_cloud.points.device
    cap = cfg.culled_capacity
    bins = cfg.nid.bins
    norm_cloud = cl.normalize_intensity(map_cloud)
    poses = _camera_to_world(frames, kf_idx, _extrinsic_lidar_to_cam(cfg, device), device)
    cull_poses = poses if T_correction is None else se3.compose(poses, T_correction)
    culls = _culls(camera, cull_poses, norm_cloud.points, norm_cloud.valid, cfg)
    pts_list, int_list, val_list, bin_list = [], [], [], []
    for j, (i, (pts_cam, mask)) in enumerate(zip(kf_idx, culls)):
        vis_idx = torch.nonzero(mask, as_tuple=True)[0]
        n_vis = vis_idx.numel()
        if n_vis > cap:
            pick = np.linspace(0, n_vis - 1, cap).astype(np.int64)
            vis_idx = vis_idx[torch.as_tensor(pick, device=device)]
        n = vis_idx.numel()
        p = torch.zeros((cap, 3), dtype=torch.float32, device=device)
        it = torch.zeros((cap,), dtype=torch.float32, device=device)
        v = torch.zeros((cap,), dtype=torch.bool, device=device)
        if T_correction is None:
            p[:n] = pts_cam[vis_idx]
        else:  # the raw keyframe camera frame (JAX `_points_in_frame`, :169-171)
            p[:n] = se3.transform_points(
                se3.inverse(se3.SE3(poses.q[j], poses.t[j])), norm_cloud.points[vis_idx])
        it[:n] = norm_cloud.intensity[vis_idx]
        v[:n] = True
        pts_list.append(p)
        int_list.append(it)
        val_list.append(v)
        if bins_of is None:
            # Quantized on the host, as the JAX runner does, and shipped as uint8.
            gray = img_io.load_gray_normalized(frames[i].image_path)
            b = np.clip((gray * bins).astype(np.int32), 0, bins - 1).astype(np.uint8)
            bin_list.append(torch.from_numpy(b).to(device).to(torch.int32))
        if save_dir:
            ts = ingest.cpp_timestamp(frames[i].timestamp)
            pcd.write(
                os.path.join(save_dir, f"{ts}_beforeNID.pcd"),
                p[:n].cpu().numpy(),
                intensity=it[:n].cpu().numpy(),
            )
    return nid_mod.NIDKeyframe(
        points=torch.stack(pts_list),
        intensity=torch.stack(int_list),
        valid=torch.stack(val_list),
        bin_image=torch.stack(bin_list) if bins_of is None else bins_of.bin_image,
        bin_tiles=None if bins_of is None else bins_of.bin_tiles,
    )


def _refine(cfg: PipelineConfig, camera, kfs, T0: se3.SE3, outer_iterations: int):
    """One NID solve from ``T0``, with the options the JAX runner forwards
    (`runner.py:377-410`): the per-keyframe solve takes none of the
    schedule's (coarse phase, frozen taps and the cache's margin and
    partial refresh, carried Hessian, ftol)."""
    n = cfg.nid
    common = dict(
        bins=n.bins,
        max_outer_iterations=outer_iterations,
        max_inner_iterations=n.max_inner_iterations,
        delta_trans_thresh=n.delta_trans_thresh,
        delta_rot_thresh=float(np.radians(n.delta_rot_thresh_deg)),
        trust_region_trans=n.trust_region_trans,
        trust_region_rot=float(np.radians(n.trust_region_rot_deg)),
    )
    if n.per_keyframe:
        return refine.refine_pose_per_keyframe(camera, kfs, T0, **common)
    kw = {}
    if n.coarse_outer_iterations:
        kw.update(coarse_outer_iterations=n.coarse_outer_iterations, coarse_stride=n.coarse_stride)
    if n.frozen_taps:
        kw.update(frozen_taps=True, frozen_guard_frac=n.frozen_guard_frac,
                  frozen_partial_frac=n.frozen_partial_frac, frozen_margin=n.frozen_margin)
    return refine.refine_pose(camera, kfs, T0, carry_hessian=n.carry_hessian, ftol=n.ftol,
                              **common, **kw)


def _listed(x):
    """A per-keyframe tensor as a list, a host value as itself (JSON)."""
    return x.tolist() if isinstance(x, torch.Tensor) else x


def process(cfg: PipelineConfig, device) -> PipelineResult:
    """Run the pipeline per the config on ``device`` ("cuda", "cuda:1",
    "cpu", ...). Returns paths, stats and per-stage timings (seconds; each
    stage ends after the device has finished its work)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    check_supported(cfg)
    t_start = time.perf_counter()
    result = PipelineResult()

    for label, path in (
        ("point_cloud_path", cfg.point_cloud_path),
        ("odometry_path", cfg.odometry_path),
        ("images_folder", cfg.images_folder),
    ):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{label} does not exist: {path!r}")

    camera = _make_camera(cfg, device)
    os.makedirs(cfg.output_path, exist_ok=True)
    filtered_dir = os.path.join(cfg.output_path, "filtered_pcd")
    os.makedirs(filtered_dir, exist_ok=True)
    metrics_path = (
        os.path.join(cfg.output_path, "metrics.jsonl")
        if cfg.metrics_path == "auto"
        else cfg.metrics_path
    )
    metrics = profiling.MetricsLogger(metrics_path)
    metrics.log("pipeline_start", config_keyframes_cap=cfg.max_keyframes, device=str(device))
    timer = profiling.StageTimer(device)
    trace_ctx = contextlib.nullcontext()
    if cfg.profile_trace_dir:
        # The capture's spans and counters are this run's alone.
        profiling.reset_trace()
        trace_ctx = profiling.trace(cfg.profile_trace_dir)
    with trace_ctx:
        _process_stages(cfg, camera, device, filtered_dir, result, timer, metrics)
    result.timings = dict(timer.timings)
    result.timings["total"] = time.perf_counter() - t_start
    if cfg.profile_trace_dir:
        # What the capture counted (utils/profiling.count: host_sync).
        metrics.log("counters", **profiling.counter_values())
    metrics.log("pipeline_done", **{k: round(v, 4) for k, v in result.timings.items()})
    return result


def _process_stages(cfg, camera, device, filtered_dir, result, timer, metrics):
    # 1. Frames + odometry (loadImagesAndOdometry, :965-1005).
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder, cfg.mask_image_folder)
    if not frames:
        raise ValueError(
            "no frames: no odometry timestamp matched an image file — check "
            "that images are named '<ts:.6f>.jpg' for the odometry timestamps"
        )
    traj = ingest.frames_trajectory(frames)
    metrics.log("frames_loaded", count=len(frames))

    # 2. Map load + trajectory crop (loadPointCloud, :92-154), then the
    # optional MLS map stage (CloudSmooth::process, cloudSmooth.cpp:77-181).
    crop_path = os.path.join(cfg.output_path, "scans-crop.pcd")
    mls_path = os.path.join(cfg.output_path, "scans-crop_mls.pcd")
    ready_path = mls_path if cfg.enable_mls else crop_path
    if cfg.resume and os.path.exists(ready_path):
        # Stage checkpoint: artifacts double as restart points.
        with timer.stage("load_crop"):
            map_cloud = pcd.read_cloud(ready_path, device, capacity=cfg.map_capacity)
        metrics.log("crop_resumed", path=ready_path)
    else:
        with timer.stage("load_crop"):
            map_cloud = pcd.read_cloud(cfg.point_cloud_path, device, capacity=cfg.map_capacity)
            map_cloud = cl.trajectory_crop(
                map_cloud, torch.as_tensor(traj.positions, device=device),
                padding=cfg.crop_padding,
            )
            pcd.write_cloud(crop_path, map_cloud)
        if cfg.enable_mls:
            # Upsampling may leave the map with another capacity than
            # cfg.map_capacity; every later stage takes any.
            with timer.stage("mls"):
                map_cloud = mls.smooth_cloud(map_cloud, cfg.mls, timer=timer)
                with timer.stage("mls_write"):
                    pcd.write_cloud(mls_path, map_cloud)
    metrics.log("map_ready", points=map_cloud.count())

    # 3. Keyframes (selectKeyframes, :1050-1075).
    kf_idx = keyframes.select(traj, cfg.keyframes)[: cfg.max_keyframes]
    result.num_keyframes = len(kf_idx)

    # 4. Culling + NID keyframe assembly (viewCullingAndSaveFilteredPcds).
    with timer.stage("culling"):
        kfs = build_nid_keyframes(camera, map_cloud, frames, kf_idx, cfg, save_dir=filtered_dir)

    # 5. Optional NID pose refinement (applyNIDBasedPoseOptimization, :156-164).
    T_correction = se3.identity(device)
    corr_path = os.path.join(cfg.output_path, "nid_correction.json")
    if cfg.enable_nid_optimize and cfg.resume and os.path.exists(corr_path):
        with open(corr_path) as f:
            saved = json.load(f)
        # (4,) and (3,), or (K, 4) and (K, 3) per keyframe.
        T_correction = se3.from_qt(
            torch.as_tensor(saved["quat_wxyz"], dtype=torch.float32, device=device),
            torch.as_tensor(saved["translation"], dtype=torch.float32, device=device),
        )
        result.nid_value = saved.get("nid", float("nan"))
        metrics.log("nid_resumed", path=corr_path)
    elif cfg.enable_nid_optimize:
        with timer.stage("nid_refine"):
            res, T_correction = _nid_stage(cfg, camera, map_cloud, frames, kf_idx, kfs,
                                           T_correction, device, timer, metrics)
            result.nid_value = float(res.nid.sum())
        result.nid_outer_iterations = _listed(res.outer_iterations)
        with open(corr_path, "w") as f:
            json.dump(
                {
                    "quat_wxyz": T_correction.q.tolist(),
                    "translation": T_correction.t.tolist(),
                    "nid": result.nid_value,
                    "per_keyframe": bool(cfg.nid.per_keyframe),
                    "outer_iterations": _listed(res.outer_iterations),
                    "converged": _listed(res.converged),
                },
                f,
                indent=2,
            )
        metrics.log(
            "nid_refined",
            nid=result.nid_value,
            outer_iterations=_listed(res.outer_iterations),
            converged=_listed(res.converged),
            evaluations=_listed(res.evaluations),
            gathers=_listed(res.gathers),
        )
        result.nid_evaluations = res.lockstep_evaluations if cfg.nid.per_keyframe else res.evaluations
    del kfs
    result.T_correction = T_correction

    # 5b. Optional manual initial guess from picked 2D-3D pairs
    # (applyInitialGuessManual, :166-176; JAX `runner.py:491-512`): each
    # keyframe's manual pose, where it has one, takes precedence over the
    # NID correction, as in the colorization branch at :510-519. The
    # result keeps the NID correction, as the JAX runner's does.
    if cfg.enable_manual_guess and cfg.correspondences_path:
        with timer.stage("manual_guess"):
            manual, have = manual_guess.estimate_keyframe_corrections(
                camera, frames, kf_idx, cfg.correspondences_path, cfg.pnp)
            have_t = torch.as_tensor(have, dtype=torch.bool, device=device)
            T_correction = se3.SE3(q=torch.where(have_t[:, None], manual.q, T_correction.q),
                                   t=torch.where(have_t[:, None], manual.t, T_correction.t))
            manual_guess.save_corrections_json(
                os.path.join(cfg.output_path, "manual_poses.json"), frames, kf_idx, manual, have)

    # 6. Colorize + fuse (pcdColorizationAndSmooth, :474-631).
    with timer.stage("colorize_fuse"):
        images = torch.from_numpy(
            np.stack([img_io.load_rgb(frames[i].image_path) for i in kf_idx])
        )
        masks = _load_masks(frames, kf_idx, cfg) if cfg.mask_image_folder else None
        poses = _camera_to_world(frames, kf_idx, _extrinsic_lidar_to_cam(cfg, device), device)
        fused = colorize.fuse(
            camera,
            map_cloud.points,
            map_cloud.valid,
            images,
            poses,
            T_correction,
            mask_images=masks,
            top_k=cfg.fusion.top_k,
            optimal_distance=cfg.fusion.optimal_distance,
            score_floor=cfg.fusion.score_floor,
            saturation_scale=cfg.fusion.saturation_scale,
            brightness_scale=cfg.fusion.brightness_scale,
            reference_compat_orientation=cfg.fusion.reference_compat_orientation,
            **_culling_kwargs(cfg),
        )

    # 6b. Optional spatial color smoothing (smoothColorsWithLocalRegion,
    # :634-703; JAX `runner.py:564-575`).
    fused_rgb = fused.rgb
    if cfg.fusion.local_smoothing_radius > 0:
        with timer.stage("local_smoothing"):
            fused_rgb = fusion.smooth_colors_local(
                map_cloud.points, fused.rgb, fused.colored, cfg.fusion.local_smoothing_radius)

    # 7. Save outputs (saveColorizedPointCloud, :866-963).
    with timer.stage("save_output"):
        keep = fused.colored if cfg.fusion.drop_uncolored else map_cloud.valid
        out_cloud = map_cloud.replace(rgb=fused_rgb, valid=keep)
        out_path = os.path.join(cfg.output_path, "cloudInWorldWithRGB.pcd")
        pcd.write_cloud(out_path, out_cloud, include=("rgb",))
    result.colored_cloud_path = out_path
    result.num_colored_points = int(keep.sum())
    if masks is not None:
        with timer.stage("save_masks"):
            result.mask_cloud_path = _save_mask_outputs(
                cfg, camera, map_cloud, frames, kf_idx, images, masks, poses, T_correction,
                fused.best_label, out_cloud, filtered_dir,
            )
    metrics.log("outputs_saved", colored_points=result.num_colored_points)


def _nid_stage(cfg, camera, map_cloud, frames, kf_idx, kfs, T_correction, device, timer,
               metrics):
    """The NID refinement (JAX `runner.py:370-460`): ``(RefineResult,
    correction)``, the correction scalar or, under ``nid.per_keyframe``,
    one a keyframe (K,). With ``nid.recull_every_outer_iter`` a host outer
    loop of one-outer-iteration solves re-culls the keyframes at the
    current correction before every pass after the first (reusing their
    bin images) and stops once every lane's pass moved less than the outer
    thresholds; the result's ``outer_iterations`` and ``converged`` are the
    loop's and its ``evaluations`` (``lockstep_evaluations`` per keyframe)
    the sum over the passes. With ``nid.per_keyframe`` and
    ``nid.smooth_trajectory`` the pose graph then fuses the corrections
    with the odometry chain."""
    n = cfg.nid
    if n.recull_every_outer_iter:
        # The improvement the reference forgoes: it reloads the same culled
        # clouds every outer iteration (visual_camera_calibration.cpp:160-167).
        evaluations = lockstep = 0
        # Packed once (one bin_pack), then handed to every re-cull.
        kfs = nid_mod.prepare_keyframes(kfs)
        for outer in range(n.max_outer_iterations):
            if outer > 0:
                with timer.stage("nid_recull"):
                    kfs = build_nid_keyframes(camera, map_cloud, frames, kf_idx, cfg,
                                              T_correction=T_correction, bins_of=kfs)
            res = _refine(cfg, camera, kfs, T_correction, 1)
            evaluations = evaluations + res.evaluations
            lockstep += res.lockstep_evaluations
            dt, dr = se3.delta_magnitudes(T_correction, res.T_camera_lidar)
            T_correction = res.T_camera_lidar
            converged = ((dt < n.delta_trans_thresh)
                         & (dr < float(np.radians(n.delta_rot_thresh_deg)))).cpu()
            metrics.log("nid_recull_outer", outer=outer + 1, max_dt=float(dt.max()),
                        max_dr=float(dr.max()))
            if bool(converged.all()):
                break
        res = res._replace(outer_iterations=outer + 1, evaluations=evaluations,
                           lockstep_evaluations=lockstep,
                           converged=converged if n.per_keyframe else bool(converged))
    else:
        res = _refine(cfg, camera, kfs, T_correction, n.max_outer_iterations)
        T_correction = res.T_camera_lidar
    if n.per_keyframe and n.smooth_trajectory:
        # Fuse the independent corrections with the VO chain, then fold the
        # smoothed trajectory back into corrections, so colorize keeps its
        # one interface.
        with timer.stage("pose_graph"):
            c2w = _camera_to_world(frames, kf_idx, _extrinsic_lidar_to_cam(cfg, device), device)
            pg = pose_graph.smooth_refined_trajectory(
                c2w, T_correction, converged=res.converged,
                abs_weight=n.smooth_abs_weight, odo_weight=n.smooth_odo_weight)
            T_correction = se3.compose(se3.inverse(c2w), pg.poses)
        metrics.log("pose_graph_smoothed", residual_norm=float(pg.residual_norm),
                    initial_residual_norm=float(pg.initial_residual_norm))
    return res, T_correction


def _load_masks(frames, kf_idx, cfg) -> torch.Tensor:
    """(K, H, W) int32 host masks of the keyframes; a missing or unreadable
    PNG gives a zero mask (JAX `runner.py:517-526`)."""
    loaded = []
    for i in kf_idx:
        try:
            loaded.append(img_io.load_mask(frames[i].mask_path))
        except (FileNotFoundError, OSError):
            loaded.append(np.zeros((cfg.camera.height, cfg.camera.width), np.int32))
    return torch.from_numpy(np.stack(loaded))


def _save_mask_outputs(cfg, camera, map_cloud, frames, kf_idx, images, masks, poses,
                       T_correction, best_label, out_cloud, filtered_dir) -> str:
    """The mask path's artifacts (`PointCloudProcessor.cpp:539-550, 818-928`;
    JAX `runner.py:585-649`): per keyframe, its visible points in the camera
    frame with their own sampled colors and labels (``<ts>_rgb-mask.pcd``);
    their concatenation at the map points' world coordinates
    (``cloudInWorldWithRGBandMask.pcd``, duplicates across keyframes kept);
    and the fused cloud colored by the jet map of each point's best label
    (``cloudInWorldWithMaskAndMappedColor.pcd``). Returns the path of the
    concatenated cloud."""
    from ..utils import colormap

    device = map_cloud.points.device
    acc_pts, acc_rgb, acc_lab = [], [], []
    for j, i in enumerate(kf_idx):
        pts_cam, rgb_k, lab_k, vis_k = colorize.keyframe_rgb_mask(
            camera,
            map_cloud.points,
            map_cloud.valid,
            images[j].to(device),
            masks[j].to(device),
            se3.SE3(poses.q[j], poses.t[j]),
            # Keyframe j's own row of a per-keyframe correction (JAX
            # `runner.py:606-610`).
            se3.SE3(T_correction.q[j], T_correction.t[j]) if T_correction.q.ndim == 2
            else T_correction,
            saturation_scale=cfg.fusion.saturation_scale,
            brightness_scale=cfg.fusion.brightness_scale,
            mask_highlight_value=cfg.fusion.mask_highlight_value,
            **_culling_kwargs(cfg),
        )
        sel = torch.nonzero(vis_k, as_tuple=True)[0]
        rgb_sel, lab_sel = rgb_k[sel].cpu().numpy(), lab_k[sel].cpu().numpy()
        pcd.write(
            os.path.join(filtered_dir, f"{ingest.cpp_timestamp(frames[i].timestamp)}_rgb-mask.pcd"),
            pts_cam[sel].cpu().numpy(),
            rgb=rgb_sel,
            mask_label=lab_sel,
        )
        acc_pts.append(map_cloud.points[sel].cpu().numpy())
        acc_rgb.append(rgb_sel)
        acc_lab.append(lab_sel)
    mask_path = os.path.join(cfg.output_path, "cloudInWorldWithRGBandMask.pcd")
    pcd.write(
        mask_path,
        np.concatenate(acc_pts) if acc_pts else np.zeros((0, 3), np.float32),
        rgb=np.concatenate(acc_rgb) if acc_rgb else None,
        mask_label=np.concatenate(acc_lab) if acc_lab else None,
    )
    # Jet-colormapped label cloud (generateSegmentMapWithColor, :818-864).
    mapped = colormap.jet(best_label.to(torch.float32) / 255.0)
    pcd.write_cloud(
        os.path.join(cfg.output_path, "cloudInWorldWithMaskAndMappedColor.pcd"),
        out_cloud.replace(rgb=mapped * 255.0),
        include=("rgb",),
    )
    return mask_path
