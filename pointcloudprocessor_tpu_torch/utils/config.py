"""One typed config tree covering every knob the reference hardcodes.

The reference scatters constants through source: camera intrinsics and
extrinsics (`PointCloudProcessor/src/PointCloudProcessor.cpp:51-62`), image
size {4096,3000} (`:206,525`), MLS params (`:67-86`), keyframe thresholds
(`:1056-1057`), NID bins / optimizer thresholds
(`visual_camera_calibration.hpp:17-32`, `calibrate.cpp:52-60`), top-5 view
fusion (`:615`), z-buffer downsample 14 (`view_culling.cpp:63`). Here all of
it lives in dataclasses (JSON round-trippable), defaults = reference values.

A copy of `pointcloudprocessor_tpu/utils/config.py`: one JSON config drives
both packages, so field names and defaults must stay equal
(tests/test_torch_config.py). Knobs of branches the PyTorch port does not
run yet raise NotImplementedError where they are read (pipeline/runner.py,
opt/refine.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class CameraConfig:
    """Defaults are the reference rig (`PointCloudProcessor.cpp:51-62,206`)."""

    model: str = "pinhole"
    # [fx, fy, cx, cy]
    intrinsic: Sequence[float] = (
        4818.200388954926,
        4819.10345841615,
        2032.4178620390019,
        1535.1895959282901,
    )
    # plumb_bob [k1, k2, p1, p2, k3]
    distortion: Sequence[float] = (
        0.003043514741045163,
        0.06634739187544138,
        -0.000217681797407554,
        -0.0006654964142658197,
        0.0,
    )
    width: int = 4096
    height: int = 3000


@dataclass
class ExtrinsicConfig:
    """LiDAR -> camera mounting transform (`PointCloudProcessor.cpp:51-54`).

    The reference initializes R_lidar2cam/t_lidar2cam but never applies them
    (the odometry is already interpolated into the camera timeline), so
    ``apply`` defaults to False for behavior parity. With ``apply=True`` the
    odometry poses are treated as LiDAR-body poses (T_world<-lidar) and every
    camera pose becomes ``T_world<-camera = T_world<-lidar ∘
    inverse(T_camera<-lidar)`` — the geometrically honest mounting chain the
    reference's dead fields imply."""

    rotation: Sequence[Sequence[float]] = (
        (-0.99993085, -0.00561199, -0.0103344),
        (0.01032389, 0.00189784, -0.99994491),
        (0.0056313, -0.99998245, -0.00183977),
    )
    translation: Sequence[float] = (
        0.071771636420221,
        -0.04934294727365431,
        -0.0677501086411397,
    )
    apply: bool = False


@dataclass
class KeyframeConfig:
    """`PointCloudProcessor.cpp:1056-1057` — angle computed but unused there;
    honoured here when ``use_angle`` is set."""

    distance_threshold: float = 0.1  # metres
    angle_threshold: float = 10.0  # degrees
    use_angle: bool = False


@dataclass
class CullingConfig:
    """Occlusion culling. ``method`` selects between the two designs the
    reference carries: "zbuffer" (`view_culling.cpp:52-174`, the default
    here — see ops/zbuffer.py) and "hpr", the reference's active
    spherical-flip hidden-point-removal path (`view_culling.cpp:266-334`)
    rebuilt as a support-function hull test (see ops/hpr.py)."""

    method: str = "zbuffer"  # "zbuffer" | "hpr"
    downsample_factor: int = 14  # view_culling.cpp:63
    depth_epsilon: float = 0.05  # view_culling.cpp:157
    enable_depth_buffer_culling: bool = True
    # HPR spherical-flip radius (view_culling.hpp:14) and support slack.
    hidden_points_removal_max_z: float = 90000.0
    hpr_tolerance: float = 0.05
    # HPR kernel selection: "dense" O(N^2) support matmul, "grid" O(N)
    # parabolic z-buffer (ops/hpr.py:hpr_mask_grid), "auto" = grid above
    # hpr_dense_cutoff points.
    hpr_impl: str = "auto"
    hpr_dense_cutoff: int = 100_000


@dataclass
class MLSConfig:
    """`PointCloudProcessor.cpp:67-86` + `cloudSmooth.cpp:25-56`."""

    compute_normals: bool = True
    polynomial_order: int = 2
    search_radius: float = 0.03
    sqr_gauss_param: float = 0.0009
    upsampling: str = "voxel_grid_dilation"  # none|sample_local_plane|random_uniform_density|voxel_grid_dilation
    slp_upsampling_radius: float = 0.05
    slp_upsampling_stepsize: float = 0.01
    rud_point_density: int = 50
    vgd_voxel_size: float = 0.001
    vgd_iterations: int = 4
    sor_mean_k: int = 60
    sor_std_dev: float = 0.7
    # TPU grid-hash parameters (no reference analogue: replaces kd-tree).
    max_neighbors: int = 32
    bucket_capacity: int = 32


@dataclass
class NIDConfig:
    """`visual_camera_calibration.hpp:17-32` + `calibrate.cpp:52-60`."""

    bins: int = 16
    max_outer_iterations: int = 10
    max_inner_iterations: int = 64
    delta_trans_thresh: float = 0.01  # metres
    delta_rot_thresh_deg: float = 1.0  # degrees (0.01745 rad in hpp:24)
    # Trust region guard (visual_camera_calibration.cpp:102)
    trust_region_trans: float = 0.2
    trust_region_rot_deg: float = 2.0
    # Re-run occlusion culling at the corrected pose between outer
    # iterations (runner-level host loop; visibility masks update, point
    # coordinates stay in the raw keyframe camera frame so the correction
    # composition is unchanged). The reference never re-culls — it reloads
    # the same culled clouds every outer iter
    # (visual_camera_calibration.cpp:160-167) — so default False.
    recull_every_outer_iter: bool = False
    # Solve an independent correction per keyframe (the TPU-native
    # generalization of per-keyframe manual poses, FrameData.cpp:31-34)
    # instead of the reference's single shared correction.
    per_keyframe: bool = False
    # Coarse-to-fine schedule (no reference analogue; opt/refine.py): run
    # the first N outer solves on every coarse_stride-th point (objective
    # evaluations are gather-bound, so a 4x subsample is ~3-4x cheaper),
    # then ALWAYS finish at full resolution with identical convergence
    # criteria. 0 = off (reference-faithful default).
    coarse_outer_iterations: int = 0
    coarse_stride: int = 4
    # Guarded frozen-tap gather (no reference analogue; opt/nid.TapCache):
    # reuse the tap-table row gather — ~70% of an objective evaluation —
    # across evaluations whose anchor pixels haven't drifted, re-gathering
    # once >frozen_guard_frac of live points move >=1 px (or >0.1% move
    # >=2 px — measured error at the default guard is ~1e-4 NID, gradient
    # cosine 1.0000; see opt/nid.multi_nid_loss_cached). The solve descends
    # a guard-bounded surrogate; the reported NID is always a fresh exact
    # evaluation. False = reference-faithful (gather every evaluation).
    frozen_taps: bool = False
    frozen_guard_frac: float = 0.25
    # Partial (drifted-blocks-only) cache refresh capacity, as a fraction of
    # each keyframe's 128-point blocks (opt/nid._partial_refresh_taps):
    # refreshes whose dirty-block count fits re-gather only those blocks —
    # bit-identical cache for every live point, drift-proportional cost.
    # 0 disables (round-4 behavior: every refresh re-gathers all rows).
    frozen_partial_frac: float = 0.0
    # Wide frozen-cache window margin in pixels (0..2; opt/nid
    # build_wide_tap_table): cache (4+2m)^2 tap windows so anchors may
    # drift +-m px with an exact VPU sub-window select before any refresh
    # is needed. 0 = round-4 behavior (4x4 rows, 1 px guard).
    frozen_margin: int = 0
    # Warm-start each inner BFGS with the previous solve's inverse-Hessian
    # (outer iterations re-solve the same objective from a nearby pose;
    # Ceres restarts from identity every ceres::Solve, :204-233).
    carry_hessian: bool = False
    # Relative function-decrease inner-solve exit (Ceres function_tolerance
    # semantics); 0 disables.
    ftol: float = 0.0
    # Pose-graph fusion of the per-keyframe corrections with the VO chain
    # (opt/pose_graph.py): non-converged refinements ride the odometry,
    # converged ones pull the trajectory. Only used with per_keyframe.
    smooth_trajectory: bool = False
    smooth_odo_weight: float = 10.0
    smooth_abs_weight: float = 1.0


@dataclass
class PnPConfig:
    """2D-3D pose estimation (`estimate_pose.hpp:11-19` defaults)."""

    ransac_iterations: int = 8192
    error_thresh_px: float = 5.0
    cauchy_kernel_px: float = 10.0
    lsq_iterations: int = 20
    seed: int = 8192


@dataclass
class FusionConfig:
    """Multi-view color fusion (`PointCloudProcessor.cpp:557-629`)."""

    top_k: int = 5  # :615
    optimal_distance: float = 2.0  # hpp:227
    score_floor: float = 0.2  # hpp:218,234 — scores mapped to [0.2, 1]
    saturation_scale: float = 1.0  # :727
    brightness_scale: float = 1.0  # :728
    # The reference mixes world/camera frames in computeOrientationScore
    # (hpp:205-220: point is camera-frame, camera position world-frame).
    # False = geometrically intended score (angle between camera ray and
    # optical axis); True = replicate the reference arithmetic exactly.
    reference_compat_orientation: bool = False
    drop_uncolored: bool = True  # removePointsWithNoColor (hpp:238-252)
    mask_highlight_value: int = 255  # generateSegmentMap :806 paints label 255 red
    # Post-fusion spatial color smoothing (smoothColorsWithLocalRegion,
    # :634-703); 0 disables (the reference's default path uses only the
    # top-K blend).
    local_smoothing_radius: float = 0.0


@dataclass
class PipelineConfig:
    point_cloud_path: str = ""
    odometry_path: str = ""
    images_folder: str = ""
    mask_image_folder: str = ""
    output_path: str = ""
    enable_mls: bool = False
    enable_nid_optimize: bool = False
    enable_manual_guess: bool = False  # GUI-free: consumes picked 2D-3D pairs
    # Stage checkpoint/resume: reuse on-disk stage artifacts when present
    # (scans-crop[_mls].pcd, nid_correction.json) instead of recomputing —
    # the explicit version of the reference's implicit file-based restart
    # points (SURVEY §5: `PointCloudProcessor.cpp:131-136`, `cloudSmooth.cpp:180`).
    resume: bool = False
    # Observability (utils/profiling.py): torch.profiler capture directory and
    # JSONL metrics path ("auto" = <output_path>/metrics.jsonl, "" = off).
    profile_trace_dir: str = ""
    metrics_path: str = "auto"
    # JSON of picked correspondences for the manual-guess path (see
    # pipeline/manual_guess.py for the schema); the headless stand-in for the
    # reference's interactive picker (`initial_guess_manual.hpp:29-355`).
    correspondences_path: str = ""
    crop_padding: float = 2.0  # PointCloudProcessor.cpp:106

    # Static capacities (XLA shapes). Clouds are padded to these.
    map_capacity: int = 2_000_000
    culled_capacity: int = 262_144
    max_keyframes: int = 64

    camera: CameraConfig = field(default_factory=CameraConfig)
    extrinsic: ExtrinsicConfig = field(default_factory=ExtrinsicConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    culling: CullingConfig = field(default_factory=CullingConfig)
    mls: MLSConfig = field(default_factory=MLSConfig)
    nid: NIDConfig = field(default_factory=NIDConfig)
    pnp: PnPConfig = field(default_factory=PnPConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        return _from_dict(cls, raw)


def _from_dict(cls, raw):
    if not dataclasses.is_dataclass(cls):
        return raw
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        val = raw[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type in _NESTED
        ):
            sub = _NESTED[f.type] if isinstance(f.type, str) else f.type
            kwargs[f.name] = _from_dict(sub, val)
        else:
            kwargs[f.name] = val
    return cls(**kwargs)


_NESTED = {
    "CameraConfig": CameraConfig,
    "ExtrinsicConfig": ExtrinsicConfig,
    "KeyframeConfig": KeyframeConfig,
    "CullingConfig": CullingConfig,
    "MLSConfig": MLSConfig,
    "NIDConfig": NIDConfig,
    "PnPConfig": PnPConfig,
    "FusionConfig": FusionConfig,
}
