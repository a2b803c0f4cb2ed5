#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pointcloudprocessor_tpu_torch) on
one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for matmuls and cuDNN.
2. Build: compiles the three kernel libraries (csrc/nid_hist.cu: K1/K2,
   csrc/tap_gather.cu: K3/K4, csrc/zbuffer.cu: K5 zmin and zbuffer_visible)
   with nvcc for sm_90a, one nvcc each, started together, from the sources
   in this checkout.
3. K1/K2 against their plain torch twins at the main path's shape (K=8
   keyframes x N=262,144 points, ~30% gated out, s uniform in [-1.5, 2.5],
   inputs from a numpy seed): histogram, NID value and s-gradient errors,
   and median times over 20 calls (CUDA events).
4. Main path at the reference's scale: the bench scene
   (pointcloudprocessor_tpu_torch/tools/bench_scene.py: 4096x3000 images,
   a 1,000,000-point wall + occluder map, 8 yawing keyframes, a planted
   odometry error T0, a left-half segmentation mask per keyframe) written
   to disk, then the port's ``runner.process(cfg, "cuda")`` under the
   headline NID schedule (bench.py:797-805: 2 outer x 20 inner,
   coarse-to-fine stride 16, frozen taps with guard 0.75, ftol 3e-4).
   Asserts the recovered correction is within 1 cm / 1 degree of T0, a
   finite NID, colored points whose colors follow the rendered texture, K1/K2
   launches, and 16 launches each of zmin and zbuffer_visible (8 culls + 8
   colorize observations).
5. K3/K4 against their twins on the scene's own 8 x 4096x3000 tap tables,
   the culled points raster-sorted at the start pose: gathers at that pose
   (fast path) and at T0 (overflow; fallback), bit-exact against the twin
   and the direct take, with median times of kernel, twin and direct take.
6. The grouped path: the frozen-tap solve (2 x 20, guard 0.75, ftol 3e-4,
   raster sort, no coarse phase) with the direct take, K3 and K4; K3 and K4
   launch, the three final NIDs agree within 1e-3, each recovers T0.
7. K5/Z1: ``zmin_tiles`` (the K5 form) bit-equal to its twin at the probe's
   full size (999,424 points, 62,995 cells, ranges with negatives and
   zeros, 1% of cells out of range); ``cull_world_points`` kernel masks
   bit-equal to the twin's on the scene's 8 keyframes; median times of
   zmin, its twin, the twin with its gather, zbuffer_visible and its twin.
8. The mask path: ``runner.process`` under the headline schedule with the
   mask folder set. Asserts what tests/test_pipeline_e2e.py's
   test_e2e_with_masks asserts (labels follow the mask, highlighted points
   are red, one dump per keyframe, the accumulated cloud is the sum of the
   dumps) and 24 launches each of zmin and zbuffer_visible (+8 dumps).
9. The earlier path: ``runner.process`` under the plain objective (2 outer
   x 20 inner), as in phase 4 otherwise.
10. Tools at full scale: ``tools/colorize_anatomy`` and
   ``tools/zbuffer_probe``, each printing its JSON line; both must report
   non-null kernel times and exact masks / buffers.

The launch counts are set to 0 just before each path and read just after.
The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. The script imports nothing of jax
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "pointcloudprocessor_tpu_torch"

# Main-path shapes: bench.py's full scale (tools/bench_scene.py holds the
# scene itself).
WIDTH, HEIGHT, N_MAP, N_CULL, K = 4096, 3000, 1_000_000, 262_144, 8
SEED = 0
# NID schedules: the headline (bench.py:797-805) and the plain objective
# (frozen taps and coarse-to-fine off). 20 inner iterations as in bench.py's
# e2e config: with 10, the plain schedule's second outer solve moves less
# than the 1 cm / 1 deg outer threshold and stops about 1.06 cm from T0, in
# the JAX package as in this port (same scene, same card).
HEADLINE = dict(max_outer_iterations=2, max_inner_iterations=20, coarse_outer_iterations=1,
                coarse_stride=16, frozen_taps=True, frozen_guard_frac=0.75, ftol=3e-4)
PLAIN = dict(max_outer_iterations=2, max_inner_iterations=20)
# The K5 probe's full size (tools/zbuffer_probe.FULL): 999,424 points into
# the 293 x 215 cells of a 14x-downsampled 4096x3000 image.
PROBE_N, PROBE_CELLS = 999_424, 293 * 215


def phase_env():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    from pointcloudprocessor_tpu_torch.utils import profiling

    card = profiling.card()
    print(card)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    return card


def phase_build():
    """The three kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pointcloudprocessor_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    names = ("nid_hist", "tap_gather", "zbuffer")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(kbuild.build, names))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} libraries in parallel")
    for b in builds:
        print(f"build {b.name}: nvcc {b.seconds:.2f} s -> {os.path.relpath(b.path, REPO)}")
        print(b.ptxas.strip())


def _ms(t):
    return "not measured" if t is None else f"{t:.3f}"


def _median_ms(fn, device="cuda"):
    from pointcloudprocessor_tpu_torch.utils import profiling

    return profiling.median_ms(fn, device)


def phase_kernels(card):
    """K1/K2 against the twin on the card; returns per-kernel records."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import nid_hist
    from pointcloudprocessor_tpu_torch.opt import nid

    dev = torch.device("cuda", 0)
    bins = 16
    rng = np.random.default_rng(SEED)
    taps = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (K, N_CULL, 2), dtype=np.int64).astype(np.int32)
    ).to(dev)
    s_np = rng.uniform(-1.5, 2.5, (K, N_CULL, 2)).astype(np.float32)
    s = torch.from_numpy(s_np).to(dev)
    bp = torch.from_numpy(rng.integers(0, bins, (K, N_CULL)).astype(np.int32)).to(dev)
    il = torch.from_numpy((rng.uniform(size=(K, N_CULL)) > 0.3).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(K, bins, bins)).astype(np.float32)).to(dev)

    # K1: histograms. f32 summation-order class, scaled to the histogram:
    # |kernel - twin| <= 1e-5 * max|twin| (shared-memory atomics and the
    # twin's GEMM add the same ~180k weights per keyframe in other orders).
    h_k = nid_hist.hist_fwd_cuda(taps, s, bp, il, bins)
    h_t = nid_hist.joint_histogram_plain(taps, s, bp, il, bins)
    torch.cuda.synchronize()
    fwd_err = float((h_k - h_t).abs().max())
    fwd_tol = 1e-5 * float(h_t.abs().max())
    print(f"K1 nid_hist_fwd  max|kernel-twin| = {fwd_err:.3e}  (tol {fwd_tol:.3e}, "
          f"max|hist| {float(h_t.abs().max()):.1f})")
    assert fwd_err <= fwd_tol, "K1 disagrees with its twin"

    # K2 with one fixed upstream g: against autograd through the twin.
    st = s.clone().requires_grad_(True)
    ht = nid_hist.joint_histogram_plain(taps, st, bp, il, bins)
    (ds_t,) = torch.autograd.grad(torch.sum(g * ht), st, retain_graph=True)
    ds_k = nid_hist.hist_bwd_cuda(g, taps, s, bp, il, bins)
    torch.cuda.synchronize()
    bwd_err = float((ds_k - ds_t).abs().max())
    bwd_tol = 1e-5 * float(ds_t.abs().max())
    print(f"K2 nid_hist_bwd  max|kernel-twin| = {bwd_err:.3e}  (tol {bwd_tol:.3e})")
    assert bwd_err <= bwd_tol, "K2 disagrees with its twin"

    # The NID objective's value and s-gradient through both paths.
    levels = torch.arange(bins, device=dev)
    hp = torch.sum((bp[..., None] == levels).float() * il[..., None], dim=-2)
    num = il.sum(-1)

    def nid_sum(h):
        return torch.sum(nid.nid_from_histograms(h, h.sum(-2), hp, num))

    sk = s.clone().requires_grad_(True)
    vk = nid_sum(nid_hist.JointHistogram.apply(taps, sk, bp, il, bins))
    (gk,) = torch.autograd.grad(vk, sk)
    st2 = s.clone().requires_grad_(True)
    vt = nid_sum(nid_hist.joint_histogram_plain(taps, st2, bp, il, bins))
    (gt,) = torch.autograd.grad(vt, st2)
    nid_err = abs(vk.detach().item() - vt.detach().item())
    grad_err = float((gk - gt).abs().max())
    grad_tol = 1e-4 * float(gt.abs().max())
    print(f"NID sum over {K} keyframes: kernel {vk.detach().item():.7f} twin {vt.detach().item():.7f} "
          f"|diff| {nid_err:.2e} (tol 1e-5); max|ds diff| {grad_err:.3e} (tol {grad_tol:.3e})")
    assert nid_err <= 1e-5 and grad_err <= grad_tol, "NID value/gradient disagree"

    # Timings: median of 20 after warm-up, kernel / twin / kernel in one
    # call on one card.
    fwd_ms = _median_ms(lambda: nid_hist.hist_fwd_cuda(taps, s, bp, il, bins))
    fwd_plain = _median_ms(lambda: nid_hist.joint_histogram_plain(taps, s, bp, il, bins))
    bwd_ms = _median_ms(lambda: nid_hist.hist_bwd_cuda(g, taps, s, bp, il, bins))
    bwd_plain = _median_ms(
        lambda: torch.autograd.grad(torch.sum(g * ht), st, retain_graph=True)
    )
    fwd_ms2 = _median_ms(lambda: nid_hist.hist_fwd_cuda(taps, s, bp, il, bins))
    bwd_ms2 = _median_ms(lambda: nid_hist.hist_bwd_cuda(g, taps, s, bp, il, bins))
    print(f"[{card}] K1 fwd {K}x{N_CULL}: kernel {fwd_ms:.3f} / {fwd_ms2:.3f} ms, "
          f"twin {fwd_plain:.3f} ms")
    print(f"[{card}] K2 bwd {K}x{N_CULL}: kernel {bwd_ms:.3f} / {bwd_ms2:.3f} ms, "
          f"twin (autograd backward) {bwd_plain:.3f} ms")
    return [
        {
            "name": "nid_hist_fwd", "route": "cuda",
            "source": f"{PKG}/csrc/nid_hist.cu",
            "replaces": "pointcloudprocessor_tpu/ops/nid_hist.py:71",
            "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain,
        },
        {
            "name": "nid_hist_bwd", "route": "cuda",
            "source": f"{PKG}/csrc/nid_hist.cu",
            "replaces": "pointcloudprocessor_tpu/ops/nid_hist.py:112",
            "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain,
        },
    ]


def write_scene(root, device="cuda"):
    """The bench scene written to disk as the pipeline reads it: map.pcd,
    odometry with the planted error T0, one JPEG per keyframe ray-cast off
    the wall and the occluder on ``device``, and one segmentation mask PNG
    per keyframe, label 255 on the left half of the image (as
    tests/test_pipeline_e2e.py writes them). Returns T0."""
    from pointcloudprocessor_tpu_torch.io import native, pcd
    from pointcloudprocessor_tpu_torch.pipeline import ingest
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    t0 = time.perf_counter()
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    points, inten = bs.scene_map(N_MAP, WIDTH, HEIGHT, SEED)
    pcd.write(os.path.join(root, "map.pcd"), points, intensity=inten)

    quats, positions = bs.scene_trajectory(K)
    T0, op = bs.scene_odometry(K)
    times = 1700000000.0 + 0.1 * np.arange(K)
    with open(os.path.join(root, "vo_interpolated_odom.txt"), "w") as f:
        for i in range(K):
            t, q = op.t[i].tolist(), op.q[i].tolist()
            f.write(f"{times[i]:.6f} {t[0]!r} {t[1]!r} {t[2]!r} "
                    f"{q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r}\n")

    mask = np.zeros((HEIGHT, WIDTH), np.uint8)
    mask[:, : WIDTH // 2] = 255
    import torch

    for i in range(K):
        gray = bs.render_gray(torch.from_numpy(quats[i]).to(device),
                              torch.from_numpy(positions[i]).to(device), WIDTH, HEIGHT)
        img = np.repeat(gray.cpu().numpy()[..., None], 3, axis=-1)
        stem = ingest.cpp_timestamp(times[i])
        name = os.path.join(root, "images", stem + ".jpg")
        mask_name = os.path.join(root, "masks", stem + ".png")
        try:
            import cv2

            codec = f"cv2 {cv2.__version__}"
            cv2.imwrite(name, img[:, :, ::-1])
            cv2.imwrite(mask_name, mask)
        except ImportError:
            from PIL import Image

            codec = "PIL"
            Image.fromarray(img).save(name, quality=95)
            Image.fromarray(mask).save(mask_name)
    print(f"scene written in {time.perf_counter() - t0:.1f} s: {N_MAP} points, {K} "
          f"{WIDTH}x{HEIGHT} JPEGs and PNG masks ({codec}); PCD codec: "
          f"{'native' if native.available() else 'numpy fallback'}")
    return T0


def _config(root, nid, masks=False):
    """The pipeline config of the smoke scene (bench.py's e2e config,
    `bench.py:768-806`, MLS off) with the given NIDConfig, and with the
    scene's mask folder if ``masks``."""
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    f_px = bs.focal(WIDTH)
    return cfg_mod.PipelineConfig(
        point_cloud_path=os.path.join(root, "map.pcd"),
        odometry_path=os.path.join(root, "vo_interpolated_odom.txt"),
        images_folder=os.path.join(root, "images"),
        mask_image_folder=os.path.join(root, "masks") if masks else "",
        output_path=os.path.join(root, "out"),
        enable_mls=False,
        enable_nid_optimize=True,
        crop_padding=12.0,  # keeps the z=6 wall inside the trajectory crop
        map_capacity=N_MAP,
        culled_capacity=N_CULL,
        max_keyframes=K,
        camera=cfg_mod.CameraConfig(
            intrinsic=(f_px, f_px, WIDTH / 2.0, HEIGHT / 2.0),
            distortion=(0.0,) * 5,
            width=WIDTH,
            height=HEIGHT,
        ),
        nid=nid,
    )


def _reset_counts():
    from pointcloudprocessor_tpu_torch.ops import nid_hist, tap_gather, zbuffer

    nid_hist.reset_launch_counts()
    tap_gather.reset_launch_counts()
    zbuffer.reset_launch_counts()


def _read_counts():
    from pointcloudprocessor_tpu_torch.ops import nid_hist, tap_gather, zbuffer

    return {**nid_hist.launch_counts, **tap_gather.launch_counts, **tap_gather.call_counts,
            **zbuffer.launch_counts}


def _pose_error(T, T0):
    from pointcloudprocessor_tpu_torch.core import se3

    dt, dr = se3.delta_magnitudes(se3.SE3(T.q.to("cpu"), T.t.to("cpu")), T0)
    return float(dt) * 100.0, float(np.degrees(float(dr)))


def phase_runner(card, root, T0, nid, label, device="cuda", masks=False):
    """``runner.process`` on the smoke scene under ``nid`` (with the mask
    folder if ``masks``), the launch counts set to 0 just before it and read
    just after. Asserts the planted error is recovered to 1 cm / 1 deg, a
    finite NID, colored points whose colors follow the rendered texture, the
    mask outputs (:func:`check_mask_outputs`), and on the card K1/K2
    launches and one zmin and one zbuffer_visible launch a cull: K for the
    NID keyframes, K for colorize, K more for the mask dumps."""
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.pipeline import runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    cfg = _config(root, nid, masks)
    shutil.rmtree(cfg.output_path, ignore_errors=True)
    _reset_counts()
    t0 = time.perf_counter()
    res = runner.process(cfg, device)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    with open(os.path.join(cfg.output_path, "metrics.jsonl")) as f:
        refined = [json.loads(line) for line in f if '"nid_refined"' in line][-1]

    err_cm, err_deg = _pose_error(res.T_correction, T0)
    print(f"[{card}] {label}: runner.process wall {wall:.2f} s; stages (s): "
          + json.dumps({k: round(v, 3) for k, v in res.timings.items()}))
    print(f"{label}: pose error vs planted T0: {err_cm:.4f} cm / {err_deg:.4f} deg; NID "
          f"{res.nid_value:.6f}; evaluations {res.nid_evaluations}; gathers "
          f"{refined['gathers']}; outer {res.nid_outer_iterations}; keyframes "
          f"{res.num_keyframes}; colored {res.num_colored_points}; launches {launches}")
    assert res.num_keyframes == K, res.num_keyframes
    assert np.isfinite(res.nid_value), res.nid_value
    assert err_cm < 1.0 and err_deg < 1.0, "refine did not recover the planted error"
    assert res.num_colored_points > 0
    if device == "cuda":
        assert launches["nid_hist_fwd"] > 0 and launches["nid_hist_bwd"] > 0, launches
        culls = (3 if masks else 2) * K
        assert launches["zmin"] == launches["zbuffer_visible"] == culls, (culls, launches)
    if masks:
        check_mask_outputs(res, cfg.output_path, label)

    # The written cloud: every colored point, colors in range, and the
    # colors carry the wall texture the images were rendered from. The bar
    # is "texture present", not "aligned": colorization composes the
    # correction as T_c2w ∘ T_correction (PointCloudProcessor.cpp:507), the
    # JAX package's convention, which on this scene shifts colors by about
    # twice the planted error (correlation ~0.85; ~0.97 with no correction,
    # ~0.999 with its inverse) — a reference-side fault recorded in
    # ROADMAP.md and kept here for parity.
    out = pcd.read(res.colored_cloud_path)
    assert len(out.points) == res.num_colored_points
    rgb = out.rgb
    assert np.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 255
    p = out.points
    on_wall = np.abs(p[:, 2] - bs.WALL_Z) < 1e-3
    corr = float(np.corrcoef(rgb[on_wall].mean(-1),
                             bs.field_wall(np, p[on_wall, 0], p[on_wall, 1]))[0, 1])
    print(f"{label}: wall color/texture correlation {corr:.4f} over {int(on_wall.sum())} points")
    assert corr > 0.8, corr
    return launches


def check_mask_outputs(res, out_dir, label):
    """What tests/test_pipeline_e2e.py's test_e2e_with_masks asserts, on the
    smoke scene: world points left of every keyframe's view centre (x <
    -0.5) carry label 255 and those right of it (x > 1.5) label 0,
    highlighted points are red, the jet-mapped cloud exists, one
    ``_rgb-mask.pcd`` dump per keyframe whose camera-frame labels follow the
    left-half mask, and the accumulated cloud holds exactly the dumps'
    points."""
    from pointcloudprocessor_tpu_torch.io import pcd

    out = pcd.read(res.mask_cloud_path)
    labels = out.mask_label
    assert labels is not None
    left = (labels[out.points[:, 0] < -0.5] == 255).mean()
    right = (labels[out.points[:, 0] > 1.5] == 0).mean()
    red = out.rgb[labels == 255]
    assert left > 0.9 and right > 0.9, (left, right)
    assert len(red) > 0 and (red[:, 0] == 255).all() and (red[:, 1:] == 0).all()
    assert os.path.exists(os.path.join(out_dir, "cloudInWorldWithMaskAndMappedColor.pcd"))
    filtered = os.path.join(out_dir, "filtered_pcd")
    dumps = sorted(d for d in os.listdir(filtered) if d.endswith("_rgb-mask.pcd"))
    assert len(dumps) == res.num_keyframes == K, dumps
    sizes = []
    for d in dumps:
        kf = pcd.read(os.path.join(filtered, d))
        sizes.append(len(kf.points))
        if len(sizes) == 1:
            assert kf.mask_label is not None and len(kf.points) > 500
            assert (kf.mask_label[kf.points[:, 0] < -0.3] == 255).mean() > 0.9
            assert (kf.mask_label[kf.points[:, 0] > 0.3] == 0).mean() > 0.9
    assert len(out.points) == sum(sizes), (len(out.points), sizes)
    print(f"{label}: mask cloud {len(out.points)} points = sum of {len(dumps)} dumps {sizes}; "
          f"label 255 on {left:.4f} of x < -0.5, 0 on {right:.4f} of x > 1.5; "
          f"{len(red)} highlighted points all red")


def scene_cloud(root, device="cuda"):
    """(cfg, camera, crop cloud, frames, keyframe indices) of the smoke
    scene, from the crop a runner.process call wrote."""
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.pipeline import ingest, keyframes, runner
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg = _config(root, cfg_mod.NIDConfig())
    camera = runner._make_camera(cfg, device)
    cloud = pcd.read_cloud(os.path.join(cfg.output_path, "scans-crop.pcd"), device,
                           capacity=cfg.map_capacity)
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    kf_idx = keyframes.select(ingest.frames_trajectory(frames), cfg.keyframes)[:K]
    return cfg, camera, cloud, frames, kf_idx


def scene_keyframes(root, device="cuda"):
    """The camera and the NID keyframes of the smoke scene, culled by the
    port's runner from the crop a runner.process call wrote."""
    from pointcloudprocessor_tpu_torch.pipeline import runner

    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    return camera, runner.build_nid_keyframes(camera, cloud, frames, kf_idx, cfg)


def phase_tap_gather(card, camera, kfs, T0, device="cuda"):
    """K3/K4 against their twins on the scene's 8 x 4096x3000 tables, the
    culled points raster-sorted at the start pose (identity): gathers at
    that pose (fast path expected) and at the planted error T0 (heavy
    overflow, fallback expected). Kernel, twin and the direct take agree
    bit for bit on every ok row. Returns per-kernel records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg
    from pointcloudprocessor_tpu_torch.opt import nid

    kfs = nid.sort_by_raster(camera, se3.identity(device),
                             nid.prepare_keyframes(kfs, build_slabs=True))
    k, r, _ = kfs.tap_rows.shape
    slab = kfs.tap_slabs.shape[-1] // 2
    rows = kfs.tap_rows.reshape(k * r, 2)
    variants = {
        "tap_select": (tg.plan_slabbed, tg.select_slabbed, tg.select_slabbed_plain,
                       tg.grouped_take_slabbed,
                       lambda p: (p.slabs2, p.slab_id, p.offs, slab),
                       lambda out: out.reshape(-1, 2)),
        "tap_streamed": (tg.plan_streamed, tg.select_streamed, tg.select_streamed_plain,
                         tg.grouped_take_streamed,
                         lambda p: (p.slabs2, p.blk0, p.rel, p.offs, slab),
                         lambda out: out.reshape(-1, 2, out.shape[-1]).transpose(1, 2).reshape(-1, 2)),
    }
    records = {}
    for pose_label, T in (("sort pose", se3.identity(device)), ("planted T0", T0.to(device))):
        _, knot, inl = nid._project_all(camera, T, kfs)
        flat = (nid._anchors(camera, knot)
                + torch.arange(k, dtype=torch.int32, device=device)[:, None] * r).reshape(-1)
        ok = inl.reshape(-1)
        n = flat.shape[0]
        direct = rows[flat.long()]
        for name, (plan_fn, kernel, twin, take, args, flat_out) in variants.items():
            p = plan_fn(kfs.tap_slabs, flat, ok, slab=slab)
            got_k = kernel(*args(p))
            got_t = twin(*args(p))
            err = float((got_k.long() - got_t.long()).abs().max())
            assert err == 0.0, f"{name}: kernel and twin differ by up to {err}"
            n_ovf = int(p.ovf_grp.sum())
            group = p.idx_eff.shape[1]
            clean = (ok & ~p.ovf_grp.repeat_interleave(group)[:n])
            assert torch.equal(flat_out(got_k)[:n][clean], direct[clean]), f"{name}: kernel != take"
            _reset_counts()
            out = take(kfs.tap_slabs, flat, ok, slab=slab, lookup_rows=lambda i: rows[i.long()])
            counts = _read_counts()
            assert torch.equal(out[ok], direct[ok]), f"{name}: grouped take != direct take"
            fast = n_ovf <= p.f_rep
            if device == "cuda":  # the kernel launched exactly when the plan took the fast path
                assert counts[name] == int(fast), (name, counts)
            print(f"{name} at the {pose_label}: overflow groups {n_ovf} of {p.ovf_grp.numel()} "
                  f"(repair budget {p.f_rep}); {'fast path (kernel)' if fast else 'fallback (per-row lookup)'}; "
                  f"kernel == twin on all rows, == tap_rows[kf, anchor] on {int(ok.sum())} ok rows")
            if pose_label == "sort pose":
                assert fast, f"{name}: the fast path was expected at the sort pose"
                t_k = _median_ms(lambda: kernel(*args(p)), device)
                t_t = _median_ms(lambda: twin(*args(p)), device)
                t_d = _median_ms(lambda: rows[flat.long()], device)
                t_g = _median_ms(
                    lambda: take(kfs.tap_slabs, flat, ok, slab=slab, lookup_rows=lambda i: rows[i.long()]),
                    device)
                t_k2 = _median_ms(lambda: kernel(*args(p)), device)
                print(f"[{card}] {name} {k}x{n // k} points, slab {slab}: kernel {_ms(t_k)} / "
                      f"{_ms(t_k2)} ms, twin {_ms(t_t)} ms, direct take {_ms(t_d)} ms, whole "
                      f"grouped take (plan + kernel + repair) {_ms(t_g)} ms")
                records[name] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_t}
    return [
        {"name": "tap_select", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
         "replaces": "pointcloudprocessor_tpu/ops/tap_gather.py:95", **records["tap_select"]},
        {"name": "tap_streamed", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
         "replaces": "pointcloudprocessor_tpu/ops/tap_gather.py:343", **records["tap_streamed"]},
    ]


def phase_grouped(card, camera, kfs, T0, device="cuda"):
    """The frozen-tap solve with each tap gather (direct, K3, K4) from the
    start pose, raster-sorted there; no coarse phase (it would move the pose
    before the first grouped gather, `nid.py:469-486`). Returns the launch
    counts of each solve."""
    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import refine

    nids, counts = {}, {}
    for G in (False, True, "streamed"):
        _reset_counts()
        t0 = time.perf_counter()
        res = refine.refine_pose(
            camera, kfs, se3.identity(device), frozen_taps=True, frozen_guard_frac=0.75,
            max_outer_iterations=2, max_inner_iterations=20, ftol=3e-4, sort_points=True,
            use_grouped_gather=G,
        )
        nid_value = float(res.nid)
        wall = time.perf_counter() - t0
        counts[G] = _read_counts()
        err_cm, err_deg = _pose_error(res.T_camera_lidar, T0)
        nids[G] = nid_value
        print(f"[{card}] grouped path, use_grouped_gather={G!r}: refine {wall:.2f} s; NID "
              f"{nid_value:.6f}; error {err_cm:.4f} cm / {err_deg:.4f} deg; evaluations "
              f"{res.evaluations}; gathers {res.gathers}; counts {counts[G]}")
        assert np.isfinite(nid_value) and err_cm < 1.0 and err_deg < 1.0, G
    if device == "cuda":
        assert counts[True]["tap_select"] >= 1, counts[True]
        assert counts["streamed"]["tap_streamed"] >= 1, counts["streamed"]
    spread = max(nids.values()) - min(nids.values())
    print(f"grouped path: final NIDs spread {spread:.2e} (tol 1e-3)")
    assert spread <= 1e-3, nids
    return counts


def phase_zbuffer(card, root, device="cuda"):
    """K5/Z1: the K5 form against its twin at the probe's full size, the
    culls of the scene's keyframes against the twin, and times at the main
    path's shapes (keyframe 0 of the crop). Returns per-kernel records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.ops import zbuffer as zb
    from pointcloudprocessor_tpu_torch.pipeline import runner
    from pointcloudprocessor_tpu_torch.tools import zbuffer_probe as zp

    # The K5 form: ranges in [-5, 12) with 5% exact zeros, half of them
    # -0.0, 1% of the cells outside the (rows, 128) buffer (dropped by both).
    rs = np.random.default_rng(SEED)
    slots = zp.n_rows(PROBE_CELLS) * 128
    cell_np = rs.integers(0, PROBE_CELLS, PROBE_N).astype(np.int32)
    far = rs.uniform(size=PROBE_N) < 0.01
    cell_np[far] = rs.choice(np.asarray([-1, -7, slots, slots + 5, 2**31 - 1], np.int32), int(far.sum()))
    rng_np = rs.uniform(-5.0, 12.0, PROBE_N).astype(np.float32)
    zero = rs.uniform(size=PROBE_N) < 0.05
    rng_np[zero] = np.where(rs.uniform(size=int(zero.sum())) < 0.5, -0.0, 0.0).astype(np.float32)
    cell, rng = torch.from_numpy(cell_np).to(device), torch.from_numpy(rng_np).to(device)
    buf_k = zp.zmin_tiles(cell, rng, PROBE_CELLS)
    buf_t = zp.zmin_tiles(cell, rng, PROBE_CELLS, plain=True)
    n_diff = int((buf_k.view(torch.int32) != buf_t.view(torch.int32)).sum())
    zmin_err = float((buf_k - buf_t).abs().max())
    print(f"K5 zmin_tiles {PROBE_N} points / {PROBE_CELLS} cells -> {tuple(buf_k.shape)}: "
          f"{n_diff} slots differ from the twin (bit-equal required); {int((buf_t < 0).sum())} "
          f"negative and {int((buf_t == 0).sum())} zero minima from {int(np.signbit(rng_np[zero]).sum())} "
          f"-0.0 and {int((~np.signbit(rng_np[zero])).sum())} +0.0 ranges, {int(far.sum())} points "
          "out of range")
    assert n_diff == 0, "K5 disagrees with its twin"

    # Z1 on the scene: the runner's culls, kernel against twin.
    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    ds, eps = cfg.culling.downsample_factor, cfg.culling.depth_epsilon
    poses = runner._camera_to_world(frames, kf_idx, None, device)
    vis_err, n_differ, n_vis = 0.0, 0, []
    for j in range(len(kf_idx)):
        T_w2c = se3.inverse(se3.SE3(poses.q[j], poses.t[j]))
        pts_cam, mask_k = zb.cull_world_points(camera, T_w2c, cloud.points, cloud.valid, ds, eps)
        u, v = cam.project_uv(camera, pts_cam)
        x, y, z = pts_cam.unbind(-1)
        r = torch.sqrt(x * x + y * y + z * z)
        mask_t = zb.cull_mask_uv_plain(camera, u, v, z, r, cloud.valid, ds, eps)
        # Masks as 0/1: the largest |kernel - twin| is 0 or 1; the count says how many.
        vis_err = max(vis_err, float((mask_k.float() - mask_t.float()).abs().max()))
        n_differ += int((mask_k != mask_t).sum())
        n_vis.append(int(mask_k.sum()))
        if j == 0:
            first = (u, v, z, r)
    print(f"Z1 cull_world_points on {len(kf_idx)} keyframes of {cloud.points.shape[0]} points: "
          f"visible {n_vis}; {n_differ} mask bits differ from the twin (bit-equal required)")
    assert n_differ == 0, "Z1 disagrees with its twin"

    # Times at keyframe 0's shapes, in turns.
    u, v, z, r = first
    ok, cell0, n_cells = zb.cells(camera, u, v, z, cloud.valid, ds)
    big = float(torch.finfo(torch.float32).max)
    r_m = torch.where(ok, r, big)
    buf0 = zb.zmin(cell0, r_m, big, n_cells + 1)
    t = {
        "zmin": _median_ms(lambda: zb.zmin(cell0, r_m, big, n_cells + 1), device),
        "zmin twin": _median_ms(lambda: zb.zmin_plain(cell0, r_m, big, n_cells + 1), device),
        "zmin twin + gather": _median_ms(
            lambda: zb.zmin_plain(cell0, r_m, big, n_cells + 1)[cell0.long()], device),
        "visible": _median_ms(lambda: zb.visible(ok, r, buf0, cell0, eps), device),
        "visible twin": _median_ms(lambda: zb.visible_plain(ok, r, buf0, cell0, eps), device),
        "cull (zmin + visible + gate)": _median_ms(
            lambda: zb.cull_mask_uv(camera, u, v, z, r, cloud.valid, ds, eps), device),
        "cull twin": _median_ms(
            lambda: zb.cull_mask_uv_plain(camera, u, v, z, r, cloud.valid, ds, eps), device),
        "zmin again": _median_ms(lambda: zb.zmin(cell0, r_m, big, n_cells + 1), device),
    }
    print(f"[{card}] K5/Z1 at {cell0.shape[0]} points, {n_cells + 1} slots (ms): "
          + ", ".join(f"{k} {_ms(v)}" for k, v in t.items()))
    return [
        {"name": "zmin", "route": "cuda", "source": f"{PKG}/csrc/zbuffer.cu",
         "replaces": "pointcloudprocessor_tpu/tools/zbuffer_probe.py:42",
         "max_abs_err": zmin_err, "ms": t["zmin"], "plain_ms": t["zmin twin"]},
        {"name": "zbuffer_visible", "route": "cuda", "source": f"{PKG}/csrc/zbuffer.cu",
         "replaces": "pointcloudprocessor_tpu/ops/zbuffer.py:69",
         "max_abs_err": vis_err, "mismatches": n_differ, "ms": t["visible"],
         "plain_ms": t["visible twin"]},
    ]


def phase_tools(device="cuda"):
    """The z-buffer tools at full scale on the card (``--quick`` off it):
    each prints its JSON line; both must be exact, with kernel times."""
    from pointcloudprocessor_tpu_torch.tools import colorize_anatomy, zbuffer_probe

    argv = [] if device == "cuda" else ["--quick", "--device", device]
    anatomy = colorize_anatomy.main(argv)
    probe = zbuffer_probe.main(argv)
    assert anatomy["exact"] and probe["exact"], (anatomy, probe)
    if device == "cuda":
        assert anatomy["zbuffer_scatter"] is not None and probe["kernel_ms"] is not None, (
            anatomy, probe)


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke.py: {PKG}/ not found beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    card = phase_env()
    phase_build()
    kernels = phase_kernels(card)
    root = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(root, ignore_errors=True)
    try:
        T0 = write_scene(root)
        # Main path: the headline schedule (bench.py:797-805).
        launches = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE), "headline schedule")
        camera, kfs = scene_keyframes(root)
        kernels += phase_tap_gather(card, camera, kfs, T0)
        grouped = phase_grouped(card, camera, kfs, T0)
        del kfs
        kernels += phase_zbuffer(card, root)
        # The mask path under the headline schedule.
        phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE), "mask path", masks=True)
        # The earlier path: the plain objective (2 outer x 20 inner).
        phase_runner(card, root, T0, cfg_mod.NIDConfig(**PLAIN), "plain schedule")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_tools()
    launches.update(tap_select=grouped[True]["tap_select"],
                    tap_streamed=grouped["streamed"]["tap_streamed"])
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
