#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pointcloudprocessor_tpu_torch) on
one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for matmuls and cuDNN.
2. Build: compiles both kernel libraries (csrc/nid_hist.cu: K1/K2,
   csrc/tap_gather.cu: K3/K4) with nvcc for sm_90a, one nvcc each, started
   together, from the sources in this checkout.
3. K1/K2 against their plain torch twins at the main path's shape (K=8
   keyframes x N=262,144 points, ~30% gated out, s uniform in [-1.5, 2.5],
   inputs from a numpy seed): histogram, NID value and s-gradient errors,
   and median times over 20 calls (CUDA events).
4. Main path at the reference's scale: a synthetic scene (4096x3000
   images, a 1,000,000-point wall + occluder map, 8 yawing keyframes, a
   planted odometry error T0) written to disk, then the port's
   ``runner.process(cfg, "cuda")`` under the headline NID schedule
   (bench.py:797-805: 2 outer x 20 inner, coarse-to-fine stride 16, frozen
   taps with guard 0.75, ftol 3e-4). Asserts the recovered correction is
   within 1 cm / 1 degree of T0, a finite NID, colored points whose colors
   follow the rendered texture, and K1/K2 launches in the run.
5. K3/K4 against their twins on the scene's own 8 x 4096x3000 tap tables,
   the culled points raster-sorted at the start pose: gathers at that pose
   (fast path) and at T0 (overflow; fallback), bit-exact against the twin
   and the direct take, with median times of kernel, twin and direct take.
6. The grouped path: the frozen-tap solve (2 x 20, guard 0.75, ftol 3e-4,
   raster sort, no coarse phase) with the direct take, K3 and K4; K3 and K4
   launch, the three final NIDs agree within 1e-3, each recovers T0.
7. The earlier path: ``runner.process`` under the plain objective (2 outer
   x 20 inner), as in phase 4 otherwise.

The launch counts are set to 0 just before each path and read just after.
The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. The script imports nothing of jax
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "pointcloudprocessor_tpu_torch"

# Main-path shapes (bench.py's full scale) and the scene of bench.py:101-254.
WIDTH, HEIGHT, N_MAP, N_CULL, K = 4096, 3000, 1_000_000, 262_144, 8
F_PX = 4818.2
WALL_Z, OCC_Z = 6.0, 2.5
OCC_X, OCC_Y = (0.3, 1.5), (-0.6, 0.6)
T0_TANGENT = (0.02, -0.01, 0.01, 0.004, -0.002, 0.004)
SEED = 0
# NID schedules: the headline (bench.py:797-805) and the plain objective
# (frozen taps and coarse-to-fine off). 20 inner iterations as in bench.py's
# e2e config: with 10, the plain schedule's second outer solve moves less
# than the 1 cm / 1 deg outer threshold and stops about 1.06 cm from T0, in
# the JAX package as in this port (same scene, same card).
HEADLINE = dict(max_outer_iterations=2, max_inner_iterations=20, coarse_outer_iterations=1,
                coarse_stride=16, frozen_taps=True, frozen_guard_frac=0.75, ftol=3e-4)
PLAIN = dict(max_outer_iterations=2, max_inner_iterations=20)


def _field_wall(x, y):
    return np.clip(0.5 + 0.25 * np.sin(7.0 * x) + 0.25 * np.cos(9.0 * y), 0.0, 1.0)


def _field_occ(x, y):
    return np.clip(
        0.5 + 0.25 * np.sin(13.0 * x + 1.0) + 0.25 * np.cos(11.0 * y + 2.0), 0.0, 1.0
    )


def phase_env():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not measured"
    print(card)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    return card


def phase_build():
    """Both kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pointcloudprocessor_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    names = ("nid_hist", "tap_gather")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(kbuild.build, names))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} libraries in parallel")
    for b in builds:
        print(f"build {b.name}: nvcc {b.seconds:.2f} s -> {os.path.relpath(b.path, REPO)}")
        print(b.ptxas.strip())


def _ms(t):
    return "not measured" if t is None else f"{t:.3f}"


def _median_ms(fn, device="cuda", reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` in ms; None off the card."""
    import torch

    if device != "cuda":
        return None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def scene_map():
    """The bench scene's map (bench.py:101-254, scene 1) in numpy: (N_MAP, 3)
    f32 points on the wall and the occluder, and their f32 intensities."""
    rng = np.random.default_rng(SEED)
    f_px = F_PX * (WIDTH / 4096.0)
    n_occ = N_MAP // 8
    n_wall = N_MAP - n_occ
    half_x = (WIDTH / 2.0) / f_px * WALL_Z
    half_y = (HEIGHT / 2.0) / f_px * WALL_Z
    wx = rng.uniform(-half_x - 0.6, half_x + 1.6, n_wall).astype(np.float32)
    wy = rng.uniform(-half_y - 0.2, half_y + 0.2, n_wall).astype(np.float32)
    ox = rng.uniform(OCC_X[0], OCC_X[1], n_occ).astype(np.float32)
    oy = rng.uniform(OCC_Y[0], OCC_Y[1], n_occ).astype(np.float32)
    points = np.concatenate([
        np.stack([wx, wy, np.full_like(wx, WALL_Z)], -1),
        np.stack([ox, oy, np.full_like(ox, OCC_Z)], -1),
    ])
    inten = np.concatenate([_field_wall(wx, wy), _field_occ(ox, oy)]).astype(np.float32)
    return points, inten


def scene_trajectory():
    """Keyframe poses P_i (wxyz quaternions and positions, f32): +x
    translation, yaw about y from -4 to 4 degrees."""
    kf_x = 0.12 * np.arange(K, dtype=np.float32)
    yaw = np.radians(np.linspace(-4.0, 4.0, K)).astype(np.float32)
    quats = np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.sin(yaw / 2), np.zeros_like(yaw)], -1
    ).astype(np.float32)
    positions = np.stack([kf_x, np.zeros_like(kf_x), np.zeros_like(kf_x)], -1)
    return quats, positions


def scene_odometry():
    """The odometry the scene writes: (T0, O_i = P_i ∘ T0 as an SE3 batch),
    the planted error of bench.py:734-749."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3

    quats, positions = scene_trajectory()
    T0 = se3.exp(torch.tensor(T0_TANGENT, dtype=torch.float32))
    return T0, se3.compose(se3.SE3(torch.from_numpy(quats), torch.from_numpy(positions)), T0)


def write_scene(root):
    """The bench scene written to disk as the pipeline reads it: map.pcd,
    odometry with the planted error (:func:`scene_odometry`), one JPEG per
    keyframe ray-cast off the wall and the occluder."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.io import native, pcd
    from pointcloudprocessor_tpu_torch.pipeline import ingest

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    f_px = F_PX * (WIDTH / 4096.0)
    points, inten = scene_map()
    pcd.write(os.path.join(root, "map.pcd"), points, intensity=inten)

    quats, positions = scene_trajectory()
    T0, op = scene_odometry()
    times = 1700000000.0 + 0.1 * np.arange(K)
    with open(os.path.join(root, "vo_interpolated_odom.txt"), "w") as f:
        for i in range(K):
            t, q = op.t[i].tolist(), op.q[i].tolist()
            f.write(f"{times[i]:.6f} {t[0]!r} {t[1]!r} {t[2]!r} "
                    f"{q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r}\n")

    # Ray-cast each keyframe's image off the wall and the occluder.
    uu = ((np.arange(WIDTH, dtype=np.float32) - WIDTH / 2.0) / f_px)[None, :]
    vv = ((np.arange(HEIGHT, dtype=np.float32) - HEIGHT / 2.0) / f_px)[:, None]
    R = se3.quat_to_matrix(torch.from_numpy(quats)).numpy()
    for i in range(K):
        Ri, t = R[i], positions[i]
        dx = uu * Ri[0, 0] + vv * Ri[0, 1] + Ri[0, 2]
        dy = uu * Ri[1, 0] + vv * Ri[1, 1] + Ri[1, 2]
        dz = uu * Ri[2, 0] + vv * Ri[2, 1] + Ri[2, 2]
        s_occ = (OCC_Z - t[2]) / dz
        hx, hy = t[0] + s_occ * dx, t[1] + s_occ * dy
        hit = (hx >= OCC_X[0]) & (hx <= OCC_X[1]) & (hy >= OCC_Y[0]) & (hy <= OCC_Y[1])
        s_wall = (WALL_Z - t[2]) / dz
        gray = np.where(hit, _field_occ(hx, hy), _field_wall(t[0] + s_wall * dx, t[1] + s_wall * dy))
        img = np.repeat((gray * 255.0).astype(np.uint8)[..., None], 3, axis=-1)
        name = os.path.join(root, "images", ingest.cpp_timestamp(times[i]) + ".jpg")
        try:
            import cv2

            codec = f"cv2 {cv2.__version__}"
            cv2.imwrite(name, img[:, :, ::-1])
        except ImportError:
            from PIL import Image

            codec = "PIL"
            Image.fromarray(img).save(name, quality=95)
    print(f"scene written in {time.perf_counter() - t0:.1f} s: {N_MAP} points, {K} "
          f"{WIDTH}x{HEIGHT} JPEGs ({codec}); PCD codec: "
          f"{'native' if native.available() else 'numpy fallback'}")
    return T0


def _config(root, nid):
    """The pipeline config of the smoke scene (bench.py's e2e config,
    `bench.py:768-806`, MLS off) with the given NIDConfig."""
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    f_px = F_PX * (WIDTH / 4096.0)
    return cfg_mod.PipelineConfig(
        point_cloud_path=os.path.join(root, "map.pcd"),
        odometry_path=os.path.join(root, "vo_interpolated_odom.txt"),
        images_folder=os.path.join(root, "images"),
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
    from pointcloudprocessor_tpu_torch.ops import nid_hist, tap_gather

    nid_hist.reset_launch_counts()
    tap_gather.reset_launch_counts()


def _read_counts():
    from pointcloudprocessor_tpu_torch.ops import nid_hist, tap_gather

    return {**nid_hist.launch_counts, **tap_gather.launch_counts, **tap_gather.call_counts}


def _pose_error(T, T0):
    from pointcloudprocessor_tpu_torch.core import se3

    dt, dr = se3.delta_magnitudes(se3.SE3(T.q.to("cpu"), T.t.to("cpu")), T0)
    return float(dt) * 100.0, float(np.degrees(float(dr)))


def phase_runner(card, root, T0, nid, label, device="cuda"):
    """``runner.process`` on the smoke scene under ``nid``, the launch counts
    set to 0 just before it and read just after. Asserts the planted error
    is recovered to 1 cm / 1 deg, a finite NID, colored points whose colors
    follow the rendered texture, and (on the card) K1/K2 launches."""
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.pipeline import runner

    cfg = _config(root, nid)
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
    on_wall = np.abs(p[:, 2] - WALL_Z) < 1e-3
    corr = float(np.corrcoef(rgb[on_wall].mean(-1), _field_wall(p[on_wall, 0], p[on_wall, 1]))[0, 1])
    print(f"{label}: wall color/texture correlation {corr:.4f} over {int(on_wall.sum())} points")
    assert corr > 0.8, corr
    return launches


def scene_keyframes(root, device="cuda"):
    """The camera and the NID keyframes of the smoke scene, culled by the
    port's runner from the crop a runner.process call wrote."""
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.pipeline import ingest, keyframes, runner
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg = _config(root, cfg_mod.NIDConfig())
    camera = runner._make_camera(cfg, device)
    cloud = pcd.read_cloud(os.path.join(cfg.output_path, "scans-crop.pcd"), device,
                           capacity=cfg.map_capacity)
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    kf_idx = keyframes.select(ingest.frames_trajectory(frames), cfg.keyframes)[:K]
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
        # The earlier path: the plain objective (2 outer x 20 inner).
        phase_runner(card, root, T0, cfg_mod.NIDConfig(**PLAIN), "plain schedule")
    finally:
        shutil.rmtree(root, ignore_errors=True)
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
