"""Offline tooling of the port (counterparts of `pointcloudprocessor_tpu/
tools/`), each runnable as ``python -m pointcloudprocessor_tpu_torch.tools.
<name>``. Tools that touch tensors take ``--device``, default ``cuda``.

Before the main path:

- :mod:`.vo_interp` — VO -> image-timestamp odometry resampler
  (`scripts/make_vo_odom_for_fastlio.py`), producing the pipeline's
  ``vo_interpolated_odom.txt`` input (slerp on the device).
- :mod:`.image_balance` — CLAHE + gamma + adaptive-gamma batch image
  balance (`scripts/image_color_balance_autonomous.py`; host).
- :mod:`.match_masks` — mask-PNG timestamp matcher (`src/extractMaskImg.py`;
  host).
- :mod:`.pick_tool` — static-HTML 2D-3D correspondence picker whose JSON
  drives ``--enableInitialGuessManual`` (projection on the device).

After the main path:

- :mod:`.nid_diagnostics` — intensity-histogram / NID sanity checks of a
  ``<ts>_beforeNID.pcd`` dump (`scripts/computeNidForCloudAndImage.py`; the
  NID through kernels B1, G1 and K1 on the card).
- :mod:`.crack_width` — 3D crack widths from ``filtered_pcd/`` and crack
  masks (`scripts/genNormAndDistanceMask.py`; normals through kernel S1 on
  the card).
- :mod:`.visualize` — TURBO-intensity overlay (on the device) and cloud
  snapshots.
- :mod:`.trajectory_plot` — trajectory-vs-cloud visual check
  (`scripts/gen_reconstruct_pose_plots.py`), headless PNG output (host).

Measurement tools (each on the card by default; ``--quick`` for a small
size; :mod:`.bench_scene` holds bench.py's scenes 1 and 2 and the analytic
keyframe cull they share):

- :mod:`.nid_bisect` — where one NID evaluation's time goes: wall, host,
  device busy, launches and host syncs of stripped-down variants, value+grad
  and the per-keyframe evaluation.
- :mod:`.nid_locality` — does raster order make an evaluation or a gather
  cheaper (G1, K3, K4, ``index_select`` of the tap table)?
- :mod:`.solver_sweep` — the ftol (or guard) sweep of the headline schedule
  on scenes 1 and 2: solve seconds, evaluations, pose error.
- :mod:`.frozen_guard_sweep` — the frozen-tap guard sweep: gathers, and the
  host syncs a re-gather costs.
- :mod:`.mls_anatomy` — the MLS pass by stage through the plain functions,
  beside the main path's ``knn.build`` + M1.
- :mod:`.mls_dedup_probe` — the dedup candidate fetch: cost and bit-equal
  output; it changes nothing in M1.
- :mod:`.scaling_bench` — the sharded solve + fuse over ``parallel/``
  (a world of 1 on one card; ``--virtual N`` Gloo CPU ranks).
- :mod:`.tap_cache_probe` — the row-width tax against G1 / G2, B1 in place
  of a wide table, the partial refresh's dirty blocks and cost.
- :mod:`.slab_gather_probe` — ``index_select`` by row width, and group
  spans and slab overflow of raster-sorted points.
- :mod:`.zbuffer_probe`, :mod:`.colorize_anatomy` and
  :mod:`.hpr_dense_probe` — the z-buffer, colorize and dense-HPR kernels
  against their plain versions.
"""
