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

Measurement tools: :mod:`.bench_scene` (the smoke run's scene),
:mod:`.zbuffer_probe`, :mod:`.colorize_anatomy` and
:mod:`.hpr_dense_probe`.
"""
