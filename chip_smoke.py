#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pointcloudprocessor_tpu_torch) on
one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for matmuls and cuDNN.
2. Build: compiles the eight kernel libraries (csrc/nid_hist.cu: K1/K2,
   csrc/tap_gather.cu: G1 tap_take, bin_pack, K3/K4, G2 wide_take, W1
   wide_select and the block forms tap_take_blocks and wide_take_blocks, csrc/zbuffer.cu: K5 zmin and
   zbuffer_visible, csrc/colorize.cu: C1 colorize_scatter and
   colorize_update, csrc/hpr.cu: H1 hpr_support and H2 hpr_grid,
   csrc/smooth.cu: N1 smooth_local, csrc/mls.cu: M1 mls_moments,
   csrc/sor.cu: S1 knn_select)
   with nvcc for sm_90a, one nvcc each, started together, from the sources
   in this checkout.
3. K1/K2 against their plain torch twins on the random set at the main
   path's fine shape (K=8 keyframes x N=262,144 points, uniform nibbles and
   point bins, ~30% gated out, s uniform in [-1.5, 2.5], inputs from a
   numpy seed): histogram, NID value and s-gradient errors; device, call
   and host times (median of 20 CUDA-event times; host time over 200 queued
   calls) beside each kernel's bound, each kernel twice. Then the same
   checks, untimed, on ragged random sets (3 x 1,037 and 8 x 262,143, where
   every other keyframe starts inside a pair of points; the first once more
   from pointers 8 bytes off 16-byte alignment, K1/K2's scalar-load path;
   12 bins, so taps 12-15 and point bins outside [0, 12) are dropped). After phase 4
   the same checks and times run on the scene's own evaluation inputs
   (``phase_kernels_scene``: the 8 keyframes projected at the start pose, at
   the headline's fine shape 8 x 262,144 and coarse shape 8 x 16,384, K2's
   upstream gradient the NID's own), with the count of points whose 16 taps
   hold 1, 2, 3 or more distinct bins.
4. Main path at the reference's scale: the bench scene
   (pointcloudprocessor_tpu_torch/tools/bench_scene.py: 4096x3000 images,
   a 1,000,000-point wall + occluder map, 8 yawing keyframes, a planted
   odometry error T0, a left-half segmentation mask per keyframe) written
   to disk, then the port's ``runner.process(cfg, "cuda")`` under the
   headline NID schedule (bench.py:797-805: 2 outer x 20 inner,
   coarse-to-fine stride 16, frozen taps with guard 0.75, ftol 3e-4).
   Asserts the recovered correction is within 1 cm / 1 degree of T0, a
   finite NID, colored points whose colors follow the rendered texture, K1/K2
   launches at both shapes (counted by points a keyframe), 8 launches each
   of zmin and zbuffer_visible (the NID culls), one of colorize_scatter
   (C1's pass (a) for the 8 colorize keyframes) and 8 of colorize_update
   (its pass (b), a keyframe each), one bin_pack a solve (the
   packed bin image; the solve's keyframes carry no tap table) and one G1
   tap_take a direct take: each coarse evaluation at 8 x 16,384, each
   frozen-tap gather and the final exact evaluation at 8 x 262,144 (26 + 5
   + 1 on the scene); prints the solve's peak device memory. Then the same
   run through the twins of C1 (``fuse(plain=True)``), G1 and the packer:
   the same pose, NID, counts and colored cloud, byte for byte.
4b. The tools path (``phase_tools_path``), on the headline run's own
   outputs, the launch counts set to 0 before and read after the tools: ``tools/nid_diagnostics`` on keyframe 0's
   ``<ts>_beforeNID.pcd`` (262,144 points) against its 4096x3000 JPEG
   with the scene's intrinsics (one ``bin_pack``, one ``tap_take`` and
   one ``nid_hist_fwd`` launch at K = 1, no ``nid_hist_bwd``); its NID
   equal bit for bit to ``multi_nid_loss`` of the same keyframe as a batch
   of one, and within 1e-5 (tests/test_torch_nid.py's tolerance) of the
   same report through the twins of B1, G1 and K1 on the card.
   ``tools/crack_width.process`` on the dumps of keyframes
   ``TOOLS_CRACK_KEYFRAMES``, each with a synthetic 4096x3000 crack mask
   (a band ``CRACK_BAND_PX`` wide, ``CRACK_LENGTH_PX`` long, across the
   wall): one ``knn_select`` (S1) launch a frame; S1's indices and flags
   bit-equal to its twin's (``chunked_radius_neighbors`` on the same card
   tensors), and the results JSON and normal masks equal to the same
   ``process`` with S1's twin (whose numpy morphology, the same on both
   runs, is replayed from the first run). ``tools/visualize overlay`` of
   keyframe 0's dump at 4096x3000: two card runs bit-equal; against the CPU
   run the differing pixels printed, those under a point whose projected
   pixel differs between the devices counted apart. ``tools/vo_interp`` on
   the scene's odometry: its times and positions (host f64) equal as text
   to the CPU run's, its quaternions (the slerp's f32 arccos and sin on the
   card) within 2 f32 ulp and the 8th decimal's rounding, the fields that
   differ counted;
   ``tools/pick_tool`` on keyframe 0. Each tool's wall is printed with the
   card's name and power limit (crack_width's split into the normals on
   the card and the host's numpy stages).
4c. The harness path (``phase_harnesses``), the launch counts set to 0
   before and read after: the nine measurement harnesses of ``tools/``
   (``nid_bisect``, ``nid_locality``, ``solver_sweep``,
   ``frozen_guard_sweep``, ``mls_anatomy``, ``mls_dedup_probe``,
   ``scaling_bench``, ``tap_cache_probe``, ``slab_gather_probe``), each its
   ``main`` at full scale (4096x3000, 1M map points, 8 x 262,144 culled
   points, the 1M-point MLS corner) with fewer repeats and sweep rows than
   its defaults (``HARNESS_ARGS``), printing its rows. Fails unless
   nid_bisect's value+grad equals ``multi_nid_loss`` at the same pose bit
   for bit, nid_locality's grouped, streamed and direct value+grad chains
   agree bit for bit, mls_dedup_probe's two plain passes (and M1 with and
   without dedup) are bit-identical, tap_cache_probe's partial and full
   refreshes give the same losses, slab_gather_probe's spans on the card
   equal the CPU's on the same anchors and scaling_bench's world of 1 over
   NCCL is bit-equal to the serial solve and fuse. Prints each harness's
   wall and the path's launches.
5. G1 and its packer (``phase_direct_take``) on the scene's keyframes in
   map order, as the headline's solve takes them: ``bin_pack`` bit-equal
   to its twin (also at 4095x2999, 1x1, 9x8, 13x21 and 97x401 and on an
   image 4 bytes off 16-byte alignment) and timed beside its bound; G1
   bit-equal to its twin and to ``tap_rows[kf,
   anchor]`` (the port's ``nid.build_tap_table``, held to the JAX package's
   on the CPU by tests/test_torch_tap_take.py; built for this check alone) on every
   point at the start pose and at T0, on the coarse subsample, at the sort
   pose, on edge knots (the image's borders, negative, +-1e9, the int32
   extremes), on a ragged n and on a 4095 x 2999 image (padded tiles); its
   device times at both shapes on map-order knots at T0, warm and with L2
   flushed, and at the sort pose, beside its twin and ``index_select`` of
   the table rows, and the bound (16 B a point and each distinct pixel the
   windows read at 4 bits; the whole-sector count of the 32-byte tiles
   they touch printed beside it). Then K3/K4 (each one launch; plan and select) on the
   scene's own 8 x 4096x3000 row tables, the culled points raster-sorted
   at the start pose: at that pose (clean groups; fast path) and at T0
   (overflow; fallback), each bit-equal to its twin on every row, flag and
   count (also with a masked step and a ragged point count), equal to the
   direct take on the ok rows of clean groups, and the whole grouped take
   equal to it
   on every ok row. Median times of the kernel, the twin,
   ``index_select``, the direct take with an int64 index and as
   ``_gather_taps`` pays it, the whole grouped take at the sort pose and at
   T0, and whole ``_gather_taps`` calls; the bound and its share.
6. The grouped path: the frozen-tap solve (2 x 20, guard 0.75, ftol 3e-4,
   raster sort, no coarse phase) with the direct take, K3 and K4, and once
   more with K3 and the slab table built at entry, as the grouped path held
   it before; peak device memory of each. K3 and K4 launch once per grouped
   take and fall back at least once; the final NIDs agree within 1e-3 and
   each recovers T0.
6b. The frozen-tap cache's kernels (``phase_wide_cache``) on the scene's
   8 x 262,144 points in map order, the cache gathered at T0, the pose
   drifted by 1.5 and 4.5 px, at margins 1 and 2: G2 ``wide_take``
   bit-equal to its twin (also on edge knots, a ragged n and a 4095 x 2999
   image), W1 ``wide_select`` bit-equal to its twin and, on every point
   live under both gates within the margin, to G1's direct take at the
   drifted knots; the block forms ``tap_take_blocks`` and
   ``wide_take_blocks`` bit-equal to their twins in place on the block
   list of a real drift. One launch a call each; device and call times
   beside the bound and the twin, G2's beside ``index_select`` on a wide
   table built once. Then ``phase_partial_solve``: ``refine_pose`` under
   the headline schedule with every refresh partial, bit-equal to the
   full-refresh solve (pose bits, NID, evaluations, gathers), margin 2
   beside margin 0 (NIDs within 1e-3; evaluations, gathers, wall and
   device time, peak memory), and margin 2 with every refresh partial and
   no coarse phase (G2's block form on a solve path). Then the smoke's
   correspondence file: 12 scene points a keyframe for 4 keyframes and
   their pixels through the planted correction (``write_picks``).
7. K5/Z1: ``zmin_tiles`` (the K5 form, cells given) bit-equal to its twin
   at the probe's full size (999,424 points, 62,995 cells, ranges with
   negatives and zeros, 1% of cells out of range). The fused cull (a
   memset of its key buffer, then two launches: ``zmin`` with the gate and
   cell fused in, ``zbuffer_visible``) bit-equal to ``cull_mask_uv_plain``
   through ``cull_world_points`` on the scene's 8 keyframes, all twice in a
   row, with a cull at another downsample factor between; on n = 0, a
   ragged n, inputs 4 bytes off 16-byte alignment and the edge set of
   ``tools/bench_scene.cull_edge_points`` (NaN and +-inf in u, v, z, edges
   of the image and the cells, a crowded cell), at both factors; and on a
   copy of keyframe 0 raster-sorted by cell; the mask bits that differ,
   summed over every cull checked. At keyframe 0: device and call times of
   the whole cull (map order, z strided, raster-sorted), each pass's device
   time (``torch.profiler``) beside its bound and beside its twin on the
   same inputs, an assertion of exactly two kernel launches and one memset
   a cull, and the same for step 0 (the eager gate, then ``zmin`` and
   ``zbuffer_visible`` with cells given), the cells-given twins and
   ``scatter_reduce_``.
7b. C1 (``phase_colorize``): ``colorize.fuse_keyframe`` bit-equal to its
   twin run on the card, every field of the fusion state after every
   keyframe, over the scene's 8 keyframes twice in a row at T0, both as
   ``fuse`` runs it (``depth_keys``: a memset and one ``colorize_scatter``
   for all the keyframes, then one ``colorize_update`` a keyframe against
   its keys) and a keyframe alone (a memset and both launches), the
   batched keys equal to each keyframe's own launch and, read as cell
   minima, to the twin's on every cell: without and with masks
   (labels from the seed), with HSV (0.7, 1.2), reference_compat and optimal
   distance 3.0, under HPR (H2, then pass (b) alone), on the edge set of
   ``bench_scene.cull_edge_points`` put in front of the camera, on a ragged
   n and n = 0; the mask dumps (``keyframe_rgb_mask``) bit-equal to theirs;
   the twin's divisions on the card against the CPU's on all 2^24 colors and
   the scene's scores (``c1_division_check``, with a Python-number divisor
   and with the twin's 0-dim tensor); over the 8 keyframes from an empty
   state, as ``fuse`` runs them (the slots fill, then replace; one memset,
   one pass (a) and 8 pass (b) launches asserted), pass (a)'s one launch
   and pass (b)'s mean device time beside their bounds counted from those
   steps' data (the records' ``ms``; pass (a)'s in f32 operations), and
   pass (a) one keyframe at a time; at keyframe 0 fused again onto its own
   state the step's and each pass's device time (``torch.profiler``, a
   memset and two launches a lone step asserted, one launch of pass (b)
   under HPR) beside that call's bound and the twin's; the whole ``fuse``
   through C1 and through the twin.
8. The HPR + smoothing path: ``runner.process`` under the headline
   schedule with ``culling.method="hpr"`` (``hpr_impl`` "auto": the grid at
   1M points) and ``fusion.local_smoothing_radius`` = ``SMOOTH_RADIUS``.
   Asserts as phase 4, with 2 calls of H2 (one for the 8 NID culls, one
   for the 8 colorize keyframes, each a memset and four launches), 8 of
   C1's pass (b) and none of its pass (a), one of N1 and none of the
   z-buffer kernels or H1. Then the same run through the twins of H2, N1,
   C1, G1 and the packer (no kernel of the path launched): the same pose,
   NID, evaluations, gathers and colored points at the same positions, the
   colors within 1 of 255 as written (``compare_smoothed``). Then the
   small-map path: the same run on ``bench_scene.scene_map(100_000)``
   (``SMALL_MAP``, written beside map.pcd; the same JPEGs and odometry;
   65,536 culled points a keyframe; outputs under ``out_small``), where
   "auto" takes H1: 2 calls of H1 (one for the 8 NID culls, one for the 8
   colorize culls), none of H2, each of the 16 masks bit-equal to the dense
   twin run on the CPU on the same inputs; its pose, NID and colored points
   printed beside the same run through the dense twin on the card (the
   pose is printed, not gated; the texture bar holds outside the
   occluder's shadow, 0.6 inside it).
9. H1 (``phase_hpr_dense``): the tiled dense cull on the two-wall scene at
   100,000 and 262,144 points bit-equal to its twin run on the CPU on the
   same inputs (all directions, then every 16th), and at 20,000 points
   with R = 1 (every pair kept); its pairs evaluated and subtiles kept
   (counted by the kernel, ``hpr.support_stats``) equal to
   ``hpr_support_tiled_plain``'s at 100,000; against the twin run on the
   card the differing bits and their margins in ulp of 2R; device and call
   times at both sizes beside two bounds (the dense N^2 x 3 FMA, and the
   inputs' own need: the needed pairs x 4 instructions at the instruction rate,
   or N x 14 B), the card twin and the chunked product; ``torch.profiler``
   asserts one launch each of ``hpr_flip``, ``hpr_describe`` and
   ``hpr_support_kernel`` and the same device launches a call at every
   size and batch; one 1M-point keyframe cull of the scene with the dense
   test (every 256th direction against the CPU twin); the 8 colorize culls
   of the 100,000-point map in one call, each row equal to its keyframe's
   own call, beside the 8 one at a time.
10. H2 (``phase_hpr_grid``): the grid cull bit-equal to its twin on the
   two-wall scene at 262,144 points and on ``bench_scene.hpr_edge_sets``
   (also strided and unaligned, and one point); then in batches, every
   mask against the twin and against a one-keyframe launch: the scene's 8
   colorize culls in the views form ``fuse`` takes (the world points
   transformed, projected and gated in the passes) and in the camera form,
   the 8 NID culls (``cull_world_points_batch``), a batch of one, and a
   batch of padded rows with an empty gate; ``torch.profiler`` asserts one
   memset and four launches a batch; device and call times of each batch
   beside the 8 culls one keyframe at a time and the eager transform the
   views form does without, each pass's device us and the bounds.
11. N1 (``phase_smooth``): the smoothing kernel on the scene's fused colors
   (HPR culling) under the path's schedule (the colored points first, a
   ``valid_first`` grid's order) and the identity, within 1e-3 of its twin
   and equal to each other, and on ``bench_scene.smooth_edge_clouds``
   (ties at the 32nd neighbor, shared buckets, buckets over capacity, cell
   faces, all or no point colored, a ragged n) within 1e-3; the windows
   the checked launch stages and their queries (counted by the kernel);
   in-radius neighbors a point (median 8-24 on the wall asserted), the
   share over 32 and bucket overflow; device and call times of
   ``knn.build``, the kernel and the twin beside the bounds (unique bytes;
   bytes of the windows staged); one launch a ``smooth_colors_local`` call
   (``torch.profiler``).
12. The mask path: ``runner.process`` under the headline schedule with the
   mask folder set. Asserts what tests/test_pipeline_e2e.py's
   test_e2e_with_masks asserts (labels follow the mask, highlighted points
   are red, one dump per keyframe, the accumulated cloud is the sum of the
   dumps), 8 launches each of zmin and zbuffer_visible, 1 + 8 of C1's pass
   (a) (the fuse's, then one a dump) and 16 of its pass (b).
13. The earlier path: ``runner.process`` under the plain objective (2 outer
   x 20 inner), as in phase 4 otherwise, with one G1 launch an evaluation.
14. The MLS path: ``runner.process`` with bench.py's e2e MLS config
   (``bench_scene.e2e_config``: MLS on, ``upsampling="none"``) under the
   headline schedule. Asserts as phase 4 (the texture bar outside the
   occluder's shadow, 0.7 inside it: the SOR thins the occluder), with one
   M1 and two S1 launches, and prints the MLS stage's split (SOR 1, the
   fit, SOR 2, the PCD write).
15. M1 (``phase_mls``) with the default MLSConfig on bench scene 1's map
   under the first SOR's mask (its exactly planar wall and occluder: the
   singular covariance) and on the MLS bench's 1M-point hardened corner
   (``bench_scene.mls_scene``, bench.py:553-578), each under three
   schedules handed to the kernel as its order (the wrapper's own: the
   grid's sort order; the identity; a seeded random permutation):
   in-radius counts and fit flags bit-equal to its twin run on the card,
   positions within 2e-6 m and normals within 1e-5 in 1 - |cos| but for
   rows whose degenerate (2-3 point) fit overflows to a zero normal in one
   of the two (at most 1 in 100,000 rows); on the corner, device and call
   times of the grid build, the schedule, ``knn.cell_order``, the kernel,
   the whole pass (points/s) and the twin beside the bound, the kernel on
   the map, and the windows the own schedule's launch stages (one a
   distinct cell of a block's chunk, counted by the kernel);
   ``torch.profiler`` asserts one launch a pass.
16. S1 (``phase_sor``) on bench scene 1's map and on the corner, as the
   SOR calls it (k 60, 0.25 m, 60 a bucket), under the same three
   schedules: indices, flags and distances bit-equal to its twin (distances
   held within 2 ulp, the largest gap printed), inlier-mask differences
   (each within 4 ulp of the threshold); device and call times of the
   build, the schedule, ``knn.cell_order``, the kernel and the twin, bound,
   windows (as M1's); ``torch.profiler`` asserts one launch a
   ``sor_stats`` call.
17. Off the bench's shapes (``phase_mls_edges``): M1 and S1 against their
   twins under the three schedules on a 20,000-point corner with NaN and
   infinite points and 1% invalid (also with 64 points a bucket, with n / 8
   buckets for M1 and 7 for S1, where most occupied cells share a bucket,
   and S1 at K = 1 on shifted queries that are not the points), on a cell-
   face cloud (points on faces of the 0.25 m and 0.03 m cells), on corners
   of 1, 63, 65 and 1,000,003 points (ragged block chunks), and, for M1
   with an f64 conditioning witness (``_conditioning``), on a snapped cloud
   (every coordinate on a lattice), a lattice cloud (every coordinate on
   the 0.03 m one) and the NaN cloud with 5 buckets, the
   occupied cells sharing a bucket counted; ``smooth_cloud`` with each
   upsampling method on a flat patch, with one more S1 launch for the
   VGD's nearest-source search.
14b. The per-keyframe path: ``runner.process`` with ``nid.per_keyframe`` and
   ``nid.smooth_trajectory`` (2 outer x 20 inner, z-buffer culls): one
   lockstep solve gives each of the 8 keyframes its own correction, then the
   pose graph fuses them with the odometry chain. Asserts each keyframe's
   final NID at most its NID at T0 + 1e-3, every lane inside the trust
   region around T0, the pose graph's residual norm at most its initial
   one, the texture bar, one K1, one K2 and one G1 launch an evaluation of
   the lockstep solve (for all 8 keyframes), one bin_pack, 8 launches of
   each z-buffer kernel; prints each keyframe's pose error before and after
   the pose graph. Then ``phase_lockstep`` times that solve against a loop
   of 8 one-keyframe solves on the same keyframes (printed, not asserted).
14c. The re-cull path: the headline schedule with
   ``nid.recull_every_outer_iter``: a pass a outer iteration, the keyframes
   culled again at the current correction before each pass after the
   first. Asserts the planted error recovered to 1 cm / 1 degree, 8
   launches of each z-buffer kernel a build (the first and each re-cull),
   one bin_pack (the re-culls reuse the packed tiles), G1 at both shapes
   (each pass's gathers and final evaluation).
14d. The cache options + manual guess path: the headline schedule with
   ``nid.frozen_margin`` 2 and ``nid.frozen_partial_frac`` 0.25, and
   ``enable_manual_guess`` on the smoke's correspondence file. Asserts the
   NID correction within 1 cm / 1 degree of T0, each of the 4 manual poses
   too, the NID at most the NID at T0 + 1e-3, one W1 launch a frozen
   evaluation, G2 (or its block form) a gather and G1 only for the final
   evaluation; prints the gathers, partial gathers, evaluations, the
   launches and the ``nid_refine`` and ``manual_guess`` seconds.
14e. The distributed path (``phase_distributed``): ``parallel/`` over NCCL
   at a world of 1 (``mesh.init_distributed`` without torchrun's
   environment, a (1, 1) mesh on the card) on the scene's 8 x 262,144
   keyframes and 1M-point map: ``refine_pose_sharded`` under the headline
   schedule, ``fuse_sharded`` with masks, ``refine_per_keyframe_sharded``
   (1 x 10) and ``optimize_sharded`` on its corrections, each in turns
   serial, sharded, sharded, serial and bit for bit against its serial
   port path (``refine_pose``, ``refine_pose_per_keyframe``,
   ``pose_graph.optimize``, ``colorize.fuse``), with equal K1 / K2 / G1 /
   B1 / C1 launches and the walls printed; a CPU tensor on the NCCL mesh
   raises.
18. Tools at full scale: ``tools/colorize_anatomy`` (the eager stages and
   the production C1 fuse) and ``tools/zbuffer_probe``, each printing its
   JSON line; both must report non-null kernel times and exact masks /
   buffers (and fuses).

The launch counts are set to 0 just before each path and read just after;
a kernel's ``launches`` are those of the headline run, H1's those of the
small-map run (a call a cull batch), H2/N1's those of the HPR + smoothing
run (H2's a call of a memset and four launches), M1/S1's those of the MLS
run (each also carries the other paths' counts as ``launches_<path>``:
the per-keyframe path's as ``launches_per_keyframe_path``, the re-cull
path's as ``launches_recull_path``, the distributed path's sharded runs'
as ``launches_distributed_path``, the tools path's as
``launches_tools_path``, the harness path's as
``launches_harness_path``), G2's and W1's those of the cache
options + manual guess run, G1's block form's those of the partial-refresh
solve of phase 6b and G2's block form's those of its margin-2 solve with
no coarse phase (each asserted at least 1). G2, W1 and the block forms
carry margin 2's times as ``ms`` and margin 1's as ``m1_*``.
The line before the last is a JSON object describing each kernel: ``ms``,
``plain_ms`` and ``library_ms`` are device times (a sleep kernel queued
ahead of the start event hides the host's enqueue; where a twin's host side
outlasts it, as the histogram twins' does, ``plain_ms`` is its call time),
``call_ms`` the time a call as its caller pays it, host included, and
``bound_ms`` the least time the card could take (bytes over 3.35 TB/s,
f32 operations over 67 TFLOP/s or 32-bit integer ones over 16.7 TOP/s,
whichever is largest). K1/K2 also carry
their launches by shape and their device / call / host times and bounds on
the scene's inputs at both shapes (``scene_fine_*``, ``scene_coarse_*``).
M1/S1 also carry ``order_ms`` (the device time of the schedule the path
hands the kernel: the grid's own sort order, ``HashGrid.order``, no device
work), ``cell_order_ms`` (``knn.cell_order``, the schedule for queries
that are not the grid's points), ``windows`` and ``queries_per_window``
(p50), which the kernel counts in the checked launch under the path's own
schedule (``run_sizes``), of the corner and ``scene_*`` of the map, and
``launches_a_call``
(``torch.profiler``: kernel launches a ``sor_stats`` / ``mls_smooth``
call, asserted 1).
C1's records (colorize_scatter, colorize_update) carry their pass's device
time as ``ms`` (``torch.profiler`` over the 8 keyframes from an empty
state, as ``fuse`` runs them: pass (a)'s one launch for the 8, pass (b)'s
mean a launch, with ``bound_ms`` the mean of its bounds), the twin's as
``plain_ms`` (for pass (a) ``depth_keys_plain`` of the 8; for pass (b) the
whole twin step), ``sequence_ms`` (the memset and every launch over that
sequence) and ``step_ms`` (its eighth), pass (a)'s ``memset_us`` and
``one_at_a_time_ms`` (8 memsets and K = 1 launches), ``call_ms`` of a lone
step, ``refuse_kf0_ms`` / ``refuse_kf0_step_ms`` (keyframe 0 fused again
onto the state it left: no slot replaced, a state the path never has;
``refuse_kf0_bound_ms``), ``fuse_call_ms`` and ``fuse_twin_call_ms`` and
the division check's counts. G1 carries
its device time on map-order knots at the fine shape (``ms``,
``map_order_ms``; ``cold_ms`` with L2 flushed), at the coarse shape
(``coarse_ms``) and at the sort pose (``sort_pose_ms``), each beside
``index_select`` of the table rows, its launches by shape
(``launches_by_n``) and the headline solve's peak memory; ``bin_pack``
its device time beside its twin and its bound.
K5/Z1 carry their pass's device time as ``ms`` and its twin's (the gate,
the cell and the scatter-min or the test, in plain torch on the same
inputs) as ``plain_ms``, a whole cull's call as ``call_ms``, the mask's
error and mismatches over every cull checked, the probe's (``probe_*``),
the twins with cells given (``cells_given_plain_ms``), step 0's
(``step0_*``) and the whole cull's (``whole_cull_*``, with its launches
and bound; ``plain_whole_cull_*`` for the twin).
H1 carries its device time at 262,144 two-wall points as ``ms`` (and at
100,000, ``ms_100000``), the bound from the inputs' need as ``bound_ms``
beside ``dense_bound_ms``, the needed pairs, the pairs evaluated and the
subtiles kept at both sizes, ``launches_a_call``, the 1M-point scene
cull's time (``scene_1m_ms``) and the small map's 8 colorize culls in one
call (``small_map_batch8_ms``) and one at a time.
H2 carries the 8 colorize culls' device time in the views form as ``ms``
(``camera_form_ms``, ``nid_batch_ms``, ``one_at_a_time_ms`` and
``eager_camera_form_ms`` beside it), each form's bound and ``passes_us``;
N1 ``windows`` and ``queries_per_window`` (p50) from the kernel's count,
``window_bound_ms`` and its errors on the edge clouds.
The last line is
``{"ok": true, "device": {...}}``. The script imports nothing of jax
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "pointcloudprocessor_tpu_torch"

# Main-path shapes: bench.py's full scale (tools/bench_scene.py holds the
# scene itself).
WIDTH, HEIGHT, N_MAP, N_CULL, K = 4096, 3000, 1_000_000, 262_144, 8
# The small-map path: the scene's map drawn at the dense cutoff, where
# culling.hpr_impl "auto" takes H1 (the cutoff is ">"); its culls keep
# 62,000-68,000 gated points and ~42,000-50,000 visible, so 65,536 culled
# points a keyframe hold every visible one.
SMALL_N_MAP, SMALL_N_CULL, SMALL_MAP = 100_000, 65_536, "map_100k.pcd"
SEED = 0
# NID schedules: the headline (bench.py:797-805) and the plain objective
# (frozen taps and coarse-to-fine off). 20 inner iterations as in bench.py's
# e2e config: with 10, the plain schedule's second outer solve moves less
# than the 1 cm / 1 deg outer threshold and stops about 1.06 cm from T0, in
# the JAX package as in this port (same scene, same card).
HEADLINE = dict(max_outer_iterations=2, max_inner_iterations=20, coarse_outer_iterations=1,
                coarse_stride=16, frozen_taps=True, frozen_guard_frac=0.75, ftol=3e-4)
PLAIN = dict(max_outer_iterations=2, max_inner_iterations=20)
# The per-keyframe path: a correction a keyframe (one lockstep solve for the
# 8), then the pose graph fuses them with the odometry chain.
PER_KEYFRAME = dict(max_outer_iterations=2, max_inner_iterations=20, per_keyframe=True,
                    smooth_trajectory=True)
# The K5 probe's full size (tools/zbuffer_probe.FULL): 999,424 points into
# the 293 x 215 cells of a 14x-downsampled 4096x3000 image.
PROBE_N, PROBE_CELLS = 999_424, 293 * 215
# The H100's published peaks (NVIDIA's data sheet, SXM part, at 700 W):
# device-memory bytes/s and f32 operations/s outside the tensor cores.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
# Its 32-bit integer rate, which the data sheet does not give: 64 INT32
# lanes an SM (NVIDIA's H100 architecture paper) x 132 SMs x the 1.98 GHz
# clock behind F32_OPS_S (128 f32 lanes x 132 x 1.98e9 x 2 for an FMA).
INT32_OPS_S = 64 * 132 * 1.98e9
# f32 operations a point of K1 / K2, counted from csrc/nid_hist.cu: two
# cubic B-spline weight sets (~20 each), then per tap a weight product and
# an add (K1: 16 x 3), or both derivative products and adds (K2: 16 x 6,
# with two derivative sets).
K1_OPS, K2_OPS = 88, 176


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
    """The eight kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pointcloudprocessor_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    names = ("nid_hist", "tap_gather", "zbuffer", "colorize", "hpr", "smooth", "mls", "sor")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(kbuild.build, names))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} libraries in parallel")
    for b in builds:
        print(f"build {b.name}: nvcc {b.seconds:.2f} s -> {os.path.relpath(b.path, REPO)}")
        print(b.ptxas.strip())


def _ms(t):
    return "not measured" if t is None else f"{t:.3f}"


def _bound(nbytes, ops=0.0, int_ops=0.0):
    """(bound_ms, bound_by): the least time the card could take, the largest
    of ``nbytes`` over its memory rate, ``ops`` over its f32 rate and
    ``int_ops`` over its 32-bit integer rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(ops / F32_OPS_S, int_ops / INT32_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _median_ms(fn, device="cuda", hide_host=False):
    """Median CUDA-event time of ``fn()``: as its caller pays it, or with
    ``hide_host`` its device time alone (profiling.median_ms)."""
    from pointcloudprocessor_tpu_torch.utils import profiling

    return profiling.median_ms(fn, device, hide_host=hide_host)


def _device_ms(fn, device="cuda"):
    return _median_ms(fn, device, hide_host=True)


def _kernel_profile(fn, device="cuda", reps=20):
    """The device work of one ``fn()`` call, from ``torch.profiler`` over
    ``reps`` calls after a warm-up: {name: [launches a call, mean device
    us]} for each kernel and each memset or copy; None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # The profiler now and then loses some of a window's device events, and
    # once lost all of them in three scheduled windows running: a window
    # counts only if every name ran a whole number of times a call. First
    # with a warm-up step (device work queued just as tracing starts can be
    # lost, so only the second step's events are kept), then without a
    # schedule.
    for scheduled in (True, True, True, False, False, False):
        if scheduled:
            sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
            with profile(activities=acts, schedule=sched) as prof:
                for _ in range(2):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
        else:
            with profile(activities=acts) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            # The step's own marker is no device work of fn.
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")):
                # The name without "void", namespaces, template arguments and parameters.
                name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
                name = re.split(r"[<(]", name)[0].split("::")[-1].strip()
                rec = out.setdefault(name, [0, 0.0])
                rec[0] += 1
                rec[1] += e.time_range.elapsed_us()
        if out and all(n % reps == 0 for n, _ in out.values()):
            break
        time.sleep(0.5)
    else:
        raise RuntimeError(f"torch.profiler saw no whole window of device work: {out}")
    return {name: [n // reps, us / n] for name, (n, us) in out.items()}


def _kernel_launches(profile):
    """Kernel launches a call in a :func:`_kernel_profile` (memsets and
    copies are not kernels)."""
    return sum(n for name, (n, _) in profile.items()
               if not name.startswith(("Memset", "Memcpy")))


def _host_us(fn, device="cuda", reps=200):
    """Host time a call in us: ``reps`` calls queued back to back (fewer
    launches than the queue holds, so the host never waits on the card)."""
    import torch

    if device != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def _hist_fns(device):
    """(K1, K2) as the path under test calls them: the kernels on the card;
    off it the twin in their place (a rehearsal of the same path)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import nid_hist

    if device == "cuda":
        return nid_hist.hist_fwd_cuda, nid_hist.hist_bwd_cuda

    def bwd(g, taps, s, bp, il, bins):
        st = s.clone().requires_grad_(True)
        h = nid_hist.joint_histogram_plain(taps, st, bp, il, bins)
        return torch.autograd.grad(torch.sum(g * h), st)[0]

    return nid_hist.joint_histogram_plain, bwd


def _nid_sum(h, bp, il, bins=16):
    """The NID objective's sum over keyframes from joint histograms ``h``
    of points with bins ``bp`` and gate ``il`` (opt/nid._sum_nid's tail)."""
    import torch

    from pointcloudprocessor_tpu_torch.opt import nid

    levels = torch.arange(bins, device=bp.device)
    hp = torch.sum((bp[..., None] == levels).float() * il[..., None], dim=-2)
    return torch.sum(nid.nid_from_histograms(h, h.sum(-2), hp, il.sum(-1)))


def _check_hist(card, label, taps, s, bp, il, g, device="cuda", twin_times=False, bins=16,
                timed=True):
    """K1/K2 against the twin on one input set (tolerances as stated
    below), then, if ``timed``, their device / call / host times and
    bounds. ``g`` is K2's upstream gradient. Returns {"fwd": record, "bwd":
    record}."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import nid_hist

    k, n = taps.shape[:2]
    fwd_fn, bwd_fn = _hist_fns(device)

    # K1: histograms. f32 summation-order class, scaled to the histogram:
    # |kernel - twin| <= 1e-5 * max|twin| (the kernel and the twin's GEMM
    # add the same weights per keyframe in other orders).
    h_k = fwd_fn(taps, s, bp, il, bins)
    h_t = nid_hist.joint_histogram_plain(taps, s, bp, il, bins)
    fwd_err = float((h_k - h_t).abs().max())
    fwd_tol = 1e-5 * float(h_t.abs().max())
    print(f"{label}: K1 nid_hist_fwd max|kernel-twin| = {fwd_err:.3e}  (tol {fwd_tol:.3e}, "
          f"max|hist| {float(h_t.abs().max()):.1f})")
    assert fwd_err <= fwd_tol, f"{label}: K1 disagrees with its twin"

    # K2 with the given upstream g: against autograd through the twin.
    st = s.clone().requires_grad_(True)
    ht = nid_hist.joint_histogram_plain(taps, st, bp, il, bins)
    (ds_t,) = torch.autograd.grad(torch.sum(g * ht), st, retain_graph=True)
    ds_k = bwd_fn(g, taps, s, bp, il, bins)
    bwd_err = float((ds_k - ds_t).abs().max())
    bwd_tol = 1e-5 * float(ds_t.abs().max())
    print(f"{label}: K2 nid_hist_bwd max|kernel-twin| = {bwd_err:.3e}  (tol {bwd_tol:.3e})")
    assert bwd_err <= bwd_tol, f"{label}: K2 disagrees with its twin"
    assert torch.all(ds_k[il == 0] == 0), f"{label}: K2 gave a gated-out point a gradient"

    # The NID objective's value and s-gradient through both paths.
    sk = s.clone().requires_grad_(True)
    vk = _nid_sum(nid_hist.joint_histogram(taps, sk, bp, il, bins), bp, il, bins)
    (gk,) = torch.autograd.grad(vk, sk)
    st2 = s.clone().requires_grad_(True)
    vt = _nid_sum(nid_hist.joint_histogram_plain(taps, st2, bp, il, bins), bp, il, bins)
    (gt,) = torch.autograd.grad(vt, st2)
    nid_err = abs(vk.detach().item() - vt.detach().item())
    grad_err = float((gk - gt).abs().max())
    grad_tol = 1e-4 * float(gt.abs().max())
    print(f"{label}: NID sum over {k} keyframes: kernel {vk.detach().item():.7f} twin "
          f"{vt.detach().item():.7f} |diff| {nid_err:.2e} (tol 1e-5); max|ds diff| "
          f"{grad_err:.3e} (tol {grad_tol:.3e})")
    assert nid_err <= 1e-5 and grad_err <= grad_tol, f"{label}: NID value/gradient disagree"
    if not timed:
        return {"fwd": {"max_abs_err": fwd_err}, "bwd": {"max_abs_err": bwd_err}}

    # Times: median of 20 after warm-up, each kernel twice in turns; per
    # call (as the caller pays it), device time alone and host time a call.
    def fwd():
        return fwd_fn(taps, s, bp, il, bins)

    def bwd():
        return bwd_fn(g, taps, s, bp, il, bins)

    call = [_median_ms(fn, device) for fn in (fwd, bwd, fwd, bwd)]
    dev = [_device_ms(fn, device) for fn in (fwd, bwd, fwd, bwd)]
    host = [_host_us(fn, device) for fn in (fwd, bwd)]
    n_pts = k * n
    bounds = (_bound(_nbytes(taps, s, bp, il, h_k), K1_OPS * n_pts),
              _bound(_nbytes(g, taps, s, bp, il, ds_k), K2_OPS * n_pts))
    out = {}
    for i, (key, name, err) in enumerate((("fwd", "K1", fwd_err), ("bwd", "K2", bwd_err))):
        (b_ms, by), t = bounds[i], dev[i]
        share = f"{b_ms / t:.2f}" if t else "not measured"
        print(f"[{card}] {label} {k}x{n}: {name} device {_ms(dev[i])} / {_ms(dev[i + 2])} ms, "
              f"a call {_ms(call[i])} / {_ms(call[i + 2])} ms, host {_ms(host[i])} us a call; "
              f"bound {b_ms * 1e3:.1f} us ({by}), kernel at {share} of it")
        out[key] = {"max_abs_err": err, "ms": dev[i], "ms_again": dev[i + 2], "call_ms": call[i],
                    "call_ms_again": call[i + 2], "host_us": host[i], "bound_ms": b_ms,
                    "bound_by": by}
    if twin_times:
        def fwd_twin():
            return nid_hist.joint_histogram_plain(taps, s, bp, il, bins)

        def bwd_twin():
            return torch.autograd.grad(torch.sum(g * ht), st, retain_graph=True)

        for key, fn in (("fwd", fwd_twin), ("bwd", bwd_twin)):
            # The twins' host side outlasts the hidden window: their device
            # time is refused, and plain_ms is then their time a call.
            call_t = _median_ms(fn, device)
            out[key].update(plain_call_ms=call_t, plain_ms=_device_ms(fn, device) or call_t)
        print(f"[{card}] {label}: twins (K1 twin, K2 twin = autograd backward) device "
              f"{_ms(out['fwd']['plain_ms'])} / {_ms(out['bwd']['plain_ms'])} ms, a call "
              f"{_ms(out['fwd']['plain_call_ms'])} / {_ms(out['bwd']['plain_call_ms'])} ms")
    return out


def phase_kernels(card, device="cuda"):
    """K1/K2 against the twin on the random set (uniform nibbles, uniform
    point bins, ~30% gated out, s uniform in [-1.5, 2.5], from a numpy
    seed) at the main path's fine shape; returns the per-kernel records."""
    import torch

    bins = 16
    rng = np.random.default_rng(SEED)
    taps = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (K, N_CULL, 2), dtype=np.int64).astype(np.int32)
    ).to(device)
    s = torch.from_numpy(rng.uniform(-1.5, 2.5, (K, N_CULL, 2)).astype(np.float32)).to(device)
    bp = torch.from_numpy(rng.integers(0, bins, (K, N_CULL)).astype(np.int32)).to(device)
    il = torch.from_numpy((rng.uniform(size=(K, N_CULL)) > 0.3).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(K, bins, bins)).astype(np.float32)).to(device)
    res = _check_hist(card, "random set", taps, s, bp, il, g, device, twin_times=True)
    for key in ("fwd", "bwd"):
        res[key]["ragged_max_abs_err"] = 0.0
    for k, n, off in RAGGED:
        label = f"ragged {k}x{n}" + (f", pointers {8 * off} B off" if off else "")
        rag = _check_hist(card, label, *_ragged_inputs(rng, k, n, off, device), device,
                          bins=RAGGED_BINS, timed=False)
        for key in ("fwd", "bwd"):
            res[key]["ragged_max_abs_err"] = max(res[key]["ragged_max_abs_err"],
                                                 rag[key]["max_abs_err"])
    return [
        {"name": "nid_hist_fwd", "route": "cuda", "source": f"{PKG}/csrc/nid_hist.cu",
         "replaces": "pointcloudprocessor_tpu/ops/nid_hist.py:71", "library_ms": None,
         **res["fwd"]},
        {"name": "nid_hist_bwd", "route": "cuda", "source": f"{PKG}/csrc/nid_hist.cu",
         "replaces": "pointcloudprocessor_tpu/ops/nid_hist.py:112", "library_ms": None,
         **res["bwd"]},
    ]


# Ragged random sets of phase 3: (K, N, offset). An odd N starts every other
# keyframe on the second point of a pair (the kernels' scalar loads and
# split stores); an offset of 1 moves every pointer 8 bytes off 16-byte
# alignment, so that the kernels take their scalar-load build. Fewer bins
# than 16, so that taps and point bins outside [0, bins) are dropped.
RAGGED = ((3, 1_037, 0), (K, N_CULL - 1, 0), (3, 1_037, 1))
RAGGED_BINS = 12


def _ragged_inputs(rng, k, n, off, device):
    """(taps, s, bin_pts, inlier, g) of a ragged random set: uniform
    nibbles, point bins in [-2, RAGGED_BINS + 2), ~30% gated out; each
    tensor a view ``off`` 8-byte words into a buffer of its own."""
    import torch

    def view(a, words):
        t = torch.from_numpy(np.ascontiguousarray(a))
        flat = torch.empty(t.numel() + words * 8 // t.element_size(), dtype=t.dtype)
        flat[flat.numel() - t.numel():] = t.reshape(-1)
        flat = flat.to(device)
        return flat[flat.numel() - t.numel():].view(t.shape)

    taps = rng.integers(-(2**31), 2**31, (k, n, 2), dtype=np.int64).astype(np.int32)
    s = rng.uniform(-1.5, 2.5, (k, n, 2)).astype(np.float32)
    bp = rng.integers(-2, RAGGED_BINS + 2, (k, n)).astype(np.int32)
    il = (rng.uniform(size=(k, n)) > 0.3).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(k, RAGGED_BINS, RAGGED_BINS)).astype(np.float32))
    return view(taps, off), view(s, off), view(bp, off), view(il, off), g.to(device)


def scene_hist_inputs(camera, kfs, T, bins=16):
    """(taps, s, bin_pts, inlier) of the NID objective on ``kfs`` at pose
    ``T``, formed as opt/nid.multi_nid_loss forms them: projection, the
    direct tap take, the point bins and the gate of ``_sum_nid``."""
    import torch

    from pointcloudprocessor_tpu_torch.opt import nid
    from pointcloudprocessor_tpu_torch.utils.numeric import to_int32

    kfs = nid.prepare_keyframes(kfs)
    with torch.no_grad():
        proj, knot, inl = nid._project_all(camera, T, kfs)
        s = proj - knot.to(proj.dtype)
        taps = nid._gather_taps(camera, kfs, knot, inl, use_grouped=False)
        bp = torch.clamp(to_int32(kfs.intensity * bins), 0, bins - 1)
    return taps, s, bp, inl.to(proj.dtype)


def distinct_bins(taps, il):
    """{distinct image bins in a point's 16 taps: gated-in points}."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import nid_hist

    v = torch.sort(nid_hist.unpack_tap_nibbles(taps), dim=-1).values
    d = 1 + (v[..., 1:] != v[..., :-1]).sum(-1)
    d = d[il > 0]
    return {str(i): int((d == i).sum()) for i in (1, 2, 3)} | {"4+": int((d >= 4).sum())}


def phase_kernels_scene(card, camera, kfs, device="cuda"):
    """K1/K2 against the twin on the scene's own evaluation inputs: the 8
    keyframes projected at the start pose (the identity correction), at the
    headline's fine shape (8 x 262,144) and coarse shape (every 16th
    point, 8 x 16,384). K2's upstream g is the NID's own gradient there.
    Prints how many points hold 1, 2, 3 or more distinct bins in their
    taps. Returns {shape: {"fwd": record, "bwd": record, ...}}."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import nid_hist
    from pointcloudprocessor_tpu_torch.opt import refine

    out = {}
    stride = HEADLINE["coarse_stride"]
    for shape, sub in (("fine", kfs), ("coarse", refine._subsample_keyframes(kfs, stride))):
        taps, s, bp, il = scene_hist_inputs(camera, sub, se3.identity(device))
        hist = distinct_bins(taps, il)
        print(f"scene {shape} {tuple(taps.shape[:2])}: {int(il.sum())} gated-in points; "
              f"distinct bins in a point's 16 taps: {hist}")
        h = nid_hist.joint_histogram_plain(taps, s, bp, il).requires_grad_(True)
        (g,) = torch.autograd.grad(_nid_sum(h, bp, il), h)
        out[shape] = _check_hist(card, f"scene {shape}", taps, s, bp, il, g, device)
        out[shape]["distinct_bins"] = hist
    return out


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
    points, inten = bs.scene_map(SMALL_N_MAP, WIDTH, HEIGHT, SEED)
    pcd.write(os.path.join(root, SMALL_MAP), points, intensity=inten)

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
    print(f"scene written in {time.perf_counter() - t0:.1f} s: {N_MAP} points ({SMALL_N_MAP} "
          f"in {SMALL_MAP}), {K} "
          f"{WIDTH}x{HEIGHT} JPEGs and PNG masks ({codec}); PCD codec: "
          f"{'native' if native.available() else 'numpy fallback'}")
    return T0


def _config(root, nid, masks=False, hpr=False, mls=False, small=False):
    """The pipeline config of the smoke scene (bench.py's e2e config,
    `bench.py:766-806`, ``bench_scene.e2e_config``) with the given
    NIDConfig, with the scene's mask folder if ``masks``, with HPR culling
    (``hpr_impl`` "auto": the grid at 1M points, H1 on the small map) and
    local color smoothing at ``SMOOTH_RADIUS`` if ``hpr``, with the MLS
    stage (``upsampling="none"``) if ``mls``; on the 100,000-point map
    (``SMALL_MAP``, ``SMALL_N_CULL`` culled points a keyframe) if
    ``small``."""
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    n_map, n_cull = (SMALL_N_MAP, SMALL_N_CULL) if small else (N_MAP, N_CULL)
    cfg = bs.e2e_config(root, nid, mls, WIDTH, HEIGHT, n_map, n_cull, K)
    if small:  # its own outputs: the later phases read the 1M-point run's crop
        cfg.point_cloud_path = os.path.join(root, SMALL_MAP)
        cfg.output_path = os.path.join(root, "out_small")
    if masks:
        cfg.mask_image_folder = os.path.join(root, "masks")
    if hpr:
        cfg.culling.method = "hpr"
        cfg.fusion.local_smoothing_radius = SMOOTH_RADIUS
    return cfg


def _reset_counts():
    from pointcloudprocessor_tpu_torch.ops import hpr, knn, mls, nid_hist, tap_gather, zbuffer
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    for mod in (nid_hist, tap_gather, zbuffer, colorize, hpr, knn, mls):
        mod.reset_launch_counts()


def _read_counts():
    from pointcloudprocessor_tpu_torch.kernels import build as kbuild
    from pointcloudprocessor_tpu_torch.ops import hpr, knn, mls, nid_hist, tap_gather, zbuffer
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    by_n = {name: {} for name in (*nid_hist.launch_counts, "tap_take")}
    for (name, n), c in sorted(kbuild.launch_shapes.items()):
        by_n[name][str(n)] = c
    return {**nid_hist.launch_counts, **tap_gather.launch_counts, **tap_gather.call_counts,
            **{f"{k}_fallbacks": v for k, v in tap_gather.fallback_counts.items()},
            **zbuffer.launch_counts, **colorize.launch_counts, **hpr.launch_counts,
            **knn.launch_counts,
            **mls.launch_counts, "launches_by_n": by_n}


def _pose_error(T, T0):
    from pointcloudprocessor_tpu_torch.core import se3

    dt, dr = se3.delta_magnitudes(se3.SE3(T.q.to("cpu"), T.t.to("cpu")), T0)
    return float(dt) * 100.0, float(np.degrees(float(dr)))


def _pose_errors(T, T0):
    """(cm, deg) of each row of a (K,) correction from T0."""
    from pointcloudprocessor_tpu_torch.core import se3

    dt, dr = se3.delta_magnitudes(se3.SE3(T.q.to("cpu"), T.t.to("cpu")), T0)
    return [(float(a) * 100.0, float(np.degrees(float(b)))) for a, b in zip(dt, dr)]


def check_per_keyframe(card, label, nid, solves, T0, pose_graph, T_final):
    """The per-keyframe path's gates, on its last lockstep solve: each
    keyframe's final NID at most its NID at the planted T0 + 1e-3, every
    lane inside the trust region around T0, the pose graph's residual norm
    at most its initial one. Prints each keyframe's pose error before and
    after the pose graph. Runs after the path's counts are read (the NIDs
    at T0 launch K1 and G1)."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod

    (camera, kfs, *_), res = solves[-1]
    device = kfs.points.device
    k = kfs.points.shape[0]
    T0_k = se3.SE3(T0.q.expand(k, 4).to(device), T0.t.expand(k, 3).to(device))
    with torch.no_grad():
        at_t0 = nid_mod.multi_nid_per_keyframe(camera, T0_k, kfs, nid.bins).cpu()
    final = res.nid.cpu()
    before, after = _pose_errors(res.T_camera_lidar, T0), _pose_errors(T_final, T0)
    for j in range(k):
        print(f"{label}: keyframe {j}: NID {float(final[j]):.6f} (at T0 {float(at_t0[j]):.6f}); "
              f"pose error vs T0 {before[j][0]:.4f} cm / {before[j][1]:.4f} deg refined, "
              f"{after[j][0]:.4f} cm / {after[j][1]:.4f} deg after the pose graph; outer "
              f"{int(res.outer_iterations[j])}, evaluations {int(res.evaluations[j])}, "
              f"converged {bool(res.converged[j])}")
    assert bool((final <= at_t0 + 1e-3).all()), (final, at_t0)
    trans, rot = nid.trust_region_trans * 100.0, nid.trust_region_rot_deg
    assert all(cm <= trans and deg <= rot for cm, deg in before), before
    if pose_graph is not None:
        print(f"[{card}] {label}: pose graph residual norm {pose_graph['residual_norm']:.6f} "
              f"(initial {pose_graph['initial_residual_norm']:.6f})")
        assert pose_graph["residual_norm"] <= pose_graph["initial_residual_norm"], pose_graph


def phase_lockstep(card, camera, kfs, nid, device="cuda"):
    """The per-keyframe solve as the path runs it (one lockstep solve over
    the 8 keyframes) against a loop of 8 one-keyframe solves (the same
    ``refine_pose_per_keyframe``, B = 1 each), from the identity, timed in
    turns (lockstep, loop, lockstep) on the host clock with the card
    synchronized. Printed for PERF.md, not asserted; each lane's NID of the
    loop beside the lockstep's."""
    from dataclasses import replace

    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod
    from pointcloudprocessor_tpu_torch.opt import refine

    kfs = nid_mod.prepare_keyframes(kfs)
    k = kfs.points.shape[0]
    kw = dict(bins=nid.bins, max_outer_iterations=nid.max_outer_iterations,
              max_inner_iterations=nid.max_inner_iterations,
              delta_trans_thresh=nid.delta_trans_thresh,
              delta_rot_thresh=float(np.radians(nid.delta_rot_thresh_deg)),
              trust_region_trans=nid.trust_region_trans,
              trust_region_rot=float(np.radians(nid.trust_region_rot_deg)))
    identity = se3.identity(device)

    def timed(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def lockstep():
        return refine.refine_pose_per_keyframe(camera, kfs, identity, **kw)

    def loop():
        return [refine.refine_pose_per_keyframe(
            camera, replace(kfs, points=kfs.points[j:j + 1], intensity=kfs.intensity[j:j + 1],
                            valid=kfs.valid[j:j + 1], bin_image=kfs.bin_image[j:j + 1],
                            bin_tiles=kfs.bin_tiles[j:j + 1]), identity, **kw)
            for j in range(k)]

    t_a, res = timed(lockstep)
    t_loop, lanes = timed(loop)
    t_b, _ = timed(lockstep)
    calls = sum(r.lockstep_evaluations for r in lanes)
    gap = max(abs(float(res.nid[j]) - float(r.nid[0])) for j, r in enumerate(lanes))
    print(f"[{card}] per-keyframe solve, {k} keyframes x {kfs.points.shape[1]} points, "
          f"{nid.max_outer_iterations} x {nid.max_inner_iterations}: lockstep {t_a:.3f} s / "
          f"{t_b:.3f} s ({res.lockstep_evaluations} evaluations of all {k}), loop of {k} "
          f"one-keyframe solves {t_loop:.3f} s ({calls} evaluations of one); largest NID gap "
          f"of a lane {gap:.2e}")


def phase_runner(card, root, T0, nid, label, device="cuda", masks=False, hpr=False, mls=False,
                 eager=False, small=False, picks=None):
    """``runner.process`` on the smoke scene under ``nid`` (with the mask
    folder if ``masks``; with HPR culling and local smoothing if ``hpr``;
    with the MLS map stage if ``mls``), the launch counts set to 0 just
    before it and read just after. Asserts the planted error is recovered
    to 1 cm / 1 deg, a finite NID, colored points whose colors follow the
    rendered texture, the mask outputs (:func:`check_mask_outputs`), and on
    the card K1/K2 launches; one launch of each z-buffer kernel (zmin and
    zbuffer_visible) a NID keyframe; one launch of C1's pass (a)
    (colorize_scatter) for all the colorize keyframes and one more a mask
    dump, one of its pass (b) (colorize_update) a colorize keyframe and a
    dump; with ``hpr`` one H2 hpr_grid call for the NID culls and one for
    the colorize keyframes (each mask dump one more), C1's pass (b) alone,
    and one N1 smooth_local launch; one G1 tap_take a direct take (by points a
    keyframe: each coarse evaluation at the coarse shape, each frozen
    gather and the final evaluation at the fine one) and one bin_pack a
    solve, whose keyframes carry no tap table; with ``mls``
    one M1 mls_moments and two S1 knn_select launches (the two SOR passes),
    and the MLS stage's split. With ``eager`` (no masks) C1, G1 and the
    packer give way to their twins (``fuse(plain=True)``: each keyframe
    through ``fuse_keyframe_plain`` with its own cull; ``direct_take_plain``,
    ``pack_bins_plain``; with ``hpr`` also H2's and N1's,
    ``hpr_mask_grid_plain``, ``hpr_mask_grid_batch_plain`` and
    ``smooth_colors_local_plain``; on the small map the dense twin,
    ``hpr_mask_plain`` a keyframe at a time on the card): the eager path
    they replaced, whose z-buffer culls take the z-buffer kernels. With
    ``small`` (and ``hpr``) the run is on the 100,000-point map, where
    "auto" takes H1: two ``hpr_support`` calls (the 8 NID culls, then the 8
    colorize culls), no H2, and each of the 16 masks bit-equal to the dense
    twin run on the CPU on the same inputs (:func:`check_dense_culls`); its
    pose is printed, not gated. With ``picks`` (a correspondence file) the
    manual initial guess runs after the solve (:func:`check_manual`), and
    the solve runs twice more on its own inputs under ``torch.profiler``,
    bit-equal, printing its wall and device-busy time. Under
    a frozen-tap margin the fine gathers are G2's (``wide_take``, its block
    form ``wide_take_blocks`` for a partial refresh) and every frozen
    evaluation one W1 ``wide_select``, G1 only the final evaluation; at
    margin 0 a partial refresh is one ``tap_take_blocks``. Prints the
    solve's peak device memory above what was held at its entry. Returns
    (launches, summary): the pose, NID, evaluations, gathers, colored
    points, the colored cloud's SHA-256 and its (points, rgb), the
    ``colorize_fuse`` stage's seconds and the solve's peak memory (MiB; None
    off the card)."""
    import functools
    import hashlib

    import torch

    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.ops import fusion, tap_gather
    from pointcloudprocessor_tpu_torch.ops import hpr as hpr_ops
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod
    from pointcloudprocessor_tpu_torch.opt import refine
    from pointcloudprocessor_tpu_torch.pipeline import colorize, runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    assert hpr or not small
    cfg = _config(root, nid, masks, hpr, mls, small)
    if picks:
        cfg.enable_manual_guess, cfg.correspondences_path = True, picks
    n_cull = cfg.culled_capacity
    shutil.rmtree(cfg.output_path, ignore_errors=True)
    kernels = (colorize.fuse, tap_gather.direct_take, tap_gather.pack_bins,
               hpr_ops.hpr_mask_grid, hpr_ops.hpr_mask_grid_batch, fusion.smooth_colors_local,
               hpr_ops.hpr_mask, hpr_ops.hpr_mask_dense_batch)
    wrapped = (nid_mod.prepare_keyframes, refine.refine_pose, refine.refine_pose_per_keyframe)
    dense_culls = []
    if eager:
        assert not masks
        colorize.fuse = functools.partial(colorize.fuse, plain=True)
        tap_gather.direct_take = tap_gather.direct_take_plain
        tap_gather.pack_bins = tap_gather.pack_bins_plain
        hpr_ops.hpr_mask_grid = hpr_ops.hpr_mask_grid_plain
        hpr_ops.hpr_mask_grid_batch = hpr_ops.hpr_mask_grid_batch_plain
        fusion.smooth_colors_local = fusion.smooth_colors_local_plain

        def dense_twin(points, gate, radius, tolerance):
            return torch.stack([hpr_ops.hpr_mask_plain(p, g, radius, tolerance)
                                for p, g in zip(points, gate)])

        hpr_ops.hpr_mask = hpr_ops.hpr_mask_plain  # the twin step's own culls
        hpr_ops.hpr_mask_dense_batch = dense_twin
    elif small:
        def dense_batch(points, gate, radius, tolerance):  # records each cull batch
            out = kernels[-1](points, gate, radius, tolerance)
            dense_culls.append((points, gate, radius, tolerance, out))
            return out

        hpr_ops.hpr_mask_dense_batch = dense_batch
    tables, peaks, solve_kw = [], [], []

    def prepare(*args, **kw):  # what the solve's keyframes carry
        out = wrapped[0](*args, **kw)
        tables.append(out.tap_rows is not None)
        return out

    solves = []  # (args, RefineResult) of each solve: one, or one a re-cull pass

    def solver(fn):
        def solve(*args, **kw):  # the solve's peak memory above its entry's
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            out = fn(*args, **kw)
            solve_kw.append(kw)
            if device == "cuda":
                torch.cuda.synchronize()
                peaks.append((torch.cuda.max_memory_allocated() - held) / 2**20)
            solves.append((args, out))
            return out

        return solve

    nid_mod.prepare_keyframes = prepare
    refine.refine_pose, refine.refine_pose_per_keyframe = solver(wrapped[1]), solver(wrapped[2])
    _reset_counts()
    t0 = time.perf_counter()
    try:
        res = runner.process(cfg, device)
    finally:
        (colorize.fuse, tap_gather.direct_take, tap_gather.pack_bins, hpr_ops.hpr_mask_grid,
         hpr_ops.hpr_mask_grid_batch, fusion.smooth_colors_local, hpr_ops.hpr_mask,
         hpr_ops.hpr_mask_dense_batch) = kernels
        nid_mod.prepare_keyframes, refine.refine_pose, refine.refine_pose_per_keyframe = wrapped
    wall = time.perf_counter() - t0
    assert tables and not any(tables), f"the solve's keyframes carried a tap table: {tables}"
    assert solves and len(peaks) == (len(solves) if device == "cuda" else 0), peaks
    # One solve, or one a pass of the re-cull loop; each pass after the
    # first culls again.
    passes = len(solves)
    assert passes == 1 or nid.recull_every_outer_iter, passes
    launches = _read_counts()
    with open(os.path.join(cfg.output_path, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    costs = [e for e in events if e["event"].startswith("cost_estimate_")]
    assert [e["event"] for e in costs] == ["cost_estimate_nid", "cost_estimate_colorize"], costs
    if label == "headline schedule":
        for e in costs:
            print(f"{label}: {e['event']}: {e['flops']:.4g} flop, {e['bytes']:.4g} B, "
                  f"{e['bound']}-bound, speed of light {e['speed_of_light_s']} s at the "
                  "H100's peaks (utils/profiling)")
    refined = [e for e in events if e["event"] == "nid_refined"][-1]
    recull = [e for e in events if e["event"] == "nid_recull_outer"]
    smoothed = [e for e in events if e["event"] == "pose_graph_smoothed"]
    assert len(recull) == (passes if nid.recull_every_outer_iter else 0), recull
    assert len(smoothed) == (1 if nid.per_keyframe and nid.smooth_trajectory else 0), smoothed

    print(f"[{card}] {label}: runner.process wall {wall:.2f} s; stages (s): "
          + json.dumps({k: round(v, 3) for k, v in res.timings.items()}))
    if nid.per_keyframe:
        err_cm, err_deg = (max(e) for e in zip(*_pose_errors(res.T_correction, T0)))
        err = f"worst keyframe {err_cm:.4f} cm / {err_deg:.4f} deg"
    else:
        err_cm, err_deg = _pose_error(res.T_correction, T0)
        err = f"{err_cm:.4f} cm / {err_deg:.4f} deg"
    print(f"{label}: pose error vs planted T0: {err}; NID "
          f"{res.nid_value:.6f}; evaluations {res.nid_evaluations}; gathers "
          f"{refined['gathers']}; outer {res.nid_outer_iterations}; passes {passes}; keyframes "
          f"{res.num_keyframes}; colored {res.num_colored_points}; solve peak device memory "
          f"{f'{max(peaks):.1f} MiB' if peaks else 'not measured'}; launches {launches}")
    for e in recull:
        print(f"{label}: re-cull pass {e['outer']}: max_dt {e['max_dt']:.6f} m, max_dr "
              f"{e['max_dr']:.6f} rad")
    assert res.num_keyframes == K, res.num_keyframes
    assert np.isfinite(res.nid_value), res.nid_value
    if nid.per_keyframe:  # each lane against its NID at T0, then the pose graph
        check_per_keyframe(card, label, nid, solves, T0, smoothed[0] if smoothed else None,
                           res.T_correction)
    elif small:  # printed, not gated: the masks are this path's gate
        print(f"{label}: planted error recovered to 1 cm / 1 deg: "
              f"{err_cm < 1.0 and err_deg < 1.0}")
    else:
        assert err_cm < 1.0 and err_deg < 1.0, "refine did not recover the planted error"
    assert res.num_colored_points > 0
    with open(res.colored_cloud_path, "rb") as f:
        summary = {"T": (res.T_correction.q.tolist(), res.T_correction.t.tolist()),
                   "nid": res.nid_value, "evaluations": res.nid_evaluations,
                   "gathers": refined["gathers"], "colored": res.num_colored_points,
                   "colored_pcd_sha256": hashlib.sha256(f.read()).hexdigest(),
                   "colorize_fuse_s": res.timings["colorize_fuse"],
                   "solve_peak_mib": max(peaks) if peaks else None}
    if nid.per_keyframe:  # the inputs of its solve, for phase_lockstep
        summary["solve_inputs"] = solves[-1][0][:2]
    if device == "cuda":
        assert launches["nid_hist_fwd"] > 0 and launches["nid_hist_bwd"] > 0, launches
        for name, by_n in launches["launches_by_n"].items():
            assert sum(by_n.values()) == launches[name], launches
        if nid.coarse_outer_iterations:  # both shapes of the coarse-to-fine solve
            assert len(launches["launches_by_n"]["nid_hist_fwd"]) == 2, launches
    if device == "cuda" and eager:
        assert launches["tap_take"] == launches["colorize_scatter"] == 0, launches
        assert launches["bin_pack"] == 0, launches
        assert launches["colorize_update"] == 0, launches
        if hpr:  # every cull and the smoothing through the twins
            assert launches["hpr_grid"] == launches["smooth_local"] == 0, launches
            assert launches["hpr_support"] == 0, launches
            assert launches["zmin"] == launches["zbuffer_visible"] == 0, launches
        else:  # the NID and colorize culls on the z-buffer kernels
            assert launches["zmin"] == launches["zbuffer_visible"] == 2 * K, launches
    elif device == "cuda":
        # The NID culls take the z-buffer kernels once a keyframe (under HPR
        # one H2 call for all the keyframes); colorize takes C1's pass (a)
        # (under HPR, one H2 call) once for all its keyframes and pass (b)
        # once a keyframe, each mask dump both (under HPR, H2 and pass (b)).
        steps = (2 if masks else 1) * K
        if hpr and small:  # "auto" takes H1: one call a cull batch
            assert launches["hpr_support"] == 2 and launches["hpr_grid"] == 0, launches
        if hpr and not small:
            assert launches["hpr_grid"] == 2 + steps - K and launches["hpr_support"] == 0, (
                launches)
        if hpr:
            assert launches["zmin"] == launches["zbuffer_visible"] == 0, launches
            assert launches["colorize_scatter"] == 0, launches
            assert launches["colorize_update"] == steps, (steps, launches)
            assert launches["smooth_local"] == 1, launches
        else:  # the NID culls of each build: the first and each re-cull
            assert launches["zmin"] == launches["zbuffer_visible"] == K * passes, launches
            assert launches["colorize_scatter"] == 1 + (K if masks else 0), launches
            assert launches["colorize_update"] == steps, (steps, launches)
            assert launches["hpr_grid"] == launches["smooth_local"] == 0, launches
        # G1: one launch a direct take. Every evaluation of the plain
        # objective gathers (the coarse phase's, all of the plain schedule's);
        # with frozen taps so does each refresh of the cache, the first
        # included, and the final exact evaluation.
        cache_kernels = ("tap_take_blocks", "wide_take", "wide_take_blocks", "wide_select")
        if nid.frozen_taps and not nid.per_keyframe:
            coarse = sum(c for n, c in launches["launches_by_n"]["nid_hist_fwd"].items()
                         if int(n) < n_cull)
            partial = sum(r.partial_gathers for _, r in solves)
            full = sum(r.gathers for _, r in solves) - partial
            # Each pass's final evaluation, and at margin 0 each full gather.
            fine = passes + (0 if nid.frozen_margin else full)
            takes = coarse + fine
            by_n = launches["launches_by_n"]["tap_take"]
            assert by_n.get(str(n_cull), 0) == fine, launches
            assert by_n.get(str(n_cull // nid.coarse_stride), 0) == coarse, launches
            if nid.frozen_margin:  # one W1 a frozen evaluation (each one K2 at the fine shape)
                frozen = launches["launches_by_n"]["nid_hist_bwd"].get(str(n_cull), 0)
                assert launches["wide_take"] == full >= 1, launches
                assert launches["wide_take_blocks"] == partial, launches
                assert launches["wide_select"] == frozen >= 1, launches
                assert launches["tap_take_blocks"] == 0, launches
            else:
                assert launches["tap_take_blocks"] == partial, launches
                assert launches["wide_take"] == launches["wide_select"] == 0, launches
        else:
            takes = launches["nid_hist_fwd"]
            assert all(launches[name] == 0 for name in cache_kernels), launches
        if nid.per_keyframe:
            # One K1, one K2 and one G1 launch an evaluation of the lockstep
            # solve, each for all K keyframes.
            lockstep = sum(r.lockstep_evaluations for _, r in solves)
            assert launches["nid_hist_fwd"] == launches["nid_hist_bwd"] == lockstep, (
                lockstep, launches)
            assert launches["launches_by_n"]["nid_hist_fwd"] == {str(n_cull): lockstep}, launches
        assert launches["tap_take"] == takes, (takes, launches)
        # One a solve; the re-cull passes reuse the first build's tiles.
        assert launches["bin_pack"] == 1, launches
        assert launches["mls_moments"] == (1 if mls else 0), launches
        assert launches["knn_select"] == (2 if mls else 0), launches
    if small and not eager:
        summary["dense_culls"] = check_dense_culls(card, label, dense_culls)
    if mls:
        t = res.timings
        split = {k: round(t[k], 3) for k in ("mls_sor1", "mls_fit", "mls_sor2", "mls_write")}
        kept = pcd.read(os.path.join(cfg.output_path, "scans-crop_mls.pcd")).points.shape[0]
        print(f"[{card}] {label}: MLS stage {t['mls']:.3f} s = {split} (s); {kept} of "
              f"{N_MAP} points kept in scans-crop_mls.pcd")
    if masks:
        check_mask_outputs(res, cfg.output_path, label)
    if picks:
        check_manual(card, label, res, cfg, solves, launches, T0, nid)
        # The path's solve again on its own inputs under torch.profiler (not
        # inside the path, whose stage times the profiler would inflate):
        # the same result, its wall and device-busy time and launches.
        (args, r), kw = solves[-1], solve_kw[-1]
        for _ in range(2):
            _reset_counts()
            again, wall_s, busy_ms, n_dev = _solve_device_ms(lambda: wrapped[1](*args, **kw),
                                                             device)
            counts = _read_counts()
            assert torch.equal(again.T_camera_lidar.q, r.T_camera_lidar.q), label
            assert float(again.nid) == float(r.nid) and again.gathers == r.gathers, label
            assert all(counts[key] == launches[key] for key in (
                "wide_take", "wide_take_blocks", "wide_select")), (counts, launches)
            print(f"[{card}] {label}: its solve again: wall {wall_s:.3f} s, device busy "
                  f"{_ms(busy_ms)} ms in {n_dev} device events (torch.profiler); G2 launches "
                  f"{counts['wide_take']}, its block form {counts['wide_take_blocks']}, W1 "
                  f"{counts['wide_select']}")

    # The written cloud: every colored point, colors in range, and the
    # colors carry the wall texture the images were rendered from. The bar
    # is "texture present", not "aligned": colorization composes the
    # correction as T_c2w ∘ T_correction (PointCloudProcessor.cpp:507), the
    # JAX package's convention, which on this scene shifts colors by about
    # twice the planted error (correlation ~0.85; ~0.97 with no correction,
    # ~0.999 with its inverse) — a reference-side fault recorded in
    # ROADMAP.md and kept here for parity.
    out = pcd.read(res.colored_cloud_path)
    summary["cloud"] = (out.points, out.rgb)
    assert len(out.points) == res.num_colored_points
    rgb = out.rgb
    assert np.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 255
    p = out.points
    on_wall = np.abs(p[:, 2] - bs.WALL_Z) < 1e-3

    def corr_over(sel):
        return float(np.corrcoef(rgb[sel].mean(-1), bs.field_wall(np, p[sel, 0], p[sel, 1]))[0, 1])

    # The wall behind the occluder as the keyframes see it (x in [0.3, 1.5]
    # and |y| <= 0.6 at 2.5 m, scaled by 6 / 2.5 from cameras at x in [0,
    # 0.84], with a margin): the cull decides its colors.
    shadow = (p[:, 0] > 0.5) & (p[:, 0] < 3.8) & (np.abs(p[:, 1]) < 1.6)
    corr, corr_open = corr_over(on_wall), corr_over(on_wall & ~shadow)
    print(f"{label}: wall color/texture correlation {corr:.4f} over {int(on_wall.sum())} points "
          f"({corr_open:.4f} outside the occluder's shadow, {int((on_wall & ~shadow).sum())} "
          "points)")
    if mls:
        # The SOR keeps ~62% of the map, so the occluder's 14-px z-buffer
        # cells go empty ~5x as often and more shadowed wall points take its
        # colors: the bar holds where the cull has no work.
        assert corr_open > 0.8 and corr > 0.7, (corr, corr_open)
    elif small:
        # A tenth of the map's points: the occluder's 12,500 leave gaps that
        # shadowed wall points show through, taking colors the texture does
        # not predict; the bar holds where the cull has no work.
        assert corr_open > 0.8 and corr > 0.6, (corr, corr_open)
    else:
        assert corr > 0.8, corr
    return launches, summary


def check_manual(card, label, res, cfg, solves, launches, T0, nid):
    """The cache + manual guess path's gates: each pose of
    manual_poses.json (one a picked keyframe) within 1 cm / 1 deg of the
    planted T0, and the NID at most the NID at T0 on the solve's keyframes
    + 1e-3. Prints the gathers, partial gathers, evaluations, the cache
    kernels' launches and the nid_refine and manual_guess stages' seconds.
    Runs after the path's counts are read (the NID at T0 launches G1 and
    K1)."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod

    with open(os.path.join(cfg.output_path, "manual_poses.json")) as f:
        manual = json.load(f)
    assert len(manual) == len(PICKED_KEYFRAMES), manual
    for ts, pose in manual.items():
        cm, deg = _pose_error(se3.SE3(torch.tensor(pose["quat_wxyz"]),
                                      torch.tensor(pose["translation"])), T0)
        print(f"{label}: manual pose of keyframe {ts}: error vs T0 {cm:.4f} cm / {deg:.4f} deg")
        assert cm < 1.0 and deg < 1.0, (ts, cm, deg)
    (camera, kfs, *_), r = solves[-1]
    with torch.no_grad():
        at_t0 = float(nid_mod.multi_nid_loss(camera, T0.to(kfs.points.device), kfs, nid.bins))
    print(f"[{card}] {label}: NID {res.nid_value:.6f} (at T0 {at_t0:.6f}); evaluations "
          f"{r.evaluations}; gathers {r.gathers} ({r.partial_gathers} partial); launches G2 "
          f"{launches['wide_take']}, G2 block form {launches['wide_take_blocks']}, W1 "
          f"{launches['wide_select']}, G1 {launches['tap_take']}, G1 block form "
          f"{launches['tap_take_blocks']}; nid_refine {res.timings['nid_refine']:.3f} s, "
          f"manual_guess {res.timings['manual_guess']:.3f} s")
    assert res.nid_value <= at_t0 + 1e-3, (res.nid_value, at_t0)


def check_dense_culls(card, label, culls):
    """Each mask of the small-map path's H1 calls against the dense twin
    run on the CPU on the same inputs (its directions at the gated points:
    the rest are not ok, so hidden), bit for bit; asserts two calls of K
    culls. Returns the mask bits checked and the visible points."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import hpr

    assert len(culls) == 2 and all(c[0].shape[0] == K for c in culls), [
        tuple(c[0].shape) for c in culls]
    t0 = time.perf_counter()
    checked, visible = 0, []
    for points, gate, radius, tol, out in culls:
        for p, g, o in zip(points.cpu(), gate.cpu(), out.cpu()):
            rows = torch.nonzero(g).flatten()
            ok, sup, self_ = hpr.hpr_support_plain(p, g, radius, rows=rows)
            want = torch.zeros_like(g)
            want[rows] = ok & (sup - self_ <= tol)
            differ = int((o != want).sum())
            assert differ == 0, f"{label}: an H1 cull differs from the CPU twin in {differ} bits"
            checked += g.numel()
            visible.append(int(o.sum()))
    print(f"[{card}] {label}: the {2 * K} H1 culls (8 NID, 8 colorize) bit-equal to the dense "
          f"twin on the CPU, {checked} mask bits; visible {visible} "
          f"(checked in {time.perf_counter() - t0:.1f} s)")
    return {"bits": checked, "visible": visible}


def compare_dense_twins(card, run, twins):
    """The small-map path against the same run through the dense twin on
    the card (its norm and cuBLAS product round otherwise than the CPU's,
    so a mask bit may differ): pose, NID and colored points side by side,
    printed, not gated."""
    keys = ("T", "nid", "evaluations", "colored")
    print(f"[{card}] small map, H1 vs the dense twin on the card: "
          + json.dumps({k: [run[k], twins[k]] for k in keys}))


def compare_smoothed(card, run, twins):
    """The HPR + smoothing run against the same run through the twins: the
    same pose, NID, evaluations, gathers and colored points at the same
    positions; colors within 1 of 255 as written (N1 sums its weights in
    another order than its twin, so a color can round the other way)."""
    keys = ("T", "nid", "evaluations", "gathers", "colored")
    same = {k: run[k] == twins[k] for k in keys}
    (p, rgb), (p_t, rgb_t) = run["cloud"], twins["cloud"]
    same["positions"] = p.shape == p_t.shape and bool(np.array_equal(p, p_t))
    err = float(np.abs(rgb.astype(np.float64) - rgb_t).max()) if same["positions"] else None
    print(f"[{card}] HPR + smoothing vs its twins: {same}; colors differ by at most {err} "
          f"(<= 1 required) over {len(p)} points")
    assert all(same.values()), (same, {k: (run[k], twins[k]) for k in keys})
    assert err <= 1.0, err


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


def _window_pixels(knot, w, h, lo=-1, hi=3):
    """Distinct pixels of the clipped windows that the knots read, summed
    over the keyframes (each reads its own image): rows and columns lo..hi-1
    around the clipped anchor (-1..2: the 4x4 window; -1-m..2+m: the wide
    window of margin m), each clamped into the image."""
    import torch

    u = torch.clamp(knot[..., 0].long(), 0, w - 1)
    v = torch.clamp(knot[..., 1].long(), 0, h - 1)
    d = torch.arange(lo, hi, device=knot.device)
    total = 0
    for j in range(knot.shape[0]):
        cols = torch.clamp(u[j, :, None] + d, 0, w - 1)
        rows = torch.clamp(v[j, :, None] + d, 0, h - 1)
        seen = torch.zeros(h * w, dtype=torch.bool, device=knot.device)
        seen[(rows[:, :, None] * w + cols[:, None, :]).reshape(-1)] = True
        total += int(seen.sum())
    return total


def _tiles_touched(knot, w, h):
    """Distinct 32-byte tiles of the packed bin image that the knots read,
    over all keyframes: each clipped 4x4 window lies in one tile
    (``tap_gather.bin_tile_shape``)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg

    k = knot.shape[0]
    th, tw = tg.bin_tile_shape(h, w)
    u = torch.clamp(knot[..., 0].long(), 0, w - 1)
    v = torch.clamp(knot[..., 1].long(), 0, h - 1)
    kf = torch.arange(k, device=knot.device)[:, None]
    ty = torch.clamp(v - 1, min=0) // tg.STRIDE
    tx = torch.clamp(u - 1, min=0) // tg.STRIDE
    return int(torch.unique((kf * th + ty) * tw + tx).numel())


def _cold_ms(fn, device="cuda", reps=20):
    """Device time of ``fn()`` with L2 flushed before each call (a 384 MB
    fill queued ahead of the start event, behind the host-hiding sleep), as
    a caller finds it after other work; None off the card."""
    import torch

    from pointcloudprocessor_tpu_torch.utils import profiling

    if device != "cuda":
        fn()
        return None
    flush = torch.empty(96 * 2**20, dtype=torch.int32, device=device)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(profiling._HIDE_CYCLES)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden:
            times.append(a.elapsed_time(b))
    return float(np.median(times)) if 2 * len(times) >= reps else None


def phase_direct_take(card, camera, kfs, T0, device="cuda"):
    """G1 (``tap_take``) and its packer (``bin_pack``) on the scene's 8
    keyframes of 4096x3000, as the headline's solve runs them: the points
    in map order (no raster sort on the direct path). The packer bit-equal
    to its twin; G1 bit-equal to its twin and to ``tap_rows[kf, anchor]``
    (the port's ``nid.build_tap_table``, which tests/test_torch_tap_take.py
    holds to the JAX package's on the CPU; built here for this comparison
    only) on every point: map order at the start pose and at T0, the coarse subsample
    (every 16th point), the sort pose, the edge knots, an odd-size image
    (4095 x 2999, padded tiles) and a ragged n. Times at both shapes on
    map-order knots at T0 beside ``index_select`` of the table rows, warm
    and with L2 flushed, at the sort pose, and inside a value+grad
    evaluation of the objective at each shape. Returns the G1 and bin_pack
    records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg
    from pointcloudprocessor_tpu_torch.opt import nid, refine

    w, h = camera.width, camera.height
    _reset_counts()
    kp = nid.prepare_keyframes(kfs)
    assert kp.tap_rows is None, "the direct path built a tap table"
    assert device != "cuda" or _read_counts()["bin_pack"] == 1
    k = kp.bin_image.shape[0]
    # The packer against its twin, and timed.
    twin_tiles = tg.pack_bins_plain(kp.bin_image)
    assert torch.equal(kp.bin_tiles, twin_tiles), "bin_pack != its twin"
    tiles = kp.bin_tiles
    pack_dev = _device_ms(lambda: tg.pack_bins(kp.bin_image), device)
    pack_call = _median_ms(lambda: tg.pack_bins(kp.bin_image), device)
    pack_twin = _median_ms(lambda: tg.pack_bins_plain(kp.bin_image), device)
    pack_bytes = _nbytes(kp.bin_image, tiles)
    pack_bound, pack_by = _bound(pack_bytes)
    share = "not measured" if pack_dev is None else f"{pack_bound / pack_dev:.2f}"
    print(f"[{card}] bin_pack {tuple(kp.bin_image.shape)} -> {tuple(tiles.shape)} "
          f"({_nbytes(tiles) / 2**20:.1f} MiB): bit-equal to its twin; device {_ms(pack_dev)} "
          f"ms, a call {_ms(pack_call)}, twin {_ms(pack_twin)}; bound {pack_bound * 1e3:.1f} us "
          f"({pack_by}: {pack_bytes} B), at {share} of it")
    # Small and ragged images (random bins, negatives included: the low 4
    # bits count), and a bin image 4 bytes off 16-byte alignment (the
    # packer's scalar loads): bit-equal to the twin.
    rs = np.random.default_rng(SEED)
    for shape in ((1, 1, 1), (2, 9, 8), (3, 13, 21), (2, 97, 401)):
        b = torch.from_numpy(rs.integers(-40, 40, shape).astype(np.int32)).to(device)
        assert torch.equal(tg.pack_bins(b), tg.pack_bins_plain(b)), f"bin_pack != twin, {shape}"
    flat = torch.from_numpy(rs.integers(0, 16, 2 * 300 * 400 + 1).astype(np.int32)).to(device)
    b = flat[1:].view(2, 300, 400)
    assert torch.equal(tg.pack_bins(b), tg.pack_bins_plain(b)), "bin_pack != twin, unaligned"
    print("bin_pack bit-equal to its twin at 1x1, 9x8, 13x21 and 97x401 (random bins) and on a "
          "2 x 300x400 image 4 bytes off 16-byte alignment")
    # The port's tap table, for the comparison alone.
    table = torch.stack([nid.build_tap_table(b) for b in kp.bin_image])
    rows = table.reshape(-1, 2)
    r = table.shape[1]
    kf_off = torch.arange(k, dtype=torch.int32, device=device)[:, None] * r
    rec = {"name": "tap_take", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
           "replaces": "pointcloudprocessor_tpu/opt/nid.py:514", "max_abs_err": 0.0}

    def check(label, knot, tl=tiles, tab=table, width=w, height=h):
        _reset_counts()
        got = tg.direct_take(tl, knot, width, height)
        launched = _read_counts()["tap_take"]
        twin = tg.direct_take_plain(tl, knot, width, height)
        anchor = tg.anchors(knot, width, height)
        want = tab[torch.arange(knot.shape[0], device=device)[:, None], anchor.long()]
        err = float((got.long() - twin.long()).abs().max()) if got.numel() else 0.0
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        assert torch.equal(got, twin), f"G1 != its twin, {label}"
        assert torch.equal(got, want), f"G1 != tap_rows[kf, anchor], {label}"
        assert device != "cuda" or launched == (1 if knot.shape[1] else 0), launched
        print(f"G1 tap_take, {label}: {tuple(knot.shape[:2])} knots bit-equal to its twin and to "
              "tap_rows[kf, anchor] on every point")

    coarse = refine._subsample_keyframes(kp, HEADLINE["coarse_stride"])
    srt = nid.sort_by_raster(camera, se3.identity(device), kp)
    knots = {}
    for label, kk, T in (("map order, start pose", kp, se3.identity(device)),
                         ("map order, T0", kp, T0.to(device)),
                         ("coarse map order, T0", coarse, T0.to(device)),
                         ("sort pose", srt, se3.identity(device))):
        knots[label] = nid._project_all(camera, T, kk)[1]
        check(label, knots[label])
    del srt, coarse
    # Edge knots: each keyframe's corners and edges, one past them, negative,
    # +-1e9 (behind the camera) and the int32 extremes, crossed, then 3,001
    # knots drawn in [-1e9, 1e9] (a ragged count).
    ends = np.asarray([0, 1, w - 1, w, w + 1, -1, -7, 10**9, -10**9, 2**31 - 1, -2**31], np.int64)
    uu, vv = np.meshgrid(ends, np.concatenate([ends[:2], [h - 1, h, h + 1], ends[5:]]))
    rs = np.random.default_rng(SEED)
    edge = np.concatenate([np.stack([uu.ravel(), vv.ravel()], -1),
                           rs.integers(-10**9, 10**9, (3001, 2))]).astype(np.int32)
    edge = torch.from_numpy(np.stack([np.roll(edge, j, axis=0) for j in range(k)])).to(device)
    check("edge knots", edge)
    fine = knots["map order, T0"]
    n = fine.shape[1]
    check(f"ragged n = {n - 77}", fine[:, : n - 77].contiguous())
    # An odd-size image: its last tile row and column padded.
    ow, oh = w - 1, h - 1
    odd_bins = kp.bin_image[:, :oh, :ow].contiguous()
    odd_tiles = tg.pack_bins(odd_bins)
    assert torch.equal(odd_tiles, tg.pack_bins_plain(odd_bins)), "bin_pack != twin, odd size"
    odd_table = torch.stack([nid.build_tap_table(b) for b in odd_bins])
    check(f"{ow} x {oh} image", fine, odd_tiles, odd_table, ow, oh)
    check(f"{ow} x {oh} image, edge knots", edge, odd_tiles, odd_table, ow, oh)
    del odd_bins, odd_tiles, odd_table

    # Times: both shapes on map-order knots at T0, and the sort pose.
    times = {}
    for label in ("map order, T0", "coarse map order, T0", "sort pose"):
        knot = knots[label]
        flat = (tg.anchors(knot, w, h) + kf_off).reshape(-1)
        fns = {"kernel": lambda knot=knot: tg.direct_take(tiles, knot, w, h),
               "index_select": lambda flat=flat: torch.index_select(rows, 0, flat),
               "twin": lambda knot=knot: tg.direct_take_plain(tiles, knot, w, h)}
        t = {f"{key} device": _device_ms(fn, device) for key, fn in fns.items()}
        t["kernel device again"] = _device_ms(fns["kernel"], device)
        for key in ("kernel", "index_select"):
            t[f"{key} cold"] = _cold_ms(fns[key], device)
        for key in fns:
            t[f"{key} call"] = _median_ms(fns[key], device)
        t["kernel host us"] = _host_us(fns["kernel"], device)
        # The bound: each knot read and each row written once (16 B a
        # point), and each distinct pixel of the windows read once at 4 bits.
        # The whole 32-byte tiles the windows touch (a tile holds 64 pixels,
        # 25 of them its own, and a window reads 16) are printed beside it,
        # a floor of this layout, not of the function.
        pixels = _window_pixels(knot, w, h)
        nbytes = 2 * _nbytes(knot) + pixels / 2
        t["bound"], t["bound_by"] = _bound(nbytes)
        tiles_n = _tiles_touched(knot, w, h)
        t["sector bound"] = _bound(2 * _nbytes(knot) + 32 * tiles_n)[0]
        times[label] = t
        share = (f"{t['bound'] / t['kernel device']:.2f}" if t["kernel device"]
                 else "not measured")
        print(f"[{card}] G1 tap_take, {label} {tuple(knot.shape[:2])}: device ms "
              + ", ".join(f"{key} {_ms(v)}" for key, v in t.items()
                          if key not in ("bound", "bound_by", "sector bound", "kernel host us"))
              + f"; host us {_ms(t['kernel host us'])}; bound {t['bound'] * 1e3:.2f} us "
              f"({t['bound_by']}: {nbytes:.0f} B, {pixels} distinct window pixels), kernel at "
              f"{share} of it; whole-sector floor {t['sector bound'] * 1e3:.2f} us ({tiles_n} "
              "tiles of 32 B)")
    # G1 as an evaluation finds it: one value+grad of the objective at T0 on
    # each shape (projection, G1, K1, entropies, K2), G1's device time from
    # torch.profiler; the coarse shape's windows stay in L2 from one
    # evaluation to the next.
    in_eval = {}
    for label, kk in (("fine", kp), ("coarse", refine._subsample_keyframes(
            kp, HEADLINE["coarse_stride"]))):
        def evaluation(kk=kk):
            xi = torch.zeros(6, device=device, requires_grad=True)
            nid.multi_nid_loss(camera, se3.compose(T0.to(device), se3.exp(xi)), kk).backward()

        prof = _kernel_profile(evaluation, device)
        in_eval[label] = prof["tap_take_kernel"][1] * 1e-3 if prof else None
        if prof:
            assert prof["tap_take_kernel"][0] == 1, prof
            print(f"[{card}] G1 in a value+grad evaluation at T0, {label} shape: "
                  f"{_ms(in_eval[label])} ms of device time; the evaluation's kernels (launches, "
                  "mean us): " + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
    main_t, coarse_t, sort_t = (times[x] for x in ("map order, T0", "coarse map order, T0",
                                                   "sort pose"))
    # The twin's host side can outlast the hidden host time (its device time
    # is then not measured): its call time stands in.
    rec.update(ms=main_t["kernel device"], ms_again=main_t["kernel device again"],
               plain_ms=main_t["twin device"] or main_t["twin call"], bound_ms=main_t["bound"],
               bound_by=main_t["bound_by"], library_ms=main_t["index_select device"],
               call_ms=main_t["kernel call"], library_call_ms=main_t["index_select call"],
               cold_ms=main_t["kernel cold"], library_cold_ms=main_t["index_select cold"],
               host_us=main_t["kernel host us"], map_order_ms=main_t["kernel device"],
               coarse_ms=coarse_t["kernel device"], coarse_cold_ms=coarse_t["kernel cold"],
               coarse_bound_ms=coarse_t["bound"], sector_bound_ms=main_t["sector bound"],
               coarse_sector_bound_ms=coarse_t["sector bound"],
               coarse_library_ms=coarse_t["index_select device"],
               sort_pose_ms=sort_t["kernel device"],
               sort_pose_library_ms=sort_t["index_select device"],
               in_eval_ms=in_eval["fine"], coarse_in_eval_ms=in_eval["coarse"])
    del table, rows
    pack = {"name": "bin_pack", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
            "replaces": "pointcloudprocessor_tpu/opt/nid.py:120", "max_abs_err": 0.0,
            "ms": pack_dev, "call_ms": pack_call, "plain_ms": pack_twin,
            "bound_ms": pack_bound, "bound_by": pack_by, "library_ms": None}
    return [rec, pack]


def phase_tap_gather(card, camera, kfs, T0, device="cuda"):
    """K3/K4 on the scene's 8 x 4096x3000 row tables, the culled points
    raster-sorted at the start pose (identity): at that pose (clean groups,
    the fast path expected) and at the planted error T0 (heavy overflow,
    the fallback expected). Each kernel equals its twin on every row, flag
    and count, and the direct take on the ok rows of clean groups; the
    whole grouped take equals the direct take on every ok row and launches
    its kernel once. Returns per-kernel records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg
    from pointcloudprocessor_tpu_torch.opt import nid

    kfs = nid.sort_by_raster(camera, se3.identity(device),
                             nid.prepare_keyframes(kfs, grouped=True))
    k, r, _ = kfs.tap_rows.shape
    slab = kfs.slab_width
    rows = kfs.tap_rows.reshape(k * r, 2)
    kf_idx = torch.arange(k, device=device)[:, None]
    kernels = {"tap_select": tg.grouped_select_slabbed, "tap_streamed": tg.grouped_select_streamed}
    twins = {"tap_select": tg.grouped_select_slabbed_plain,
             "tap_streamed": tg.grouped_select_streamed_plain}
    takes = {"tap_select": ("grouped_take_slabbed", tg.grouped_take_slabbed, True),
             "tap_streamed": ("grouped_take_streamed", tg.grouped_take_streamed, "streamed")}
    records = {name: {"max_abs_err": 0.0} for name in kernels}
    for pose_label, T in (("sort pose", se3.identity(device)), ("planted T0", T0.to(device))):
        _, knot, inl = nid._project_all(camera, T, kfs)
        anchor = tg.anchors(knot, camera.width, camera.height)
        flat = (anchor + torch.arange(k, dtype=torch.int32, device=device)[:, None] * r).reshape(-1)
        ok = inl.reshape(-1)
        n = flat.shape[0]
        flat64 = flat.long()
        direct = rows[flat64]
        for name, kernel in kernels.items():
            take_name, take, use_grouped = takes[name]
            got = kernel(rows, flat, ok, slab=slab)
            twin = twins[name](rows, flat, ok, slab=slab)
            err = float((got.taps.long() - twin.taps.long()).abs().max())
            n_ovf = int(got.n_ovf)
            assert err == 0.0 and torch.equal(got.taps, twin.taps), f"{name}: kernel != twin"
            assert torch.equal(got.ovf_grp, twin.ovf_grp), f"{name}: flags != twin"
            assert n_ovf == int(twin.n_ovf) == int(got.ovf_grp.sum()), f"{name}: count != twin"
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
            ng, group, _ = got.taps.shape
            clean = ok & ~got.ovf_grp.repeat_interleave(group)[:n]
            taps = got.taps.reshape(-1, 2)[:n]
            assert torch.equal(taps[clean], direct[clean]), f"{name}: kernel != direct take"
            _reset_counts()
            out = take(rows, flat, ok, slab=slab)
            counts = _read_counts()
            assert torch.equal(out[ok], direct[ok]), f"{name}: grouped take != direct take"
            fell_back = counts[f"{take_name}_fallbacks"] == 1
            if device == "cuda":  # one launch a grouped take, fallback or not
                assert counts[name] == counts[take_name] == 1, (name, counts)
            print(f"{name} at the {pose_label}: overflow groups {n_ovf} of {ng}; "
                  f"{'fallback (per-row lookup)' if fell_back else 'fast path (repair only)'}; "
                  f"kernel == twin on all {ng * group} rows, flags and count; == tap_rows[kf, "
                  f"anchor] on {int(clean.sum())} clean ok rows; grouped take == it on "
                  f"{int(ok.sum())} ok rows")
            if pose_label == "planted T0":
                records[name]["fallback_take_ms"] = _median_ms(
                    lambda: take(rows, flat, ok, slab=slab), device)
                continue
            assert not fell_back, f"{name}: the fast path was expected at the sort pose"
            # Whole masked groups and steps, and a ragged point count: the
            # kernel's padding and all-masked rules, against the twin.
            ok_holes = ok.clone()
            ok_holes[1024:2048] = False
            ok_holes[5000:5300] = False
            for f, o in ((flat, ok_holes), (flat[: n - 77], ok[: n - 77])):
                a, b = kernel(rows, f, o, slab=slab), twins[name](rows, f, o, slab=slab)
                assert torch.equal(a.taps, b.taps) and torch.equal(a.ovf_grp, b.ovf_grp) and int(
                    a.n_ovf) == int(b.n_ovf), f"{name}: kernel != twin with masked steps / ragged n"
            # The bound: each index and mask byte read once, each distinct
            # table row that an ok point needs read once (8 B), the taps,
            # flags and count written once. Counted in whole 32-byte sectors
            # of the table, the practical floor of scattered rows.
            need = flat[ok]
            n_rows = int(torch.unique(need).numel())
            n_sectors = int(torch.unique(need // 4).numel())
            io = _nbytes(flat, ok, got.taps, got.ovf_grp, got.n_ovf)
            bound_ms, bound_by = _bound(io + 8 * n_rows)
            sector_ms = _bound(io + 32 * n_sectors)[0]

            def run():
                return kernel(rows, flat, ok, slab=slab)

            def run_twin():
                return twins[name](rows, flat, ok, slab=slab)

            def library():
                return torch.index_select(rows, 0, flat)

            def direct64():
                return rows[flat64]

            def eager_take():
                return kfs.tap_rows[kf_idx, anchor.long()]

            dev_t = {key: _device_ms(fn, device) for key, fn in (
                ("kernel", run), ("twin", run_twin), ("index_select", library),
                ("direct take, int64 index", direct64),
                ("eager table take", eager_take), ("kernel again", run))}
            call_t = {key: _median_ms(fn, device) for key, fn in (
                ("kernel", run), ("index_select", library),
                ("eager table take", eager_take),
                ("grouped take", lambda: take(rows, flat, ok, slab=slab)),
                ("_gather_taps direct",
                 lambda: nid._gather_taps(camera, kfs, knot, inl, use_grouped=False)),
                ("_gather_taps grouped",
                 lambda: nid._gather_taps(camera, kfs, knot, inl, use_grouped=use_grouped)))}
            host_t = {key: _host_us(fn, device) for key, fn in (
                ("kernel", run), ("index_select", library),
                ("eager table take", eager_take))}
            print(f"[{card}] {name} {k}x{n // k} points, slab {slab}: device ms: "
                  + ", ".join(f"{key} {_ms(v)}" for key, v in dev_t.items()))
            print(f"[{card}] {name}: ms a call (host included): "
                  + ", ".join(f"{key} {_ms(v)}" for key, v in call_t.items()))
            print(f"[{card}] {name}: host us a call: "
                  + ", ".join(f"{key} {_ms(v)}" for key, v in host_t.items()))
            share = f"{bound_ms / dev_t['kernel']:.2f}" if dev_t["kernel"] else "not measured"
            print(f"{name} bound {bound_ms * 1e3:.1f} us ({bound_by}: {io + 8 * n_rows} B, "
                  f"{n_rows} distinct rows of {int(ok.sum())} ok points), kernel at {share} "
                  f"of it; whole-sector floor {sector_ms * 1e3:.1f} us ({n_sectors} sectors)")
            records[name].update(
                ms=dev_t["kernel"], plain_ms=dev_t["twin"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=dev_t["index_select"],
                eager_take_ms=dev_t["eager table take"], call_ms=call_t["kernel"],
                eager_take_call_ms=call_t["eager table take"],
                take_ms=call_t["grouped take"])
    for name, rec in records.items():
        print(f"[{card}] {name}: whole grouped take {_ms(rec['take_ms'])} ms at the sort pose, "
              f"{_ms(rec['fallback_take_ms'])} ms at T0")
    return [
        {"name": "tap_select", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
         "replaces": "pointcloudprocessor_tpu/ops/tap_gather.py:95", **records["tap_select"]},
        {"name": "tap_streamed", "route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu",
         "replaces": "pointcloudprocessor_tpu/ops/tap_gather.py:343", **records["tap_streamed"]},
    ]


def phase_grouped(card, camera, kfs, T0, device="cuda"):
    """The frozen-tap solve with each tap gather (direct, K3, K4) from the
    start pose, raster-sorted there; no coarse phase (it would move the pose
    before the first grouped gather, `nid.py:469-486`). Then K3 once more
    with the plane-concat slab table built at entry, as the grouped path
    held it before it read the row table. Prints the peak device memory of
    each solve. Returns the launch counts of each solve."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import nid, refine

    def mib(b):
        return f"{b / 2**20:.1f} MiB" if b is not None else "not measured"

    nids, counts, peaks = {}, {}, {}
    runs = (("direct", False, False), ("K3", True, False), ("K4", "streamed", False),
            ("K3 + slab table", True, True))
    for label, G, slabs in runs:
        _reset_counts()
        cuda = device == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        solve_kfs = nid.prepare_keyframes(kfs, build_slabs=True) if slabs else kfs
        res = refine.refine_pose(
            camera, solve_kfs, se3.identity(device), frozen_taps=True, frozen_guard_frac=0.75,
            max_outer_iterations=2, max_inner_iterations=20, ftol=3e-4, sort_points=True,
            use_grouped_gather=G,
        )
        nid_value = float(res.nid)
        wall = time.perf_counter() - t0
        del solve_kfs
        peaks[label] = torch.cuda.max_memory_allocated() - held if cuda else None
        counts[label] = _read_counts()
        err_cm, err_deg = _pose_error(res.T_camera_lidar, T0)
        nids[label] = nid_value
        print(f"[{card}] grouped path, {label} (use_grouped_gather={G!r}): refine {wall:.2f} s; "
              f"NID {nid_value:.6f}; error {err_cm:.4f} cm / {err_deg:.4f} deg; evaluations "
              f"{res.evaluations}; gathers {res.gathers}; peak device memory above the "
              f"keyframes {mib(peaks[label])}; counts {counts[label]}")
        assert np.isfinite(nid_value) and err_cm < 1.0 and err_deg < 1.0, label
    if device == "cuda":
        for label, name, take in (("K3", "tap_select", "grouped_take_slabbed"),
                                  ("K4", "tap_streamed", "grouped_take_streamed")):
            c = counts[label]
            assert c[name] == c[take] >= 1 and c[f"{take}_fallbacks"] >= 1, (label, c)
    spread = max(nids.values()) - min(nids.values())
    print(f"grouped path: final NIDs spread {spread:.2e} (tol 1e-3)")
    assert spread <= 1e-3, nids
    return counts


# The frozen-tap cache's drifts: the planted correction moved along the
# camera's x axis by this many pixels on the wall (bench_scene.WALL_Z).
DRIFT_PX = (1.5, 4.5)
MARGINS = (1, 2)
# The cache + manual guess path: the headline schedule with the cache's
# widest window and a partial refresh, and 12 picked pairs for 4 keyframes.
CACHE_MANUAL = dict(HEADLINE, frozen_margin=2, frozen_partial_frac=0.25)
PICKED_KEYFRAMES, PICKS_A_KEYFRAME = (0, 2, 4, 6), 12


def _drifted(T0, px):
    """T0 moved ``px`` pixels along u at the wall's depth."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    xi = torch.tensor([px * bs.WALL_Z / bs.focal(WIDTH), 0.0, 0.0, 0.0, 0.0, 0.0])
    return se3.compose(T0, se3.exp(xi))


def _block_list(drifted, cap):
    """The (K, cap) int32 ids of the 128-point blocks holding a drifted
    point, ascending, padded with nb (``opt/nid._refresh``'s list)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg

    k, n = drifted.shape
    nb = n // tg.PARTIAL_BLOCK
    dirty = torch.any(drifted.reshape(k, nb, tg.PARTIAL_BLOCK), dim=2)
    iota = torch.arange(nb, dtype=torch.int32, device=drifted.device)
    return torch.sort(torch.where(dirty, iota, nb), dim=1).values[:, :cap].contiguous()


def _block_knots(knot, blocks):
    """[(1, P_j, 2)] the knots of keyframe j's listed blocks (ids below nb)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg

    nb = knot.shape[1] // tg.PARTIAL_BLOCK
    step = torch.arange(tg.PARTIAL_BLOCK, device=knot.device)
    return [knot[j, (blocks[j][blocks[j] < nb].long()[:, None] * tg.PARTIAL_BLOCK
                     + step).reshape(-1)][None] for j in range(knot.shape[0])]


def phase_wide_cache(card, camera, kfs, T0, device="cuda"):
    """G2 (``wide_take``), W1 (``wide_select``) and the block forms of G1
    and G2 (``tap_take_blocks``, ``wide_take_blocks``) on the scene's 8
    keyframes of 262,144 points (map order, as the frozen solve runs them),
    the cache gathered at T0 and the pose drifted by 1.5 and 4.5 px; at
    margins 1 and 2. G2 bit-equal to its twin (at T0, on edge knots, on a
    ragged n and on a 4095 x 2999 image); W1 bit-equal to its twin at each
    drift, and its taps and effective knots equal to G1's direct take at
    the drifted knots on every point live under both gates within the
    margin; each block form bit-equal to its twin, in place, on the block
    list of a real drift (points drifted past the guard: >= 1 px for G1's,
    >= m + 1 px for G2's). G2 also bit-equal at every pixel of one
    keyframe, on the scene's image, the 4095 x 2999 one and a 4093 x 2998
    one (each side 3 mod 5); the addressing model ``wide_take_plan`` equal
    to G2 on the scene's knots, with its sectors and 16-byte loads a point.
    One launch a call each. Times each beside its bound and its twin, G2
    beside ``index_select`` on a (K H W, 4 + 2m) wide table built once.
    Returns the four records (margin 2's as ``ms``, margin 1's as
    ``m1_*``)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import tap_gather as tg
    from pointcloudprocessor_tpu_torch.opt import nid

    w, h = camera.width, camera.height
    kp = nid.prepare_keyframes(kfs)
    tiles = kp.bin_tiles
    k, n = kp.points.shape[:2]
    nb = n // tg.PARTIAL_BLOCK
    _, kc, inl_c = nid._project_all(camera, T0.to(device), kp)
    drift = {px: nid._project_all(camera, _drifted(T0, px).to(device), kp)[1:]
             for px in DRIFT_PX}
    base = {"route": "cuda", "source": f"{PKG}/csrc/tap_gather.cu", "max_abs_err": 0.0}
    recs = {
        "wide_take": dict(base, name="wide_take",
                          replaces="pointcloudprocessor_tpu/opt/nid.py:637"),
        "wide_select": dict(base, name="wide_select",
                            replaces="pointcloudprocessor_tpu/opt/nid.py:653", library_ms=None),
        "tap_take_blocks": dict(base, name="tap_take_blocks",
                                replaces="pointcloudprocessor_tpu/opt/nid.py:606",
                                library_ms=None),
        "wide_take_blocks": dict(base, name="wide_take_blocks",
                                 replaces="pointcloudprocessor_tpu/opt/nid.py:690",
                                 library_ms=None),
    }

    def once(name, fn):
        """fn() with the counts at 0; asserts one launch of ``name``."""
        _reset_counts()
        out = fn()
        launched = _read_counts()[name]
        assert device != "cuda" or launched == 1, (name, launched)
        return out

    def timed(rec, prefix, label, fn, twin, nbytes, library=None):
        t = {"ms": _device_ms(fn, device), "call_ms": _median_ms(fn, device),
             "plain_ms": _device_ms(twin, device) or _median_ms(twin, device)}
        t["bound_ms"], t["bound_by"] = _bound(nbytes)
        if library is not None:
            t["library_ms"] = _device_ms(library, device)
            t["library_call_ms"] = _median_ms(library, device)
        rec.update({f"{prefix}{key}": v for key, v in t.items()})
        share = f"{t['bound_ms'] / t['ms']:.2f}" if t["ms"] else "not measured"
        print(f"[{card}] {rec['name']}, {label}: device {_ms(t['ms'])} ms, a call "
              f"{_ms(t['call_ms'])}, twin {_ms(t['plain_ms'])}"
              + (f", index_select on the wide table {_ms(t['library_ms'])}" if library else "")
              + f"; bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: {nbytes:.0f} B), at "
              f"{share} of it")

    rs = np.random.default_rng(SEED)
    ends = np.asarray([0, 1, w - 1, w, -1, -7, 10**9, -10**9, 2**31 - 1, -2**31], np.int64)
    uu, vv = np.meshgrid(ends, np.asarray([0, 1, h - 1, h, -1, 10**9, -2**31], np.int64))
    edge = np.concatenate([np.stack([uu.ravel(), vv.ravel()], -1),
                           rs.integers(-10**9, 10**9, (3001, 2))]).astype(np.int32)
    edge = torch.from_numpy(np.stack([np.roll(edge, j, axis=0) for j in range(k)])).to(device)
    odd_bins = kp.bin_image[:, : h - 1, : w - 1].contiguous()
    odd_tiles = tg.pack_bins(odd_bins)
    # Each side 3 mod 5: the last tile column and row hold 3 columns and
    # rows of the image.
    w3, h3 = w - 3, h - 2
    tiles3 = tg.pack_bins(kp.bin_image[:1, :h3, :w3].contiguous())
    yy, xx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    every = torch.stack([xx, yy], -1).reshape(1, -1, 2).to(torch.int32)
    del xx, yy

    for m in MARGINS:
        prefix = "" if m == 2 else f"m{m}_"
        rows = 4 + 2 * m
        # G2 against its twin.
        wide = once("wide_take", lambda: tg.wide_take(tiles, kc, w, h, m))
        assert torch.equal(wide, tg.wide_take_plain(tiles, kc, w, h, m)), f"G2 != twin, m {m}"
        checks = (("edge knots", (tiles, edge, w, h)),
                  (f"ragged n = {n - 77}", (tiles, kc[:, : n - 77].contiguous(), w, h)),
                  (f"{w - 1} x {h - 1} image", (odd_tiles, kc, w - 1, h - 1)),
                  (f"{w - 1} x {h - 1} image, edge knots", (odd_tiles, edge, w - 1, h - 1)),
                  (f"every pixel of keyframe 0", (tiles[:1], every, w, h)),
                  (f"every pixel of keyframe 0, {w - 1} x {h - 1} image",
                   (odd_tiles[:1], every[:, : (h - 1) * w], w - 1, h - 1)),
                  (f"every pixel of keyframe 0, {w3} x {h3} image",
                   (tiles3, every[:, : h3 * w], w3, h3)))
        for label, args in checks:
            got = once("wide_take", lambda: tg.wide_take(*args, m))
            assert torch.equal(got, tg.wide_take_plain(*args, m)), (label, m)
            del got
        # The addressing model on the scene's knots: its planes, and what a
        # point reads under it.
        planes, sectors, loads, read = tg.wide_take_plan(tiles, kc, w, h, m)
        assert torch.equal(planes, wide), f"the addressing model != G2, m {m}"
        counts = {"sectors_a_point": float(sectors.double().mean()),
                  "sectors_max": int(sectors.max()),
                  "loads16_a_point": float(loads.double().mean()), "loads16_max": int(loads.max()),
                  "distinct_sectors": sum(int(torch.unique(r[r >= 0]).numel()) for r in read)}
        del planes, sectors, loads, read
        print(f"G2 wide_take, m = {m}: {tuple(wide.shape)} planes at T0 bit-equal to its twin; "
              f"also on edge knots, a ragged n, a {w - 1} x {h - 1} image and every pixel of "
              f"keyframe 0 of it, the scene's and a {w3} x {h3} image; the addressing model "
              f"equal to G2: "
              f"{counts['sectors_a_point']:.4f} sectors a point (max {counts['sectors_max']}), "
              f"{counts['loads16_a_point']:.4f} 16-byte loads (max {counts['loads16_max']}); "
              f"{counts['distinct_sectors']} distinct sectors over the {k} keyframes "
              f"({counts['distinct_sectors'] * 32 / 1e6:.1f} MB of the tiles' "
              f"{_nbytes(tiles) / 1e6:.1f})")
        # The yardstick: index_select on the wide table, built once by G2 from
        # every pixel's knot.
        table = tg.wide_take(tiles, every.expand(k, -1, -1).contiguous(), w, h, m)
        table = table.permute(0, 2, 1).reshape(-1, rows).contiguous()
        flat = (tg.anchors(kc, w, h).long()
                + torch.arange(k, device=device)[:, None] * (h * w)).reshape(-1)
        assert torch.equal(torch.index_select(table, 0, flat).reshape(k, n, rows),
                           wide.permute(0, 2, 1)), "G2 != the wide table's rows"
        pixels = _window_pixels(kc, w, h, lo=-1 - m, hi=3 + m)
        timed(recs["wide_take"], prefix, f"m = {m}", lambda: tg.wide_take(tiles, kc, w, h, m),
              lambda: tg.wide_take_plain(tiles, kc, w, h, m),
              _nbytes(kc) + _nbytes(wide) + pixels / 2,
              library=lambda: torch.index_select(table, 0, flat))
        recs["wide_take"][f"{prefix}window_pixels"] = pixels
        recs["wide_take"].update({f"{prefix}{key}": v for key, v in counts.items()})
        del table, flat
        # W1 at each drift, and its exactness within the margin.
        for px in DRIFT_PX:
            kt, inl_t = drift[px]
            taps, eff = once("wide_select", lambda: tg.wide_select(wide, kt, kc, m))
            twin_taps, twin_eff = tg.wide_select_plain(wide, kt, kc, m)
            assert torch.equal(taps, twin_taps) and torch.equal(eff, twin_eff), ("W1", m, px)
            exact = tg.direct_take(tiles, kt, w, h)
            within = inl_c & inl_t & ((kt.long() - kc.long()).abs().amax(-1) <= m)
            assert torch.equal(taps[within], exact[within]), ("W1 != G1 within the margin", m, px)
            assert torch.equal(eff[within], kt[within]), ("W1's knots", m, px)
            print(f"W1 wide_select, m = {m}, drift {px} px: bit-equal to its twin; taps and knots "
                  f"equal to G1's direct take at the drifted knots on all {int(within.sum())} "
                  f"points live under both gates within the margin (of "
                  f"{int((inl_c & inl_t).sum())} live under both)")
            if px == DRIFT_PX[0]:
                timed(recs["wide_select"], prefix, f"m = {m}, drift {px} px",
                      lambda: tg.wide_select(wide, kt, kc, m),
                      lambda: tg.wide_select_plain(wide, kt, kc, m),
                      2 * _nbytes(kt) + 4 * 4 * k * n + _nbytes(taps, eff))
        # G2's block form on the dirty list of the 4.5 px drift.
        kt, inl_t = drift[DRIFT_PX[-1]]
        shift = (kt.float() - kc.float()).abs().amax(-1)
        blocks = _block_list((shift >= m + 1) & (inl_t | inl_c), nb)
        got = once("wide_take_blocks",
                   lambda: tg.wide_take_blocks(tiles, kt, blocks, wide.clone(), w, h, m))
        want = tg.wide_take_blocks_plain(tiles, kt, blocks, wide.clone(), w, h, m)
        assert torch.equal(got, want), ("G2 blocks != twin", m)
        listed = int((blocks < nb).sum())
        assert listed > 0
        retaken = _block_knots(kt, blocks)
        nbytes = (listed * tg.PARTIAL_BLOCK * (8 + 4 * rows) + _nbytes(blocks)
                  + sum(_window_pixels(x, w, h, lo=-1 - m, hi=3 + m) for x in retaken) / 2)
        print(f"G2's block form, m = {m}, drift {DRIFT_PX[-1]} px: {listed} of {k * nb} blocks "
              "listed, bit-equal to its twin in place")
        scratch = wide.clone()
        timed(recs["wide_take_blocks"], prefix, f"m = {m}, {listed} blocks",
              lambda: tg.wide_take_blocks(tiles, kt, blocks, scratch, w, h, m),
              lambda: tg.wide_take_blocks_plain(tiles, kt, blocks, scratch, w, h, m), nbytes)
        recs["wide_take_blocks"][f"{prefix}blocks_listed"] = listed
        del wide, scratch, got, want
    # G1's block form (margin 0) on the dirty list of the 1.5 px drift.
    kt, inl_t = drift[DRIFT_PX[0]]
    shift = (kt.float() - kc.float()).abs().amax(-1)
    blocks = _block_list((shift >= 1) & (inl_t | inl_c), nb)
    taps = tg.direct_take(tiles, kc, w, h)
    got = once("tap_take_blocks", lambda: tg.tap_take_blocks(tiles, kt, blocks, taps.clone(), w, h))
    assert torch.equal(got, tg.tap_take_blocks_plain(tiles, kt, blocks, taps.clone(), w, h))
    listed = int((blocks < nb).sum())
    nbytes = (listed * tg.PARTIAL_BLOCK * 16 + _nbytes(blocks)
              + sum(_window_pixels(x, w, h) for x in _block_knots(kt, blocks)) / 2)
    print(f"G1's block form, drift {DRIFT_PX[0]} px: {listed} of {k * nb} blocks listed, "
          "bit-equal to its twin in place")
    timed(recs["tap_take_blocks"], "", f"{listed} blocks",
          lambda: tg.tap_take_blocks(tiles, kt, blocks, taps, w, h),
          lambda: tg.tap_take_blocks_plain(tiles, kt, blocks, taps, w, h), nbytes)
    recs["tap_take_blocks"]["blocks_listed"] = listed
    return list(recs.values())


def _solve_device_ms(fn, device):
    """(result, wall s, device busy ms, device events): ``fn()`` once on the
    host clock with the card synchronized, its kernels' device time summed
    by ``torch.profiler`` (CUDA activity only; None off the card), and the
    count of device events summed (a short count shows events the profiler
    dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, wall, sum(e.time_range.elapsed_us() for e in dev) * 1e-3, len(dev)


def phase_partial_solve(card, camera, kfs, T0, device="cuda"):
    """``refine_pose`` under the headline schedule on the scene's 8
    keyframes, from the identity: with ``frozen_partial_frac`` 1.0 (every
    refresh through G1's block form) against 0.0, the raster sort pinned
    off for both, then margin 2 against margin 0. The partial solve is
    bit-equal to the full-refresh one (pose bits, NID, evaluations and
    gathers; JAX's ``test_refine_partial_refresh_solve_is_bit_identical``
    on the card) with at least one partial gather; margin 2 reaches
    margin 0's NID within 1e-3. Then margin 2 with every refresh partial and
    no coarse phase, so that the fine phase outruns the margin and G2's
    block form runs. Each within 1 cm / 1 deg of T0. The counts are set to
    0 before each solve and read after it; prints each solve's evaluations,
    gathers, launches, wall and device time and peak memory. Returns the
    launches of the partial solve (G1's block form's path) and of the last
    (G2's block form's)."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import refine

    runs = (("full refresh", dict(frozen_partial_frac=0.0, sort_points=False)),
            ("partial 1.0", dict(frozen_partial_frac=1.0, sort_points=False)),
            ("margin 2", dict(frozen_margin=2, sort_points=False)),
            # The fine phase from the identity, ~20-35 px from T0: the margin
            # is outrun, and every refresh goes through G2's block form.
            ("margin 2, partial 1.0, no coarse phase",
             dict(frozen_margin=2, frozen_partial_frac=1.0, coarse_outer_iterations=0)))
    out = {}
    for label, kw in runs:
        _reset_counts()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        res, wall, busy, n_dev = _solve_device_ms(
            lambda kw=kw: refine.refine_pose(camera, kfs, se3.identity(device),
                                             **dict(HEADLINE, **kw)), device)
        peak = ((torch.cuda.max_memory_allocated() - held) / 2**20 if device == "cuda"
                else None)
        counts = _read_counts()
        err_cm, err_deg = _pose_error(res.T_camera_lidar, T0)
        out[label] = (res, counts)
        print(f"[{card}] partial / wide solve, {label}: NID {float(res.nid):.6f}; error "
              f"{err_cm:.4f} cm / {err_deg:.4f} deg; evaluations {res.evaluations}; gathers "
              f"{res.gathers} ({res.partial_gathers} partial); wall {wall:.3f} s, device busy "
              f"{_ms(busy)} ms in {n_dev} device events; peak memory above the keyframes "
              f"{f'{peak:.1f} MiB' if peak is not None else 'not measured'}; launches "
              + json.dumps({key: counts[key] for key in (
                  "nid_hist_fwd", "nid_hist_bwd", "tap_take", "tap_take_blocks", "wide_take",
                  "wide_take_blocks", "wide_select")}))
        assert np.isfinite(float(res.nid)) and err_cm < 1.0 and err_deg < 1.0, label
    (full, _), (part, pc), (wide, wc), (wide_part, wpc) = (out[label] for label, _ in runs)
    assert torch.equal(full.T_camera_lidar.q, part.T_camera_lidar.q), "partial pose != full"
    assert torch.equal(full.T_camera_lidar.t, part.T_camera_lidar.t), "partial pose != full"
    assert float(full.nid) == float(part.nid) and full.evaluations == part.evaluations
    assert full.gathers == part.gathers and part.partial_gathers >= 1, (full, part)
    assert abs(float(wide.nid) - float(full.nid)) <= 1e-3, (float(wide.nid), float(full.nid))
    if device == "cuda":
        assert pc["tap_take_blocks"] == part.partial_gathers >= 1, pc
        assert wc["wide_take"] + wc["wide_take_blocks"] == wide.gathers, wc
        assert wc["wide_select"] >= 1 and wc["tap_take_blocks"] == 0, wc
        assert wpc["wide_take_blocks"] == wide_part.partial_gathers >= 1, wpc
    print(f"partial-refresh solve bit-equal to the full-refresh solve (pose, NID, {full.evaluations}"
          f" evaluations, {full.gathers} gathers, {part.partial_gathers} of them partial); margin"
          f" 2 NID {float(wide.nid):.6f} vs margin 0 {float(full.nid):.6f}")
    return pc, wpc


def write_picks(root, camera, kfs, T0, device="cuda"):
    """The correspondence file of the cache + manual guess path:
    PICKS_A_KEYFRAME pairs for each of PICKED_KEYFRAMES, scene points of the
    keyframe's cull (its camera frame before the correction) and their
    pixels through the planted correction T0. Returns its path."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.pipeline import ingest, keyframes
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg = _config(root, cfg_mod.NIDConfig())
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    kf_idx = keyframes.select(ingest.frames_trajectory(frames), cfg.keyframes)[:K]
    rs = np.random.default_rng(SEED)
    picks = {}
    for j in PICKED_KEYFRAMES:
        pts = kfs.points[j][kfs.valid[j]]
        with torch.no_grad():
            px = cam.project(camera, se3.transform_points(T0.to(device), pts))
        ok = torch.nonzero(cam.in_image(camera, px)).reshape(-1).cpu().numpy()
        sel = torch.from_numpy(rs.choice(ok, PICKS_A_KEYFRAME, replace=False)).to(device)
        picks[ingest.cpp_timestamp(frames[kf_idx[j]].timestamp)] = {
            "pixels": px[sel].tolist(), "points": pts[sel].tolist()}
    path = os.path.join(root, "picks.json")
    with open(path, "w") as f:
        json.dump(picks, f)
    return path


# A second downsample factor for the cull between two of the main path's:
# another grid, so a key buffer of another size.
ALT_DS = 7


def _offset_view(t):
    """A copy of 1-D ``t`` one element past the start of its own buffer:
    4 bytes off 16-byte alignment for f32, 1 byte for bool."""
    import torch

    flat = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t
    return flat[1:]


def _compare_masks(tally, label, got, want):
    """Adds the mask bits of ``got`` that differ from ``want`` and their
    largest absolute difference to ``tally``; asserts they are equal."""
    assert got.shape == want.shape, f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}"
    n_diff = int((got != want).sum())
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    tally["culls"] += 1
    tally["mismatches"] += n_diff
    tally["max_abs_err"] = max(tally["max_abs_err"], err)
    assert n_diff == 0, f"{label}: {n_diff} mask bits differ from the twin"


def _check_cull(tally, camera, label, u, v, z, r, valid, ds, eps):
    """The cull against its twin, bit for bit (see _compare_masks); returns
    the mask."""
    from pointcloudprocessor_tpu_torch.ops import zbuffer as zb

    got = zb.cull_mask_uv(camera, u, v, z, r, valid, ds, eps)
    _compare_masks(tally, label, got, zb.cull_mask_uv_plain(camera, u, v, z, r, valid, ds, eps))
    return got


def phase_zbuffer(card, root, device="cuda"):
    """K5/Z1: the probe's form (cells given) against its twin at the
    probe's full size; the fused cull against its twin on the scene's 8
    keyframes twice over, with a cull at another downsample factor between,
    on n = 0, a ragged n, unaligned inputs and the edge set; its launches
    and times at the main path's shape (keyframe 0 of the crop), in map
    order and raster-sorted, beside each pass's twin, the composition
    before the gate was fused in (step 0: the eager gate, ``zmin`` and
    ``zbuffer_visible`` with cells given), the cells-given twins and
    ``scatter_reduce_``. Returns per-kernel records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.ops import zbuffer as zb
    from pointcloudprocessor_tpu_torch.pipeline import runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
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

    # Z1 on the scene: the runner's culls (z a strided view of the camera-
    # frame points), all keyframes twice in a row, so that the key buffer's
    # memory is reused, and a cull at ALT_DS (another grid, another buffer
    # size) between two of them. ``tally`` sums every fused cull's mismatches.
    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    ds, eps = cfg.culling.downsample_factor, cfg.culling.depth_epsilon
    poses = runner._camera_to_world(frames, kf_idx, None, device)
    tally = {"culls": 0, "mismatches": 0, "max_abs_err": 0.0}
    n_vis = []
    for rnd in range(2):
        for j in range(len(kf_idx)):
            T_w2c = se3.inverse(se3.SE3(poses.q[j], poses.t[j]))
            pts_cam, mask_k = zb.cull_world_points(camera, T_w2c, cloud.points, cloud.valid, ds, eps)
            u, v = cam.project_uv(camera, pts_cam)
            x, y, z = pts_cam.unbind(-1)
            r = torch.sqrt(x * x + y * y + z * z)
            mask_t = zb.cull_mask_uv_plain(camera, u, v, z, r, cloud.valid, ds, eps)
            _compare_masks(tally, f"Z1: keyframe {j} (round {rnd})", mask_k, mask_t)
            if rnd == 0:
                n_vis.append(int(mask_k.sum()))
            if j == 0:
                first = (u, v, z, r)
            if j == 2:
                _check_cull(tally, camera, f"keyframe {j} at ds {ALT_DS}", u, v, z, r, cloud.valid,
                            ALT_DS, eps)
    print(f"Z1 cull_world_points on {len(kf_idx)} keyframes of {cloud.points.shape[0]} points, "
          f"twice, a cull at ds {ALT_DS} between: visible {n_vis}; every mask bit-equal to "
          "the twin's")

    # Keyframe 0 with z contiguous, as colorize passes it; n = 0, a ragged
    # n, inputs 4 bytes off 16-byte alignment, and the edge set
    # (tools/bench_scene).
    u, v, z, r = first
    z = z.contiguous()
    val = cloud.valid
    edge = {k: torch.from_numpy(a).to(device) for k, a in
            bs.cull_edge_points(WIDTH, HEIGHT, ds, 20_000, SEED).items()}
    cases = {
        "n = 0": (u[:0], v[:0], z[:0], r[:0], val[:0]),
        f"n = {u.shape[0] + 3:,}": tuple(torch.cat([a, b[:3]]) for a, b in zip(
            (u, v, z, r, val), (edge[k] for k in ("u", "v", "z", "rng", "valid")))),
        "unaligned": tuple(_offset_view(t) for t in (u, v, z, r, val)),
        "edge set": tuple(edge[k] for k in ("u", "v", "z", "rng", "valid")),
        "edge set, unaligned": tuple(_offset_view(edge[k]) for k in ("u", "v", "z", "rng", "valid")),
    }
    for label, args in cases.items():
        for d in (ds, ALT_DS):
            _check_cull(tally, camera, label, *args, d, eps)
    print(f"Z1: masks bit-equal to the twin's at ds {ds} and {ALT_DS} on: " + ", ".join(cases))

    # The raster-sorted copy of keyframe 0 (a scanner map in scan order):
    # the mask, un-permuted, must be the twin's.
    ok, cell0, n_cells = zb.cells(camera, u, v, z, val, ds)
    order = torch.sort(cell0, stable=True).indices
    sorted_args = tuple(t[order] for t in (u, v, z, r, val))
    mask_s = torch.empty_like(val)
    mask_s[order] = _check_cull(tally, camera, "raster-sorted", *sorted_args, ds, eps)
    _compare_masks(tally, "raster-sorted, un-permuted", mask_s,
                   zb.cull_mask_uv_plain(camera, u, v, z, r, val, ds, eps))
    print(f"Z1: {tally['mismatches']} mask bits differ from the twin's over {tally['culls']} "
          f"culls checked (max abs error {tally['max_abs_err']})")

    def cull(args=(u, v, z, r, val)):
        return zb.cull_mask_uv(camera, *args, ds, eps)

    # Each pass's twin on the same inputs: the gate, the cell and the
    # scatter-min; the gate, the cell and the test against a given buffer.
    big = float(torch.finfo(torch.float32).max)
    r_m = torch.where(ok, r, big)

    def scatter_twin():
        ok_t, cell_t, nc = zb.cells(camera, u, v, z, val, ds)
        return zb.zmin_plain(cell_t, torch.where(ok_t, r, big), big, nc + 1)

    def test_twin(buf):
        ok_t, cell_t, _ = zb.cells(camera, u, v, z, val, ds)
        return zb.visible_plain(ok_t, r, buf, cell_t, eps)

    # Step 0, the composition before the gate was fused in: the eager gate,
    # zmin with cells given (fill, scatter, decode) and zbuffer_visible with
    # cells given.

    def step0(args=(u, v, z, r, val)):
        ok0, c0, nc = zb.cells(camera, *args[:3], args[4], ds)
        buf = zb.zmin(c0, torch.where(ok0, args[3], big), big, nc + 1)
        return zb.visible(ok0, args[3], buf, c0, eps)

    assert torch.equal(step0(), zb.cull_mask_uv_plain(camera, u, v, z, r, val, ds, eps))
    assert torch.equal(step0(sorted_args)[torch.argsort(order)], step0())
    buf0 = zb.zmin(cell0, r_m, big, n_cells + 1)
    cell64 = cell0.long()
    filled = torch.full((n_cells + 1,), big, dtype=torch.float32, device=device)

    fns = {
        "cull": cull,
        "cull, z strided": lambda: cull(first + (val,)),
        "cull, raster-sorted": lambda: cull(sorted_args),
        "twin": lambda: zb.cull_mask_uv_plain(camera, u, v, z, r, val, ds, eps),
        "scatter twin": scatter_twin,
        "test twin": lambda: test_twin(buf0),
        "step 0": step0,
        "step 0, raster-sorted": lambda: step0(sorted_args),
        "step 0 zmin": lambda: zb.zmin(cell0, r_m, big, n_cells + 1),
        "step 0 zbuffer_visible": lambda: zb.visible(ok, r, buf0, cell0, eps),
        "zmin twin": lambda: zb.zmin_plain(cell0, r_m, big, n_cells + 1),
        "visible twin": lambda: zb.visible_plain(ok, r, buf0, cell0, eps),
        "scatter_reduce_ amin": lambda: filled.scatter_reduce_(0, cell64, r_m, reduce="amin"),
    }
    dev_t = {k: _device_ms(fn, device) for k, fn in fns.items()}
    call_t = {k: _median_ms(fns[k], device) for k in (
        "cull", "cull, z strided", "twin", "step 0", "step 0 zmin", "step 0 zbuffer_visible")}
    prof = {k: _kernel_profile(fns[k], device) for k in (
        "cull", "cull, z strided", "cull, raster-sorted", "step 0", "step 0, raster-sorted")}
    print(f"[{card}] Z1 at {u.shape[0]} points ({int(ok.sum())} gated in), {n_cells} cells: "
          "device ms: "
          + ", ".join(f"{k} {_ms(t)}" for k, t in dev_t.items()))
    print(f"[{card}] Z1: ms a call (host included): "
          + ", ".join(f"{k} {_ms(t)}" for k, t in call_t.items()))
    passes = {"cull_scatter": None, "cull_test": None}
    if device == "cuda":
        for k, p in prof.items():
            print(f"[{card}] Z1 {k}: {_kernel_launches(p)} kernel launches a call; device work "
                  "a call (launches, mean us): "
                  + json.dumps({n: [c, round(us, 2)] for n, (c, us) in p.items()}))
        # Two launches a cull, both from csrc/zbuffer.cu, and one memset of
        # the key buffer; nothing else.
        for k in ("cull", "cull, z strided", "cull, raster-sorted"):
            assert sorted(prof[k]) == sorted([*passes, "Memset"]), prof[k]
            assert _kernel_launches(prof[k]) == 2 and prof[k]["Memset"][0] == 1, prof[k]
        passes = {n: prof["cull"][n][1] * 1e-3 for n in passes}

    pt_bytes = _nbytes(u, v, z, r, val)
    scatter_bound = _bound(pt_bytes)
    test_bound = _bound(pt_bytes + u.shape[0])  # + the mask
    for name, (b_ms, _) in (("cull_scatter", scatter_bound), ("cull_test", test_bound)):
        t = passes[name]
        share = "not measured" if t is None else f"{b_ms / t:.2f}"
        print(f"{name}: device {_ms(t)} ms, bound {b_ms * 1e3:.2f} us (bytes), at {share} of it")
    whole = {
        "whole_cull_ms": dev_t["cull"], "whole_cull_call_ms": call_t["cull"],
        "whole_cull_launches": None if device != "cuda" else _kernel_launches(prof["cull"]),
        "whole_cull_memset_ms": None if device != "cuda" else prof["cull"]["Memset"][1] * 1e-3,
        "whole_cull_bound_ms": test_bound[0], "whole_cull_strided_ms": dev_t["cull, z strided"],
        "whole_cull_sorted_ms": dev_t["cull, raster-sorted"],
        "step0_whole_cull_ms": dev_t["step 0"], "step0_whole_cull_call_ms": call_t["step 0"],
        "step0_whole_cull_launches": None if device != "cuda" else _kernel_launches(prof["step 0"]),
        "step0_whole_cull_sorted_ms": dev_t["step 0, raster-sorted"],
        "plain_whole_cull_ms": dev_t["twin"], "plain_whole_cull_call_ms": call_t["twin"],
    }
    return [
        {"name": "zmin", "route": "cuda", "source": f"{PKG}/csrc/zbuffer.cu",
         "replaces": "pointcloudprocessor_tpu/tools/zbuffer_probe.py:42",
         "max_abs_err": tally["max_abs_err"], "mismatches": tally["mismatches"],
         "probe_max_abs_err": zmin_err, "probe_mismatches": n_diff,
         "ms": passes["cull_scatter"], "call_ms": call_t["cull"],
         "plain_ms": dev_t["scatter twin"], "cells_given_plain_ms": dev_t["zmin twin"],
         "bound_ms": scatter_bound[0], "bound_by": scatter_bound[1],
         "library_ms": dev_t["scatter_reduce_ amin"], "step0_ms": dev_t["step 0 zmin"],
         "step0_call_ms": call_t["step 0 zmin"], **whole},
        {"name": "zbuffer_visible", "route": "cuda", "source": f"{PKG}/csrc/zbuffer.cu",
         "replaces": "pointcloudprocessor_tpu/ops/zbuffer.py:69",
         "max_abs_err": tally["max_abs_err"], "mismatches": tally["mismatches"],
         "ms": passes["cull_test"], "call_ms": call_t["cull"],
         "plain_ms": dev_t["test twin"], "cells_given_plain_ms": dev_t["visible twin"],
         "bound_ms": test_bound[0], "bound_by": test_bound[1], "library_ms": None,
         "step0_ms": dev_t["step 0 zbuffer_visible"],
         "step0_call_ms": call_t["step 0 zbuffer_visible"], **whole},
    ]


# C1's division check: every 24-bit color.
DIVISION_COLORS = 1 << 24


def _clone_state(s):
    from pointcloudprocessor_tpu_torch.ops import fusion
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    def c(t):
        return None if t is None else t.clone()

    return colorize.FuseState(fusion.TopKColors(s.topk.scores.clone(), s.topk.rgb.clone()),
                              s.count.clone(), c(s.best_score), c(s.best_label))


def _bits_differ(a, b) -> int:
    """Elements of two tensors whose bits differ (b moved to a's device)."""
    import torch

    b = b.to(a.device)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _state_diffs(a, b) -> dict:
    """Per field of two fusion states, the elements whose bits differ."""
    pairs = {"scores": (a.topk.scores, b.topk.scores), "rgb": (a.topk.rgb, b.topk.rgb),
             "count": (a.count, b.count), "best_score": (a.best_score, b.best_score),
             "best_label": (a.best_label, b.best_label)}
    return {k: _bits_differ(x, y) for k, (x, y) in pairs.items() if x is not None}


def _c1_scene(root, T_correction, device):
    """(cfg, camera, cloud, poses, views, images, masks, culling) of the C1
    checks: the smoke scene's crop, the 8 keyframes' poses and views as the
    runner's colorize forms them (``T_correction`` applied; the batch
    asserted bit-equal to each view formed alone), their RGB images and one
    label image a keyframe (labels 0-255 from the seed, rolled by
    keyframe), all on ``device``."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.io import images as img_io
    from pointcloudprocessor_tpu_torch.pipeline import colorize, runner

    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    poses = runner._camera_to_world(frames, kf_idx, runner._extrinsic_lidar_to_cam(cfg, device),
                                    device)
    # The views as fuse forms them, in one batch, and each keyframe alone:
    # the same bits.
    batch = colorize.keyframe_pose(poses, T_correction)
    views = [batch.at(j) for j in range(len(kf_idx))]
    for j, view in enumerate(views):
        one = colorize.keyframe_pose(se3.SE3(poses.q[j], poses.t[j]), T_correction)
        assert all(_bits_differ(a, b) == 0 for a, b in (
            (view.T.q, one.T.q), (view.T.t, one.T.t), (view.R, one.R))), f"view {j}"
    images = torch.from_numpy(
        np.stack([img_io.load_rgb(frames[i].image_path) for i in kf_idx])).to(device)
    labels = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH), dtype=np.int32)).to(device)
    masks = [torch.roll(labels, 97 * j, dims=1) for j in range(len(kf_idx))]
    return cfg, camera, cloud, poses, views, images, masks, runner._culling_kwargs(cfg)


def c1_division_check(camera, views, points, valid, images, culling, sat=0.7, bri=1.2,
                      opt_dist=3.0):
    """How far the twin's divisions on the card stray from the CPU's
    (ops/fusion: ``hsv_adjust``'s by 255 and the distance score's by the
    optimal distance), on identical inputs: the first DIVISION_COLORS packed
    colors (all 2^24) through ``pack_rgb(hsv_adjust(., sat, bri))``, and the
    score at ``opt_dist`` of the map's points in each keyframe (camera-frame
    points and ranges computed on the card, copied to the CPU;
    reference_compat off, since its own square root would be the CPU's,
    which torch does not round correctly on every input). Counted once with
    the twin as it is (a 0-dim tensor divisor, ``fusion._divide``) and once
    with a Python-number divisor, which torch applies on the card as a
    product with its reciprocal. Returns {"colors": (number, tensor),
    "scores": (number, tensor), ...}: the elements that differ, each way."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import fusion
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    dev = points.device
    c = torch.arange(DIVISION_COLORS, dtype=torch.int32, device=dev)
    colors = fusion.unpack_rgb(c)
    cams = []
    for view, img in zip(views, images):
        obs = colorize.observe_keyframe(camera, img, view.T, points, valid,
                                        camera_position_world=view.position, **culling)
        x, y, z = obs.points_camera.unbind(-1)
        cams.append((x, y, z, torch.sqrt(x * x + y * y + z * z), view.position))

    def counts():
        n_col = _bits_differ(fusion.pack_rgb(fusion.hsv_adjust(colors, sat, bri)),
                             fusion.pack_rgb(fusion.hsv_adjust(colors.cpu(), sat, bri)))
        n_score = 0
        for args in cams:
            kw = dict(optimal_distance=opt_dist)
            n_score += _bits_differ(fusion.final_score_xyz(*args, **kw),
                                    fusion.final_score_xyz(*(a.cpu() for a in args), **kw))
        return n_col, n_score

    after = counts()
    tensor_divide = fusion._divide
    fusion._divide = lambda x, d: x / d
    try:
        before = counts()
    finally:
        fusion._divide = tensor_divide
    return {"colors": (before[0], after[0]), "scores": (before[1], after[1]),
            "n_colors": DIVISION_COLORS, "n_scores": len(cams) * points.shape[0]}


def _stack_views(views):
    """The batch of the keyframe views ``views`` (copies, the same bits)."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    return colorize.KeyframePose(se3.SE3(torch.stack([v.T.q for v in views]),
                                         torch.stack([v.T.t for v in views])),
                                 torch.stack([v.R for v in views]),
                                 torch.stack([v.position for v in views]))


def phase_colorize(card, root, T0, device="cuda"):
    """C1: ``fuse_keyframe`` (a memset and ``colorize_scatter`` +
    ``colorize_update``) bit-equal to its twin run on the card, field by
    field after every keyframe, over the scene's 8 keyframes twice in a row
    (the registers fill, then replace their minima), at the planted
    correction T0: with and without masks; with HSV (0.7, 1.2),
    reference_compat and optimal distance 3.0; under HPR (H2, then pass (b)
    alone); on the edge set of ``bench_scene.cull_edge_points`` put in front
    of the camera; on a ragged n and n = 0. The dumps (``keyframe_rgb_mask``)
    bit-equal to theirs. The twin's divisions on the card against the
    CPU's at HSV (0.7, 1.2) and optimal distance 3.0
    (``c1_division_check``). Each pass's device time (``torch.profiler``: a
    memset and two launches a step, asserted) over the 8 keyframes from an
    empty state, as ``fuse`` runs them, beside its bound over the same
    steps; at keyframe 0 fused again onto its own state, device and call
    times of the step, each pass and the twin; the whole ``fuse`` through C1
    and through the twin. Returns the C1a / C1b records."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.ops import zbuffer as zb
    from pointcloudprocessor_tpu_torch.pipeline import colorize
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    T_corr = T0.to(device)
    cfg, camera, cloud, poses, views, images, masks, culling = _c1_scene(root, T_corr, device)
    pts, val = cloud.points, cloud.valid
    top_k = cfg.fusion.top_k
    hsv = dict(saturation_scale=0.7, brightness_scale=1.2, reference_compat_orientation=True,
               optimal_distance=3.0)
    tally = {"steps": 0, "mismatches": 0, "keys": 0}

    def check_keys(label, keys, p, v, batch, ds):
        """Pass (a) for the batch: equal to each keyframe's own launch (K =
        1) on every key, and read as cell minima to the twin's on every
        cell."""
        twin = colorize.depth_keys_plain(camera, batch, p, v, ds)
        got = colorize.cell_minima(keys) if device == "cuda" else keys
        assert _bits_differ(got, twin) == 0, f"C1 {label}: batched keys != the twin's"
        for j in range(keys.shape[0]):
            one = colorize.depth_keys(camera, batch.at(j).batch(), p, v, ds)[0]
            assert _bits_differ(keys[j], one) == 0, f"C1 {label}, keyframe {j}: batched != K = 1"
        tally["keys"] += keys.numel()

    def check(label, p, v, views_, imgs, msk, rounds=2, **opts):
        """Over ``rounds`` x the keyframes: the batched path as ``fuse`` runs
        it (pass (a) once for all, then pass (b) a keyframe against its
        keys) and each keyframe alone (memset, both passes), each state
        bit-equal to the twin's after every keyframe."""
        kw = {**culling, **opts}
        zbuf = kw["culling_method"] == "zbuffer"
        batch = _stack_views(views_)
        labelled = msk is not None
        batched, alone, ts = (colorize.init_fuse_state(p.shape[0], device, top_k, labelled)
                       for _ in range(3))
        for _ in range(rounds):
            keys = None
            if zbuf:
                keys = colorize.depth_keys(camera, batch, p, v, kw["downsample_factor"])
                check_keys(label, keys, p, v, batch, kw["downsample_factor"])
            for j, view in enumerate(views_):
                m = None if msk is None else msk[j]
                colorize.fuse_keyframe(batched, camera, imgs[j], view, p, v, m,
                                       keys=None if keys is None else keys[j], **kw)
                colorize.fuse_keyframe(alone, camera, imgs[j], view, p, v, m, **kw)
                colorize.fuse_keyframe_plain(ts, camera, imgs[j], view, p, v, m, **kw)
                for path, ks in (("batched", batched), ("K = 1", alone)):
                    d = _state_diffs(ks, ts)
                    tally["steps"] += 1
                    tally["mismatches"] += sum(d.values())
                    assert not any(d.values()), f"C1 {label} {path}, keyframe {j}: != twin {d}"
        filled = int(torch.isfinite(batched.topk.scores).sum())
        print(f"C1 {label}: {rounds} x {len(views_)} keyframes of {p.shape[0]} points, every "
              f"state bit-equal to the twin's (batched keys and K = 1); observations "
              f"{int(batched.count.sum())}, filled slots {filled}, points colored "
              f"{int(torch.isfinite(batched.topk.scores[0]).sum())}")
        return batched

    check("default", pts, val, views, images, None)
    check("masks", pts, val, views, images, masks)
    check("HSV (0.7, 1.2), reference_compat, optimal distance 3.0, masks", pts, val, views,
          images, masks, **hsv)
    check("HPR (grid)", pts, val, views, images, None, rounds=1, culling_method="hpr",
          hpr_impl="grid")
    # The edge set in front of the camera: the identity view, each (u, v, z)
    # put back through the scene's distortion-free pinhole at depth z.
    edge = bs.cull_edge_points(WIDTH, HEIGHT, cfg.culling.downsample_factor, 20_000, SEED)
    fx, fy, cx, cy = (float(c) for c in camera.intrinsic.cpu())
    u, v, z = (edge[k].astype(np.float64) for k in ("u", "v", "z"))
    with np.errstate(invalid="ignore", over="ignore"):
        xyz = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1).astype(np.float32)
    e_pts = torch.from_numpy(xyz).to(device)
    e_val = torch.from_numpy(edge["valid"]).to(device)
    eye = colorize.keyframe_pose(se3.identity(device), se3.identity(device))
    check("edge set", e_pts, e_val, [eye, views[0]], images[:2], masks[:2], **hsv)
    n = pts.shape[0]
    check(f"n = {n - 77:,}", pts[: n - 77], val[: n - 77], views[:3], images, masks)
    check("n = 0", pts[:0], val[:0], views[:2], images, masks)

    # The dumps, every output bit for bit.
    cases = [(j, {}) for j in range(len(views))]
    cases += [(0, dict(culling_method="hpr", hpr_impl="grid")), (1, hsv)]
    for j, opts in cases:
        colors = {k: opts[k] for k in ("saturation_scale", "brightness_scale") if k in opts}
        kw = {**culling, **{k: o for k, o in opts.items() if k.startswith(("culling", "hpr"))}}
        got = colorize.keyframe_rgb_mask(camera, pts, val, images[j], masks[j],
                                         se3.SE3(poses.q[j], poses.t[j]), T_corr, **colors, **kw)
        want = colorize.keyframe_rgb_mask_plain(camera, pts, val, images[j], masks[j], views[j],
                                                **colors, **kw)
        d = [_bits_differ(a, b) for a, b in zip(got, want)]
        assert not any(d), f"C1 dump {j} {opts}: kernel != twin {d}"
    print(f"C1 dumps: {len(cases)} keyframe views (points, rgb, label, visible) bit-equal to the "
          "twin's, one under HPR, one with the HSV map")
    print(f"C1: {tally['mismatches']} state elements differ from the twin's over "
          f"{tally['steps']} steps checked")

    # The twin's divisions on the card against the CPU's (ops/fusion).
    div = c1_division_check(camera, views, pts, val, images, culling)
    print(f"C1 twin's divisions, card vs CPU: of all {div['n_colors']} colors through HSV "
          f"(0.7, 1.2), {div['colors'][0]} differ when dividing by a number, "
          f"{div['colors'][1]} by a 0-dim tensor (the twin); of {div['n_scores']} scores at "
          f"optimal distance 3.0 ({len(views)} keyframes), {div['scores'][0]} and "
          f"{div['scores'][1]}")
    assert div["colors"][1] == div["scores"][1] == 0, div

    # Times at keyframe 0 fused again and again onto the state it left (no
    # masks), then over the 8 keyframes from an empty state (the path's).
    view, img = views[0], images[0]
    st = colorize.init_fuse_state(n, device, top_k)
    tw = colorize.init_fuse_state(n, device, top_k)

    def step():
        return colorize.fuse_keyframe(st, camera, img, view, pts, val, **culling)

    def twin():
        return colorize.fuse_keyframe_plain(tw, camera, img, view, pts, val, **culling)

    ds = cfg.culling.downsample_factor
    batch = colorize.keyframe_pose(poses, T_corr)  # the views as fuse forms them

    def twin_scatter():  # the twin of the batched pass (a), as the CPU runs it
        return colorize.depth_keys_plain(camera, batch, pts, val, ds)

    def fuse(plain):
        return colorize.fuse(camera, pts, val, images, poses, T_corr, top_k=top_k, plain=plain,
                             **culling)

    def sequence():  # a fresh state through the 8 keyframes, as fuse runs them
        s = colorize.init_fuse_state(n, device, top_k)
        keys = colorize.depth_keys(camera, batch, pts, val, ds)
        for j, vw in enumerate(views):
            colorize.fuse_keyframe(s, camera, images[j], vw, pts, val, keys=keys[j], **culling)

    def per_keyframe():  # pass (a) for the 8 keyframes one at a time (K = 1)
        for j in range(len(views)):
            colorize.depth_keys(camera, batch.at(j).batch(), pts, val, ds)

    dev_t = {k: _device_ms(fn, device) for k, fn in (
        ("step", step), ("twin step", twin), ("twin of pass (a)", twin_scatter), ("step again", step))}
    call_t = {k: _median_ms(fn, device) for k, fn in (
        ("step", step), ("twin step", twin), ("twin of pass (a)", twin_scatter),
        ("fuse", lambda: fuse(False)), ("fuse, twin", lambda: fuse(True)))}
    prof = _kernel_profile(step, device)
    passes = {"colorize_scatter": None, "colorize_update": None}
    one_at_a_time = memset_us = None
    if device == "cuda":
        print(f"[{card}] C1 step (K = 1): device work a call (launches, mean us): "
              + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
        assert sorted(prof) == sorted([*passes, "Memset"]), prof
        assert _kernel_launches(prof) == 2 and prof["Memset"][0] == 1, prof
        passes = {k: prof[k][1] * 1e-3 for k in passes}
        prof_hpr = _kernel_profile(lambda: colorize.fuse_keyframe(
            st, camera, img, view, pts, val, **{**culling, "culling_method": "hpr"}), device)
        print(f"[{card}] C1 step under HPR: " + json.dumps(
            {k: [c, round(us, 2)] for k, (c, us) in prof_hpr.items()}))
        assert prof_hpr["colorize_update"][0] == 1 and "colorize_scatter" not in prof_hpr, prof_hpr
        # The 8 keyframes from an empty state: one memset and one pass (a)
        # for all, then pass (b) a keyframe; the first K fill the slots
        # (every visible sample is kept), the rest replace where they beat
        # the minimum.
        seq = _kernel_profile(sequence, device, reps=5)
        print(f"[{card}] C1 over the 8 keyframes from an empty state: " + json.dumps(
            {k: [c, round(us, 2)] for k, (c, us) in seq.items() if k in (*passes, "Memset")}))
        assert seq["colorize_scatter"][0] == seq["Memset"][0] == 1, seq
        assert seq["colorize_update"][0] == len(views), seq
        sequence_ms = {k: seq[k][1] * 1e-3 for k in passes}
        memset_us = seq["Memset"][1]
        # Pass (a) one keyframe at a time, as each keyframe alone runs it.
        per = _kernel_profile(per_keyframe, device, reps=5)
        print(f"[{card}] C1 pass (a) one keyframe at a time (K = 1): " + json.dumps(
            {k: [c, round(us, 2)] for k, (c, us) in per.items()}))
        assert per["colorize_scatter"][0] == per["Memset"][0] == len(views), per
        one_at_a_time = len(views) * (per["colorize_scatter"][1] + per["Memset"][1]) * 1e-3
    else:
        sequence_ms = {k: None for k in passes}
    print(f"[{card}] C1 at keyframe 0 fused again, {n} points: device ms: "
          + ", ".join(f"{k} {_ms(t)}" for k, t in dev_t.items()))
    print(f"[{card}] C1: ms a call (host included): "
          + ", ".join(f"{k} {_ms(t)}" for k, t in call_t.items()))

    # Pass (a)'s bound, from this call's data: bytes, xyz and valid read once
    # (13 B a point) and the 8 key buffers written once; f32 operations,
    # counted from csrc/colorize.cu: for each valid point and view the
    # transform (9 products, 9 sums); at z > 0 the projection (2 divisions
    # and 32 products and sums) and the gate and cell (2 floors, 2
    # divisions); for each point gated in, its range (3 products, 2 sums, a
    # square root). A division and a square root count as one operation
    # each, a least count (nvcc expands both into an approximation on the
    # special-function unit and a few FMAs).
    n_front = n_gated = 0
    for j in range(len(views)):
        x, y, z = se3.transform_xyz(batch.at(j).T, pts[:, 0], pts[:, 1], pts[:, 2])
        u, v = cam.project_xyz(camera, x, y, z)
        n_front += int((val & (z > 0)).sum())
        n_gated += int(zb.cells(camera, u, v, z, val, ds)[0].sum())
    a_ops = 18 * int(val.sum()) * len(views) + 38 * n_front + 6 * n_gated

    # Pass (b)'s bound, from this call's data: xyz and valid (13 B a point)
    # and the keys, a visible point's K scores and its count (read and written), each
    # distinct pixel whose sample a slot takes (3 B), and writes the slots a
    # call replaces (8 B each). Counted for each keyframe of the sequence
    # from an empty state (the passes' ``ms``; their mean) and for keyframe 0
    # fused again onto the state it left (``refuse_kf0_*``).
    gw, gh = zb.grid(camera, ds)
    keys = 4 * gw * gh
    a_bytes = 13 * n + len(views) * keys

    def update_bytes(state, j):  # fuses keyframe j into ``state``
        before = _clone_state(state)
        obs = colorize.observe_keyframe(camera, images[j], views[j].T, pts, val,
                                        camera_position_world=views[j].position, **culling)
        colorize.fuse_keyframe(state, camera, images[j], views[j], pts, val, **culling)
        n_vis = int(obs.visible.sum())
        took = (state.topk.scores.view(torch.int32)
                != before.topk.scores.view(torch.int32)).any(0)
        ui = torch.clamp(obs.pixels[:, 0][took].to(torch.int64), 0, WIDTH - 1)
        vi = torch.clamp(obs.pixels[:, 1][took].to(torch.int64), 0, HEIGHT - 1)
        n_pix = int(torch.unique(vi * WIDTH + ui).numel())
        replaced = _bits_differ(state.topk.scores, before.topk.scores)
        nb = 13 * n + keys + 3 * n_pix + n_vis * (4 * top_k + 8) + 8 * replaced
        return nb, n_vis, replaced, n_pix

    kf0 = update_bytes(st, 0)
    seq_state = colorize.init_fuse_state(n, device, top_k)
    seq_b = [update_bytes(seq_state, j) for j in range(len(views))]
    b_bytes = sum(b[0] for b in seq_b) / len(seq_b)
    bound_a, bound_b, bound_kf0 = _bound(a_bytes, a_ops), _bound(b_bytes), _bound(kf0[0])
    for name, (b_ms, by), nb, t, what in (
            ("colorize_scatter", bound_a, a_bytes, sequence_ms["colorize_scatter"],
             f"one launch for the {len(views)} keyframes; {a_ops} f32 operations: {n_front} point-views "
             f"in front of the camera, {n_gated} gated in; {_bound(a_bytes)[0] * 1e3:.2f} us "
             "of bytes"),
            ("colorize_update", bound_b, b_bytes, sequence_ms["colorize_update"],
             "the mean of the 8 keyframes from an empty state; by keyframe (visible, slots "
             "replaced, pixels sampled) " + json.dumps([b[1:] for b in seq_b])),
            ("colorize_update, keyframe 0 fused again", bound_kf0, kf0[0],
             passes["colorize_update"], f"{kf0[1]} visible, {kf0[2]} slots replaced, "
             f"{kf0[3]} pixels sampled")):
        share = "not measured" if t is None else f"{b_ms / t:.2f}"
        print(f"{name}: device {_ms(t)} ms, bound {b_ms * 1e3:.2f} us ({by}: {nb:.0f} B, "
              f"{what}), at {share} of it")
    seq_ms = (None if memset_us is None else memset_us * 1e-3 + sequence_ms["colorize_scatter"]
              + len(views) * sequence_ms["colorize_update"])
    print(f"[{card}] C1 over the 8 keyframes from an empty state: {_ms(seq_ms)} ms of device "
          f"time (one memset {_ms(memset_us)} us, pass (a) once, pass (b) 8 times); pass (a) one "
          f"keyframe at a time {_ms(one_at_a_time)} ms (8 memsets and launches) against "
          f"{_ms(None if memset_us is None else memset_us * 1e-3 + sequence_ms['colorize_scatter'])}"
          f" batched; {tally['keys']} keys checked")
    common = {"route": "cuda", "source": f"{PKG}/csrc/colorize.cu", "max_abs_err": 0.0,
              "mismatches": tally["mismatches"], "call_ms": call_t["step"],
              "sequence_ms": seq_ms, "step_ms": None if seq_ms is None else seq_ms / len(views),
              "refuse_kf0_step_ms": dev_t["step"],
              "twin_step_ms": dev_t["twin step"],
              "twin_step_call_ms": call_t["twin step"], "fuse_call_ms": call_t["fuse"],
              "fuse_twin_call_ms": call_t["fuse, twin"], "library_ms": None,
              "division_diffs": {k: div[k] for k in ("colors", "scores")}}
    return [
        {"name": "colorize_scatter", "replaces": "pointcloudprocessor_tpu/pipeline/colorize.py:49",
         "ms": sequence_ms["colorize_scatter"], "refuse_kf0_ms": passes["colorize_scatter"],
         "memset_us": memset_us, "one_at_a_time_ms": one_at_a_time,
         "plain_ms": dev_t["twin of pass (a)"] or call_t["twin of pass (a)"],
         "bound_ms": bound_a[0], "bound_by": bound_a[1], **common},
        # Where a twin's host side outlasts the hidden host time (its device
        # time is then not measured), its call time stands in, as for pass (a).
        {"name": "colorize_update", "replaces": "pointcloudprocessor_tpu/ops/fusion.py:72",
         "ms": sequence_ms["colorize_update"], "refuse_kf0_ms": passes["colorize_update"],
         "refuse_kf0_bound_ms": bound_kf0[0],
         "plain_ms": dev_t["twin step"] if dev_t["twin step"] else call_t["twin step"],
         "bound_ms": bound_b[0], "bound_by": bound_b[1], **common},
    ]


# H1 / H2 / N1 (csrc/hpr.cu, csrc/smooth.cu): the dense cull at the dense
# cutoff and at bench.py's culled size, the grid cull at bench.py's
# bench_hpr size (`bench.py:665-697`), and the smoothing radius: ~15 colored
# neighbors a wall point at the scene's density (7/8 of 1M points on ~30 m^2).
HPR_DENSE_N = (100_000, 262_144)
HPR_DENSE_SCENE_STRIDE = 256  # the 1M-point scene cull's directions checked on the CPU
HPR_DENSE_R1_N = 20_000  # the R = 1 set: every range past 2R, every pair kept
HPR_GRID_N = 262_144
SMOOTH_RADIUS = 0.015
HPR_TOL = 0.05


def _scene_colorize_cull(camera, cloud, q, t):
    """(points_camera (N, 3), gate) of the colorize HPR cull of the map at
    camera pose (q, t), formed as pipeline/colorize.observe_keyframe forms
    them (the unfloored pixel gate)."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.models import camera as cam

    p = cloud.points
    x, y, z = se3.transform_xyz(se3.inverse(se3.SE3(q, t)), p[:, 0], p[:, 1], p[:, 2])
    u, v = cam.project_xyz(camera, x, y, z)
    gate = (cloud.valid & (z > 0.0) & (u >= 0) & (u < camera.width) & (v >= 0)
            & (v < camera.height))
    return torch.stack([x, y, z], dim=-1), gate


def _h1_profile(card, label, fn, device):
    """``torch.profiler`` over one H1 call: asserts one launch each of
    ``hpr_flip``, ``hpr_describe`` and ``hpr_support_kernel``; returns
    {name: [launches, mean us]} (None off the card)."""
    prof = _kernel_profile(fn, device, reps=5)
    if prof is None:
        return None
    print(f"[{card}] H1 {label}, device work a call (launches, mean us): "
          + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
    for name in ("hpr_flip", "hpr_describe", "hpr_support_kernel"):
        assert prof.get(name, [0])[0] == 1, (name, prof)
    return prof


# H1's bound from the inputs' own need: 4 instructions a needed pair (3 FMA
# and a max) at the card's instruction rate, 128 lanes an SM x 132 SMs x 1.98 GHz
# (F32_OPS_S / 2), or N x 14 B (x, y, z, valid in, the mask out).
H1_INSTR_S = F32_OPS_S / 2


def phase_hpr_dense(card, root, device="cuda"):
    """H1 (the tiled dense cull) on the two-wall scene (z jitter 0.3 m, 2%
    invalid) at the dense cutoff and at bench.py's culled size, bit-equal to
    its twin run on the CPU on the same inputs (every direction at the
    cutoff, every 16th at 262,144 points), and at 20,000 points with R = 1
    (every range past 2R: no subtile skipped); its pairs evaluated and
    subtiles kept (counted by the kernel) equal to
    ``hpr_support_tiled_plain``'s on the card at the cutoff. Against the
    twin run on the card, whose norm and cuBLAS product round otherwise, the
    mask bits that differ and their margins in ulp of 2R are printed.
    Device and call times at both sizes beside two bounds (the dense N^2 x
    3 FMA; the inputs' own need: the needed pairs, counted by
    ``tools/hpr_dense_probe.needed_pairs``, x 4 instructions at the instruction
    rate, or N x 14 B), the card twin's and the chunked product's; the
    launches a call (``torch.profiler``), the same at both sizes and for a
    batch. Then one 1M-point colorize cull of the scene's keyframe 0 with
    the dense test, every 256th direction against the CPU twin, and the 8
    colorize culls of the 100,000-point map (the small-map path's) in one
    batch, each row equal to its keyframe's own call. Returns the kernel's
    record."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import hpr
    from pointcloudprocessor_tpu_torch.pipeline import runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
    from pointcloudprocessor_tpu_torch.tools import hpr_dense_probe as probe
    from pointcloudprocessor_tpu_torch.utils import profiling

    ulp = float(np.spacing(np.float32(2.0 * hpr.DEFAULT_RADIUS)))
    where = "card" if device == "cuda" else device
    rec = {"mismatches": 0, "card_twin_flips": 0, "card_twin_flips_outside_2ulp": 0,
           "card_twin_max_margin_ulp": 0.0, "max_abs_err": 0.0}

    def stats_of(fn):
        """(result, [pairs evaluated, subtiles kept]) of one H1 call."""
        hpr.support_stats = torch.zeros(2, dtype=torch.int64, device=device) \
            if device == "cuda" else None
        try:
            out = fn()
            return out, (hpr.support_stats.tolist() if device == "cuda" else None)
        finally:
            hpr.support_stats = None

    def check_cpu(label, pts, valid, rows, radius=hpr.DEFAULT_RADIUS):
        got, kept = stats_of(lambda: hpr.hpr_mask(pts, valid, radius))
        ok_c, sup_c, self_c = hpr.hpr_support_plain(pts.cpu(), valid.cpu(), radius, rows=rows)
        differ = int((got.cpu()[rows] != (ok_c & (sup_c - self_c <= HPR_TOL))).sum())
        rec["mismatches"] += differ
        rec["max_abs_err"] = max(rec["max_abs_err"], float(differ > 0))
        print(f"H1 hpr_support on {label}: {int(got.sum())} visible; against the twin on the "
              f"CPU ({rows.numel()} directions): {differ} mask bits differ (bit-equal "
              f"required); pairs evaluated, subtiles kept: {kept}")
        assert differ == 0, f"H1 disagrees with its twin on {label}"
        return got, kept

    sets = {}
    for n in HPR_DENSE_N:
        pts, valid = probe.two_wall_set(n, device)
        rows = torch.arange(0, n, 1 if n <= HPR_DENSE_N[0] else 16)
        got, kept = check_cpu(f"two walls, {n} points", pts, valid, rows)
        ok, sup, self_ = hpr.hpr_support_plain(pts, valid)
        want = ok & (sup - self_ <= HPR_TOL)
        diff = got != want
        margin_ulp = ((sup - self_ - HPR_TOL).abs() / ulp)[diff]
        n_out = int((margin_ulp > 2.0).sum())
        rec["card_twin_flips"] += int(diff.sum())
        rec["card_twin_flips_outside_2ulp"] += n_out
        if margin_ulp.numel():
            rec["card_twin_max_margin_ulp"] = max(rec["card_twin_max_margin_ulp"],
                                                  float(margin_ulp.max()))
        print(f"  against the twin on the {where}: {int(diff.sum())} differ, {n_out} with a "
              f"margin over 2 ulp of 2R ({ulp} m)")
        need = probe.needed_pairs(pts, valid)
        sets[n] = (pts, valid, kept, need)
    # The tiled plan in torch on the same device: the kernel's counts.
    n0 = HPR_DENSE_N[0]
    pts, valid, kept, _ = sets[n0]
    _, _, _, tiled = hpr.hpr_support_tiled_plain(pts, valid)
    print(f"H1 at {n0} points: pairs evaluated and subtiles kept {kept}, "
          f"hpr_support_tiled_plain's {list(tiled)}")
    if device == "cuda":
        assert kept == list(tiled), (kept, tiled)
    # R = 1: every flipped point has s <= 0, so the rule keeps every subtile.
    p_np, v_np = bs.two_walls(HPR_DENSE_R1_N, SEED + 1, z_jitter=0.3, invalid=0.02)
    pts1, val1 = torch.from_numpy(p_np).to(device), torch.from_numpy(v_np).to(device)
    _, kept_r1 = check_cpu(f"two walls, {HPR_DENSE_R1_N} points, R = 1", pts1, val1,
                           torch.arange(HPR_DENSE_R1_N), radius=1.0)
    n_ok = int(val1.sum())
    if device == "cuda":
        assert kept_r1[0] == n_ok * n_ok, (kept_r1, n_ok)
    # Times at both sizes, bench.py's culled size last.
    dev_t, call_t, prof = {}, {}, {}
    for n, (pts, valid, kept, need) in sets.items():
        r = torch.linalg.vector_norm(pts, dim=-1)
        okm = valid & (r > 1e-9)
        u = pts / torch.clamp(r, min=1e-12)[:, None]
        ft = torch.where(okm[:, None], u * (2.0 * hpr.DEFAULT_RADIUS - r)[:, None],
                         0.0).T.contiguous()
        dirs = torch.where(okm[:, None], u, 0.0)

        def product(dirs=dirs, ft=ft, n=n):
            return [torch.amax(dirs[s: s + 4096] @ ft, dim=1) for s in range(0, n, 4096)]

        def kernel(pts=pts, valid=valid):
            return hpr.hpr_mask(pts, valid)

        def twin(pts=pts, valid=valid):
            return hpr.hpr_mask_plain(pts, valid)

        dev_t[n] = {k: _device_ms(fn, device) for k, fn in (
            ("kernel", kernel), ("twin", twin), ("chunked product", product),
            ("kernel again", kernel))}
        # The twin's and the product's host side outlast the hidden window:
        # their device time is refused, and their time a call stands in.
        call_t[n] = {k: profiling.median_ms(fn, device, reps=20 if k == "kernel" else 5)
                     for k, fn in (("kernel", kernel), ("twin", twin),
                                   ("chunked product", product))}
        dense_ms, _ = _bound(0, 6.0 * n * n)
        own_ms, own_by = _bound(14 * n, int_ops=0.0)
        if need * 4 / H1_INSTR_S * 1e3 > own_ms:
            own_ms, own_by = need * 4 / H1_INSTR_S * 1e3, "operations"
        t = dev_t[n]["kernel"]
        print(f"[{card}] H1 at {n} points: device ms: "
              + ", ".join(f"{k} {_ms(v)}" for k, v in dev_t[n].items())
              + "; a call: " + ", ".join(f"{k} {_ms(v)}" for k, v in call_t[n].items())
              + f"; bounds: the inputs' need {own_ms:.4f} ms ({own_by}: {need} needed pairs x 4"
              f" instructions at {H1_INSTR_S:.3g}/s, or {n} x 14 B), share "
              f"{'not measured' if t is None else f'{own_ms / t:.3f}'}; the dense "
              f"{n}^2 x 3 FMA {dense_ms:.3f} ms; pairs evaluated {kept[0] if kept else None} "
              f"({'not measured' if not kept else f'{kept[0] / int(okm.sum()) ** 2:.5f}'} of "
              f"the ok pairs), subtiles kept {kept[1] if kept else None}")
        prof[n] = _h1_profile(card, f"at {n} points", kernel, device)
        rec.update({f"ms_{n}": t, f"call_ms_{n}": call_t[n]["kernel"],
                    f"plain_ms_{n}": dev_t[n]["twin"] or call_t[n]["twin"],
                    f"library_ms_{n}": dev_t[n]["chunked product"] or call_t[n]["chunked product"],
                    f"bound_ms_{n}": own_ms, f"dense_bound_ms_{n}": dense_ms,
                    f"needed_pairs_{n}": need, f"pairs_evaluated_{n}": kept[0] if kept else None,
                    f"subtiles_kept_{n}": kept[1] if kept else None})
    # One 1M-point colorize cull of the scene (the headline run's crop).
    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    poses = runner._camera_to_world(frames, kf_idx, None, device)
    pts1, gate1 = _scene_colorize_cull(camera, cloud, poses.q[0], poses.t[0])
    rows = torch.arange(0, pts1.shape[0], HPR_DENSE_SCENE_STRIDE)
    vis_dense, kept_1m = check_cpu(f"the scene's keyframe-0 colorize cull ({pts1.shape[0]} "
                                   f"points, {int(gate1.sum())} gated in)", pts1, gate1, rows)
    vis_grid = hpr.hpr_mask_grid(pts1, gate1)
    dense_1m = profiling.median_ms(lambda: hpr.hpr_mask(pts1, gate1), device, reps=5, warmup=1,
                                   hide_host=True)
    print(f"[{card}] H1 on the scene's keyframe-0 colorize cull: device {_ms(dense_1m)} ms; "
          f"{int(vis_dense.sum())} visible (the grid cull: {int(vis_grid.sum())}, "
          f"{int((vis_dense != vis_grid).sum())} bits differ)")
    del cloud, pts1, gate1
    # The small-map path's 8 colorize culls in one call.
    camera, R, t, pw, vw = probe.scene_views(SMALL_N_MAP, device)
    cams, gates = hpr.view_points(camera, R, t, pw, vw)
    batch = hpr.mask_batch(cams, gates, hpr.DEFAULT_RADIUS, HPR_TOL, impl="dense")
    for j in range(K):
        assert torch.equal(batch[j], hpr.hpr_mask(cams[j], gates[j])), j
    batch_ms = _device_ms(lambda: hpr.mask_batch(cams, gates, hpr.DEFAULT_RADIUS, HPR_TOL,
                                                 impl="dense"), device)
    batch_call = profiling.median_ms(lambda: hpr.mask_batch(cams, gates, hpr.DEFAULT_RADIUS,
                                                            HPR_TOL, impl="dense"), device)
    # One keyframe at a time: the sum of each call's device time (8 calls
    # outlast the hidden window's host time).
    singles = [_device_ms(lambda j=j: hpr.hpr_mask(cams[j], gates[j]), device) for j in range(K)]
    singles_ms = None if None in singles else sum(singles)
    prof["batch"] = _h1_profile(card, f"the {K} colorize culls of the {SMALL_N_MAP}-point map",
                                lambda: hpr.mask_batch(cams, gates, hpr.DEFAULT_RADIUS, HPR_TOL,
                                                       impl="dense"), device)
    print(f"[{card}] H1, the {K} colorize culls of the {SMALL_N_MAP}-point map "
          f"({[int(g.sum()) for g in gates]} gated in): one call {_ms(batch_ms)} ms of device "
          f"time ({_ms(batch_call)} a call), each row equal to its keyframe's own call; one "
          f"keyframe at a time {_ms(singles_ms)}")
    launches = None
    if prof[HPR_DENSE_N[0]] is not None:
        counts = {k: sum(c for c, _ in p.values()) for k, p in prof.items()}
        assert len(set(counts.values())) == 1, counts  # a fixed count, whatever the size
        launches = counts[HPR_DENSE_N[0]]
        print(f"H1: {launches} device launches (kernels, memsets, copies) a call, at every size "
              "and batch")
    n = HPR_DENSE_N[-1]
    rec.update(ms=rec[f"ms_{n}"], call_ms=rec[f"call_ms_{n}"], plain_ms=rec[f"plain_ms_{n}"],
               library_ms=rec[f"library_ms_{n}"], bound_ms=rec[f"bound_ms_{n}"],
               bound_by="operations" if rec[f"needed_pairs_{n}"] * 4 / H1_INSTR_S
               > 14 * n / HBM_BYTES_S else "bytes", dense_bound_ms=rec[f"dense_bound_ms_{n}"],
               ms_again=dev_t[n]["kernel again"], plain_call_ms=call_t[n]["twin"],
               library_call_ms=call_t[n]["chunked product"], n=n,
               launches_a_call=launches, r1_pairs_evaluated=kept_r1[0] if kept_r1 else None,
               scene_1m_ms=dense_1m, scene_1m_pairs_evaluated=kept_1m[0] if kept_1m else None,
               scene_1m_visible_dense=int(vis_dense.sum()),
               scene_1m_visible_grid=int(vis_grid.sum()), small_map_batch8_ms=batch_ms,
               small_map_batch8_call_ms=batch_call, small_map_one_at_a_time_ms=singles_ms)
    return [{"name": "hpr_support", "route": "cuda", "source": f"{PKG}/csrc/hpr.cu",
             "replaces": "pointcloudprocessor_tpu/ops/hpr.py:79", **rec}]


# f32 operations a point and view of H2's views form, counted from
# csrc/zbuffer.cuh and csrc/hpr.cu: the transform (9 products, 9 sums), the
# pixel (2 divisions, 20 products, 12 sums), the range (3 products, 2 sums,
# a square root), the bearing (2 divisions) and the cell (2 differences, 2
# divisions); a division or square root counted as one. The erosion: 2 axes
# x 33 taps x (a sum and a min) a cell.
H2_VIEW_OPS, H2_CAMERA_OPS, H2_ERODE_OPS = 64, 14, 2 * 33 * 2
H2_GRID = 512


def _h2_passes(card, label, fn, device):
    """``torch.profiler`` over one H2 call: asserts one memset and the four
    passes, each launched once; returns {pass: device us} (None off the
    card)."""
    prof = _kernel_profile(fn, device)
    if prof is None:
        return None
    print(f"[{card}] H2 {label}, device work a call (launches, mean us): "
          + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
    assert sorted(prof) == sorted(["hpr_bounds", "hpr_scatter", "hpr_erode", "hpr_test",
                                   "Memset"]), prof
    assert all(c == 1 for c, _ in prof.values()), prof
    return {k: prof[k][1] for k in prof}


def phase_hpr_grid(card, root, device="cuda"):
    """H2 bit-equal to its twin on the two-wall scene at bench.py's
    bench_hpr size, on the edge sets of ``bench_scene.hpr_edge_sets`` (also
    through strided and unaligned views, and one point); then in batches,
    as the HPR path runs it: the 8 colorize culls of the scene in the views
    form ``fuse`` takes (``hpr_mask_grid_views``: the world points
    transformed, projected and gated in the passes) and in the camera form
    on the eager transform (``view_points``), the 8 NID culls
    (``cull_world_points_batch``, as ``runner.build_nid_keyframes`` culls),
    a batch of K = 1, and a batch of keyframes with other strides (rows of
    a padded tensor, 4 bytes off alignment) and one empty gate: every mask
    against the twin and against a one-keyframe launch. ``torch.profiler``
    asserts one memset and four launches a batch; each batch's device and
    call times beside the same culls one keyframe at a time (8 memsets and
    32 launches), the eager transform the views form does without, each
    pass's device us and the bounds. Returns the kernel's record."""
    import torch

    from pointcloudprocessor_tpu_torch.core import cloud as cl
    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import hpr
    from pointcloudprocessor_tpu_torch.pipeline import colorize, runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    tally = {"culls": 0, "mismatches": 0, "max_abs_err": 0.0}

    def check(label, pts, valid):
        got = hpr.hpr_mask_grid(pts, valid)
        _compare_masks(tally, f"H2 {label}", got, hpr.hpr_mask_grid_plain(pts, valid))
        return got

    def check_batch(label, got, pts, gates):
        """Each row against the twin and a one-keyframe launch."""
        for j in range(got.shape[0]):
            _compare_masks(tally, f"H2 {label}, keyframe {j}", got[j],
                           hpr.hpr_mask_grid_plain(pts[j], gates[j]))
            one = hpr.hpr_mask_grid(pts[j], gates[j])
            assert torch.equal(got[j], one), f"H2 {label}, keyframe {j}: batch != alone"
        return [int(v.sum()) for v in got]

    p_np, v_np = bs.two_walls(HPR_GRID_N, SEED, z_jitter=0.3, invalid=0.02)
    pts, valid = torch.from_numpy(p_np).to(device), torch.from_numpy(v_np).to(device)
    vis = check(f"two walls, {HPR_GRID_N} points", pts, valid)
    print(f"H2 hpr_grid on two walls, {HPR_GRID_N} points: {int(vis.sum())} visible, bit-equal "
          "to the twin")
    for name, (ep, ev) in bs.hpr_edge_sets().items():
        ep, ev = torch.from_numpy(ep).to(device), torch.from_numpy(ev).to(device)
        check(name, ep, ev)
        wide = torch.zeros((ep.shape[0], 5), device=device)
        wide[:, 1:4] = ep  # x, y, z with stride 5, 4 bytes off alignment
        check(f"{name}, strided", wide[:, 1:4], _offset_view(ev))
    check("one point", pts[:1], valid[:1] | True)
    print("H2: bit-equal to the twin on: " + ", ".join(bs.hpr_edge_sets()) + " (each also "
          "strided and unaligned), one point")

    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    poses = runner._camera_to_world(frames, kf_idx, None, device)
    views = colorize.keyframe_pose(poses, se3.identity(device))
    R, t = views.R, views.T.t
    pw, vw = cloud.points, cloud.valid
    k, n = R.shape[0], pw.shape[0]
    pts_c, gates_c = hpr.view_points(camera, R, t, pw, vw)
    norm = cl.normalize_intensity(cloud)
    c = cfg.culling
    T_w2c = se3.inverse(poses)
    pts_n, gates_n = hpr._frustum(camera, norm.points.expand(k, n, 3), norm.valid, T_w2c)

    def colorize_views():
        return hpr.hpr_mask_grid_views(camera, R, t, pw, vw)

    def colorize_camera():
        return hpr.hpr_mask_grid_batch(pts_c, gates_c)

    def colorize_eager():  # the camera form with the eager ops the views form does without
        return hpr.hpr_mask_grid_batch(*hpr.view_points(camera, R, t, pw, vw))

    def nid_batch():
        return hpr.hpr_mask_grid_batch(pts_n, gates_n)

    def one_at_a_time():
        return [hpr.hpr_mask_grid(pts_c[j], gates_c[j]) for j in range(k)]

    def twin():
        return hpr.hpr_mask_grid_views_plain(camera, R, t, pw, vw)

    got_v = colorize_views()
    n_vis = check_batch("colorize culls, views form", got_v, pts_c, gates_c)
    assert torch.equal(got_v, colorize_camera()), "H2's views form != its camera form"
    got_n = hpr.cull_world_points_batch(camera, T_w2c, norm.points, norm.valid,
                                        radius=c.hidden_points_removal_max_z,
                                        tolerance=c.hpr_tolerance, impl="grid")[1]
    assert torch.equal(got_n, nid_batch())
    n_vis_nid = check_batch("NID culls", got_n, pts_n, gates_n)
    check_batch("a batch of one", hpr.hpr_mask_grid_batch(pts_c[:1], gates_c[:1]), pts_c[:1],
                gates_c[:1])
    pad = torch.zeros((k, n + 7, 5), device=device)
    pad[:, 7:, 1:4] = pts_c
    strided, gates_s = pad[:, 7:, 1:4], gates_c.clone()
    gates_s[2] = False
    got_s = hpr.hpr_mask_grid_batch(strided, gates_s)
    check_batch("other strides, an empty gate", got_s, strided, gates_s)
    assert not got_s[2].any()
    print(f"H2 batched on the scene's {n} points: the 8 colorize culls (views and camera forms) "
          f"visible {n_vis}, the 8 NID culls {n_vis_nid}, a batch of one, a strided batch with "
          f"an empty gate: {tally['mismatches']} mask bits differ from the twin over "
          f"{tally['culls']} culls; every batch row equal to its one-keyframe launch")

    fns = {"views": colorize_views, "camera": colorize_camera, "nid": nid_batch,
           "one_at_a_time": one_at_a_time, "eager_camera": colorize_eager,
           "views_again": colorize_views}
    dev_t = {name: _device_ms(fn, device) for name, fn in fns.items()}
    call_t = {name: _median_ms(fn, device) for name, fn in fns.items() if name != "views_again"}
    call_t["twin"] = _call_ms(twin, device, reps=3)
    passes = {form: _h2_passes(card, f"{form} batch of {k}", fn, device)
              for form, fn in (("views", colorize_views), ("camera", colorize_camera),
                               ("nid", nid_batch))}
    # The function's least time. Views form: the world points and valid (13
    # B a point) read once, K bytes a point out; camera form: K x 14 B a
    # point (13 in, 1 out). Operations: a point and view's, and the erosion.
    erode_ops = k * H2_GRID * H2_GRID * H2_ERODE_OPS
    b_views = _bound(13 * n + k * n, k * n * H2_VIEW_OPS + erode_ops)
    b_camera = _bound(14 * k * n, k * n * H2_CAMERA_OPS + erode_ops)
    share = (f"{b_views[0] / dev_t['views']:.2f}" if dev_t["views"] else "not measured")
    print(f"[{card}] H2 the 8 colorize culls: device ms "
          + ", ".join(f"{name} {_ms(v)}" for name, v in dev_t.items())
          + "; a call: " + ", ".join(f"{name} {_ms(v)}" for name, v in call_t.items())
          + f"; bounds: views form {b_views[0] * 1e3:.2f} us ({b_views[1]}), camera form "
          f"{b_camera[0] * 1e3:.2f} us ({b_camera[1]}: {k} x 14 B a point); views form at "
          f"{share}")
    return [{"name": "hpr_grid", "route": "cuda", "source": f"{PKG}/csrc/hpr.cu",
             "replaces": "pointcloudprocessor_tpu/ops/hpr.py:150", **tally,
             "ms": dev_t["views"], "ms_again": dev_t["views_again"], "call_ms": call_t["views"],
             "camera_form_ms": dev_t["camera"], "nid_batch_ms": dev_t["nid"],
             "one_at_a_time_ms": dev_t["one_at_a_time"],
             "eager_camera_form_ms": dev_t["eager_camera"],
             "eager_camera_form_call_ms": call_t["eager_camera"],
             "plain_ms": call_t["twin"], "plain_call_ms": call_t["twin"], "library_ms": None,
             "bound_ms": b_views[0], "bound_by": b_views[1], "camera_form_bound_ms": b_camera[0],
             "camera_form_bound_by": b_camera[1], "keyframes_a_batch": k, "passes_us": passes,
             "visible_colorize": n_vis, "visible_nid": n_vis_nid}]


def phase_smooth(card, root, device="cuda"):
    """N1 on the scene's fused colors (colorize with HPR culling at the
    identity correction, 8 keyframes) at ``SMOOTH_RADIUS``, under the
    path's schedule (the order of a grid built with ``valid_first``) and
    the identity: within 1e-3 of the twin (``fusion.smooth_colors_local_plain``)
    and equal to each other; then ``smooth_colors_local`` on the edge clouds
    of ``bench_scene.smooth_edge_clouds`` (ties at equal distance with
    distinct colors at the 32nd neighbor, cells sharing a bucket, buckets
    over capacity, points on cell faces, all or no point colored, a ragged
    n) within 1e-3 of the twin. The windows the checked launch stages and
    their queries (counted by the kernel, ``run_sizes``); the distribution
    of in-radius neighbors a wall point (asserted median 8-24), the share of
    queries with more than 32 and of overflowing buckets; times of
    ``knn.build``, the kernel and the twin beside the bounds (unique bytes;
    bytes a window staged). Returns the kernel's record."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.io import images as img_io
    from pointcloudprocessor_tpu_torch.ops import fusion, knn
    from pointcloudprocessor_tpu_torch.pipeline import colorize, runner
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg, camera, cloud, frames, kf_idx = scene_cloud(root, device)
    hcfg = _config(root, cfg_mod.NIDConfig(), hpr=True)
    images = torch.from_numpy(np.stack([img_io.load_rgb(frames[i].image_path) for i in kf_idx]))
    poses = runner._camera_to_world(frames, kf_idx, None, device)
    fused = colorize.fuse(camera, cloud.points, cloud.valid, images, poses, se3.identity(device),
                          **runner._culling_kwargs(hcfg))
    pts, rgb, colored = cloud.points, fused.rgb, fused.colored
    n, cap, k_max = pts.shape[0], 32, 32
    table = max(2 * n, 1024)
    grid = knn.build(pts, colored, SMOOTH_RADIUS, table, cap, valid_first=True)
    identity = torch.arange(n, dtype=torch.int32, device=device)
    sizes = _run_sizes(device)
    want = fusion.smooth_colors_local_plain(pts, rgb, colored, SMOOTH_RADIUS)
    whole = fusion.smooth_colors_local(pts, rgb, colored, SMOOTH_RADIUS)
    if device == "cuda":
        got = knn.smooth_local_cuda(grid, pts, rgb, colored, SMOOTH_RADIUS, k_max, grid.order,
                                    run_sizes=sizes)
        got_id = knn.smooth_local_cuda(grid, pts, rgb, colored, SMOOTH_RADIUS, k_max, identity)
    else:
        got = got_id = whole
    windows, per_window = _window_stats(sizes)
    err = float((got - want).abs().max())
    moved = float((got - rgb).abs().max())
    print(f"N1 smooth_local on {n} points ({int(colored.sum())} colored), radius "
          f"{SMOOTH_RADIUS} m: max|kernel - twin| = {err:.3e} (tol 1e-3); colors moved up to "
          f"{moved:.1f}; the identity schedule gives the same colors: "
          f"{bool(torch.equal(got_id, got))}; smooth_colors_local == the kernel on the same "
          f"grid: {bool(torch.equal(whole, got))}; windows staged {windows}, queries a window "
          f"(p50) {per_window}")
    assert err <= 1e-3, "N1 disagrees with its twin"
    assert torch.equal(got_id, got) and torch.equal(whole, got)

    # The edge clouds, each through smooth_colors_local against the twin.
    edge_err = {}
    for name, (ep, ec, er) in bs.smooth_edge_clouds().items():
        erng = np.random.default_rng(SEED)
        e_rgb = torch.from_numpy(erng.uniform(0, 255, (len(ep), 3)).astype(np.float32))
        e_args = (torch.from_numpy(ep).to(device), e_rgb.to(device), torch.from_numpy(ec).to(device),
                  er)
        edge_err[name] = float((fusion.smooth_colors_local(*e_args)
                                - fusion.smooth_colors_local_plain(*e_args)).abs().max())
    print("N1 on the edge clouds, max|kernel - twin|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in edge_err.items()) + " (tol 1e-3)")
    assert max(edge_err.values()) <= 1e-3, edge_err

    # In-radius neighbors a colored point (duplicates counted, before the
    # cap of 32), and the buckets' occupancy.
    q_idx = torch.nonzero(colored, as_tuple=True)[0]
    r2 = torch.tensor(SMOOTH_RADIUS * SMOOTH_RADIUS, dtype=torch.float32, device=device)
    counts, occupied = [], []
    for s in range(0, q_idx.numel(), 65536):
        q = pts[q_idx[s: s + 65536]]
        cand, cx, cy, cz = knn._candidates_with_points(grid, pts, q)
        d2 = (cx - q[:, 0:1]) ** 2 + (cy - q[:, 1:2]) ** 2 + (cz - q[:, 2:3]) ** 2
        counts.append(((cand >= 0) & (d2 <= r2)).sum(1))
        hashes = knn._neighbor_hashes(grid, q).long()
        occupied.append(torch.clamp(grid.counts[hashes], max=cap).sum(1))
    counts, occupied = torch.cat(counts), torch.cat(occupied)
    on_wall = (pts[q_idx, 2] - bs.WALL_Z).abs() < 1e-3
    qs = torch.tensor([0.1, 0.5, 0.9], device=device)
    wall_q = torch.quantile(counts[on_wall].float(), qs).tolist()
    occ_q = torch.quantile(counts[~on_wall].float(), qs).tolist() if (~on_wall).any() else None
    all_q = torch.quantile(counts.float(), qs).tolist()
    over_k = float((counts > k_max).float().mean())
    nonempty = int((grid.counts > 0).sum())
    over = int((grid.counts > cap).sum())
    dropped = int(torch.clamp(grid.counts - cap, min=0).sum())
    slots = float(occupied.float().mean())
    print(f"N1 neighbors within {SMOOTH_RADIUS} m a colored point (p10 / median / p90): all "
          f"{all_q}, wall {wall_q}, occluder {occ_q}; more than {k_max}: {over_k:.4f} of "
          f"queries; buckets: {nonempty} occupied, {over} over capacity {cap} "
          f"({over / max(nonempty, 1):.2e}), {dropped} points dropped; candidate slots a query "
          f"{slots:.1f}")
    assert 8 <= wall_q[1] <= 24, wall_q

    def build():
        return knn.build(pts, colored, SMOOTH_RADIUS, table, cap, valid_first=True)

    def kernel():
        return knn.smooth_local_cuda(grid, pts, rgb, colored, SMOOTH_RADIUS, k_max, grid.order)

    def twin():
        return fusion.smooth_colors_local_plain(pts, rgb, colored, SMOOTH_RADIUS)

    def whole_call():
        return fusion.smooth_colors_local(pts, rgb, colored, SMOOTH_RADIUS)

    fns = {"build": build, "twin": twin, "smooth_colors_local": whole_call}
    if device == "cuda":
        fns = {"kernel": kernel, **fns, "kernel again": kernel}
    dev_t = {k: _device_ms(fn, device) for k, fn in fns.items()}
    call_t = {k: _median_ms(fn, device) for k, fn in fns.items() if k != "kernel again"}
    n_col = int(colored.sum())
    # Unique bytes: the counts, the occupied slots, points, rgb, colored, the
    # schedule and the output, each once. A window staged: 27 count words,
    # and 16 B a slot (index and point), at a colored query's mean slots.
    unique = (4 * table + 4 * int(torch.clamp(grid.counts, max=cap).sum()) + 12 * n + 12 * n + n
              + 4 * n + 12 * n)
    b_ms, by = _bound(unique)
    window_bytes = None if windows is None else windows * (27 * 4 + 16 * slots)
    pw_ms = None if window_bytes is None else _bound(window_bytes)[0]
    t_k = dev_t.get("kernel")
    share = f"{b_ms / t_k:.3f}" if t_k else "not measured"
    print(f"[{card}] N1 device ms: " + ", ".join(f"{k} {_ms(t)}" for k, t in dev_t.items())
          + "; a call: " + ", ".join(f"{k} {_ms(t)}" for k, t in call_t.items())
          + f"; bounds: unique bytes {b_ms * 1e3:.1f} us ({unique} B), the windows staged "
          + ("not measured" if pw_ms is None else f"{pw_ms * 1e3:.1f} us ({window_bytes:.0f} B)")
          + f"; kernel at {share} of the first")
    prof = _kernel_profile(whole_call, device, reps=5)
    if prof is not None:
        print(f"[{card}] smooth_colors_local device work a call ({_kernel_launches(prof)} "
              "kernel launches; launches, mean us): "
              + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
        assert prof["smooth_local_kernel"][0] == 1, prof
    return [{"name": "smooth_local", "route": "cuda", "source": f"{PKG}/csrc/smooth.cu",
             "replaces": "pointcloudprocessor_tpu/ops/fusion.py:196", "max_abs_err": err,
             "edge_cloud_max_abs_err": edge_err,
             "ms": t_k, "ms_again": dev_t.get("kernel again"), "call_ms": call_t.get("kernel"),
             "plain_ms": dev_t["twin"] or call_t["twin"], "plain_call_ms": call_t["twin"],
             "library_ms": None, "bound_ms": b_ms, "bound_by": by, "window_bound_ms": pw_ms,
             "windows": windows, "queries_per_window": per_window,
             "build_ms": dev_t["build"], "build_call_ms": call_t["build"],
             "smooth_colors_local_call_ms": call_t["smooth_colors_local"],
             "radius_m": SMOOTH_RADIUS, "neighbors_p10_p50_p90": all_q,
             "neighbors_wall_p10_p50_p90": wall_q, "neighbors_occluder_p10_p50_p90": occ_q,
             "share_over_k": over_k, "buckets_over_capacity": over,
             "buckets_occupied": nonempty}]


# The MLS bench's size (bench.py:581-606, bench_mls: the hardened corner at
# 1M points, the default MLSConfig) and the tolerances of M1 against its
# twin: in-radius counts and fit flags bit-equal; positions and normals as
# tests/test_torch_mls.py holds the twin to the JAX package, but for the
# overflow knife's edge of degenerate 2-3 point neighborhoods (counted).
MLS_N = 1_000_000
MLS_POS_TOL, MLS_NRM_TOL = 2e-6, 1e-5
# f32 operations of M1, counted from csrc/mls.cu: a candidate slot read
# (3 subtractions, 3 products, 2 sums, 2 compares), an in-radius candidate
# (the weight ~12 with the exp, pass 1 8, pass 2 ~15, pass 3: u, v, h 15,
# powers 6, 15 moments x 3, 6 right-hand sides ~12: ~113), a point (the
# 3x3 solves 3 x ~40, the 6x6 solve ~150, the frame and projection ~80).
M1_OPS_SLOT, M1_OPS_IN, M1_OPS_POINT = 10, 113, 350
# Operations of S1's function (csrc/sor.cu), not of its bit-by-bit
# selection: f32 ones for a candidate slot read as M1's; then, at the 32-bit
# integer rate, one compare of the 64-bit (d2, position) key (2 operations)
# for each in-radius key of a query with more than K (the K smallest of
# them), and k log2 k compares for the output order of the k = min(in
# radius, K) kept.
S1_OPS_SLOT, S1_INT_OPS_CMP = 10, 2


def _s1_bound(grid, pts, radius, k, exclude_self=False):
    """S1's bound on the grid's own points as queries, K = ``k``: (bound_ms,
    bound_by, bytes, f32 operations, integer operations, compares, slots a
    query, in-radius a query, queries over k). Bytes: the schedule and the
    counts read, each bucket's occupied slots, points and queries, the
    query's cell, and idx / dist / ok written (9 B a neighbor); operations:
    S1_OPS_SLOT a candidate slot, S1_INT_OPS_CMP a compare of the
    selection (the overflow's scan and a sort of the kept)."""
    import torch

    n = pts.shape[0]
    cap = grid.buckets.shape[1]
    slots, inr = _slots_and_in_radius(grid, pts, pts, radius, exclude_self=exclude_self)
    over = inr > k
    nbytes = (4 * 2 * n + 4 * int(torch.clamp(grid.counts, max=cap).sum()) + 12 * n + 12 * n
              + 4 * n + 9 * k * n)
    ops = S1_OPS_SLOT * int(slots.sum())
    kept = torch.clamp(inr, max=k).double()
    compares = int(inr[over].sum()) + float((kept * torch.log2(kept.clamp(min=1))).sum())
    int_ops = S1_INT_OPS_CMP * compares
    b_ms, by = _bound(nbytes, ops, int_ops)
    return b_ms, by, nbytes, ops, int_ops, compares, slots, inr, over


def _slots_and_in_radius(grid, pts, queries, radius, exclude_self=False):
    """(occupied candidate slots a query, in-radius candidates a query),
    counted with torch ops in chunks, for the bounds."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn

    cap = grid.buckets.shape[1]
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=pts.device)
    slots, inr = [], []
    for s in range(0, queries.shape[0], 32768):
        q = queries[s: s + 32768]
        cand, cx, cy, cz = knn._candidates_with_points(grid, pts, q)
        d2 = (cx - q[:, 0:1]) ** 2 + (cy - q[:, 1:2]) ** 2 + (cz - q[:, 2:3]) ** 2
        hit = (cand >= 0) & (d2 <= r2)
        if exclude_self:
            hit &= cand != torch.arange(s, s + q.shape[0], device=pts.device)[:, None]
        inr.append(hit.sum(1))
        slots.append(torch.clamp(grid.counts[knn._neighbor_hashes(grid, q).long()], max=cap)
                     .sum(1))
    return torch.cat(slots), torch.cat(inr)


def _schedules(m, device, own=None):
    """The three schedules S1 and M1 are held under: the path's own
    (``own``; None: the wrapper's default), the identity and a seeded random
    permutation, (m,) int32."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    return {"own": own, "identity": torch.arange(m, dtype=torch.int32, device=device),
            "random": torch.randperm(m, generator=g).to(torch.int32).to(device)}


# Bins of the run-size histogram the kernels fill (``run_sizes``): bin s
# counts the windows staged for s queries, the last one those of more.
RUN_SIZE_BINS = 1025


def _run_sizes(device):
    """A zeroed run-size histogram for a checked launch on the card, else
    None (the twins stage nothing)."""
    import torch

    return (torch.zeros(RUN_SIZE_BINS, dtype=torch.int32, device=device)
            if device == "cuda" else None)


def _window_stats(run_sizes):
    """(windows staged, p50 queries a window) from the kernel's run-size
    histogram; (None, None) without one."""
    import torch

    if run_sizes is None:
        return None, None
    hist = run_sizes.long()
    sizes = torch.repeat_interleave(torch.arange(hist.numel(), device=hist.device), hist)
    return int(hist.sum()), float(sizes.double().quantile(0.5))


def _mls_kw(cfg, n):
    """``mls_smooth``'s keyword arguments of the pass for ``n`` points."""
    return dict(search_radius=cfg.search_radius, sqr_gauss_param=cfg.sqr_gauss_param,
                polynomial_order=cfg.polynomial_order, bucket_capacity=cfg.bucket_capacity,
                table_size=max(n // 2, 1024))


def _mls_check(label, pts, valid, kw, device, witness=False):
    """M1 against its twin (``mls.mls_pass_plain`` run on the same device)
    on one cloud, with the pass's keyword arguments ``kw``, under each of
    :func:`_schedules`: in-radius counts and fit flags bit-equal; positions
    within ``MLS_POS_TOL`` and normals within ``MLS_NRM_TOL`` on the finite
    rows but for the rows where a degenerate fit's normal overflows to 0 in
    one of the two (each with at most 3 neighbors, at most ``_max_flips(n)``
    of them); non-finite rows NaN where the twin's are. With ``witness``,
    a finite row outside those bounds is left out only where
    :func:`_conditioning` shows its fit ill-conditioned (its readings
    printed); any other such row fails. Returns (position error, normal
    error, flips), the largest over the schedules, and (windows staged, p50
    points a window) of the own schedule's launch."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import mls

    n = pts.shape[0]
    want = mls.mls_pass_plain(pts, valid, chunk_size=min(16384, max(2 * n, 1024)), **kw)
    pos_w, nrm_w, surf_w, cnt_w = want
    finite = torch.isfinite(pts).all(1)
    q = torch.tensor([0.5, 0.999, 0.99999], device=pts.device)
    worst = (0.0, 0.0, 0)
    stats = (None, None)
    for name, order in _schedules(n, device).items():
        sizes = _run_sizes(device) if name == "own" else None
        got = (mls.mls_moments_cuda(pts, valid, order=order, run_sizes=sizes, **kw)
               if device == "cuda" else want)
        if name == "own":
            stats = _window_stats(sizes)
        pos, nrm, surf, cnt = got
        assert torch.equal(cnt, cnt_w), f"M1's in-radius counts differ on {label} ({name})"
        assert torch.equal(surf.ok, surf_w.ok), f"M1's fit flags differ on {label} ({name})"
        zero, zero_w = ~(nrm != 0).any(1), ~(nrm_w != 0).any(1)
        flip = zero != zero_w
        pos_err = (pos - pos_w).abs().amax(1)
        cos = 1.0 - (nrm * nrm_w).sum(1).abs()
        rows = valid & finite
        exempt = torch.zeros_like(rows)
        if witness:
            out = rows & (flip | (pos_err > MLS_POS_TOL)
                          | ((cos > MLS_NRM_TOL) & ~zero & ~zero_w))
            if out.any():
                o = out.nonzero()[:, 0]
                ill, dpos, dnrm = _conditioning(pts, valid, kw, o, cnt_w)
                exempt[o] = ill
                print(f"M1 on {label}, {name} schedule: {len(o)} finite rows outside the "
                      f"bounds (in-radius {sorted(set(cnt[o].tolist()))}; positions "
                      f"{_range(pos_err[o])} m, normals {_range(cos[o])}, "
                      f"{int(flip[o].sum())} zero-normal flips), {int(ill.sum())} of them "
                      f"ill-conditioned by the f64 witness (f32-sized perturbations move them "
                      f"by {_range(dpos[ill])} m, {_range(dnrm[ill])}; the others by "
                      f"{_range(dpos[~ill])} m, {_range(dnrm[~ill])})")
        flip = flip & ~exempt
        keep = ~flip & rows & ~exempt
        cos_keep = cos[keep & ~zero_w]
        err = float(pos_err[keep].max()) if keep.any() else 0.0
        nerr = float(cos_keep.max()) if cos_keep.numel() else 0.0
        nan_alike = torch.equal(pos[~finite].isnan(), pos_w[~finite].isnan())
        if name == "own":
            inr = cnt[valid].float()
            pq = torch.quantile(pos_err[keep], q).tolist() if keep.any() else []
            print(f"M1 mls_moments on {label} ({n} points, {int(valid.sum())} valid, radius "
                  f"{kw['search_radius']} m, B {kw['bucket_capacity']}, table "
                  f"{kw['table_size']}): in-radius a valid point p50 / p99.9 / max "
                  f"{torch.quantile(inr, q[:2]).tolist() if inr.numel() else []} / "
                  f"{int(inr.max()) if inr.numel() else 0}; {int(surf.ok.sum())} ok; "
                  f"positions p50 / p99.9 / p99.999 {pq}")
        print(f"M1 on {label}, {name} schedule: counts and ok bit-equal to the twin; "
              f"{int(flip.sum())} rows with the normal 0 in one of the two (cap "
              f"{_max_flips(n)}; in-radius {sorted(set(cnt[flip].tolist()))}); the other "
              f"finite valid rows: positions within {err:.3e} m (tol {MLS_POS_TOL}), normals "
              f"within {nerr:.3e} in 1 - |cos| (tol {MLS_NRM_TOL}); non-finite rows alike: "
              f"{nan_alike}" + (f"; {int(exempt.sum())} ill-conditioned rows left out"
                                if witness else ""))
        assert int(flip.sum()) <= _max_flips(n), f"{int(flip.sum())} zero-normal flips on {label}"
        if flip.any():
            assert int(cnt[flip].max()) <= 3, cnt[flip]
        assert err <= MLS_POS_TOL and nerr <= MLS_NRM_TOL and nan_alike, (
            f"M1 disagrees with its twin on {label} ({name})")
        worst = (max(worst[0], err), max(worst[1], nerr), max(worst[2], int(flip.sum())))
    return (*worst, *stats)


def _range(t):
    """'[min, max]' of a tensor, '[]' when empty."""
    return f"[{float(t.min()):.3e}, {float(t.max()):.3e}]" if t.numel() else "[]"


# Trials of _conditioning's witness: each a perturbation of the fit's sums.
WITNESS_TRIALS = 16


def _conditioning(pts, valid, kw, rows, cnt_w):
    """The f64 witness of :func:`_mls_check`: whether f32 arithmetic
    determines the moments fit of each of ``rows`` to within the bounds.
    Its in-radius candidates are the twin's (``mls._in_radius`` over the
    twin's grid, counts asserted equal to ``cnt_w``). Their offsets, cast
    to f64, go through the fit in f64 (the twin's sums, then its own
    ``mls._oriented_frame``, ``mls._chol_solve`` and ``mls.project_onto``),
    once as they are and ``WITNESS_TRIALS`` times with each sum moved by g
    times the sum of its terms' magnitudes, its sign a hash of the row's
    index, the trial and the sum (so a row's witness does not depend on the
    other rows checked with it), g = (k + 4) 2^-24
    for k candidates: the error bound of an f32 sum of k three-factor
    terms in any order. A row is ill-conditioned where one of those moves
    carries its f64 position past ``MLS_POS_TOL`` or its normal past
    ``MLS_NRM_TOL`` (1 - |cos|) from the unmoved fit: a change within f32
    rounding that takes the answer out of the bounds is the witness.
    Returns (ill, the largest position move, the largest normal move),
    each (R,)."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn, mls

    r = kw["search_radius"]
    grid = knn.build(pts, valid, r, kw["table_size"], kw["bucket_capacity"], store_points=True)
    q = pts[rows]
    dx, dy, dz, _, cnt = mls._in_radius(q, *knn.candidate_points(grid, q), r)
    assert torch.equal(cnt.to(torch.int32), cnt_w[rows])
    d = torch.stack([dx, dy, dz], -1).double()
    q64 = q.double()
    w = torch.exp(-(d * d).sum(-1) / kw["sqr_gauss_param"]) * (
        torch.arange(d.shape[1], device=d.device) < cnt[:, None])
    g = (cnt.double() + 4.0) * 2.0 ** -24
    salt = [0]

    def fit(trial):
        def total(terms):  # sum over the candidates, moved within its f32 bound
            s = terms.sum(1)
            if trial < 0:
                return s
            salt[0] += 1
            shape = (-1, *[1] * (s.dim() - 1))
            entry = torch.arange(s[0].numel(), device=s.device).view(s.shape[1:])
            h = ((rows.long().view(shape) * 73856093) ^ (entry * 19349669)
                 ^ ((trial * 64 + salt[0]) * 83492791)) % 1000003
            sign = ((h % 2) * 2 - 1).to(s)
            return s + sign * g.view(shape) * terms.abs().sum(1)

        wsum = total(w).clamp(min=1e-20)
        m = total(w[..., None] * d) / wsum[:, None]
        e = d - m[:, None]
        C = total(w[..., None, None] * e[..., :, None] * e[..., None, :])
        normal, tu, tv = mls._oriented_frame(C, q64, q64 + m)
        coef = torch.zeros((len(rows), 6), dtype=d.dtype, device=d.device)
        if kw["polynomial_order"] >= 2:
            u, v = (e * tu[:, None]).sum(-1), (e * tv[:, None]).sum(-1)
            h = (e * normal[:, None]).sum(-1)
            ph = torch.stack([torch.ones_like(u), u, v, u * u, u * v, v * v], -1)
            A = total(w[..., None, None] * ph[..., :, None] * ph[..., None, :])
            A = A + 1e-8 * torch.eye(6, dtype=d.dtype, device=d.device)
            coef = mls._chol_solve(A, total((w * h)[..., None] * ph))
            coef = torch.where((cnt >= 6)[:, None], coef, 0.0)
        surf = mls.MLSSurface(q64 + m, normal, tu, tv, coef, cnt >= 3)
        return mls.project_onto(surf, q64)

    pos0, nrm0 = fit(-1)
    dpos = torch.zeros(len(rows), dtype=torch.float64, device=d.device)
    dnrm = torch.zeros_like(dpos)
    for trial in range(WITNESS_TRIALS):
        pos, nrm = fit(trial)
        dpos = torch.maximum(dpos, (pos - pos0).abs().amax(-1))
        dnrm = torch.maximum(dnrm, 1.0 - (nrm * nrm0).sum(-1).abs())
    return (dpos > MLS_POS_TOL) | (dnrm > MLS_NRM_TOL), dpos, dnrm


def _max_flips(n):
    """Zero-normal flips allowed between M1 and its twin on ``n`` points:
    2, as tests/test_torch_mls.py allows between the twin and the JAX
    package on 20,000 points, or 1 in 100,000 rows on a larger cloud."""
    return max(2, n // 100_000)


def phase_mls(card, device="cuda"):
    """M1 on bench scene 1's map (its wall and occluder exactly planar: the
    singular covariance) under the valid mask that the first SOR gives
    ``smooth_cloud`` there, and on the MLS bench's hardened corner
    (``bench_scene.mls_scene``, ``MLS_N`` points), each with the default
    MLSConfig as ``mls_smooth`` runs it and held to its twin by
    :func:`_mls_check`. Device and call times of ``knn.build``, the kernel
    and the whole pass (points/s) on the corner beside the bound and the
    twin's time. Returns the kernel's record."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn, mls, sor
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.MLSConfig()
    pts_m, _ = bs.scene_map(N_MAP, WIDTH, HEIGHT, SEED)
    scene = torch.from_numpy(pts_m).to(device)
    sor1 = sor.sor_mask(scene, torch.ones(N_MAP, dtype=torch.bool, device=device),
                        mean_k=cfg.sor_mean_k, std_mult=cfg.sor_std_dev,
                        cell_size=max(cfg.search_radius * 4.0, 0.25),
                        bucket_capacity=max(cfg.bucket_capacity, cfg.sor_mean_k))
    skw = _mls_kw(cfg, N_MAP)
    err_s, nerr_s, flips_s, windows_s, per_window_s = _mls_check(
        "bench scene 1's map after the first SOR", scene, sor1, skw, device)
    sgrid = knn.build(scene, sor1, cfg.search_radius, skw["table_size"], cfg.bucket_capacity)
    scene_ms = (_device_ms(lambda: mls.mls_moments_cuda(scene, sor1, grid=sgrid, **skw))
                if device == "cuda" else None)
    print(f"[{card}] M1 on bench scene 1's map after the first SOR: device ms {_ms(scene_ms)}; "
          f"{windows_s} windows staged (p50 {per_window_s} points a window)")
    del scene, sor1, sgrid
    n = MLS_N
    pts = torch.from_numpy(bs.mls_scene(n)).to(device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    kw = _mls_kw(cfg, n)
    err, nerr, flips, windows, per_window = _mls_check("the hardened corner", pts, valid, kw,
                                                       device)
    grid = knn.build(pts, valid, cfg.search_radius, kw["table_size"], cfg.bucket_capacity)

    def kernel():
        return mls.mls_moments_cuda(pts, valid, grid=grid, **kw)

    def twin():
        return mls.mls_pass_plain(pts, valid, chunk_size=min(16384, 2 * n), **kw)

    def build():
        return knn.build(pts, valid, cfg.search_radius, kw["table_size"], cfg.bucket_capacity)

    def whole():
        return mls.mls_smooth(pts, valid, cfg)

    def schedule():
        return grid.order

    def cell_order():
        return knn.cell_order(pts, cfg.search_radius, kw["table_size"])

    fns = {"build": build, "order": schedule, "cell_order": cell_order, "twin": twin,
           "mls_smooth": whole}
    if device == "cuda":
        fns = {"kernel": kernel, **fns, "kernel again": kernel}
    dev_t = {k: _device_ms(fn, device) for k, fn in fns.items() if k != "twin"}
    call_t = {k: _call_ms(fn, device, reps=3 if k == "twin" else 20)
              for k, fn in fns.items() if k != "kernel again"}
    slots, inr = _slots_and_in_radius(grid, pts, pts, cfg.search_radius)
    t = kw["table_size"]
    nbytes = (4 * t + 4 * int(torch.clamp(grid.counts, max=cfg.bucket_capacity).sum())
              + 12 * n + 4 * n + 101 * n)
    ops = (M1_OPS_SLOT * int(slots.sum()) + M1_OPS_IN * int(inr.sum()) + M1_OPS_POINT * n)
    b_ms, by = _bound(nbytes, ops)
    t_k = dev_t.get("kernel")
    share = f"{b_ms / t_k:.3f}" if t_k else "not measured"
    whole_ms = call_t["mls_smooth"]
    rate = f"{n / (whole_ms * 1e-3):.4g}" if whole_ms else "not measured"
    print(f"[{card}] M1 device ms: " + ", ".join(f"{k} {_ms(v)}" for k, v in dev_t.items())
          + "; a call: " + ", ".join(f"{k} {_ms(v)}" for k, v in call_t.items())
          + f"; bound {b_ms:.3f} ms ({by}: {nbytes} B, {ops:.4g} f32 operations over "
          f"{int(slots.sum())} slots and {int(inr.sum())} in-radius candidates), kernel at "
          f"{share}; the whole pass (build + M1) {rate} points/s; {windows} windows staged "
          f"(p50 {per_window} points a window)")
    prof = _kernel_profile(whole, device, reps=3)
    a_call = None
    if prof is not None:
        print(f"[{card}] mls_smooth device work a call ({_kernel_launches(prof)} kernel "
              "launches; launches, mean us): "
              + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
        a_call = prof["mls_moments_kernel"][0]
        assert a_call == 1, prof
    return [{"name": "mls_moments", "route": "cuda", "source": f"{PKG}/csrc/mls.cu",
             "replaces": "pointcloudprocessor_tpu/ops/mls.py:203",
             "max_abs_err": max(err, err_s), "max_normal_err": max(nerr, nerr_s),
             "normal_flips": flips, "scene_max_abs_err": err_s,
             "scene_max_normal_err": nerr_s, "scene_normal_flips": flips_s, "ms": t_k,
             "ms_again": dev_t.get("kernel again"), "call_ms": call_t.get("kernel"),
             "plain_ms": call_t["twin"], "plain_call_ms": call_t["twin"], "library_ms": None,
             "bound_ms": b_ms, "bound_by": by, "build_ms": dev_t["build"],
             "build_call_ms": call_t["build"], "order_ms": dev_t["order"],
             "cell_order_ms": dev_t["cell_order"], "windows": windows,
             "queries_per_window": per_window, "scene_ms": scene_ms, "scene_windows": windows_s,
             "scene_queries_per_window": per_window_s, "launches_a_call": a_call,
             "mls_smooth_call_ms": whole_ms,
             "points_per_s": None if not whole_ms else n / (whole_ms * 1e-3), "n": n}]


def _call_ms(fn, device, reps=20):
    """Median time a call, host included (utils.profiling.median_ms)."""
    from pointcloudprocessor_tpu_torch.utils import profiling

    return profiling.median_ms(fn, device, reps=reps, warmup=1 if reps < 5 else 3)


def _s1_check(label, grid, pts, queries, k, exclude_self, device):
    """S1 (``knn_select_cuda``, radius the grid's cell) under each of
    :func:`_schedules` against its twin (``chunked_radius_neighbors`` on the
    same device): indices and flags bit-equal, distances within 2 ulp. The
    own schedule is the grid's order where the queries are the grid's
    points (``exclude_self``, as ``sor_stats`` calls it), else the
    wrapper's. Returns the twin's (idx, dist, ok), the largest distance
    error (m, ulp) over the schedules and (windows staged, p50 queries a
    window) of the own schedule's launch."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn

    r = grid.cell_size
    want = knn.chunked_radius_neighbors(grid, pts, queries, r, k, exclude_self=exclude_self)
    idx_w, dist_w, ok_w = want
    err, ulps = 0.0, 0
    stats = (None, None)
    own = grid.order if exclude_self else None
    for name, order in _schedules(queries.shape[0], device, own).items():
        sizes = _run_sizes(device) if name == "own" else None
        got = (knn.knn_select_cuda(grid, pts, queries, r, k, exclude_self, order=order,
                                   run_sizes=sizes)
               if device == "cuda" else want)
        if name == "own":
            stats = _window_stats(sizes)
        idx, dist, ok = got
        assert torch.equal(idx, idx_w) and torch.equal(ok, ok_w), (
            f"S1's indices or flags differ from its twin's on {label} ({name} schedule)")
        if ok.any():
            ulps = max(ulps, int((dist[ok].view(torch.int32) - dist_w[ok].view(torch.int32))
                                 .abs().max()))
            err = max(err, float((dist[ok] - dist_w[ok]).abs().max()))
        assert ulps <= 2 and torch.equal(dist[~ok], dist_w[~ok]), (
            f"S1's distances differ from its twin's on {label} ({name} schedule)")
    print(f"S1 knn_select on {label} ({queries.shape[0]} queries, K = {k}"
          f"{', the query excluded' if exclude_self else ''}): indices and flags bit-equal to "
          f"the twin under the own, identity and random schedules; distances within {ulps} "
          f"ulp ({err:.3e} m)")
    return want, err, ulps, stats


def _sor_check(card, label, pts, valid, device):
    """S1 against its twin on one cloud, as the MLS stage's SOR calls it
    (k 60, 0.7 sigma, 0.25 m cells and radius, 60 a bucket, 2n buckets),
    under each of :func:`_schedules` (:func:`_s1_check`), and the inlier
    masks' differences (each within 4 ulp of the threshold). Returns the
    grid, the count of those differences, the largest absolute distance
    error, its gap in ulp and (windows staged, p50 queries a window) of
    the own schedule's launch."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn, sor

    n = pts.shape[0]
    grid = knn.build(pts, valid, 0.25, 2 * n, 60)
    (idx_w, dist_w, ok_w), dist_err, ulps, stats = _s1_check(label, grid, pts, pts, 60, True,
                                                            device)
    got = knn.radius_search(grid, pts, pts, 0.25, 60, exclude_self=True, order=grid.order)
    idx, dist, ok = got

    def mask(d, o):
        cnt = o.sum(1)
        mean_d = torch.where(cnt > 0, torch.where(o, d, 0.0).sum(1) / torch.clamp(cnt, min=1),
                             torch.inf)
        return (*sor.sor_threshold(mean_d, valid, 0.7), mean_d)

    m, th, mean_d = mask(dist, ok)
    m_w, th_w, _ = mask(dist_w, ok_w)
    differ = m != m_w
    ulp = float(np.spacing(np.float32(float(th_w))))
    near = (mean_d - th_w).abs() <= 4 * ulp
    print(f"S1 on {label}: neighbors a point p50 {float(ok.sum(1).float().median())}; inliers "
          f"{int(m.sum())} (twin {int(m_w.sum())}), {int(differ.sum())} differ, all within 4 "
          f"ulp of the threshold {float(th_w)}: {bool(near[differ].all())}")
    assert bool(near[differ].all()), "S1's inlier mask differs away from the threshold"
    return grid, int(differ.sum()), dist_err, ulps, stats


def phase_sor(card, device="cuda"):
    """S1 on the MLS bench's hardened corner (``MLS_N`` points) and on bench
    scene 1's map (:func:`_sor_check` on each); device and call times of
    ``knn.build``, the schedule, the kernel and the twin on the corner
    beside the bound, the kernel's on the map, and the windows each stages.
    Returns the kernel's record."""
    import torch

    from pointcloudprocessor_tpu_torch.ops import knn, sor
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    pts_m, _ = bs.scene_map(N_MAP, WIDTH, HEIGHT, SEED)
    scene = torch.from_numpy(pts_m).to(device)
    sgrid, differ_scene, err_scene, ulps_scene, (windows_s, per_window_s) = _sor_check(
        card, "bench scene 1's map", scene, torch.ones(N_MAP, dtype=torch.bool, device=device),
        device)
    scene_ms = (_device_ms(lambda: knn.knn_select_cuda(sgrid, scene, scene, 0.25, 60, True,
                                                       order=sgrid.order))
                if device == "cuda" else None)
    print(f"[{card}] S1 on bench scene 1's map: device ms {_ms(scene_ms)}; {windows_s} windows "
          f"staged (p50 {per_window_s} queries a window)")
    del scene, sgrid
    n = MLS_N
    pts = torch.from_numpy(bs.mls_scene(n)).to(device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    grid, differ, err, ulps, (windows, per_window) = _sor_check(card, "the hardened corner",
                                                                pts, valid, device)

    def kernel():
        return knn.knn_select_cuda(grid, pts, pts, 0.25, 60, True, order=grid.order)

    def twin():
        return knn.chunked_radius_neighbors(grid, pts, pts, 0.25, 60, exclude_self=True)

    def build():
        return knn.build(pts, valid, 0.25, 2 * n, 60)

    def schedule():
        return grid.order

    def cell_order():
        return knn.cell_order(pts, 0.25, 2 * n)

    fns = {"build": build, "order": schedule, "cell_order": cell_order, "twin": twin}
    if device == "cuda":
        fns = {"kernel": kernel, **fns, "kernel again": kernel}
    dev_t = {k: _device_ms(fn, device) for k, fn in fns.items() if k != "twin"}
    call_t = {k: _call_ms(fn, device, reps=3 if k == "twin" else 20)
              for k, fn in fns.items() if k != "kernel again"}
    b_ms, by, nbytes, ops, int_ops, compares, slots, inr, over = _s1_bound(
        grid, pts, 0.25, 60, exclude_self=True)
    t_k = dev_t.get("kernel")
    share = f"{b_ms / t_k:.3f}" if t_k else "not measured"
    print(f"[{card}] S1 device ms: " + ", ".join(f"{k} {_ms(v)}" for k, v in dev_t.items())
          + "; a call: " + ", ".join(f"{k} {_ms(v)}" for k, v in call_t.items())
          + f"; bound {b_ms:.3f} ms ({by}: {nbytes} B, {ops:.4g} f32 and {int_ops:.4g} "
          f"integer operations ({compares:.4g} 64-bit compares); "
          f"{int(slots.sum())} slots, {int(inr.sum())} in radius, {int(over.sum())} queries "
          f"over 60), kernel at {share}; {windows} windows staged (p50 {per_window} queries "
          "a window)")
    prof = _kernel_profile(lambda: sor.sor_stats(pts, valid, 60, 0.25, None, 60), device, reps=3)
    a_call = None
    if prof is not None:
        print(f"[{card}] sor_stats device work a call ({_kernel_launches(prof)} kernel launches; "
              "launches, mean us): "
              + json.dumps({k: [c, round(us, 2)] for k, (c, us) in prof.items()}))
        a_call = prof["knn_select_kernel"][0]
        assert a_call == 1, prof
    return [{"name": "knn_select", "route": "cuda", "source": f"{PKG}/csrc/sor.cu",
             "replaces": "pointcloudprocessor_tpu/ops/knn.py:294",
             "max_abs_err": max(err, err_scene), "max_dist_ulp": max(ulps, ulps_scene),
             "mask_differences": differ, "mask_differences_scene": differ_scene,
             "ms": t_k, "ms_again": dev_t.get("kernel again"), "call_ms": call_t.get("kernel"),
             "plain_ms": call_t["twin"], "plain_call_ms": call_t["twin"], "library_ms": None,
             "bound_ms": b_ms, "bound_by": by, "build_ms": dev_t["build"],
             "build_call_ms": call_t["build"], "order_ms": dev_t["order"],
             "cell_order_ms": dev_t["cell_order"], "windows": windows,
             "queries_per_window": per_window, "scene_ms": scene_ms, "scene_windows": windows_s,
             "scene_queries_per_window": per_window_s, "launches_a_call": a_call, "n": n}]


# Off the bench's shapes: the ragged counts of phase_mls_edges (S1 takes 128
# queries a block, M1 64: a lone point, one short of M1's chunk, one past
# it, and a cloud three past a million).
EDGE_SIZES = (1, 63, 65, 1_000_003)


def _edge_clouds():
    """{label: (points (n, 3) f32, valid (n,) bool)} of phase_mls_edges,
    from numpy seeds: the NaN / inf cloud (a 20,000-point corner with NaN
    and +-inf coordinates and 1% invalid), the cell-face cloud (a corner
    whose points lie on faces of the SOR's 0.25 m cells and M1's 0.03 m
    ones), the snapped cloud (every coordinate on one of the two lattices),
    the lattice cloud (every coordinate on the 0.03 m lattice) and a corner
    of each of ``EDGE_SIZES`` points."""
    from pointcloudprocessor_tpu_torch.tools import bench_scene as bs

    p = bs.mls_scene(20_000, seed=3)
    p[:3] = np.nan
    p[3, 0], p[4, 2] = np.inf, -np.inf
    clouds = {"the NaN / inf cloud": (p, np.arange(len(p)) % 100 != 7)}
    f = bs.mls_scene(20_000, seed=4)
    # mls_scene's pieces: the dense wall (the first half), the wall at x = 0
    # (the next quarter), the sparse wall (the rest). Each wall's own axis on
    # the 0.03 m lattice puts it on a face of both cells (z = 6 m = 200 x
    # 0.03 = 24 x 0.25, x = 0); 1 in 16 points of the dense wall also has x
    # on the 0.25 m lattice or y on the 0.03 m one, so that every axis meets
    # faces without making a neighborhood collinear.
    n_a, n_b = len(f) // 2, len(f) // 4
    lattice = [(slice(0, n_a), 2, 0.03), (slice(n_a, n_a + n_b), 0, 0.03),
               (slice(n_a + n_b, None), 2, 0.03), (slice(0, n_a, 16), 0, 0.25),
               (slice(8, n_a, 16), 1, 0.03)]
    for rows, axis, cell in lattice:
        c = np.float32(cell)
        f[rows, axis] = (np.round(f[rows, axis] / c) * c).astype(np.float32)
    clouds["the cell-face cloud"] = (f, np.ones(len(f), bool))
    # Every coordinate on a lattice: each wall's own axis on 0.03 m, of the
    # in-plane ones 1 in 4 on 0.25 m, the rest on 0.03 m. Points pile up on
    # lattice sites and lines: many neighborhoods are duplicated or
    # collinear points, whose normal f32 sums do not determine (M1 is held
    # there with the f64 witness of _conditioning).
    g = bs.mls_scene(20_000, seed=4)
    for rows, (own, u, v) in ((slice(0, n_a), (2, 0, 1)), (slice(n_a, n_a + n_b), (0, 1, 2)),
                              (slice(n_a + n_b, None), (2, 0, 1))):
        block = g[rows]
        i = np.arange(len(block))
        for axis, cell in ((own, 0.03), (u, np.where(i % 4 == 1, 0.25, 0.03)),
                           (v, np.where(i % 4 == 3, 0.25, 0.03))):
            c = np.asarray(cell, np.float32)
            block[:, axis] = (np.round(block[:, axis] / c) * c).astype(np.float32)
        g[rows] = block
    clouds["the snapped cloud"] = (g, np.ones(len(g), bool))
    # Every coordinate of every point on the 0.03 m lattice: the wall's own
    # axis on a face of both cells, the points stacked on lattice sites.
    lat = bs.mls_scene(20_000, seed=4)
    c = np.float32(0.03)
    clouds["the lattice cloud"] = ((np.round(lat / c) * c).astype(np.float32),
                                   np.ones(len(lat), bool))
    for n in EDGE_SIZES:
        clouds[f"a {n}-point corner"] = (bs.mls_scene(n, seed=5), np.ones(n, bool))
    return clouds


def _shared_buckets(pts, valid, cell, table):
    """Occupied cells (of the valid points) whose bucket holds another
    occupied cell too."""
    import torch

    from pointcloudprocessor_tpu_torch.ops.voxel import voxel_coords, voxel_hash

    cells = torch.unique(voxel_coords(pts[valid], cell), dim=0)
    _, inverse, per_bucket = torch.unique(voxel_hash(cells, table), return_inverse=True,
                                          return_counts=True)
    return int((per_bucket[inverse] > 1).sum())


def phase_mls_edges(card, device="cuda"):
    """M1 and S1 off the bench's shapes, each under the three schedules of
    :func:`_schedules` against its twin (M1 as :func:`_mls_check`, S1 as
    :func:`_s1_check`): on the clouds of :func:`_edge_clouds` (M1 with the
    default MLSConfig, and with 64 points a bucket on the NaN / inf cloud;
    S1 as the SOR calls it at K = 60 and, on shifted queries that are not
    the points, at K = 1), and with tables of 7 (S1) and n / 8 and 5 (M1)
    buckets, where most occupied cells share a bucket (with 5, a cell's 27
    buckets list the same points many times over); M1 on the snapped and
    lattice clouds and with 5 buckets under :func:`_conditioning`'s
    witness, everywhere
    else to the plain bounds; then ``smooth_cloud`` with
    each upsampling method on a flat 4,000-point patch, asserting the JAX
    tests' properties (more points out than in, all on the plane) and, on
    the card, one S1 launch for the VGD's nearest search besides the two
    SORs."""
    import torch

    from pointcloudprocessor_tpu_torch.core import cloud as cl
    from pointcloudprocessor_tpu_torch.ops import knn, mls
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.MLSConfig()
    for label, (p, v) in _edge_clouds().items():
        pts = torch.from_numpy(p).to(device)
        valid = torch.from_numpy(v).to(device)
        n = pts.shape[0]
        shared = [_shared_buckets(pts, valid, cell, table)
                  for cell, table in ((cfg.search_radius, max(n // 2, 1024)),
                                      (0.25, max(2 * n, 1024)))]
        print(f"{label}: occupied cells sharing a bucket with another, M1's grid / S1's: "
              f"{shared[0]} / {shared[1]}")
        if label == "the NaN / inf cloud":
            assert shared[0] > 0, "the NaN / inf cloud has no bucket shared by two cells"
        _mls_check(label, pts, valid, _mls_kw(cfg, n), device,
                   witness=label in ("the snapped cloud", "the lattice cloud"))
        grid = knn.build(pts, valid, 0.25, max(2 * n, 1024), 60)
        _s1_check(label, grid, pts, pts, 60, True, device)
        if label == "the NaN / inf cloud":
            _mls_check(label + ", B 64", pts, valid,
                       dict(_mls_kw(cfg, n), bucket_capacity=64, table_size=10_000), device)
            q = (pts[:5000] + 0.01).contiguous()
            _s1_check(label + ", shifted queries", grid, pts, q, 1, False, device)
            _mls_check(label + ", n / 8 buckets", pts, valid,
                       dict(_mls_kw(cfg, n), table_size=n // 8), device)
            _mls_check(label + ", 5 buckets", pts, valid, dict(_mls_kw(cfg, n), table_size=5),
                       device, witness=True)
            _s1_check(label + ", 7 buckets", knn.build(pts, valid, 0.25, 7, 60), pts, pts, 60,
                      True, device)
        del pts, valid, grid

    rng = np.random.default_rng(6)
    flat = np.zeros((4000, 3), np.float32)
    flat[:, :2] = rng.uniform(-0.5, 0.5, size=(4000, 2))
    for method in ("sample_local_plane", "random_uniform_density", "voxel_grid_dilation"):
        cfg = cfg_mod.MLSConfig(search_radius=0.1, sqr_gauss_param=0.01, upsampling=method,
                                slp_upsampling_radius=0.02, slp_upsampling_stepsize=0.01,
                                rud_point_density=4, vgd_voxel_size=0.02, vgd_iterations=1,
                                sor_mean_k=10, sor_std_dev=3.0, bucket_capacity=64)
        _reset_counts()
        out = mls.smooth_cloud(cl.make(flat, device), cfg)
        counts = _read_counts()
        v = out.valid
        z = float(out.points[v, 2].abs().max())
        print(f"smooth_cloud with {method} on the {device}: {int(v.sum())} of "
              f"{out.points.shape[0]} points valid, |z| <= {z:.2e}; M1 {counts['mls_moments']}, "
              f"S1 {counts['knn_select']} launches")
        assert int(v.sum()) > 4000 and z < 0.02
        if device == "cuda":
            assert counts["mls_moments"] == 1 and counts["knn_select"] == (
                3 if method == "voxel_grid_dilation" else 2), counts


def phase_tools(device="cuda"):
    """The z-buffer tools at full scale on the card (``--quick`` off it):
    each prints its JSON line; both must be exact, with kernel times, the
    anatomy with the production (C1) and the eager fuse a frame."""
    from pointcloudprocessor_tpu_torch.tools import colorize_anatomy, zbuffer_probe

    argv = [] if device == "cuda" else ["--quick", "--device", device]
    anatomy = colorize_anatomy.main(argv)
    probe = zbuffer_probe.main(argv)
    assert anatomy["exact"] and probe["exact"], (anatomy, probe)
    if device == "cuda":
        assert anatomy["zbuffer_scatter"] is not None and probe["kernel_ms"] is not None, (
            anatomy, probe)
        assert anatomy["full"] is not None and anatomy["full_plain"] is not None, anatomy


# The harness path's arguments a harness: the full scale with fewer repeats
# (and fewer sweep rows) than the harnesses' defaults, to fit the smoke's
# time; the harnesses' own runs give the full rows.
HARNESS_ARGS = {
    "nid_bisect": ["--reps", "3", "--split-reps", "5"],
    "nid_locality": ["--reps", "3"],
    "solver_sweep": ["--ftols", "0,3e-4", "--reps", "1"],
    "frozen_guard_sweep": ["--guards", "0.75,1.0", "--reps", "1"],
    "mls_anatomy": ["--reps", "1"],
    "mls_dedup_probe": ["--reps", "1"],
    "scaling_bench": [],
    "tap_cache_probe": ["--reps", "5"],
    "slab_gather_probe": ["--reps", "3"],
}


def phase_harnesses(card, device="cuda"):
    """The harness path (phase 4c): the nine measurement harnesses of
    ``tools/`` (each ``main``, printing its rows) at full scale on the card
    (``--quick`` off it), the launch counts set to 0 before and read after.
    Checks, each failing the run: nid_bisect's value+grad equals
    ``multi_nid_loss`` at the same pose bit for bit; nid_locality's grouped,
    streamed and direct value+grad chains agree bit for bit; mls_dedup_probe's
    two plain passes (and M1 with and without dedup) are bit-identical;
    tap_cache_probe's partial and full refreshes give the same losses;
    slab_gather_probe's spans on the card equal the CPU's on the same
    anchors; scaling_bench at a world of 1 (NCCL) is bit-equal to the serial
    solve and fuse. Returns the launch counts."""
    import importlib

    _reset_counts()
    walls = {}
    out = {}
    for name, extra in HARNESS_ARGS.items():
        mod = importlib.import_module(f"pointcloudprocessor_tpu_torch.tools.{name}")
        argv = ["--device", device, *extra] + ([] if device == "cuda" else ["--quick"])
        if name == "scaling_bench" and device != "cuda":
            argv = ["--device", device, "--keyframes", "2", "--points", "2048", "--width",
                    "128", "--height", "96", "--inner", "3", "--outer", "1"]
        t0 = time.perf_counter()
        out[name] = mod.main(argv)
        walls[name] = time.perf_counter() - t0
    counts = _read_counts()
    print(f"[{card}] harness path walls (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {sum(walls.values()):.1f}")
    print(f"[{card}] harness path launches: "
          + json.dumps({k: v for k, v in counts.items() if k != "launches_by_n" and v}))
    bis, loc = out["nid_bisect"], out["nid_locality"]
    assert bis["value_grad_equals_multi_nid_loss"], bis
    assert loc["acc_grouped"] == loc["acc_streamed"] == loc["acc_direct"], loc
    dedup = out["mls_dedup_probe"]
    assert dedup["exact"] and dedup.get("m1_dedup_exact", device != "cuda"), dedup
    tap = out["tap_cache_probe"]
    assert tap["refresh_0.1px_losses_equal"] and tap["refresh_0.33px_losses_equal"], tap
    assert out["slab_gather_probe"]["spans_cpu_equal"], out["slab_gather_probe"]
    assert out["scaling_bench"] == 0, "scaling_bench: the world of 1 differs from serial"
    if device == "cuda":
        assert bis["value_grad_launches"] and bis["value_grad_wall_ms"], bis
    return counts


# The crack_width phase: the keyframes whose dumps it measures, and the
# synthetic crack each carries (a band across the wall: the host's numpy
# skeleton and structure tensor cost ~5 and ~2.5 s a 4096x3000 frame).
TOOLS_CRACK_KEYFRAMES = (0, 1)
CRACK_BAND_PX, CRACK_LENGTH_PX = 5, 1200


def _crack_mask(j):
    """A crack mask of the scene's image size for keyframe ``j``: a band
    CRACK_BAND_PX wide and CRACK_LENGTH_PX long (at most a third of the
    width), at a slope of 0.15 from (0.34 W, (0.23 + 0.1 j) H): from (1392,
    690 + 300 j) at 4096x3000."""
    mask = np.zeros((HEIGHT, WIDTH), np.uint8)
    x0, y0 = int(0.34 * WIDTH), int((0.23 + 0.1 * j) * HEIGHT)
    xs = np.arange(x0, x0 + min(CRACK_LENGTH_PX, WIDTH // 3))
    ys = (y0 + 0.15 * (xs - x0)).astype(np.int64)
    for d in range(-(CRACK_BAND_PX // 2), CRACK_BAND_PX - CRACK_BAND_PX // 2):
        mask[ys + d, xs] = 255
    return mask


class _MorphologyReplay:
    """Records what the numpy morphology of ``tools/crack_width`` returns
    in one ``process`` run and replays it in a later run on the same masks
    (it runs on the host, the same on both runs), so that a twin run of
    the device stages costs no second skeleton."""

    NAMES = ("distance_transform", "skeletonize", "structure_tensor_directions")

    def __init__(self):
        self.seen = {}

    def _key(self, name, args):
        import hashlib

        return (name,) + tuple(hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                               if isinstance(a, np.ndarray) else repr(a) for a in args)

    def run(self, replay):
        import contextlib

        from pointcloudprocessor_tpu_torch.ops import morphology

        originals = {n: getattr(morphology, n) for n in self.NAMES}

        def wrap(name):
            def fn(*args, **kw):
                key = self._key(name, args + tuple(sorted(kw.items())))
                if replay:
                    return self.seen[key]
                self.seen[key] = out = originals[name](*args, **kw)
                return out
            return fn

        @contextlib.contextmanager
        def ctx():
            for n in self.NAMES:
                setattr(morphology, n, wrap(n))
            try:
                yield
            finally:
                for n, f in originals.items():
                    setattr(morphology, n, f)

        return ctx()


def phase_tools_path(card, root, device="cuda"):
    """The offline tools on the headline run's outputs (phase 4b). Returns
    the launch counts of the tools' run."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.io import pcd
    from pointcloudprocessor_tpu_torch.models import camera as cam
    from pointcloudprocessor_tpu_torch.ops import knn, nid_hist, tap_gather
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod
    from pointcloudprocessor_tpu_torch.pipeline import ingest, keyframes
    from pointcloudprocessor_tpu_torch.tools import (crack_width, nid_diagnostics, pick_tool,
                                                     visualize, vo_interp)
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod
    from pointcloudprocessor_tpu_torch.utils.numeric import to_int32

    cfg = _config(root, cfg_mod.NIDConfig())
    frames = ingest.load_frames(cfg.odometry_path, cfg.images_folder)
    kf_idx = keyframes.select(ingest.frames_trajectory(frames), cfg.keyframes)[:K]
    stems = [ingest.cpp_timestamp(frames[i].timestamp) for i in kf_idx]
    dumps = os.path.join(cfg.output_path, "filtered_pcd")
    dump = [os.path.join(dumps, f"{ts}_beforeNID.pcd") for ts in stems]
    image0 = frames[kf_idx[0]].image_path
    intr, dist = list(cfg.camera.intrinsic), list(cfg.camera.distortion)
    work = os.path.join(root, "tools")
    crack_root, twin_root = os.path.join(work, "crack"), os.path.join(work, "crack_twin")
    for r in (crack_root, twin_root):
        for sub in ("filtered_pcd", "mask_select"):
            os.makedirs(os.path.join(r, sub), exist_ok=True)
        for j in TOOLS_CRACK_KEYFRAMES:
            shutil.copyfile(dump[j], os.path.join(r, "filtered_pcd", f"{stems[j]}.pcd"))
            _write_png(os.path.join(r, "mask_select", f"{stems[j]}.png"), _crack_mask(j))
    pick_dir = os.path.join(work, "picks")
    os.makedirs(pick_dir, exist_ok=True)
    shutil.copyfile(dump[0], os.path.join(pick_dir, os.path.basename(dump[0])))
    stamps = os.path.join(work, "stamps.txt")
    t_odom = np.loadtxt(cfg.odometry_path, ndmin=2)[:, 0]
    with open(stamps, "w") as f:
        for t in np.linspace(t_odom[0] - 0.05, t_odom[-1] + 0.05, 71):
            f.write(f"{t:.6f}\n")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    estimate_normals = crack_width.estimate_normals
    normals_s = []

    def timed_normals(*args, **kw):
        sync()
        t = time.perf_counter()
        out = estimate_normals(*args, **kw)
        sync()
        normals_s.append(time.perf_counter() - t)
        return out

    replay = _MorphologyReplay()
    walls = {}
    _reset_counts()
    t = time.perf_counter()
    report = nid_diagnostics.analyze(dump[0], image0, 16, intr, device=device)
    sync()
    walls["nid_diagnostics"] = time.perf_counter() - t
    crack_width.estimate_normals = timed_normals
    try:
        t = time.perf_counter()
        with replay.run(replay=False):
            results = crack_width.process(crack_root, intr, dist, WIDTH, HEIGHT, device=device)
        walls["crack_width"] = time.perf_counter() - t
    finally:
        crack_width.estimate_normals = estimate_normals
    t = time.perf_counter()
    overlay_png = os.path.join(work, "overlay.png")
    assert visualize.main(["overlay", "--cloud", dump[0], "--image", image0, "--intrinsic",
                           *map(str, intr), "--output", overlay_png, "--device", device]) == 0
    walls["visualize_overlay"] = time.perf_counter() - t
    t = time.perf_counter()
    odom_out = os.path.join(work, f"vo_{device}.txt")
    assert vo_interp.main(["--odometry", cfg.odometry_path, "--timestamps", stamps,
                           "--output", odom_out, "--device", device]) == 0
    walls["vo_interp"] = time.perf_counter() - t
    t = time.perf_counter()
    ts_list = pick_tool.generate(pick_dir, cfg.images_folder, intr, dist,
                                 os.path.join(work, "picks.html"), device=device)
    walls["pick_tool"] = time.perf_counter() - t
    launches = _read_counts()

    # What the tools' run launched.
    n_frames = len(TOOLS_CRACK_KEYFRAMES)
    print(f"[{card}] tools path: launches {launches}")
    if device == "cuda":
        want = {"bin_pack": 1, "tap_take": 1, "nid_hist_fwd": 1, "nid_hist_bwd": 0,
                "knn_select": n_frames}
        assert all(launches[k] == v for k, v in want.items()), (want, launches)
        assert launches["launches_by_n"]["nid_hist_fwd"] == {str(N_CULL): 1}, launches
        others = [k for k, v in launches.items()
                  if k not in want and isinstance(v, int) and v and not k.endswith("_calls")]
        assert not others, (others, launches)
    print(f"[{card}] tools path: nid_diagnostics on {os.path.basename(dump[0])}: "
          f"{report['num_points']} points, {report['num_projected']} projected, NID "
          f"{report['nid']!r}; wall {walls['nid_diagnostics']:.3f} s")
    assert report["num_points"] == N_CULL and report["num_projected"] > N_CULL // 2, report

    # nid_diagnostics against multi_nid_loss at K = 1 and against the twins.
    _, _, kf = nid_diagnostics.keyframe(dump[0], image0, 16, device)
    camera = cam.create_camera("pinhole", intr, (0,) * 5, WIDTH, HEIGHT, device)
    with torch.no_grad():
        multi = float(nid_mod.multi_nid_loss(camera, se3.identity(device), kf, 16))
    assert multi == report["nid"], (multi, report["nid"])
    kernels = (tap_gather.direct_take, tap_gather.pack_bins, nid_hist.joint_histogram)
    tap_gather.direct_take = tap_gather.direct_take_plain
    tap_gather.pack_bins = tap_gather.pack_bins_plain
    nid_hist.joint_histogram = nid_hist.joint_histogram_plain
    try:
        twin = nid_diagnostics.analyze(dump[0], image0, 16, intr, device=device)
    finally:
        tap_gather.direct_take, tap_gather.pack_bins, nid_hist.joint_histogram = kernels
    nid_twin = twin.pop("nid")
    assert {k: v for k, v in report.items() if k != "nid"} == twin, (report, twin)
    print(f"[{card}] tools path: nid_diagnostics NID {report['nid']!r} = multi_nid_loss at "
          f"K = 1 {multi!r}; through the twins of B1 / G1 / K1 {nid_twin!r} (|diff| "
          f"{abs(nid_twin - report['nid']):.3g})")
    assert abs(nid_twin - report["nid"]) <= 1e-5, (nid_twin, report["nid"])
    if device == "cuda":
        _tools_kernel_times(card, camera, kf, pcd.read(dump[0]).points)

    # crack_width: S1 against its twin, then the whole process through it.
    with open(results) as f:
        measured = json.load(f)
    for j in TOOLS_CRACK_KEYFRAMES:
        pts = torch.from_numpy(pcd.read(dump[j]).points).to(device)
        idx, ok = crack_width.neighbors(pts)
        n = pts.shape[0]
        grid = knn.build(pts, torch.ones((n,), dtype=torch.bool, device=device), 0.1,
                         max(2 * n, 1024), 64)
        t_idx, _, t_ok = knn.chunked_radius_neighbors(grid, pts, pts, 0.1, 60, 16384)
        assert torch.equal(idx, t_idx) and torch.equal(ok, t_ok), j
        cnt = ok.sum(1).float()
        print(f"[{card}] tools path: S1 on keyframe {j}'s {n} points: indices and flags "
              f"bit-equal to its twin; in-radius neighbors median {float(cnt.median()):.0f}, "
              f"{int((cnt < 3).sum())} points with fewer than 3")
    search = knn.radius_search
    knn.radius_search = lambda grid, p, q, r, k, chunk_size=65536, exclude_self=False, order=None: (
        knn.chunked_radius_neighbors(grid, p, q, r, k, chunk_size, exclude_self))
    try:
        t = time.perf_counter()
        with replay.run(replay=True):
            twin_results = crack_width.process(twin_root, intr, dist, WIDTH, HEIGHT,
                                               device=device)
        twin_wall = time.perf_counter() - t
    finally:
        knn.radius_search = search
    with open(twin_results) as f:
        assert json.load(f) == measured
    for ts in (stems[j] for j in TOOLS_CRACK_KEYFRAMES):
        rel = os.path.join("norm_masks", f"{ts}_norm.png")
        with open(os.path.join(crack_root, rel), "rb") as a, \
                open(os.path.join(twin_root, rel), "rb") as b:
            assert a.read() == b.read(), rel
    widths = [m["crack_width_mm"] for m in measured if m["crack_width_mm"] is not None]
    assert len(widths) >= 2 * n_frames, measured
    host_s = walls["crack_width"] - sum(normals_s)
    print(f"[{card}] tools path: crack_width on {n_frames} frames: {len(measured)} "
          f"measurements, width median {np.median(widths):.2f} mm; wall "
          f"{walls['crack_width']:.3f} s = normals on the {device} "
          f"{', '.join(f'{s:.3f}' for s in normals_s)} s + host {host_s:.3f} s; results "
          f"JSON and normal masks equal to the run through S1's twin ({twin_wall:.3f} s, "
          "morphology replayed)")

    # visualize: twice on the card, once on the CPU.
    def run_overlay(dev):
        with torch.no_grad():
            return visualize.overlay(dump[0], image0, intr, device=dev).cpu()

    a = run_overlay(device)
    b = run_overlay(device)
    assert torch.equal(a, b), "two overlays on the card differ"
    c = run_overlay("cpu")
    pts = torch.from_numpy(pcd.read(dump[0]).points)
    uv = {}
    for dev in (device, "cpu"):
        px = cam.project(cam.create_camera("pinhole", intr, (0,) * 5, WIDTH, HEIGHT, dev),
                         pts.to(dev))
        uv[dev] = to_int32(px).cpu()
    moved = torch.any(uv[device] != uv["cpu"], dim=1)
    differ = torch.any(a != c, dim=-1)
    touched = torch.zeros((HEIGHT, WIDTH), dtype=torch.bool)
    for dev in (device, "cpu"):
        u, v = uv[dev][moved, 0].long(), uv[dev][moved, 1].long()
        inside = (u >= 0) & (u < WIDTH) & (v >= 0) & (v < HEIGHT)
        touched[v[inside], u[inside]] = True
    print(f"[{card}] tools path: visualize overlay {WIDTH}x{HEIGHT}, {pts.shape[0]} points: two "
          f"{device} runs bit-equal; against the CPU run {int(differ.sum())} pixels differ, "
          f"{int((differ & touched).sum())} of them under the {int(moved.sum())} points whose "
          f"projected pixel differs between the devices, {int((differ & ~touched).sum())} "
          f"elsewhere; largest difference {float((a - c).abs().max()):.3g}; wall "
          f"{walls['visualize_overlay']:.3f} s (PNG write included)")

    # vo_interp: the card's file against the CPU's.
    cpu_out = os.path.join(work, "vo_cpu.txt")
    assert vo_interp.main(["--odometry", cfg.odometry_path, "--timestamps", stamps,
                           "--output", cpu_out, "--device", "cpu"]) == 0
    with open(odom_out) as f1, open(cpu_out) as f2:
        rows = [(a.split(), b.split()) for a, b in zip(f1.read().splitlines(),
                                                     f2.read().splitlines())]
    assert len(rows) == 71 and all(a[:4] == b[:4] for a, b in rows), "times / positions"
    q_dev = np.asarray([a[4:] for a, _ in rows], np.float64)
    q_cpu = np.asarray([b[4:] for _, b in rows], np.float64)
    # The quaternions: the slerp's f32 arccos / sin on the card against the
    # CPU's (times and positions are host f64, equal as text).
    # A field may differ by 2 f32 ulp of its value and the 8th decimal's rounding.
    diff = np.abs(q_dev - q_cpu)
    ulp = np.spacing(np.maximum(np.abs(q_dev), np.abs(q_cpu)).astype(np.float32))
    fields = int((diff > 0).sum())
    print(f"[{card}] tools path: vo_interp 71 stamps: times and positions equal as text to the "
          f"CPU run's; {fields} of {q_dev.size} quaternion fields differ, by at most "
          f"{diff.max():.3g}; byte-equal {fields == 0}; wall {walls['vo_interp']:.3f} s")
    assert (diff <= 2 * ulp.astype(np.float64) + 1.01e-8).all(), diff.max()
    assert ts_list == [stems[0]], ts_list
    print(f"[{card}] tools path: walls (s) " + json.dumps(
        {k: round(v, 3) for k, v in walls.items()}))
    return launches


def _tools_kernel_times(card, camera, kf, points):
    """Device times of the tools path's kernels on its own inputs (not
    counted as its launches): B1, G1 and K1 at K = 1 on keyframe 0's dump
    and image, S1 on its points as crack_width calls it; each beside its
    bound, computed as the main path's records compute it."""
    import torch

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.ops import knn, nid_hist, tap_gather
    from pointcloudprocessor_tpu_torch.opt import nid as nid_mod
    from pointcloudprocessor_tpu_torch.utils.numeric import to_int32

    kp = nid_mod.prepare_keyframes(kf)
    with torch.no_grad():
        proj, knot, inl = nid_mod._project_all(camera, se3.identity("cuda"), kp)
        s = (proj - knot.to(proj.dtype)).contiguous()
        taps = tap_gather.direct_take(kp.bin_tiles, knot, WIDTH, HEIGHT)
        bp = torch.clamp(to_int32(kp.intensity * 16), 0, 15)
        il = inl.to(torch.float32)
        hist = nid_hist.hist_fwd_cuda(taps, s, bp, il, 16)
    n = knot.shape[1]
    pts = torch.from_numpy(points).cuda()
    grid = knn.build(pts, torch.ones((n,), dtype=torch.bool, device="cuda"), 0.1,
                     max(2 * n, 1024), 64)
    rows = {
        "bin_pack": (lambda: tap_gather.pack_bins(kp.bin_image),
                     _bound(_nbytes(kp.bin_image, kp.bin_tiles))),
        "tap_take": (lambda: tap_gather.direct_take(kp.bin_tiles, knot, WIDTH, HEIGHT),
                     _bound(2 * _nbytes(knot) + _window_pixels(knot, WIDTH, HEIGHT) / 2)),
        "nid_hist_fwd": (lambda: nid_hist.hist_fwd_cuda(taps, s, bp, il, 16),
                         _bound(_nbytes(taps, s, bp, il, hist), K1_OPS * n)),
        "knn_select": (lambda: knn.knn_select_cuda(grid, pts, pts, 0.1, 60, order=grid.order),
                       _s1_bound(grid, pts, 0.1, 60)[:2]),
    }
    for name, (fn, (b_ms, by)) in rows.items():
        t = _device_ms(fn)
        share = "not measured" if t is None else f"{b_ms / t:.3f}"
        print(f"[{card}] tools path: {name} at K = 1, {n} points: device {_ms(t)} ms, a call "
              f"{_ms(_median_ms(fn))} ms; bound {b_ms * 1e3:.2f} us ({by}), {share} of it")


def _write_png(path, img):
    try:
        import cv2

        cv2.imwrite(path, img)
    except ImportError:
        from PIL import Image

        Image.fromarray(img).save(path)


DIST_PER_KEYFRAME = dict(max_outer_iterations=1, max_inner_iterations=10)
DIST_COUNTS = ("nid_hist_fwd", "nid_hist_bwd", "tap_take", "bin_pack", "colorize_scatter",
               "colorize_update")


def _bits_equal(a, b) -> bool:
    import torch

    a, b = (torch.as_tensor(x) for x in (a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def phase_distributed(card, root, T0, device="cuda"):
    """``parallel/`` over NCCL at a world of 1 (Gloo on the CPU): the
    sharded headline solve, per-keyframe solve, pose graph and fuse on the
    scene, each run in turns serial, sharded, sharded, serial and each
    bit-equal to its serial port path, with the same kernel launches.
    Returns the sharded paths' launches, summed over their first runs; the
    process group is destroyed on the way out."""
    import torch
    import torch.distributed as dist

    from pointcloudprocessor_tpu_torch.core import se3
    from pointcloudprocessor_tpu_torch.opt import pose_graph, refine
    from pointcloudprocessor_tpu_torch.parallel import fusion_shard, nid_shard
    from pointcloudprocessor_tpu_torch.parallel import mesh as mesh_lib
    from pointcloudprocessor_tpu_torch.parallel import pose_graph_shard
    from pointcloudprocessor_tpu_torch.pipeline import colorize

    mesh_lib.init_distributed()
    try:
        mesh = mesh_lib.make_mesh(1, 1)
        want_backend = "nccl" if device == "cuda" else "gloo"
        assert dist.get_backend() == want_backend and dist.get_world_size() == 1, mesh
        print(f"[{card}] distributed: {mesh}, backend {dist.get_backend()}")
        if device == "cuda":
            try:
                mesh_lib.all_reduce(torch.zeros(1), mesh.get_group(mesh_lib.KF_AXIS))
            except ValueError as e:
                print(f"distributed: a CPU tensor on the NCCL mesh raises: {e}")
            else:
                raise AssertionError("a CPU tensor rode the NCCL group")
        sharded_counts = {}

        def turns(label, serial, sharded, fields):
            """Serial, sharded, sharded, serial: every result's ``fields``
            bit-equal to the first's, the launches equal; returns the
            first result and the four walls."""
            runs = []
            for turn, is_sharded in enumerate((False, True, True, False)):
                _reset_counts()
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = (sharded if is_sharded else serial)()
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _read_counts()
                if turn == 1:
                    for k, v in counts.items():
                        if isinstance(v, int):
                            sharded_counts[k] = sharded_counts.get(k, 0) + v
                runs.append((out, wall, {k: counts[k] for k in DIST_COUNTS}))
            (ref, _, ref_counts), walls = runs[0], [w for _, w, _ in runs]
            for out, _, counts in runs[1:]:
                for field in fields:
                    got, want = out, ref
                    for name in field.split("."):
                        got, want = getattr(got, name), getattr(want, name)
                    assert _bits_equal(got, want), (label, field)
                if device == "cuda":
                    assert counts == ref_counts, (label, counts, ref_counts)
            print(f"[{card}] distributed: {label} bit-equal sharded / serial; walls (s) serial "
                  f"{walls[0]:.3f} / {walls[3]:.3f}, sharded {walls[1]:.3f} / {walls[2]:.3f}; "
                  f"launches each {json.dumps(ref_counts)}")
            return ref, walls

        camera, kfs = scene_keyframes(root, device)
        local = mesh_lib.shard_keyframes(mesh, kfs)
        start = se3.identity(device)
        ref, _ = turns(
            "headline solve",
            lambda: refine.refine_pose(camera, kfs, start, **HEADLINE),
            lambda: nid_shard.refine_pose_sharded(camera, local, start, mesh, **HEADLINE),
            ("T_camera_lidar.q", "T_camera_lidar.t", "nid", "evaluations", "gathers"))
        err_cm, err_deg = _pose_error(ref.T_camera_lidar, T0)
        print(f"[{card}] distributed: headline NID {float(ref.nid):.6f}, {ref.evaluations} "
              f"evaluations, {ref.gathers} gathers, error {err_cm:.4f} cm / {err_deg:.4f} deg")
        assert np.isfinite(float(ref.nid)) and err_cm < 1.0 and err_deg < 1.0

        # The per-keyframe solve, then the pose graph on its corrections.
        pk_local = mesh_lib.shard_keyframes(mesh, kfs, split_points=False)
        pk, _ = turns(
            "per-keyframe solve",
            lambda: refine.refine_pose_per_keyframe(camera, kfs, start, **DIST_PER_KEYFRAME),
            lambda: nid_shard.refine_per_keyframe_sharded(camera, pk_local, start, mesh,
                                                          **DIST_PER_KEYFRAME),
            ("T_camera_lidar.q", "T_camera_lidar.t", "nid", "outer_iterations", "converged",
             "evaluations", "lockstep_evaluations"))
        del kfs, local, pk_local
        T_corr = T0.to(device)
        cfg, camera, cloud, poses, _, images, masks, culling = _c1_scene(root, T_corr, device)
        meas = se3.compose(poses, pk.T_camera_lidar)
        odo = pose_graph.relative_measurements(poses)
        kw = dict(abs_weight=pk.converged.to(device=device, dtype=torch.float32),
                  odo_weight=10.0, iterations=8)
        pg, _ = turns(
            "pose graph", lambda: pose_graph.optimize(poses, odo, meas, **kw),
            lambda: pose_graph_shard.optimize_sharded(mesh, poses, odo, meas, **kw),
            ("poses.q", "poses.t", "residual_norm", "initial_residual_norm"))
        print(f"[{card}] distributed: per-keyframe lockstep evaluations "
              f"{pk.lockstep_evaluations}; pose graph residual {float(pg.residual_norm):.6f} "
              f"(initial {float(pg.initial_residual_norm):.6f})")

        # The fuse with masks, at T0.
        mask_stack = torch.stack(masks)
        fused, _ = turns(
            "fuse", lambda: colorize.fuse(camera, cloud.points, cloud.valid, images, poses,
                                          T_corr, mask_stack, **culling),
            lambda: fusion_shard.fuse_sharded(
                camera, mesh_lib.shard_pt(mesh, cloud.points),
                mesh_lib.shard_pt(mesh, cloud.valid), mesh_lib.shard_kf(mesh, images),
                se3.SE3(mesh_lib.shard_kf(mesh, poses.q), mesh_lib.shard_kf(mesh, poses.t)),
                T_corr, mesh, mesh_lib.shard_kf(mesh, mask_stack), **culling),
            ("rgb", "colored", "best_label", "observation_count"))
        print(f"[{card}] distributed: fuse {int(fused.colored.sum())} colored")
        if device == "cuda":
            assert all(sharded_counts[k] >= 1 for k in DIST_COUNTS), sharded_counts
        print(f"[{card}] distributed: sharded paths' launches (first sharded run of each) "
              + json.dumps({k: sharded_counts[k] for k in DIST_COUNTS}))
        return sharded_counts
    finally:
        dist.destroy_process_group()


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
        launches, headline = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                          "headline schedule")
        # The same run through the twins of C1, G1 and the packer, the eager
        # path they replaced: the same pose, NID, counts and colored cloud,
        # byte for byte.
        _, eager = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                "headline schedule, eager C1 / G1", eager=True)
        timed = ("colorize_fuse_s", "solve_peak_mib", "cloud")
        same = {k: headline[k] == eager[k] for k in headline if k not in timed}
        print(f"[{card}] headline with C1 / G1 vs their twins: {same}; colorize_fuse "
              f"{headline['colorize_fuse_s']:.3f} s vs {eager['colorize_fuse_s']:.3f} s; solve "
              f"peak memory {headline['solve_peak_mib']} vs {eager['solve_peak_mib']} MiB")
        assert all(same.values()), (headline, eager)
        # The offline tools on the headline run's dumps and odometry.
        tools_launches = phase_tools_path(card, root)
        # The nine measurement harnesses at full scale.
        harness_launches = phase_harnesses(card)
        camera, kfs = scene_keyframes(root)
        scene = phase_kernels_scene(card, camera, kfs)
        kernels += phase_direct_take(card, camera, kfs, T0)
        kernels += phase_tap_gather(card, camera, kfs, T0)
        grouped = phase_grouped(card, camera, kfs, T0)
        # The frozen-tap cache's kernels, then its solves.
        kernels += phase_wide_cache(card, camera, kfs, T0)
        partial_launches, wide_partial_launches = phase_partial_solve(card, camera, kfs, T0)
        picks = write_picks(root, camera, kfs, T0)
        del kfs
        kernels += phase_zbuffer(card, root)
        kernels += phase_colorize(card, root, T0)
        # The HPR + smoothing path under the headline schedule, then through
        # the twins of H2, N1, C1, G1 and the packer.
        hpr_launches, hpr_run = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                             "HPR + smoothing", hpr=True)
        _, hpr_eager = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                    "HPR + smoothing, twins", hpr=True, eager=True)
        compare_smoothed(card, hpr_run, hpr_eager)
        # The small-map path: HPR + smoothing on the 100,000-point map, where
        # "auto" takes H1 (one call for the 8 NID culls, one for the 8
        # colorize culls), then the same run through the dense twin on the card.
        small_launches, small_run = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                                 "small map, HPR + smoothing", hpr=True,
                                                 small=True)
        _, small_twins = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                      "small map, dense twin", hpr=True, small=True, eager=True)
        compare_dense_twins(card, small_run, small_twins)
        kernels += phase_hpr_dense(card, root)
        kernels += phase_hpr_grid(card, root)
        kernels += phase_smooth(card, root)
        # The mask path under the headline schedule.
        phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE), "mask path", masks=True)
        # The earlier path: the plain objective (2 outer x 20 inner).
        phase_runner(card, root, T0, cfg_mod.NIDConfig(**PLAIN), "plain schedule")
        # The MLS path: bench.py's e2e config with MLS on, headline schedule.
        mls_launches, _ = phase_runner(card, root, T0, cfg_mod.NIDConfig(**HEADLINE),
                                       "MLS path", mls=True)
        # The per-keyframe path (z-buffer culls): one lockstep solve for the 8
        # keyframes, then the pose graph; then the lockstep solve timed
        # against 8 one-keyframe solves on its keyframes.
        pk_launches, pk_run = phase_runner(card, root, T0, cfg_mod.NIDConfig(**PER_KEYFRAME),
                                           "per-keyframe + pose graph")
        phase_lockstep(card, *pk_run.pop("solve_inputs"), cfg_mod.NIDConfig(**PER_KEYFRAME))
        # The re-cull path: the headline schedule, re-culling the keyframes at
        # the current correction between outer iterations.
        recull_launches, _ = phase_runner(
            card, root, T0, cfg_mod.NIDConfig(**HEADLINE, recull_every_outer_iter=True),
            "re-cull path")
        # The cache options + manual guess path: the headline schedule with
        # the cache's margin 2 and partial refresh, and picked pairs for 4
        # keyframes.
        cache_launches, _ = phase_runner(card, root, T0, cfg_mod.NIDConfig(**CACHE_MANUAL),
                                         "cache options + manual guess", picks=picks)
        # The distributed path: parallel/ over NCCL at a world of 1, each
        # sharded path bit-equal to its serial one.
        dist_launches = phase_distributed(card, root, T0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels += phase_mls(card)
    kernels += phase_sor(card)
    phase_mls_edges(card)
    phase_tools()
    launches.update(tap_select=grouped["K3"]["tap_select"],
                    tap_streamed=grouped["K4"]["tap_streamed"])
    # Each kernel's launches are those of the path it was ported for (H1's
    # the small-map path's, H2's and N1's the HPR + smoothing path's, M1's
    # and S1's the MLS path's, the z-buffer headline path's for the rest);
    # each record also carries the other paths'.
    paths = {"zbuffer_path": launches, "hpr_path": hpr_launches, "mls_path": mls_launches,
             "small_map_path": small_launches, "per_keyframe_path": pk_launches,
             "recull_path": recull_launches, "cache_manual_path": cache_launches,
             "partial_solve_path": partial_launches,
             "wide_partial_solve_path": wide_partial_launches,
             "distributed_path": dist_launches, "tools_path": tools_launches,
             "harness_path": harness_launches}
    own = {"hpr_support": "small_map_path", "hpr_grid": "hpr_path", "smooth_local": "hpr_path",
           "mls_moments": "mls_path", "knn_select": "mls_path", "wide_take": "cache_manual_path",
           "wide_select": "cache_manual_path", "tap_take_blocks": "partial_solve_path",
           "wide_take_blocks": "wide_partial_solve_path"}
    for k in kernels:
        mine = own.get(k["name"], "zbuffer_path")
        k["launches"] = paths[mine][k["name"]]
        if mine in ("cache_manual_path", "partial_solve_path", "wide_partial_solve_path"):
            assert k["launches"] >= 1, (k["name"], mine, paths[mine])
        for path, counts in paths.items():
            if path != mine:
                k[f"launches_{path}"] = counts.get(k["name"], 0)
    for k in kernels:
        if k["name"] == "tap_take":
            k["launches_by_n"] = launches["launches_by_n"]["tap_take"]
            k["solve_peak_mib"] = headline["solve_peak_mib"]
    for k, key in zip(kernels[:2], ("fwd", "bwd")):
        k["launches_by_n"] = launches["launches_by_n"][k["name"]]
        for shape, res in scene.items():
            r = res[key]
            k.update({f"scene_{shape}_{f}": r[f] for f in (
                "ms", "ms_again", "call_ms", "host_us", "bound_ms", "max_abs_err")})
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
