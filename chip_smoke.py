"""Smoke run of the PyTorch port (``airslam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases f,vo]

``--phases`` runs only the named phases (r, b, t, l, p, f, slice, tracking,
path, vo, synth, e2e, mesh, stage2, system, vio, refine, reloc, train, matcher, tools;
``path`` needs ``slice`` and ``tracking``, ``e2e`` and ``stage2`` run ``synth`` first, ``mesh``
``synth`` and ``e2e``) and then prints no
result line: it is for a short first run of a new kernel. Without it every
phase runs. Phases, one line each (any failure raises and the script exits non-zero
without a result line):

1. ``device``: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels are built from ``airslam_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. ``kernel R``: rectification remap on the EuRoC cam0/cam1 grids vs its
   plain PyTorch version (f32, ≤1e-5), kernel / plain / ``F.grid_sample``
   times.
3. ``kernel B`` / ``kernel T``: LOI point sampling at the frontend's shapes,
   f32 and bf16 maps, points on and beyond the borders, vs the plain version
   (f32 ≤1e-5 abs; bf16 ≤1e-5 relative to the map's max). These entry points
   no longer run on the path: ``loi_features`` does their work there.
   ``kernel LOI``: ``loi_features``, the stage-1 head's whole sampling for
   both views in one launch, at the path's shapes (2 views, 512 lines, 300
   junctions, out-of-range pair indices, points on and beyond the borders)
   vs its plain version, every map/output type pair: f32 output ≤1e-5 abs
   (f32 maps) or ≤1e-5 of the map's max (bf16 maps), bf16 output within one
   bf16 ulp, and how many values are not bit-equal (compiled without FMA
   contraction, none should be); two runs bit-equal; a CUDA-graph replay
   gives the eager bits;
   a non-contiguous or wrongly typed operand raises. Then each
   instantiation's registers, the kernel's time, eager time, plain time and
   bound, the time of the six-launch per-view sequence it replaced
   (:func:`loi_unfused`), of ``F.grid_sample`` at the same samples
   (:func:`loi_library`, three calls, timed only) and an empty kernel's (the launch
   floor), and the sweep of lines (warps) per block, 1-8.
4. ``kernel P``: the whole-solver tracking kernel vs its plain version on
   synthetic problems made from a seed: the kernel's full size (512 points,
   128 lines), the path's shape (256 points, one masked line), a fixed pose
   (must come back unchanged) and a lines-only problem. Gates: translation
   ≤2e-3, rotation ≤1e-3 (max abs), inlier agreement ≥0.98, inlier counts
   within 2 %, and ‖t − t_true‖ < 5e-3. Then each block size's registers,
   shared and local bytes, the block-size sweep (64, 128, 256 threads) at
   both shapes, and the times with the chain of dependent reductions the
   kernel runs and µs per link.
5. ``slice``: ``FrontendStep`` in bf16, then f32 with TF32 off, over the 3
   stereo pairs of ``tests/data/torch_frontend_oracle.npz`` (the JAX
   package's f32 CPU outputs), gated with ``scripts/verify_tpu.py``'s
   metrics and thresholds.
6. ``tracking slice``: the port's ``MapBuilder`` with SuperPoint keypoints,
   bf16 and then f32, over the same pairs: pair 0 initialises the map through
   ``add_input``; pairs 1 and 2 run the per-frame tracking path
   (``MapBuilder.track_frame``: rectify → detect → batched stereo+temporal
   match → frame → line matches → PnP → pose-only solve → keyframe check)
   and are gated against ``tests/data/torch_tracking_oracle.npz`` (the JAX
   ``MapBuilder`` on the CPU).
7. ``kernel F``: the fused attention kernel vs its plain version at the
   path's two shapes ((1, 4, 400, 64) and (2, 4, 400, 64), strided views as
   LightGlue hands them over), (4, 1024, 64) unbatched, an odd size, padded
   keys masked, one batch entry with every key masked, bf16, f32 and mixed.
   Gates: f32 ≤1e-5 abs, bf16 ≤2e-2 of the output's max, two runs bit-equal.
   Each instantiation's registers, shared and local bytes; the bf16 route's
   query-tile sweep (16–64 rows per block); times of the kernel, its plain
   version, ``scaled_dot_product_attention`` and ``mha``.
8. ``VO``: ``MapBuilder.add_input`` with ``use_flash=True`` over the 8 stored
   frames of ``tests/data/torch_vo_oracle.npz`` (the JAX ``MapBuilder`` on the
   CPU), bf16 then f32: initialisation, tracking, four keyframe insertions
   with the sliding-window local BA, then ``save_trajectory``, ``save_map``
   and ``load_map``. f32 gates: the oracle's keyframe ids, every pose within
   0.02 m / 5e-3, landmark counts within 5 %; bf16: every pose within 0.05 m.
   The launch counts are set to 0 before the run and read after it: a tracked
   frame must launch R 1, ``loi_features`` 1, P 1, F 36, B and T 0.
8a. ``synth``: the rendered 3D world of ``tests/data/torch_e2e_oracle.npz``
   (the JAX world and the seed of its numpy pixel noise):
   ``apps/make_synth_dataset_torch.py --world`` writes the ASL trees of its
   40-frame loop (stride 2) on the card, rectified and with
   ``--distort_camera configs/camera/synth_stereo_distorted.yaml``; the PNGs
   of frames 0 and 19, both views, within 1 grey level of the JAX render's
   on at most 1e-3 of the pixels, the ground truth equal; ms per rendered
   stereo pair at 752×480.
8b. ``e2e`` (ROADMAP A.1): ``apps/visual_odometry_torch.py`` (called in this
   process, so that its launches are counted) over the first 20 frames of
   each tree: rectified f32 and bf16 with ``--use_flash``, distorted f32,
   against the JAX VO CLI's runs stored in the oracle
   (scripts/verify_tpu_e2e.py's gates): f32 the same keyframe decisions,
   every run's unaligned ATE to the JAX CLI's trajectory ≤ 0.05 m and its
   Sim(3)-aligned ATE to the ground truth ≤ 0.05 m
   (``apps/evaluate_torch.py``'s ``evaluate``), bf16 the keyframe count
   within 1; the mapv0 read back by ``load_map``; the launches of each run
   (counts set to 0 before it): R once a frame in the distorted run (0
   rectified), ``loi_features`` once a frame, P once a tracked frame, F 36 a
   frame with ``--use_flash``.
8c. ``mesh``: the multi-device path (``airslam_tpu_torch/parallel/``).
   ``entry.dryrun_multichip(8, "cuda")``: the sharded sparse and window BA,
   frame-parallel detection (3 frames at 120×188 and 5 at 752×480, padded),
   the F = 15 / P = 256 / L = 32 window with an IMU chain, the mesh-pipelined
   runner and the dp/tp LightGlue step (dim 256, 9 layers), each against its
   single-device run on a mesh of the card repeated 8 times. Then over the
   distorted tree in f32, in turns: the VO CLI with ``--mesh_pipelined`` (the
   default mesh, one card: a chunk of 1), and with cuDNN off
   ``MeshPipelinedRunner`` on a virtual mesh of 4 (a chunk of 2, one image a
   shard) and the sequential loop: the JAX CLI's keyframe decisions,
   unaligned ATE to its trajectory ≤ 0.05 m, every pose within 1e-3 m of
   the sequential run (the CLI's: phase e2e's, cuDNN on), launches per run
   (R and P as sequential, ``loi_features`` once per detection shard), ms a
   frame. One ``plnet`` step data-parallel over a virtual mesh of 2 against
   the single-device step, ``loi_features`` and B+T′ launched once per
   shard: loss and terms 1e-6 relative, gradients 1e-3 per leaf and 1e-4
   over all leaves (relative L2).
8d. ``stage2`` (ROADMAP A.1): stage 2 of scripts/verify_tpu_e2e.py on the
   rendered loop, against the JAX CLIs' runs stored in the e2e oracle (all
   40 frames). (a) ``apps/map_refinement_torch.py`` (in this process) on the
   JAX VO CLI's mapv0 with the point vocabulary the JAX refinement CLI
   trained on it, f32, without and with ``--use_flash``: the JAX CLI's loop
   pairs (Rlq / tlq within 1e-3 / 1e-3 m), its merged counts, trajectory_v1's
   keyframes within 0.02 m / 5e-3 of its, the Sim(3)-aligned ATE to the
   truth ≤ 0.05 m (``REFINE_GATES``); launches P once per pose-only solve,
   F 36 per LightGlue call with ``--use_flash`` (else 0), nothing else;
   stage ms. (b) The port's own chain over the rectified tree:
   ``apps/visual_odometry_torch.py --dtype f32`` over all 40 frames (the
   JAX 40-frame run's keyframes, ATE to it and to the truth ≤ 0.05 m;
   launches R 0, ``loi_features`` 40, P 39, F 0), the refinement CLI with
   ``--use_flash`` on that mapv0 with its own vocabulary (ATE to the truth
   ≤ 0.05 m; loops and merges printed beside the JAX chain's), and
   ``apps/relocalization_torch.py --use_flash`` on its mapv1 with the ten
   hard queries of ``tests/data/torch_reloc_oracle.npz`` (the same world
   and loop: recall ≥ 0.8 and ≥ the JAX chain's − 0.1, accepted-pose ATE ≤
   0.05 m; launches ``loi_features`` once a query, F 36 per LightGlue call,
   P once per pose refinement, R, B and T 0).
8e. ``system``: ``apps/benchmark_system_torch.py --frames 60 --json`` on the
   oracle's world (bf16, 400 keypoints, PLNet without SuperPoint,
   LightGlue): every frame tracked, the aligned ATE ≤ 0.05 m, the unaligned
   ATE to the JAX benchmark loop's trajectory ≤ 0.05 m and its keyframe
   count within 1; launches ``loi_features`` 60, P 59; Hz, ms a frame and the
   per-stage breakdown of ``MapBuilder.stage_timer`` beside the card.
9. ``path``: every launch count set to 0, then rectify (kernel R) →
   ``FrontendStep`` (``loi_features``) on one pair, which must launch R and
   ``loi_features`` once each and B and T never. The same again for the f32
   program. Then the same for one tracked frame, which must launch R,
   ``loi_features`` and P once each. Then the per-frame times over 20
   frames, bf16 and f32.
10. ``VIO``: the stereo-inertial path in f32 against
   ``tests/data/torch_vio_oracle.npz`` (the JAX ``MapBuilder``, f64
   geometry). (a) ``add_input`` with ``use_flash=True`` and each frame's IMU
   batch over the 8 stored frames, on their camera with ``use_imu`` and
   ``configs/camera/synth_stereo_imu.yaml``'s noise: the oracle's keyframe
   ids, every pose within 0.02 m / 5e-3, landmark counts within 5 %, each
   keyframe's preintegration (dT, dR, dV, dP) within 1e-4 relative; a
   tracked frame launches R 1, ``loi_features`` 1, P 1, F 36 (the counts set
   to 0 before the run). (b) ``track_features`` over the stored
   initialization stream (tests/test_vio.py's, 41 frames, 400 keypoints, an
   identity matcher): the same keyframe ids, the IMU initialized at the
   oracle's keyframe, every pose within 0.02 m / 5e-3, landmark counts within
   5 %, the last keyframe's gyro bias within 5e-3 of the truth, keyframe
   speeds < 2 m/s, consecutive keyframe distances within 0.05 m of the
   truth; kernel P launched once per tracked frame before the
   initialization and never after. Prints the ms of a VI tracked frame
   before and after the initialization, of the F=2 solve, of
   ``initialize_imu`` and of a vision and a VI ``local_ba``.
11. ``refine``: stage 2 in float32 against ``tests/data/torch_refine_oracle.npz``
   (the JAX refiner on the CPU). The corridor loop's map (a) is rebuilt by
   the port's ``MapBuilder`` on the CPU in float64 and held to the JAX map's
   digest (keyframe ids, poses and mappoints within 1e-6 m), written as a
   mapv0 and loaded onto the card in float32. (a) ``MapRefiner.run`` with the
   identity matcher: the JAX loop pairs (Rlq / tlq within 1e-3 / 1e-3 m), the
   merged counts, refined keyframes within 0.02 m / 5e-3, ATE within 0.05 m
   of the truth, kernel P launched once per JAX pose-only solve; word ids on
   the card equal the CPU's. (b) the drifted map with the pose graph:
   corrections within 1e-3 of the JAX ones, the ATE falls below a quarter
   and below 0.03 m. The dense against the sparse global BA: at most twice
   the JAX package's own float32 gap + 1e-4 m, keyframes and mappoints.
   ``apps/map_refinement_torch.py --use_flash`` on the mapv0: the JAX CLI's
   loop and merge counts, trajectory_v1 within 0.02 m of its; its launch
   counts (set to 0 before it) are the record's ``launches_refine``. The
   map-scale sparse BA (1,000 keyframes, 100k points, 3 LM iterations, chunk
   4096): cost below 1e-3 of its start, mean pose error below half; the
   scene cut to 100 keyframes / 10k points within 1e-3 m of the JAX x64
   solve; ms per iteration, peak memory and a profiled iteration; the pose
   graph at 1,000 keyframes; kernel P at 64/128/256/512 points with one
   masked line against its plain version.
12. ``reloc``: stage 3 in float32 against ``tests/data/torch_reloc_oracle.npz``
   (the JAX VO, refinement and relocalization CLIs on the CPU over the
   rendered 40-frame loop). ``loi_features`` with one view (the mono query)
   under phase ``l``'s gates and kernel F at (3, 4, 400, 64) and (8, 4, 400,
   64), f32 and bf16, under phase ``f``'s, with their times. Then
   ``apps/relocalization_torch.py --use_flash`` on the stored mapv1 and its
   10 novel-view queries: recall ≥ 0.8 and ≥ the JAX run's − 0.1, the
   accepted poses' aligned ATE ≤ 0.05 m, every query both accept within
   0.02 m / 5e-3 of the JAX pose; the launch counts (set to 0 before the run,
   the record's ``launches_reloc``): R, B and T 0, ``loi_features`` once per
   query, F 36 per LightGlue call and P once per pose refinement; ms per
   query and per stage (detect, match, PnP, refine). SuperGlue (``matcher:
   1``) behind the port's detector on the frontend pairs against the stored
   JAX matches (agreement ≥ 0.9, count delta ≤ 0.1). The device PnP on
   tests/test_pnp.py's three cases under that test's tolerances, and the
   same draws on the card and the CPU in float64 within 1e-6.

13. ``train``: detector training. (a) Kernel B+T′ (``loi_features_backward``,
   the gradient of ``loi_features`` for f32 maps) against autograd through
   the plain forward at the training shape (8 views, 165 candidates, their
   330 endpoints as junctions) and the VO path's (2 views, 512 lines, 300
   junctions, points on and beyond the borders): map gradients within 1e-5
   of the largest |gradient|, the ramps' within 1e-4 of theirs; the
   autograd function behind ``loi_features`` gives the same; two calls give
   the same ``d_loi`` bits; the same gates on 2 views whose endpoints crowd
   one texel row (600 lines) or one texel, or whose lines lie beyond every
   border; bf16 maps raise; the kernel's registers, shared and local bytes;
   its time (the call's one zero fill and the kernel), its kernels and
   memsets per call (a CUDA graph's nodes), the plain version's time,
   ``F.grid_sample``'s backward at the same samples (timed only), the bound
   and the launch floor. (b) One step of each mode
   (``plnet`` with the LOI head and descriptors, ``superpoint``,
   ``distill``) from the shipped checkpoints on the stored pairs of
   ``tests/data/torch_train_oracle.npz`` (the JAX trainer's step on the
   CPU), f32 with TF32 off: the targets' labels and masks equal, each loss
   term within 1e-4 relative, each leaf's gradient within 1e-3 relative L2
   (the stored values and the norm), each leaf's one-step clipped-Adam
   update within 1e-2 relative L2 on the stored entries whose gradient sign
   is determined. (c) ``apps/train_plnet_torch.py`` in each mode, 20 steps
   at batch 8 and 512² from a fresh initialisation (``distill``: the shipped
   ``plnet_s0.npz`` frozen), every count set to 0 before each run: every
   loss finite, the last 5 steps' mean below the first 5's, ``loi_features``
   and kernel B+T′ once per ``plnet`` step (never otherwise), the written
   checkpoint reloads into the port's ``FeatureDetector`` (through
   ``AIRSLAM_CHECKPOINT_DIR``), which detects a stored pair; ms per step and
   images per second.
14. ``matcher``: the matcher trainer (no hand kernel lies on its path). (a)
   One step of each mode (LightGlue and SuperGlue on ``corners`` and on
   ``detected`` tokens) from the shipped checkpoint on the stored JAX batch
   of ``tests/data/torch_matcher_oracle.npz`` (the JAX trainer's step on
   the CPU), f32 with TF32 off, under phase ``train``'s gates: the loss
   within 1e-4 relative, each leaf's gradient within 1e-3 relative L2, the
   Adam update within 1e-2 where |JAX's gradient| exceeds 1e-3 of the
   leaf's rms (below it float32 noise nears Adam's eps and sets the
   update); SuperGlue's attention key biases, whose gradient is zero in
   exact arithmetic, within 1e-5 of their key kernel's gradient norm
   instead; peak memory.
   (b) The port's batch builders on the stored 16-bit images against the
   stored JAX batch: corner tokens and masks equal, descriptors and scores
   within 1e-5; the detected tokens as sets, at least 0.98 of each view's
   agreeing, with their targets and negatives equal. (c) The three pairs of
   ``tests/test_trained_detector.py::test_wide_viewpoint_matching`` (v = 2)
   rendered from the stored JAX draws (numpy's pixel noise, as the oracle
   rendered the JAX pairs), the port's detector and the shipped LightGlue:
   mean count ≥ 60, mean precision > 0.9, each count within 5 % of the JAX
   count. (d) ``apps/train_matcher_torch.py`` in each mode, 20 steps at
   batch 4 and 512² from a fresh initialisation (``--view 2`` for
   ``detected``), every count set to 0 before each run: every loss finite,
   the last 5 steps' mean below the first 5's, no hand kernel launched, the
   written checkpoint loads bit-equal into the port's ``PointMatcher``
   (through ``AIRSLAM_CHECKPOINT_DIR``), which matches a stored frontend
   pair with finite scores; ms per step, pairs per second and peak memory;
   then each mode's step cut into render, batch and matcher, synchronised,
   with each part's peak memory.
15. ``tools``: the last bring-up slice (``tests/data/torch_tools_oracle.npz``).
   (a) The detector with the fast stage-1 head and the stored JAX seeded
   weights, f32 with TF32 off, on the 3 frontend pairs (both views, line
   threshold 0.5): each view at the f32 frontend gates against the stored
   JAX detection; ``detect_junctions=False`` returns zero junction fields;
   no kernel launched (the fast head samples in plain PyTorch). (b)
   ``apps/test_feature_torch.py`` over the 3 left images rectified with
   euroc.yaml, every count set to 0 before: kernel R and ``loi_features``
   once per image, each image at the f32 gates against the stored JAX CLI's
   run, every annotated image written and readable. (c) ``backend/validate``'s
   printers on ``apps/bench_backend.py``'s window on the card, the stored JAX
   dicts' keys and counts, values within 1e-3 relative (after the BA, chi²
   at float32 rounding: below 1e-3). (d) Two 3-frame sequences rendered on
   the card, ``apps/run_batch_torch.py --stage vo`` over one and
   ``apps/run_launch_torch.py`` on a launch file of one VO node over the
   other, at once (subprocesses of the VO CLI; the loop over several
   sequences is the CPU test's): both exit 0 and write trajectories of every
   frame that ``apps/evaluate_torch.py`` reads against the ground truth, ATE
   ≤ 0.05 m. (e)
   ``apps/bench_backend_torch.py`` alone after them: the poses within 1e-4 m
   of the stored JAX float32 ``local_ba``, the same inliers; ms per call.

Before the last line it prints the kernels' JSON record and the card's
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or the JAX package (the oracle is a stored file).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(REPO, "tests", "data", "torch_frontend_oracle.npz")
TRACKING_ORACLE = os.path.join(REPO, "tests", "data", "torch_tracking_oracle.npz")
VO_ORACLE = os.path.join(REPO, "tests", "data", "torch_vo_oracle.npz")
VIO_ORACLE = os.path.join(REPO, "tests", "data", "torch_vio_oracle.npz")
REFINE_ORACLE = os.path.join(REPO, "tests", "data", "torch_refine_oracle.npz")
RELOC_ORACLE = os.path.join(REPO, "tests", "data", "torch_reloc_oracle.npz")
TRAIN_ORACLE = os.path.join(REPO, "tests", "data", "torch_train_oracle.npz")
MATCHER_ORACLE = os.path.join(REPO, "tests", "data", "torch_matcher_oracle.npz")
E2E_ORACLE = os.path.join(REPO, "tests", "data", "torch_e2e_oracle.npz")
TOOLS_ORACLE = os.path.join(REPO, "tests", "data", "torch_tools_oracle.npz")
EUROC = {  # configs/camera/euroc.yaml:14-15,23-24: fx, fy, cx, cy / radtan
    "cam0": ([458.654, 457.296, 367.215, 248.375],
             [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    "cam1": ([457.587, 456.134, 379.999, 255.238],
             [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
}
HEIGHT, WIDTH = 480, 752
# H100 SXM data sheet (dense): HBM rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12  # tensor cores, dense
BF16_GATES = {"kp_agree_1px": 0.90, "kp_top100_overlap": 0.85,
              "line_agree_3px": 0.80, "junc_agree_2px": 0.80, "match_agree": 0.90}
F32_GATES = {"kp_agree_1px": 0.98, "kp_top100_overlap": 0.95,
             "line_agree_3px": 0.90, "junc_agree_2px": 0.90, "match_agree": 0.95}
# the detector alone (no matches): fast head, test_feature CLI
DETECT_GATES = {k: F32_GATES[k] for k in ("kp_agree_1px", "kp_top100_overlap",
                                          "line_agree_3px", "junc_agree_2px")}
TOOLS_FIELDS = ("keypoints", "kp_mask", "lines", "line_mask", "junctions", "junc_mask")
# kernel P against its plain version (both f32 on the card): the accept test
# is a strict `<` on f32 sums taken in different orders, so the two are held
# to the solver's accuracy, not to bits
POSE_GATES = {"t": 2e-3, "R": 1e-3, "inlier_agree": 0.98, "count_rel": 0.02, "t_true": 5e-3}
# the tracked frame against the JAX MapBuilder's (f64 solve of f32 features)
TRACK_GATES = {"f32": {"t": 2e-3, "R": 1e-3, "inliers_rel": 0.05},
               "bf16": {"t": 2e-2, "R": 5e-3, "inliers_min": 0.8}}
# kernel F against its plain version on the card
FLASH_GATES = {"f32": 1e-5, "bf16_rel": 2e-2}
# the VO run against the JAX MapBuilder's (f32 features, f64 geometry)
VO_GATES = {"f32": {"t": 0.02, "R": 5e-3, "count_rel": 0.05}, "bf16": {"t": 0.05}}
# launches of one tracked frame (no keyframe) of the VO path with use_flash;
# a stereo-inertial frame before the IMU is initialized launches the same
FRAME_LAUNCHES = {"remap": 1, "bilerp_points": 0, "bilerp_points_t": 0, "loi_features": 1,
                  "pose_only_fast": 1, "flash_mha": 36, "loi_features_backward": 0}
# the stereo-inertial runs against the JAX MapBuilder's (f64): the VO gates on
# poses and landmark counts, test_full_vio_pipeline's asserts on the
# initialized state, and the keyframes' preintegration deltas
# stage 2 against the JAX refiner: the digest of the f64 rebuilt map (m), loop
# transforms (rotation entries, m), refined poses (PARITY_TPU.json local_ba_*
# gates), refined ATE (E2E_TPU.json stage2_refine), pose-graph corrections (m),
# the dense/sparse gap (≤ factor · the JAX f32 gap + add, m), the map-scale
# solve (cost ratio, pose-error ratio) and the reduced scene against the JAX
# x64 solve (m), the CLI's trajectory against the JAX CLI's (m)
REFINE_GATES = {"digest": 1e-6, "loop_R": 1e-3, "loop_t": 1e-3, "pose_t": 0.02, "pose_R": 5e-3,
                "ate": 0.05, "correction": 1e-3, "gap_factor": 2.0, "gap_add": 1e-4,
                "scale_cost": 1e-3, "scale_err": 0.5, "reduced": 1e-3, "cli_t": 0.02}
MAP_SCALE = (1000, 100_000)  # keyframes, points: tests/test_global_ba.py's map-scale scene
REDUCED_SCENE = (100, 10_000)
REFINE_P_SHAPES = ((64, 60), (128, 100), (256, 200), (512, 400))  # padded, matched points
VIO_GATES = {"bg": 5e-3, "speed": 2.0, "rel_t": 0.05, "preint_rel": 1e-4}
# stage 3 against the JAX relocalizer: recall (E2E_TPU.json's gate, and at
# most 0.1 below the JAX run's), the accepted poses' aligned ATE (m), the
# poses both accept (PARITY_TPU.json local_ba_* gates: m, max abs of R),
# SuperGlue's agreement and count delta (PARITY_TPU.json superglue_*)
RELOC_GATES = {"recall": 0.8, "recall_drop": 0.1, "ate": 0.05, "pose_t": 0.02, "pose_R": 5e-3,
               "sg_agree": 0.9, "sg_count": 0.1}
RELOC_F_BATCHES = (3, 8)  # LightGlue's top-3 batch and matcher recovery's (up to 8)
# f32 operations one row costs, counted from csrc/pose_gn.cu: residuals +
# six Jacobian columns + the 27 accumulators per LM iteration, and one robust
# cost evaluation (the trial cost, a round's first cost, the relabel)
POSE_FLOPS = {"point_iter": 400, "point_cost": 45, "line_iter": 1100, "line_cost": 110}
POSE_THREADS = (64, 128, 256)  # kernel P's block sizes (csrc/pose_gn.cu instantiations)
FLASH_Q_WARPS = (1, 2, 3, 4)   # kernel F's bf16 query tiles of 16 rows per block
LOI_WARPS = (1, 2, 4, 8)       # loi_features' lines (one warp each) per block
# detector training: kernel B+T' against its plain version (map gradients
# within 1e-5 of the largest |gradient|, the ramps' within 1e-4 of theirs:
# atomics sum in another order); one step of each mode against the stored
# JAX step (each loss term relative, each leaf's gradient relative L2 on the
# stored values and in norm, each leaf's clipped-Adam update relative L2 on
# the stored values where JAX's gradient is nonzero; where it is exactly zero
# the port's stays within dead_grad of the leaf's rms, float32 noise of
# cuDNN's algorithms and not a gradient, and Adam's first step moves no entry
# by more than lr); the CLI's runs (steps, batch at full width)
TRAIN_GATES = {"map_grad": 1e-5, "ramp_grad": 1e-4, "term": 1e-4, "grad": 1e-3, "update": 1e-2,
               "dead_grad": 1e-5, "offsets": 1e-6}
TRAIN_CLI = {"steps": 20, "batch": 8}
# the rendered sequences (scripts/make_torch_oracle.py's E2E: make_synth_dataset
# --frames 40 --stride 2 --traj loop, the VO CLI over the first 20) and the
# system benchmark's 60 frames of forward; the card's render against the JAX
# PNGs (grey levels, share of pixels that differ); the CLI and benchmark runs
# against the JAX runs and the ground truth (scripts/verify_tpu_e2e.py:206-216:
# unaligned and Sim(3)-aligned ATE in m, keyframe count delta)
E2E_RUN = {"frames": 40, "stride": 2, "traj": "loop", "run": 20, "system": 60}
E2E_GATES = {"png_levels": 1, "png_share": 1e-3, "traj": 0.05, "ate": 0.05, "kf_delta": 1}
E2E_CAMERAS = {"rect": "configs/camera/synth_stereo.yaml",
               "dist": "configs/camera/synth_stereo_distorted.yaml"}
E2E_RUNS = {"f32": ("rect", ["--dtype", "f32"]), "bf16": ("rect", ["--dtype", "bf16", "--use_flash"]),
            "dist f32": ("dist", ["--dtype", "f32"])}
# stage 2 on the same loop (scripts/make_torch_oracle.py's e2e_stages): the
# refinement CLI on the stored JAX mapv0 of all 40 frames with the stored
# point vocabulary, without and with the fused attention, held to the JAX
# refinement CLI's run by REFINE_GATES (loop pairs, merges, refined
# keyframes, ATE to the truth); then the port's own chain of the three CLIs
# over the rectified tree, each stage held to the truth (E2E_GATES,
# REFINE_GATES' ATE, RELOC_GATES) with the JAX chain's counts beside it
STAGE2_REFINE_RUNS = {"stage2 refine": [], "stage2 refine flash": ["--use_flash"]}
# the multi-device path (phase mesh): entry.dryrun_multichip's mesh size
# (production shapes), the virtual mesh MeshPipelinedRunner runs on besides the
# CLI's default mesh (one card: a chunk of 1), the dp plnet step's mesh and
# batch (uneven: shards of 4 and 3, so a reduction that weights each shard
# by its own size is wrong, as it is not at 4 and 4). cuDNN picks its
# convolution algorithms by shape, so a shard of one image (or part of a
# training batch) rounds PLNet's line head otherwise than the batch it came
# from (up to 9e-5 in line_pred at batch 1 against 2 on an H100, 0 with cuDNN
# off), and an f32 VO run turns that into millimetres by frame 20.
# So the virtual mesh runs twice: with cuDNN on, as users run it, held to the
# JAX CLI's run (keyframes, ATE) with its gap to phase e2e's sequential run
# printed; and with cuDNN off against the sequential loop with cuDNN off
# (every pose within seq m), which checks the sharding itself. The CLI's run
# on its default mesh (the pair detected as one batch, as the sequential
# loop does) runs with cuDNN on and is held to phase e2e's sequential run.
# The dp steps (cuDNN deterministic, as phase train's steps) against the
# one-device steps: at the first step the loss and terms within loss
# relative, the gradients within grad_leaf relative L2 per leaf and grad_all
# over every leaf together; at the second the loss and terms within step2
# (its gradients are printed: two one-device runs already part there by up
# to 2e-2, B+T′'s atomic sums flipping the sign of Adam's first update where
# a gradient is near 0). Card readings of the sound steps, of two
# one-device runs and of planted faults: scripts/dp_step_faults.py, PERF.md
MESH_RUN = {"dryrun": 8, "virtual": 4, "dp": 2, "batch": 7}
MESH_GATES = {"seq": 1e-3, "loss": 1e-6, "grad_leaf": 1e-4, "grad_all": 1e-4, "step2": 1e-5}
TRAIN_MODES = {"plnet": [], "superpoint": ["--model", "superpoint"],
               "distill": ["--model", "superpoint", "--distill"]}
# the matcher trainer (scripts/make_torch_oracle.py's matcher oracle): the
# stored batch tensors by the names of the JAX batch tuples' entries
# (LightGlue's and SuperGlue's tuples share all but the keypoints' scale);
# the CLI's lr; the batch builders on the stored images (descriptors and
# heatmap scores absolute; corner tokens and masks exact; the detected tokens
# as sets: the share of each view's tokens both packages detect, with their
# targets and negatives equal); the stored step's Adam update on the entries
# whose |JAX gradient| exceeds update_floor of the leaf's rms (below it the
# gradient's float32 noise, up to 1e-4 of the rms, nears Adam's eps of 1e-8
# and sets the update), SuperGlue's attention key biases, whose gradient
# vanishes in exact arithmetic (softmax is shift-invariant along the keys),
# held to null_grad of their layer's key kernel gradient instead of the leaf
# gates; the wide-viewpoint pairs
# (tests/test_trained_detector.py::test_wide_viewpoint_matching's gates, each
# pair's count relative to the JAX count); the CLI's runs (batch 4 at 512²,
# the detected runs at --view 2)
MATCHER_FIELDS = {
    "corners": {"lightglue": ("k0", "d0", "m0", "k1", "d1", "m1", "both", "only0", "only1"),
                "superglue": ("k0", "s0", "d0", "m0", "k1", "s1", "d1", "m1", "both", "only0",
                              "only1")},
    "detected": {"lightglue": ("k0", "d0", "m0", "k1", "d1", "m1", "tgt", "neg0", "neg1"),
                 "superglue": ("k0", "s0", "d0", "m0", "k1", "s1", "d1", "m1", "tgt", "neg0",
                               "neg1")}}
MATCHER_MODES = ("lightglue_corners", "superglue_corners", "lightglue_detected",
                 "superglue_detected")
MATCHER_LR = 2e-4
MATCHER_GATES = {"desc": 1e-5, "score": 1e-5, "token_share": 0.98, "wide_count": 60,
                 "wide_precision": 0.9, "wide_count_rel": 0.05, "update_floor": 1e-3,
                 "null_grad": 1e-5}
MATCHER_CLI = {"steps": 20, "batch": 4, "view": 2}
# phase tools: the fast head's detector configuration (the seeded head's
# scores sit just above 0.5: test_feature's line threshold keeps lines);
# bench_backend's window (frames, points, seed); the CLI chains' sequences
# (3 frames of ``forward``: the e2e oracle's world and the port's own of
# seed 1 with texture, one for each CLI chain; the loop's period is the
# sequence's length) and bench_backend's timed calls
TOOLS_FAST = {"max_keypoints": 400, "line_threshold": 0.5}
TOOLS_BENCH = (5, 230, 0)
TOOLS_RUN = {"frames": 3, "calls": 3, "warmup": 0}  # the accuracy call warms each up
TOOLS_SEQUENCES = {"SYNTH_01": ["--world", E2E_ORACLE],
                   "SYNTH_02": ["--seed", "1", "--texture", "0.1"]}
TOOLS_GATES = {"bench_t": 1e-4, "validate_rel": 1e-3, "after_chi2": 1e-3}
TOOLS_LAUNCH = """<launch>
  <arg name="config_path" default="$(find air_slam)/configs/visual_odometry/vo_euroc.yaml"/>
  <arg name="camera_config_path" default="$(find air_slam)/configs/camera/euroc.yaml"/>
  <arg name="dataroot"/>
  <arg name="saving_dir"/>
  <node name="visual_odometry" pkg="air_slam" type="visual_odometry" output="screen">
    <param name="config_path" value="$(arg config_path)"/>
    <param name="camera_config_path" value="$(arg camera_config_path)"/>
    <param name="dataroot" value="$(arg dataroot)"/>
    <param name="saving_dir" value="$(arg saving_dir)"/>
  </node>
</launch>
"""


# ---------------------------------------------------------------------------
# frontend agreement metrics (copied from scripts/verify_tpu.py:55-130)
# ---------------------------------------------------------------------------


def _pts_agree(a, b, tol):
    """Fraction of rows of ``a`` with a row of ``b`` within ``tol`` (L2)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return float((d.min(axis=1) <= tol).mean())


def _lines_agree(a, b, tol):
    """Fraction of segments in ``a`` matched by one in ``b`` with both
    endpoints within ``tol`` (either endpoint order)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    e1 = np.maximum(np.linalg.norm(a[:, None, 0:2] - b[None, :, 0:2], axis=-1),
                    np.linalg.norm(a[:, None, 2:4] - b[None, :, 2:4], axis=-1))
    e2 = np.maximum(np.linalg.norm(a[:, None, 0:2] - b[None, :, 2:4], axis=-1),
                    np.linalg.norm(a[:, None, 2:4] - b[None, :, 0:2], axis=-1))
    d = np.minimum(e1, e2)
    return float((d.min(axis=1) <= tol).mean())


def _match_pairs(out):
    """(kp0_xy, kp1_xy) coordinate pairs of accepted matches."""
    kp0, kp1, idx1 = out["o0"], out["o1"], out["o2"].astype(np.int64)
    ok = idx1 >= 0
    return np.concatenate([kp0[ok], kp1[np.clip(idx1[ok], 0, len(kp1) - 1)]],
                          axis=-1)  # (M, 4)


def detection_metrics(ref, got):
    """Agreement of two detections, dicts of ``TOOLS_FIELDS`` (one image's,
    or the junctions of several pooled): the frontend metrics without the
    matches."""
    m = {}
    kp_c = ref["keypoints"][ref["kp_mask"] > 0]
    kp_t = got["keypoints"][got["kp_mask"] > 0]
    m["kp_agree_1px"] = _pts_agree(kp_c, kp_t, 1.0)
    k = min(100, len(kp_c), len(kp_t))
    m["kp_top100_overlap"] = _pts_agree(ref["keypoints"][:k], got["keypoints"][:k], 1.0)
    m["line_agree_3px"] = _lines_agree(ref["lines"][ref["line_mask"] > 0],
                                       got["lines"][got["line_mask"] > 0], 3.0)
    m["junc_agree_2px"] = _pts_agree(ref["junctions"][ref["junc_mask"] > 0],
                                     got["junctions"][got["junc_mask"] > 0], 2.0)
    return m


def frontend_metrics(ref, got):
    """Agreement of two entry()-layout output dicts (``o0``..``o10``)."""
    def fields(out):
        return dict(zip(TOOLS_FIELDS, (out[k] for k in ("o0", "o7", "o4", "o5", "o8", "o10"))))

    m = detection_metrics(fields(ref), fields(got))
    mc = _match_pairs(ref)
    mt = _match_pairs(got)
    if len(mc) and len(mt):
        d0 = np.linalg.norm(mc[:, None, 0:2] - mt[None, :, 0:2], axis=-1)
        d1 = np.linalg.norm(mc[:, None, 2:4] - mt[None, :, 2:4], axis=-1)
        m["match_agree"] = float((np.maximum(d0, d1).min(axis=1) <= 1.5).mean())
    else:
        m["match_agree"] = 1.0 if len(mc) == len(mt) else 0.0
    return m


def tools_detection(z, prefix):
    """One stored JAX detection of the tools oracle (``prefix`` such as
    ``fast0_1_`` or ``feature2_``)."""
    return {f: z[prefix + f] for f in TOOLS_FIELDS}


def tools_loi_params(z):
    """The JAX fast ``LoiHead``'s seeded parameters stored in the tools
    oracle, as the nested tree ``loi_fast_from_flax`` reads."""
    tree = {}
    for k in z.files:
        if k.startswith("loi/"):
            *path, leaf = k.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


def oracle_pairs():
    """The fixture's stereo pairs (float32 in [0, 1]) and the JAX outputs."""
    z = np.load(ORACLE)
    frames = z["frames_u8"].astype(np.float32) / np.float32(255.0)
    refs = [{k[len(f"p{i}_"):]: z[k] for k in z.files if k.startswith(f"p{i}_")}
            for i in range(frames.shape[0])]
    return frames, refs


def superglue_agreement(z, detector, matcher):
    """The port's detector and ``matcher`` (SuperGlue) on the frontend
    oracle's 3 pairs against the stored JAX matches of the relocalization
    oracle, as ``scripts/verify_tpu.py:299-320`` compares them: per pair the
    share of JAX matches that a port match reproduces with both ends within
    1.5 px; and the summed match counts (port, JAX)."""
    frames, _ = oracle_pairs()
    agree, n_port, n_jax = [], 0, 0
    for i in range(frames.shape[0]):
        f = detector.detect(frames[i])
        views = [type(f)(*(t[v] for t in f)) for v in (0, 1)]
        pairs, _ = matcher.matching_points(views[0], views[1])
        kp0, kp1 = (v.keypoints.float().cpu().numpy() for v in views)
        mt = np.concatenate([kp0[pairs[:, 0]], kp1[pairs[:, 1]]], -1)
        mc = z[f"sg{i}_pairs"]
        n_port, n_jax = n_port + len(mt), n_jax + len(mc)
        if len(mc) and len(mt):
            d0 = np.linalg.norm(mc[:, None, 0:2] - mt[None, :, 0:2], axis=-1)
            d1 = np.linalg.norm(mc[:, None, 2:4] - mt[None, :, 2:4], axis=-1)
            agree.append(float((np.maximum(d0, d1).min(axis=1) <= 1.5).mean()))
        else:
            agree.append(1.0 if len(mc) == len(mt) else 0.0)
    return agree, n_port, n_jax


def reloc_oracle():
    """The stored JAX stage-3 run (``tests/data/torch_reloc_oracle.npz``)."""
    return np.load(RELOC_ORACLE)


def write_reloc_tree(z, root, queries=None):
    """The stored refined map, its vocabularies and the query images as the
    JAX CLIs left them: ``root/map/{AirSLAM_mapv1.bin, point_voc.npz,
    junction_voc.npz}``, ``root/queries/<stamp>.png`` (the queries of the
    indices ``queries``, all by default) and ``root/gt_tum.txt``. Returns
    (map root, query folder, query names)."""
    import lzma

    map_root, qdir = os.path.join(root, "map"), os.path.join(root, "queries")
    os.makedirs(map_root, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)
    files = {"AirSLAM_mapv1.bin": lzma.decompress(z["mapv1_xz"].tobytes()),
             "point_voc.npz": z["point_voc"].tobytes(),
             "junction_voc.npz": z["junction_voc"].tobytes()}
    for name, data in files.items():
        with open(os.path.join(map_root, name), "wb") as f:
            f.write(data)
    with open(os.path.join(root, "gt_tum.txt"), "wb") as f:
        f.write(z["gt_tum"].tobytes())
    names = [str(n) for n in z["query_names"]]
    for i in (range(len(names)) if queries is None else queries):
        with open(os.path.join(qdir, names[i]), "wb") as f:
            f.write(z[f"q{i}_png"].tobytes())
    return map_root, qdir, names


def reloc_ate(trajectory, gt):
    """Sim(3)-aligned ATE (evo_ape -as, the port's ``io.trajectory.ate_rmse``)
    of [(t, Twc)] against the ground truth [(t, Twc)], each pose paired with
    the ground-truth stamp within 0.02 s (scripts/verify_tpu_e2e.py's
    ``_ate_vs_rows``). Returns (ATE m, pairs)."""
    from airslam_tpu_torch.io.trajectory import ate_rmse

    stamps = np.asarray([t for t, _ in gt])
    est, ref = [], []
    for t, T in trajectory:
        j = int(np.argmin(np.abs(stamps - t)))
        if abs(stamps[j] - t) < 0.02:
            est.append((t, T))
            ref.append(gt[j])
    if len(est) < 3:
        return float("inf"), len(est)
    return ate_rmse(est, ref, align=True), len(est)


def euroc_grids():
    """EuRoC cam0/cam1 undistortion grids (R = I, P = K), (2, H, W, 2)."""
    from airslam_tpu_torch.core.camera import undistort_rectify_map

    out = []
    for cam in ("cam0", "cam1"):
        (fx, fy, cx, cy), dist = EUROC[cam]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        out.append(undistort_rectify_map(K, dist, np.eye(3), K, (WIDTH, HEIGHT)))
    return np.stack(out)


def camera_node(cam, imu=None):
    """The ``Camera(node=...)`` dictionary of a rectified pinhole stereo rig
    whose body frame is the left camera. ``cam``: fx, fy, cx, cy, baseline,
    depth_lower_thr, depth_upper_thr, max_y_diff, image_height, image_width.
    ``imu``: the IMU block of a stereo-inertial rig (rate_hz, the four noise
    densities, g_value), which sets ``use_imu``."""
    intr = [float(cam[k]) for k in ("fx", "fy", "cx", "cy")]
    right = np.eye(4)
    right[0, 3] = float(cam["baseline"])

    def view(T):
        return {"intrinsics": intr, "distortion_coeffs": [0.0] * 5, "T_type": 0,
                "T": [float(v) for v in T.ravel()]}

    node = {"image_height": int(cam["image_height"]), "image_width": int(cam["image_width"]),
            "depth_lower_thr": float(cam["depth_lower_thr"]),
            "depth_upper_thr": float(cam["depth_upper_thr"]),
            "max_y_diff": float(cam["max_y_diff"]), "distortion_type": 0, "use_imu": 0,
            "cam0": view(np.eye(4)), "cam1": view(right)}
    if imu is not None:
        node.update({k: float(v) for k, v in imu.items()}, use_imu=1)
    return node


def tracking_oracle():
    """(camera values, init record, {pair index: record}) of the stored JAX
    tracking run."""
    z = np.load(TRACKING_ORACLE)
    cam = {k[len("camera_"):]: float(z[k]) for k in z.files if k.startswith("camera_")}
    init = {k[len("init_"):]: z[k] for k in z.files if k.startswith("init_")}
    pairs = {}
    for k in z.files:
        if k[0] == "p" and k[1].isdigit():
            i, name = k[1:].split("_", 1)
            pairs.setdefault(int(i), {})[name] = z[k]
    return cam, init, pairs


def tracking_builder(cam, dtype, device, identity_rectify=False, use_flash=False, imu=None):
    """The port's visual-odometry ``MapBuilder`` (SuperPoint keypoints, PLNet
    lines, LightGlue, the shipped checkpoints, networks in ``dtype``) on the
    camera the stored pairs were rendered with (stereo-inertial with the IMU
    block ``imu``, see :func:`camera_node`). ``identity_rectify``: give
    the (already rectified) camera identity remap grids, so that a frame goes
    through the rectification kernel as a distorted rig's would, with its
    pixels unchanged."""
    from airslam_tpu_torch.core.camera import Camera
    from airslam_tpu_torch.entry import vo_map_builder

    camera = Camera(node=camera_node(cam, imu))
    if identity_rectify:
        v, u = np.mgrid[0:camera.image_height, 0:camera.image_width].astype(np.float32)
        camera.map_left = camera.map_right = np.stack([u, v], axis=-1)
    return vo_map_builder(camera, dtype=dtype, device=device, use_flash=use_flash)


def vo_oracle():
    """The stored JAX VO run: (camera values, frames (N, 2, H, W) float32 in
    [0, 1], record of arrays)."""
    z = np.load(VO_ORACLE)
    cam = {k[len("camera_"):]: float(z[k]) for k in z.files if k.startswith("camera_")}
    rec = {k: z[k] for k in z.files if not k.startswith("camera_") and k != "frames_u8"}
    return cam, z["frames_u8"].astype(np.float32) / np.float32(255.0), rec


def vio_oracle():
    """The stored stereo-inertial JAX runs: (camera values, IMU block, record
    of arrays); the record's ``a_`` keys are the image path over the VO
    oracle's frames, its ``b_`` keys the initialization stream."""
    z = np.load(VIO_ORACLE)
    cam = {k[len("camera_"):]: float(z[k]) for k in z.files if k.startswith("camera_")}
    imu = {k[len("imu_"):]: float(z[k]) for k in z.files if k.startswith("imu_")
           and k[len("imu_"):] in ("rate_hz", "gyroscope_noise_density", "gyroscope_random_walk",
                                   "accelerometer_noise_density", "accelerometer_random_walk",
                                   "g_value")}
    return cam, imu, {k: z[k] for k in z.files}


def imu_batch(t, gyr, acc, lo, hi):
    """Rows ``lo:hi`` as the port's ``ImuData`` list (one frame's batch)."""
    from airslam_tpu_torch.core.imu import ImuData

    return [ImuData(float(t[k]), gyr[k], acc[k]) for k in range(int(lo), int(hi))]


class StreamCamera:
    """tests/test_vo_pipeline.py's FakeCamera, with the stream's IMU noise
    when ``noise`` is given: a rectified 752×480 pinhole rig (fx = fy = 450,
    baseline 0.1 m), the body frame the left camera."""

    def __init__(self, noise=None):
        self.fx = self.fy = 450.0
        self.cx, self.cy, self.bf = 376.0, 240.0, 45.0
        self.image_width, self.image_height = 752, 480
        self.depth_lower_thr, self.depth_upper_thr = 0.1, 20.0
        self.max_x_diff = self.bf / self.depth_lower_thr
        self.min_x_diff = self.bf / self.depth_upper_thr
        self.max_y_diff = 1.0
        self.Tbc = self.Tcb = np.eye(4)
        self.use_imu, self.g_value = noise is not None, 9.81
        if noise is not None:
            self.gyr_noise, self.acc_noise, self.gyr_walk, self.acc_walk = (
                float(v) for v in noise)

    def intrinsics(self):
        from airslam_tpu_torch.core.camera import Intrinsics

        return Intrinsics(self.fx, self.fy, self.cx, self.cy, self.bf,
                          self.image_width, self.image_height)

    def rectify_maps(self, device=None):
        return None, None


class IdMatcher:
    """Matches by descriptor identity (the stream's descriptors are unit
    vectors, one per world point): tests/test_vo_pipeline.py's FakeMatcher,
    answering in tensors as the port's matcher does."""

    def match(self, k0, s0, d0, m0, k1, s1, d1, m1, threshold=None):
        import torch

        from airslam_tpu_torch.ops.match import Matches

        sim = np.asarray(d0) @ np.asarray(d1).T
        idx = sim.argmax(axis=1).astype(np.int32)
        ok = (sim.max(axis=1) > 0.99) & np.asarray(m0)
        ok &= np.asarray(m1)[idx]
        return Matches(idx1=torch.as_tensor(np.where(ok, idx, -1)),
                       score=torch.as_tensor(np.where(ok, 1.0, 0.0)), mask=torch.as_tensor(ok))

    def matching_points(self, f0, f1, outlier_rejection=False, threshold=None):
        """(M, 2) index pairs and (M,) scores, as ``PointMatcher.matching_points``."""
        m = self.match(f0.keypoints, None, f0.kp_desc, f0.kp_mask,
                       f1.keypoints, None, f1.kp_desc, f1.kp_mask)
        i0 = np.nonzero(m.mask.numpy())[0]
        return (np.stack([i0, m.idx1.numpy()[i0]], -1).astype(np.int32),
                m.score.numpy()[i0])


CORRIDOR_MAX_DEPTH = 6.0  # finite visibility: a revisit shares no covisibility
K_BUDGET, L_BUDGET = 128, 16  # the stream's keypoint and line slots per frame


def corridor_world(n_pts=1500, seed=10):
    """tests/test_refinement.py's corridor: points along +z and one unit
    descriptor per point."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(1.0, 14.0, n_pts)], axis=-1)
    desc = rng.randn(n_pts, 256).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return pts, desc


def loop_trajectory(n=30, step=0.4):
    """Out along +z and back to the start (tests/test_refinement.py)."""
    out = []
    for i in range(n):
        T = np.eye(4)
        k = i if i < n // 2 else (n - 1 - i)
        T[:3, 3] = [0.01 * k, 0.0, step * k]
        out.append(T)
    return out


def render_features(pts, desc, Twc, cam, max_depth=None):
    """tests/test_vo_pipeline.py's renderer on the port's ``FrameFeatures``:
    the visible points projected into the stereo pair (at most ``K_BUDGET``,
    subsampled in a fixed order), no lines or junctions. Returns (left,
    right, stereo pairs)."""
    from airslam_tpu_torch.frontend.detector import FrameFeatures

    Rwc, twc = Twc[:3, :3], Twc[:3, 3]
    pc = (pts - twc) @ Rwc
    z = pc[:, 2]
    u = pc[:, 0] / z * cam.fx + cam.cx
    v = pc[:, 1] / z * cam.fy + cam.cy
    ur = u - cam.bf / z
    vis = (z > 0.5) & (u >= 5) & (u < 747) & (v >= 5) & (v < 475) & (ur >= 0)
    if max_depth is not None:
        vis &= z < max_depth
    vis_idx = np.nonzero(vis)[0]
    if len(vis_idx) > K_BUDGET:
        vis_idx = vis_idx[:: len(vis_idx) // K_BUDGET + 1][:K_BUDGET]
    k = len(vis_idx)

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[:k] = a
        return out

    left = FrameFeatures(
        keypoints=pad(np.stack([u[vis_idx], v[vis_idx]], -1), (K_BUDGET, 2)),
        kp_scores=pad(np.ones(k), (K_BUDGET,)), kp_desc=pad(desc[vis_idx], (K_BUDGET, 256)),
        kp_mask=np.arange(K_BUDGET) < k,
        lines=np.zeros((L_BUDGET, 4), np.float32), line_scores=np.zeros(L_BUDGET, np.float32),
        line_mask=np.zeros(L_BUDGET, bool), junctions=np.zeros((8, 2), np.float32),
        junc_scores=np.zeros(8, np.float32), junc_desc=np.zeros((8, 256), np.float32),
        junc_mask=np.zeros(8, bool))
    right = left._replace(keypoints=pad(np.stack([ur[vis_idx], v[vis_idx]], -1), (K_BUDGET, 2)))
    return left, right, np.stack([np.arange(k), np.arange(k)], -1).astype(np.int32)


def drift_T(s, max_drift=0.22, max_yaw_deg=2.0):
    """tests/test_pose_graph_refinement.py's drift: s in [0, 1] → a
    translation ramp along +x/+z and a small yaw, ~``max_drift`` m at s = 1."""
    T = np.eye(4)
    a = np.deg2rad(max_yaw_deg) * s
    T[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    T[:3, 3] = [0.7 * max_drift * s, 0.15 * max_drift * s, 0.7 * max_drift * s]
    return T


def corridor_map(device="cpu", dtype=None, drifted=False):
    """The corridor loop's map (a), or with ``drifted`` the drifted map (b),
    built by the port's ``MapBuilder`` over the rendered feature stream
    (tests/test_refinement.py's and tests/test_pose_graph_refinement.py's
    fixtures: keyframe config min_init_stereo_feature 50, max_num_match 200,
    tracking_point_rate 0.95). Map (b) then takes the drift through
    ``apply_pose_corrections``. Returns (map, clean keyframe poses)."""
    import torch

    from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder

    cam = StreamCamera()
    builder = MapBuilder(cam, detector=None, matcher=IdMatcher(), device=device,
                         dtype=dtype or torch.float64,
                         kf_config=KeyframeConfig(min_init_stereo_feature=50, max_num_match=200,
                                                  tracking_point_rate=0.95))
    pts, desc = corridor_world()
    for i, T in enumerate(loop_trajectory()):
        builder.track_features(i * 0.1, *render_features(pts, desc, T, cam,
                                                         max_depth=CORRIDOR_MAX_DEPTH))
    m = builder.map
    clean = {fid: m.keyframes[fid].Twc.copy() for fid in m.keyframe_ids}
    if drifted:
        ids = m.keyframe_ids
        m.apply_pose_corrections({fid: drift_T(k / (len(ids) - 1)) @ m.keyframes[fid].Twc
                                  for k, fid in enumerate(ids)})
    return m, clean


def stream_frame(rec, n):
    """Frame ``n`` of the stored stream: (left, right FrameFeatures of numpy
    arrays, stereo pairs), rebuilt from its keypoints and world-point ids as
    tests/test_vo_pipeline.py's renderer made them."""
    from airslam_tpu_torch.frontend.detector import FrameFeatures

    kp, ids = rec["b_kp"][n], rec["b_ids"][n].astype(np.int64)
    mask = ids >= 0
    k, n_lines, n_junc = int(mask.sum()), int(rec["b_n_lines"]), int(rec["b_n_junctions"])
    desc = np.zeros((len(ids), 256), np.float32)
    desc[:k] = rec["b_desc"][ids[:k]]
    left = FrameFeatures(
        keypoints=kp, kp_scores=mask.astype(np.float32), kp_desc=desc, kp_mask=mask,
        lines=np.zeros((n_lines, 4), np.float32), line_scores=np.zeros(n_lines, np.float32),
        line_mask=np.zeros(n_lines, bool), junctions=np.zeros((n_junc, 2), np.float32),
        junc_scores=np.zeros(n_junc, np.float32), junc_desc=np.zeros((n_junc, 256), np.float32),
        junc_mask=np.zeros(n_junc, bool))
    right = left._replace(keypoints=np.stack([rec["b_ur"][n], kp[:, 1]], -1))
    return left, right, np.stack([np.arange(k), np.arange(k)], -1).astype(np.int32)


def map_scale_scene(n_frames, n_points, seed=2, obs_per=6, max_obs=8):
    """tests/test_global_ba.py::test_map_scale_1000kf_100kpts's scene at any
    size (numpy): a circle of ``n_frames`` keyframes of radius 30 m with
    identity rotations, ``n_points`` points each seen by ``obs_per``
    consecutive keyframes, exact stereo observations, poses perturbed by 2 cm
    and points by 5 cm, the first keyframe fixed, the observation table
    ``max_obs`` wide. The intrinsics are the stream camera's."""
    cam = StreamCamera()
    F, P = n_frames, n_points
    rng = np.random.RandomState(seed)
    th = np.linspace(0, 2 * np.pi, F, endpoint=False)
    twb = np.stack([30 * np.cos(th), 30 * np.sin(th), np.zeros(F)], -1)
    pts = twb[rng.randint(0, F, P)] + np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-3, 3, P), rng.uniform(4, 9, P)], -1)
    anchor = rng.randint(0, F - obs_per, P)
    pidx = np.repeat(np.arange(P, dtype=np.int64), obs_per)
    fidx = (anchor[:, None] + np.arange(obs_per)[None, :]).astype(np.int64).ravel()
    rel = pts[pidx] - twb[fidx]  # identity rotations: camera frame = world
    z = rel[:, 2]
    u = cam.fx * rel[:, 0] / z + cam.cx
    v = cam.fy * rel[:, 1] / z + cam.cy
    ok = (z > 0.5) & (u > -200) & (u < 1000) & (v > -200) & (v < 700)
    n = len(pidx)
    table = np.full((P, max_obs), n, np.int64)  # global_ba.build_obs_table, vectorized
    slot = np.zeros(P, np.int64)
    for oi in np.nonzero(ok)[0]:
        if slot[pidx[oi]] < max_obs:
            table[pidx[oi], slot[pidx[oi]]] = oi
            slot[pidx[oi]] += 1
    twb0 = twb + rng.randn(F, 3) * 0.02
    twb0[0] = twb[0]
    pts0 = pts + rng.randn(P, 3) * 0.05
    pose_fixed = np.zeros(F, bool)
    pose_fixed[0] = True
    return dict(Rwb=np.tile(np.eye(3), (F, 1, 1)), twb=twb, twb0=twb0, pts=pts, pts0=pts0,
                pidx=pidx, fidx=fidx, pobs=np.stack([u, v, u - cam.bf / z], -1), ok=ok,
                table=table, pose_fixed=pose_fixed)


def map_scale_problem(scene, dtype, device):
    """The port's ``SparseBAProblem`` of a :func:`map_scale_scene` (no lines:
    one masked dummy line)."""
    import torch

    from airslam_tpu_torch.backend import global_ba as gba

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return gba.SparseBAProblem(
        Rwb=f(scene["Rwb"]), twb=f(scene["twb0"]), pose_fixed=b(scene["pose_fixed"]),
        points=f(scene["pts0"]), pobs_pidx=i(scene["pidx"]), pobs_fidx=i(scene["fidx"]),
        pobs=f(scene["pobs"]), pobs_mask=b(scene["ok"]), point_obs_table=i(scene["table"]),
        lines=f([[1.0, 0, 0, 0, 1, 0]]), lobs_lidx=i([0]), lobs_fidx=i([0]),
        lobs=f(np.zeros((1, 8))), lobs_stereo=b([False]), lobs_mask=b([False]),
        lobs_sigma=f([0.001]), line_obs_table=i([[1]]), Rcb=f(np.eye(3)), tcb=f(np.zeros(3)))


def _rodrigues(v):
    theta = float(np.linalg.norm(v))
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)
    if theta < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(theta) / theta * K
            + (1.0 - np.cos(theta)) / theta ** 2 * (K @ K))


def tracking_problem(seed, n_points, n_lines, n_masked_points=0, mask_lines=False,
                     outliers=True, device="cpu", dtype=None):
    """A synthetic F=1 pose-only problem from a seed (numpy): ``n_points``
    world points seen from a known pose (every second one stereo, a fifth
    with 40 px outliers), then ``n_masked_points`` zero rows masked out as the
    builder pads them, and ``n_lines`` Plücker lines with their endpoint
    observations (every third one mono, two outliers). The initial pose is
    the identity. Returns (problem, intrinsics, true twb)."""
    import torch

    from airslam_tpu_torch.backend import gn
    from airslam_tpu_torch.core.camera import Intrinsics

    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)
    fx, fy, cx, cy, bf = 450.0, 450.0, 376.0, 240.0, 45.0
    K, M = n_points, n_lines
    pts = rng.randn(K, 3) * 2 + [0, 0, 8]
    xi = np.array([0.02, -0.03, 0.01, 0.05, -0.04, 0.06])
    Rwb_t, twb_t = _rodrigues(xi[:3]), xi[3:]
    Rcw, tcw = Rwb_t.T, -Rwb_t.T @ twb_t

    def project(p):
        pc = p @ Rcw.T + tcw
        u = pc[:, 0] / pc[:, 2] * fx + cx
        v = pc[:, 1] / pc[:, 2] * fy + cy
        return u, v, u - bf / pc[:, 2]

    u, v, ur = project(pts)
    obs = np.stack([u, v, np.where(np.arange(K) % 2 == 0, ur, -1.0)], -1)
    if outliers and K >= 5:
        out_idx = rng.choice(K, K // 5, replace=False)
        obs[out_idx, :2] += rng.randn(len(out_idx), 2) * 40
    pad = n_masked_points
    pts = np.concatenate([pts, np.zeros((pad, 3))])
    obs = np.concatenate([obs, np.tile([0.0, 0.0, -1.0], (pad, 1))])
    pmask = np.concatenate([np.ones(K, bool), np.zeros(pad, bool)])

    q = rng.randn(M, 3) * 1.5 + [0, 0, 8]
    d = rng.randn(M, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lines = np.concatenate([np.cross(q, d), d], axis=1)
    obs8 = np.zeros((M, 8))
    for i in range(M):
        uu, vv, uur = project(np.stack([q[i] - 1.2 * d[i], q[i] + 1.2 * d[i]]))
        obs8[i] = [uu[0], vv[0], uu[1], vv[1], uur[0], vv[0], uur[1], vv[1]]
    if outliers and M >= 2:
        obs8[rng.choice(M, 2, replace=False), :2] += 30.0
    l_stereo = np.arange(M) % 3 != 0
    lmask = np.zeros(M, bool) if mask_lines else np.ones(M, bool)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    frames = gn.FrameStates(Rwb=f(np.eye(3)[None]), twb=f(np.zeros((1, 3))),
                            vel=f(np.zeros((1, 3))), bg=f(np.zeros((1, 3))),
                            ba=f(np.zeros((1, 3))))
    problem = gn.BAProblem(
        frames=frames, pose_fixed=b([False]), vel_fixed=b([True]),
        points=f(pts), point_fixed=b(np.ones(K + pad)), point_obs=f(obs[:, None, :]),
        point_obs_mask=b(pmask[:, None]),
        lines=f(lines), line_fixed=b(np.ones(M)), line_obs=f(obs8[:, None, :]),
        line_obs_stereo=b(l_stereo[:, None]), line_obs_mask=b(lmask[:, None]),
        line_obs_sigma=f(np.full((M, 1), 0.8)),
        Rwg=f(np.eye(3)), gravity_free=f(0.0), imu=None, Rcb=f(np.eye(3)), tcb=f(np.zeros(3)))
    return problem, Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf), twb_t


def refine_pose_problem(seed, padded, matched, device="cpu", dtype=None):
    """A pose-only problem at the shape ``MapRefiner._pose_only`` gives
    kernel P: ``matched`` points padded to ``padded`` (a power of two, at
    least 64) with masked zero rows, and one masked line."""
    return tracking_problem(seed, matched, 1, n_masked_points=padded - matched,
                            mask_lines=True, device=device, dtype=dtype)


def pose_agreement(got, want):
    """How far two results of the pose-only solve (problem', point inliers,
    line inliers, count) are apart: max abs of t and R, the share of equal
    inlier flags, the relative gap of the counts."""
    t = float((got[0].frames.twb - want[0].frames.twb).abs().max())
    R = float((got[0].frames.Rwb - want[0].frames.Rwb).abs().max())
    flags_g = np.concatenate([got[1].cpu().numpy().ravel(), got[2].cpu().numpy().ravel()])
    flags_w = np.concatenate([want[1].cpu().numpy().ravel(), want[2].cpu().numpy().ravel()])
    n_g, n_w = int(got[3]), int(want[3])
    return {"t": t, "R": R, "inlier_agree": float((flags_g == flags_w).mean()),
            "count_rel": abs(n_g - n_w) / max(n_w, 1), "num_inliers": n_g}


# ---------------------------------------------------------------------------
# chip phases
# ---------------------------------------------------------------------------


def card():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def _no_tf32(label):
    """TF32 off while the f32 program runs; restored after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if label == "f32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _time_ms(fn, iters=100, reps=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times between CUDA events, so the host's
    launch overhead stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _eager_ms(fn, iters=200, warmup=20):
    """Time per call of ``fn`` issued eagerly back to back (CUDA events):
    the wrapper's host cost shows here when it exceeds the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_r(dev, grids_np):
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.ops.gridsample import remap as remap_plain
    from airslam_tpu_torch.ops.remap import remap

    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.rand(2, HEIGHT, WIDTH).astype(np.float32), device=dev)
    grids = torch.as_tensor(grids_np, device=dev)
    got = remap(images, grids)

    def plain():
        return torch.stack([remap_plain(images[i], grids[i]) for i in range(2)])

    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    _require(err <= 1e-5, f"kernel R disagrees with its plain version: {err}")
    # nearest library call: grid_sample over normalized coordinates; it clamps
    # the COORDINATE at the border (padding_mode="border") where remap clamps
    # the integer taps with unclipped weights, so the two differ off-image
    scale = torch.tensor([2.0 / (WIDTH - 1), 2.0 / (HEIGHT - 1)], device=dev)
    norm_grid = grids * scale - 1.0
    img4 = images[:, None]

    def library():
        return F.grid_sample(img4, norm_grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    ms = _time_ms(lambda: remap(images, grids))
    eager = _eager_ms(lambda: remap(images, grids))
    plain_ms = _time_ms(plain)
    lib_ms = _time_ms(library)
    n = 2 * HEIGHT * WIDTH
    taps = sum(_distinct_taps(grids[i, ..., 0], grids[i, ..., 1], HEIGHT, WIDTH)
               for i in range(2))  # texels the grids read, not the whole images
    bound, by = _bound_ms(taps * 4 + n * 8 + n * 4, n * 13)
    print(f"kernel R: max_abs_err={err:.3e} (<=1e-5) ms={ms:.5f} eager_ms={eager:.5f} "
          f"plain_ms={plain_ms:.5f} texels_read={taps}/{n} "
          f"grid_sample_ms={lib_ms:.5f} bound_ms={bound:.6f} ({by})")
    return {"name": "remap", "route": "cuda", "source": "airslam_tpu_torch/csrc/remap.cu",
            "replaces": "airslam_tpu/ops/remap_tiled.py:140", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def _border_points(rng, shape, lo, hi, size):
    """Uniform points plus exact border and beyond-border values."""
    n = int(np.prod(shape))
    v = rng.uniform(lo, hi, n).astype(np.float32)
    edge = np.asarray([-1.5, -0.5, 0.0, size - 1.0, size - 0.5, size + 1.0], np.float32)
    m = min(len(edge), n // 2)
    v[:m] = edge[:m]
    v[m:2 * m] = edge[::-1][:m]
    return v.reshape(shape)


def _distinct_taps(x, y, h, w):
    """Distinct texels the 4-tap samples of these points touch."""
    import torch

    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    taps = torch.cat([(yy * w + xx).reshape(-1) for yy in (y0, y1) for xx in (x0, x1)])
    return int(torch.unique(taps.long()).numel())


def phase_kernel_bt(dev, which):
    """Kernel B (LOI map, 300 junction points) or T (thin/aux map, 512×30
    interior points) at the frontend's shapes."""
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.ops import bilerp

    rng = np.random.RandomState(1 if which == "B" else 2)
    c, pts = (128, (300,)) if which == "B" else (4, (512, 30))
    fn = bilerp.bilerp_points if which == "B" else bilerp.bilerp_points_t
    x = torch.as_tensor(_border_points(rng, pts, -1.5, 129.5, 128), device=dev)
    y = torch.as_tensor(_border_points(rng, pts, -1.5, 129.5, 128)[::-1].copy(), device=dev)

    def plain(fmap):
        out = bilerp.bilerp_plain(fmap, x, y)
        return out if which == "B" else torch.movedim(out, -1, 0)

    errs = {}
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):
        fmap = torch.as_tensor(rng.randn(128, 128, c).astype(np.float32), device=dev).to(dtype)
        got, want = fn(fmap, x, y), plain(fmap)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * (1.0 if dtype == torch.float32 else float(fmap.float().abs().max()))
        _require(err <= tol, f"kernel {which} ({dtype}) disagrees with plain: {err} > {tol}")
        errs[dtype], maps[dtype] = err, fmap
    fmap = maps[torch.bfloat16]  # the production program's dtype
    # nearest library call: grid_sample, align_corners=True, zero padding
    # (its border weights differ from the stage-1 arithmetic)
    img4 = fmap.permute(2, 0, 1)[None].contiguous()
    g = (torch.stack([x, y], dim=-1).reshape(1, 1, -1, 2) * (2.0 / 127) - 1.0).to(fmap.dtype)

    def library():
        return F.grid_sample(img4, g, mode="bilinear", align_corners=True)

    ms = _time_ms(lambda: fn(fmap, x, y))
    eager = _eager_ms(lambda: fn(fmap, x, y))
    plain_ms = _time_ms(lambda: plain(fmap))
    lib_ms = _time_ms(library)
    n = x.numel()
    n_bytes = _distinct_taps(x, y, 128, 128) * c * 2 + n * 8 + n * c * 4
    bound, by = _bound_ms(n_bytes, n * c * 8 + n * 20)
    print(f"kernel {which}: points={tuple(pts)} C={c} max_abs_err f32={errs[torch.float32]:.3e} "
          f"bf16={errs[torch.bfloat16]:.3e} ms={ms:.5f} eager_ms={eager:.5f} plain_ms={plain_ms:.5f} "
          f"grid_sample_ms={lib_ms:.5f} bound_ms={bound:.6f} ({by})")
    name = "bilerp_points" if which == "B" else "bilerp_points_t"
    line = 45 if which == "B" else 124
    return {"name": name, "route": "cuda", "source": "airslam_tpu_torch/csrc/bilerp.cu",
            "replaces": f"airslam_tpu/ops/bilerp_pallas.py:{line}",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def loi_unfused(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                out_dtype=None):
    """The stage-1 head's sampling as it ran before ``loi_features``, view
    by view: kernel B at the junctions, the clamp and row gathers, the
    interior ramps and kernel T on each 4-channel map, the permutes, both
    concatenations and casts (``feats`` and ``res_in``) — for two views six
    kernel launches and the glue around them. Kept to be timed beside the
    fused kernel and held against it. Operands as ``loi_features``; returns
    [(feats (L, 256 + 8·T), res_in (L, 8·T))] per view."""
    import torch

    from airslam_tpu_torch.ops.bilerp import bilerp_points, bilerp_points_t

    out_dtype = out_dtype or loi.dtype
    n_lines = lines.shape[1]

    def interior(fmap, seg):
        x = seg[:, 0:1] * t_fwd[None, :] + seg[:, 2:3] * t_rev[None, :] - 0.5
        y = seg[:, 1:2] * t_fwd[None, :] + seg[:, 3:4] * t_rev[None, :] - 0.5
        out = bilerp_points_t(fmap, x.contiguous(), y.contiguous())  # (C, L, T)
        return out.permute(1, 0, 2).reshape(n_lines, -1)

    views = []
    for v in range(loi.shape[0]):
        f_junc = bilerp_points(loi[v], junc_xy[v, :, 0] - 0.5, junc_xy[v, :, 1] - 0.5)
        idx = pair_idx[v].clamp(0, junc_xy.shape[1] - 1)
        f_thin = interior(loi_thin[v], lines[v])
        f_aux = interior(loi_aux[v], prop_lines[v])
        feats = torch.cat([f_junc[idx[:, 0]], f_junc[idx[:, 1]], f_thin, f_aux], dim=-1)
        views.append((feats.to(out_dtype), torch.cat([f_thin, f_aux], dim=-1).to(out_dtype)))
    return views


def loi_library(ops):
    """``F.grid_sample``'s operands for the stage-1 head's sampling of every
    view (timed only; other border rule: zeros beyond the map, where the
    kernel clamps its taps), the same samples ``loi_features`` takes: the
    128-channel LOI map at the junctions, the 4 thin channels at the lines'
    interior points and the 4 aux channels at the proposals'. Returns three
    (input NCHW, grid (V, 1, P, 2)) pairs in the maps' type."""
    import torch

    loi, thin, aux, junc, _, lines, props, t_fwd, t_rev = ops
    h, w = loi.shape[1:3]

    def pair(fmap, x, y):
        # a texel coordinate X − 0.5 of the kernel is 2X / size − 1 with align_corners=False
        grid = torch.stack([2 * x / w - 1, 2 * y / h - 1], -1)[:, None]
        inp = fmap.permute(0, 3, 1, 2).contiguous()
        return inp, grid.to(inp.dtype).contiguous()

    def interior(seg, i):
        return (seg[..., i:i + 1] * t_fwd + seg[..., i + 2:i + 3] * t_rev).flatten(1)

    return [pair(loi, junc[..., 0], junc[..., 1]),
            pair(thin, interior(lines, 0), interior(lines, 1)),
            pair(aux, interior(props, 0), interior(props, 1))]


def loi_library_ms(ops):
    """Device ms of :func:`loi_library`'s three ``F.grid_sample`` calls."""
    import torch.nn.functional as F

    calls = loi_library(ops)
    return _time_ms(lambda: [F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=False) for inp, grid in calls])


def loi_backward_library_ms(ops):
    """Device ms of ``F.grid_sample``'s backward (ATen's
    ``grid_sampler_2d_backward``: the input's and the grid's gradients) at
    :func:`loi_library`'s samples, three calls, for one gradient of each
    output."""
    import torch

    calls = [(torch.randn(inp.shape[0], inp.shape[1], 1, grid.shape[2], device=inp.device,
                          dtype=inp.dtype), inp, grid) for inp, grid in loi_library(ops)]
    return _time_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
        gout, inp, grid, 0, 0, False, [True, True]) for gout, inp, grid in calls])


def loi_inputs(rng, n_views, n_lines, n_junc, dtype, device="cpu", n_interior=30):
    """The stage-1 head's operands from a seed: LOI, thin and aux maps
    (V, 128, 128, C) in ``dtype``; junctions on and beyond the borders;
    pair indices with out-of-range ones (clamped by the head); lines at the
    clamped junctions and proposals around them, both crossing the borders;
    the head's interior ramps. Returns the ``loi_features`` operands in
    order."""
    import torch

    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt or torch.float32)

    maps = [t(rng.randn(n_views, 128, 128, c).astype(np.float32), dtype) for c in (128, 4, 4)]
    junc = _border_points(rng, (n_views, n_junc, 2), -1.5, 129.5, 128)
    pairs = rng.randint(0, n_junc, (n_views, n_lines, 2)).astype(np.int64)
    odd = np.asarray([[n_junc - 1, 0], [n_junc, -1], [-5, n_junc + 7]], np.int64)
    pairs[:, :len(odd)] = odd[:n_lines]
    ends = np.take_along_axis(junc, np.clip(pairs, 0, n_junc - 1).reshape(n_views, -1, 1),
                              axis=1).reshape(n_views, n_lines, 4)
    props = ends + rng.randn(n_views, n_lines, 4).astype(np.float32) * 3
    n = n_interior
    ramps = (np.arange(1, n + 1, dtype=np.float32) / (n + 1),
             np.arange(n, 0, -1, dtype=np.float32) / (n + 1))
    return (*maps, t(junc), t(pairs, torch.int64), t(ends), t(props.astype(np.float32)),
            t(ramps[0]), t(ramps[1]))


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (the bf16
    values between them, plus one), elementwise."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def loi_gate(got, want, fmap):
    """(error, limit, passed) of ``loi_features`` against its plain version:
    a bf16 output in bf16 ulps (≤ 1), an f32 output in max abs, ≤ 1e-5 for
    f32 maps and ≤ 1e-5 of the map's max for bf16 ones."""
    import torch

    if got.dtype == torch.bfloat16:
        err = int(bf16_ulps(got, want).max()) if got.numel() else 0
        return err, 1, err <= 1
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 1e-5 * (1.0 if fmap.dtype == torch.float32 else float(fmap.float().abs().max()))
    return err, tol, err <= tol


def _loi_work(ops, out):
    """(bytes, f32 operations) of one ``loi_features`` call: every small
    operand read once, the texels of the three maps these points touch (per
    view), the output written once; 9 operations per sample and channel
    (csrc/bilerp.cu combine) and about 20 per point for its taps."""
    loi, thin, aux, junc, pairs, lines, props, t_fwd, t_rev = ops
    size = loi.element_size()
    n_views, n_lines = lines.shape[:2]
    nt = t_fwd.shape[0]
    n_bytes = sum(t.numel() * t.element_size() for t in ops[3:]) + out.numel() * out.element_size()
    for v in range(n_views):
        idx = pairs[v].clamp(0, junc.shape[1] - 1).unique()
        jx, jy = junc[v, idx, 0] - 0.5, junc[v, idx, 1] - 0.5
        n_bytes += _distinct_taps(jx, jy, 128, 128) * 128 * size
        for seg, fmap in ((lines[v], thin), (props[v], aux)):
            x = seg[:, 0:1] * t_fwd[None] + seg[:, 2:3] * t_rev[None] - 0.5
            y = seg[:, 1:2] * t_fwd[None] + seg[:, 3:4] * t_rev[None] - 0.5
            n_bytes += _distinct_taps(x, y, 128, 128) * 4 * size
    n_samples_c = n_views * n_lines * (2 * 128 + 2 * 4 * nt)
    n_points = n_views * n_lines * (2 + 2 * nt)
    return n_bytes, n_samples_c * 9 + n_points * 20


def phase_kernel_loi(dev):
    """``loi_features`` against its plain version at the path's shapes, then
    its times beside the sequence it replaced and the launch floor."""
    import ctypes

    import torch

    from airslam_tpu_torch.ops import bilerp, cuda_build

    f32, bf = torch.float32, torch.bfloat16
    rng = np.random.RandomState(3)
    worst, notes, ops_by = {}, [], {}
    for map_dtype in (f32, bf):
        ops = loi_inputs(rng, 2, 512, 300, map_dtype, dev)
        ops_by[map_dtype] = ops
        for out_dtype in (f32, bf):
            got = bilerp.loi_features(*ops, out_dtype=out_dtype)
            again = bilerp.loi_features(*ops, out_dtype=out_dtype)
            want = bilerp.loi_features_plain(*ops, out_dtype=out_dtype)
            torch.cuda.synchronize()
            label = f"maps {str(map_dtype)[6:]} -> {str(out_dtype)[6:]}"
            _require(got.shape == want.shape == (2, 512, 496) and got.dtype == out_dtype,
                     f"kernel LOI ({label}): output {tuple(got.shape)} {got.dtype}")
            _require(torch.equal(got, again), f"kernel LOI ({label}): two runs differ")
            err, tol, ok = loi_gate(got, want, ops[0])
            _require(ok, f"kernel LOI ({label}) disagrees with its plain version: {err} > {tol}")
            worst[(map_dtype, out_dtype)] = err
            differ = int((got != want).sum())
            notes.append((f"{label}: {err:.3e}" if out_dtype == f32 else f"{label}: {err} ulp")
                         + f", {differ} of {got.numel()} values not bit-equal")
    ops = ops_by[bf]  # the production program's types
    eager = bilerp.loi_features(*ops).clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = bilerp.loi_features(*ops)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    _require(torch.equal(captured, eager), "kernel LOI: a CUDA-graph replay differs from eager")
    def spoiled(i, t):
        return ops[:i] + (t,) + ops[i + 1:]

    bad = {"non-contiguous lines": spoiled(5, ops[5].transpose(0, 1).contiguous().transpose(0, 1)),
           "int32 pair_idx": spoiled(4, ops[4].int()),
           "f32 thin map beside bf16 ones": spoiled(1, ops[1].float())}
    for what, args in bad.items():
        try:
            bilerp.loi_features(*args)
        except ValueError:
            continue
        raise RuntimeError(f"kernel LOI took {what}")
    print("kernel LOI: " + "; ".join(notes) + " (gates f32 out <=1e-5 abs, or <=1e-5 of the "
          "map's max for bf16 maps; bf16 out <=1 ulp; two runs bit-equal; graph replay = eager; "
          "bad operands raise)")
    for map_dtype in (f32, bf):
        for out_dtype in (f32, bf):
            a = bilerp.kernel_attributes(map_dtype, out_dtype)
            print(f"kernel LOI instantiation maps={str(map_dtype)[6:]} out={str(out_dtype)[6:]}: "
                  f"registers={a['registers']} static_smem={a['static_smem']} "
                  f"local_bytes={a['local_bytes']} threads={a['threads']}")

    lib = cuda_build.library("bilerp")
    lib.airslam_empty_launch.argtypes = [ctypes.c_void_p]
    lib.airslam_empty_launch.restype = ctypes.c_int

    def empty():
        _require(lib.airslam_empty_launch(torch.cuda.current_stream().cuda_stream) == 0,
                 "the empty kernel did not launch")

    times = {}
    for label, dtype in (("bf16", bf), ("f32", f32)):
        o = ops_by[dtype]
        times[label] = dict(
            ms=_time_ms(lambda: bilerp.loi_features(*o)),
            eager_ms=_eager_ms(lambda: bilerp.loi_features(*o)),
            plain_ms=_time_ms(lambda: bilerp.loi_features_plain(*o)),
            unfused_ms=_time_ms(lambda: loi_unfused(*o)),
            unfused_eager_ms=_eager_ms(lambda: loi_unfused(*o)),
            library_ms=loi_library_ms(o))
        times[label]["bound_ms"], times[label]["bound_by"] = _bound_ms(
            *_loi_work(o, bilerp.loi_features(*o)))
    floor_ms, floor_eager_ms = _time_ms(empty), _eager_ms(empty)
    for label, t in times.items():
        print(f"kernel LOI {label} (2 views, 512 lines, 300 junctions): ms={t['ms']:.5f} "
              f"eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
              f"bound_ms={t['bound_ms']:.6f} ({t['bound_by']}) the per-view sequence it "
              f"replaced (6 kernels + glue): ms={t['unfused_ms']:.5f} "
              f"eager_ms={t['unfused_eager_ms']:.5f}; F.grid_sample at the same samples (LOI "
              f"at the junctions, thin and aux at the interior points, 3 calls): "
              f"ms={t['library_ms']:.5f}")
    print(f"empty kernel (launch floor): ms={floor_ms:.5f} eager_ms={floor_eager_ms:.5f}")
    o = ops_by[bf]
    sweep = {w: [] for w in LOI_WARPS}
    for w in LOI_WARPS + LOI_WARPS[::-1]:  # in turns, so that a drift spreads over all
        sweep[w].append(_time_ms(lambda: bilerp._launch_loi(*o, out_dtype=bf, warps=w)))
    print("kernel LOI bf16 lines-per-block sweep ms: "
          + " ".join(f"{w} ({-(-1024 // w)} blocks): {min(t):.5f}" for w, t in sweep.items()))
    t = times["bf16"]
    return {"name": "loi_features", "route": "cuda", "source": "airslam_tpu_torch/csrc/bilerp.cu",
            "replaces": "airslam_tpu/ops/bilerp_pallas.py:45,124",
            "max_abs_err": max(worst[(f32, f32)], worst[(bf, f32)]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def train_loi_inputs(rng, n_views, device, n_lines=None):
    """``loi_features``' operands at the training shape: the LOI head's
    endpoint path over ``n_lines`` candidates (55 segments + 110 decoys),
    junctions = the 2·L endpoints, pairs (i, L + i); lines on and beyond the
    borders, proposals jittered ±2 cells; f32 maps (V, 128, 128, C)."""
    import torch

    n = n_lines or 165

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    maps = [t(rng.randn(n_views, 128, 128, c).astype(np.float32)) for c in (128, 4, 4)]
    lines = _border_points(rng, (n_views, n, 4), -1.5, 129.5, 128)
    props = (lines + rng.uniform(-2, 2, lines.shape)).astype(np.float32)
    junc = np.concatenate([lines[..., 0:2], lines[..., 2:4]], axis=1)
    ar = np.arange(n)
    pairs = np.broadcast_to(np.stack([ar, ar + n], -1), (n_views, n, 2)).astype(np.int64)
    ramps = (np.arange(1, 31, dtype=np.float32) / 31, np.arange(30, 0, -1, dtype=np.float32) / 31)
    return (*maps, t(junc), t(pairs, torch.int64), t(lines), t(props), t(ramps[0]), t(ramps[1]))


LOI_BACKWARD_CASES = {"one_row": 600, "one_texel": 165, "beyond_borders": 165}
LOI_BACKWARD_TILES = (32, 64, 128, 256)  # kernel B+T′'s texels per block, swept


def crowded_loi_inputs(rng, n_views, device, case):
    """:func:`train_loi_inputs` bent to stress kernel B+T′'s tile owners:
    ``one_row`` every endpoint junction at y − 0.5 = 40.25 (all 1,200 taps
    of 600 lines on rows 40 and 41: more than one pass of the owners' list),
    ``one_texel`` every one at (50, 30) + 0.5 (weight 1 on texel (30, 50)),
    ``beyond_borders`` lines and proposals (and so junctions and interior
    points) at coordinates beyond every border, where the far border's taps
    merge and the near border's weights extrapolate."""
    import torch

    n = LOI_BACKWARD_CASES[case]
    ops = list(train_loi_inputs(rng, n_views, device, n_lines=n))
    junc = ops[3].clone()
    if case == "one_row":
        junc[..., 1] = 40.75
    elif case == "one_texel":
        junc[..., 0], junc[..., 1] = 50.5, 30.5
    else:
        beyond = np.asarray([-7.5, -2.25, -1.0, -0.5, 127.0, 128.5, 129.0, 131.75, 140.0],
                            np.float32)
        lines = beyond[rng.randint(0, len(beyond), (n_views, n, 4))]
        props = lines + rng.uniform(-2, 2, lines.shape).astype(np.float32)
        ops[5], ops[6] = (torch.as_tensor(a, device=device) for a in (lines, props))
        junc = torch.cat([ops[5][..., 0:2], ops[5][..., 2:4]], dim=1).contiguous()
    ops[3] = junc
    return tuple(ops)


def _device_ops(fn):
    """(kernels, memsets) one call of ``fn`` puts on the card: the nodes of
    a CUDA graph that captures the call, by type (``libcuda``'s
    ``cuGraphNodeGetType``)."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    fn()  # allocations and builds off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _require(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _require(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int()
        _require(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                 "cuGraphNodeGetType")
        kinds.append(kind.value)
    return kinds.count(0), kinds.count(2)  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMSET


def _loi_backward_work(ops):
    """(bytes, f32 operations) of one ``loi_features_backward`` call: the
    row gradient and every small operand read once, the texels of the thin
    and aux maps its points touch (the coordinate derivative), the three
    zeroed map gradients and two ramp gradients written once; about 40
    operations per sample and channel (the scatter's and the derivative's
    products) and 20 per point for its taps."""
    loi, thin, aux, junc, pairs, lines, props, t_fwd, t_rev = ops
    n_views, n_lines = lines.shape[:2]
    nt = t_fwd.shape[0]
    row = 2 * 128 + 2 * 4 * nt
    n_bytes = n_views * n_lines * row * 4 + sum(t.numel() * t.element_size() for t in ops[3:])
    n_bytes += sum(t.numel() * 4 for t in (loi, thin, aux)) + 2 * nt * 4
    for v in range(n_views):
        for seg in (lines[v], props[v]):
            x = seg[:, 0:1] * t_fwd[None] + seg[:, 2:3] * t_rev[None] - 0.5
            y = seg[:, 1:2] * t_fwd[None] + seg[:, 3:4] * t_rev[None] - 0.5
            n_bytes += _distinct_taps(x, y, 128, 128) * 4 * 4
    return n_bytes, n_views * n_lines * (row * 40 + (2 + 2 * nt) * 20)


def phase_kernel_loi_backward(dev):
    """Kernel B+T′ against autograd through the plain forward, at the
    training shape (8 views, 165 candidates, the endpoint path) and the VO
    path's (2 views, 512 lines, 300 junctions), and on the crowded inputs
    of :func:`crowded_loi_inputs`; ``d_loi`` bit-equal over two calls; the
    autograd function behind ``loi_features`` (the training path's launch)
    gives the plain forward's rows under phase l's gate and the kernel's
    gradients; the kernel's attributes; times beside the plain version, the
    bound and the launch floor, and the call's zero fills and kernels."""
    import ctypes

    import torch

    from airslam_tpu_torch.ops import bilerp, cuda_build

    g = TRAIN_GATES
    rng = np.random.RandomState(5)
    shapes = {"train (8 views, 165 lines, 330 endpoint junctions)": train_loi_inputs(rng, 8, dev),
              "VO (2 views, 512 lines, 300 junctions)": loi_inputs(rng, 2, 512, 300,
                                                                   torch.float32, dev)}
    notes, worst, grads = [], 0.0, {}
    for label, ops in shapes.items():
        v, n = ops[5].shape[:2]
        grad = torch.as_tensor(rng.randn(v, n, 496).astype(np.float32), device=dev)
        grads[label] = grad
        before = bilerp.loi_features_backward.launches
        got = bilerp.loi_features_backward(grad, *ops)
        want = bilerp.loi_features_backward_plain(grad, *ops)
        torch.cuda.synchronize()
        _require(bilerp.loi_features_backward.launches == before + 1,
                 f"kernel B+T' ({label}) did not count its launch")
        errs = []
        for name, a, b, tol in zip(("d_loi", "d_thin", "d_aux", "d_t_fwd", "d_t_rev"), got, want,
                                   (g["map_grad"],) * 3 + (g["ramp_grad"],) * 2):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            _require(a.shape == b.shape and err <= tol * scale,
                     f"kernel B+T' ({label}) {name} disagrees with autograd through the plain "
                     f"version: {err:.3e} > {tol} x {scale:.3e}")
            errs.append(f"{name} {err:.2e} ({err / max(scale, 1e-30):.1e} of max)")
            if name.startswith("d_t"):
                continue
            worst = max(worst, err)
        # through autograd: the function behind loi_features
        leaves = [t.detach().clone().requires_grad_(True) for t in (ops[0], ops[1], ops[2], ops[7],
                                                                    ops[8])]
        out = bilerp.loi_features(leaves[0], leaves[1], leaves[2], *ops[3:7], leaves[3], leaves[4])
        err, tol, ok = loi_gate(out.detach(),
                                bilerp.loi_features_plain(*ops, out_dtype=torch.float32), ops[0])
        _require(ok, f"kernel loi_features ({label}, f32, through the autograd function) "
                     f"disagrees with its plain version: {err} > {tol}")
        errs.append(f"forward {err:.2e}")
        out.backward(grad)
        for name, leaf, want_g, tol in zip(("d_loi", "d_thin", "d_aux", "d_t_fwd", "d_t_rev"),
                                           leaves, want, (g["map_grad"],) * 3
                                           + (g["ramp_grad"],) * 2):
            _require(float((leaf.grad - want_g).abs().max())
                     <= tol * float(want_g.abs().max()),
                     f"kernel B+T' ({label}): autograd through loi_features gave another {name}")
        notes.append(f"{label}: " + ", ".join(errs))
        # d_loi is written once per texel in a fixed order: the same bits again
        _require(torch.equal(bilerp.loi_features_backward(grad, *ops)[0], got[0]),
                 f"kernel B+T' ({label}): two calls gave other d_loi bits")
    for case in LOI_BACKWARD_CASES:
        ops = crowded_loi_inputs(rng, 2, dev, case)
        grad = torch.as_tensor(rng.randn(2, ops[5].shape[1], 496).astype(np.float32),
                               device=dev)
        got = bilerp.loi_features_backward(grad, *ops)
        want = bilerp.loi_features_backward_plain(grad, *ops)
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(got, want)]
        _require(all(e <= tol for e, tol in zip(errs, (g["map_grad"],) * 3
                                                + (g["ramp_grad"],) * 2))
                 and torch.equal(bilerp.loi_features_backward(grad, *ops)[0], got[0]),
                 f"kernel B+T' ({case}): {errs} of the largest |gradient|, or other bits again")
        notes.append(f"{case} (2 views, {ops[5].shape[1]} lines): worst "
                     f"{max(errs[:3]):.1e} / ramps {max(errs[3:]):.1e} of the largest")
    label, ops = next(iter(shapes.items()))
    try:
        bilerp.loi_features_backward(grads[label], *(t.to(torch.bfloat16) for t in ops[:3]),
                                     *ops[3:])
    except ValueError:
        pass
    else:
        raise RuntimeError("kernel B+T' took bf16 maps")
    print("kernel B+T' (loi_features_backward): " + "; ".join(notes)
          + f" (gates: maps <= {g['map_grad']} of the largest |gradient|, ramps <= "
          f"{g['ramp_grad']} of theirs; the autograd function's forward against "
          f"loi_features_plain <= 1e-5, its gradients the same; d_loi bit-equal over two "
          f"calls; bf16 maps raise)")
    a = bilerp.backward_kernel_attributes()
    print(f"kernel B+T' attributes: registers={a['registers']} static_smem={a['static_smem']} "
          f"local_bytes={a['local_bytes']} threads={a['threads']}")

    lib = cuda_build.library("bilerp")
    lib.airslam_empty_launch.argtypes = [ctypes.c_void_p]
    lib.airslam_empty_launch.restype = ctypes.c_int

    def empty():
        _require(lib.airslam_empty_launch(torch.cuda.current_stream().cuda_stream) == 0,
                 "the empty kernel did not launch")

    times = {}
    for label, ops in shapes.items():
        grad = grads[label]
        maps_only = torch.zeros_like(ops[0])
        t = dict(ms=_time_ms(lambda: bilerp.loi_features_backward(grad, *ops)),
                 eager_ms=_eager_ms(lambda: bilerp.loi_features_backward(grad, *ops)),
                 plain_ms=_eager_ms(lambda: bilerp.loi_features_backward_plain(grad, *ops),
                                    iters=20, warmup=3),
                 zeros_ms=_time_ms(lambda: (maps_only.zero_(),)),
                 library_ms=loi_backward_library_ms(ops))
        t["bound_ms"], t["bound_by"] = _bound_ms(*_loi_backward_work(ops))
        times[label] = t
        before = bilerp.loi_features_backward.launches
        kernels, memsets = _device_ops(lambda: bilerp.loi_features_backward(grad, *ops))
        ours = bilerp.loi_features_backward.launches - before - 1  # the capture's
        print(f"kernel B+T' {label}: ms={t['ms']:.5f} (the call: its zero fills and the "
              f"kernel) eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.5f} (eager, "
              f"autograd through the plain forward, forward included) bound_ms="
              f"{t['bound_ms']:.6f} ({t['bound_by']}); zeroing a tensor of the LOI map's "
              f"gradient's size alone ms={t['zeros_ms']:.5f}; F.grid_sample's backward at the "
              f"same samples (3 calls) ms={t['library_ms']:.5f}; per call on the card (the "
              f"nodes of a CUDA graph of one call): {kernels} kernels, {memsets} memsets, "
              f"{ours} of the kernels kernel B+T′ (its launch counter), so "
              f"{kernels + memsets - ours} zero fill(s)")
    print(f"empty kernel (launch floor): ms={_time_ms(empty):.5f}")
    for label, ops in shapes.items():
        grad = grads[label]
        first = bilerp.loi_features_backward(grad, *ops)[0]
        sweep = {r: [] for r in LOI_BACKWARD_TILES}
        for r in LOI_BACKWARD_TILES + LOI_BACKWARD_TILES[::-1]:  # in turns
            _require(torch.equal(bilerp._launch_backward(grad, *ops, tile=r)[0], first),
                     f"kernel B+T' ({label}) tile={r} gave other d_loi bits")
            sweep[r].append(_time_ms(lambda: bilerp._launch_backward(grad, *ops, tile=r)))
        print(f"kernel B+T' {label} texels-per-block sweep ms (d_loi bit-equal across it): "
              + " ".join(f"{r}: {min(t):.5f}" for r, t in sweep.items()))
    t = times[next(iter(shapes))]
    return {"name": "loi_features_backward", "route": "cuda",
            "source": "airslam_tpu_torch/csrc/bilerp.cu",
            "replaces": "airslam_tpu/models/plnet.py:428",
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def train_scene(z, prefix, view):
    """View ``view`` of a stored pair of the train oracle as a port Scene
    (batch of one)."""
    import torch

    from airslam_tpu_torch.frontend.synthgen import Scene

    img = z[f"{prefix}/image"][view].astype(np.float32) / np.float32(65535)
    return Scene(image=torch.as_tensor(img)[None],
                 **{f: torch.as_tensor(z[f"{prefix}/{f}"][view])[None]
                    for f in ("corners", "corner_mask", "segments", "segment_mask")})


def _to_dev(scene, dev):
    return type(scene)(*(t.to(dev) for t in scene))


def _leaf_gaps(z, mode, grads, before, after, lr, floor=0.0):
    """Per leaf of the stored step, a dict: ``norm`` the relative gap of the
    gradient's norm, ``grad`` the relative L2 gap of its stored values,
    ``update`` the relative L2 gap of the update's stored values where JAX's
    gradient is nonzero, ``left_out`` the others (``left_out_floor``: the
    entries under 1e-3 of the leaf's rms, which an earlier gate left out),
    ``flips`` the gradient's sign flips among the kept entries and
    ``flip_ratio`` the largest |JAX gradient| / rms among them,
    ``dead_grad`` the port's largest |gradient| / rms and ``dead_update`` its
    largest |update| / lr where JAX's gradient is exactly zero, ``moved`` how
    many of those the port's step moved. ``grads``/``before``/``after``:
    flat {leaf: array}. ``floor`` > 0 also leaves out of the update gap the
    entries whose |JAX gradient| is at most ``floor`` of the leaf's rms.

    Adam's first step is ≈ −lr·sign g, so an entry whose sign two float32
    programs may set differently moves by 2·lr: an exact zero of XLA's (a
    dead channel) reads up to 1.4e-6 of the leaf's rms under cuDNN's
    algorithms, so those entries are held by ``TRAIN_GATES["dead_grad"]``
    instead of the update gate."""
    gaps = {}
    for leaf in grads:
        key = f"{mode}/leaf/{leaf}"
        idx = z[f"{key}/idx"]
        g = grads[leaf].reshape(-1)
        ref_norm = float(z[f"{key}/norm"])
        want_g, want_u = z[f"{key}/grad"], z[f"{key}/update"]
        upd = (after[leaf].reshape(-1) - before[leaf].reshape(-1))[idx]
        dead = want_g == 0
        rms = ref_norm / np.sqrt(g.size)
        keep = np.abs(want_g) > floor * rms
        flip = keep & (np.sign(g[idx]) != np.sign(want_g))
        gaps[leaf] = dict(
            norm=abs(float(np.linalg.norm(g.astype(np.float64))) - ref_norm) / max(ref_norm, 1e-30),
            grad=_rel_l2(g[idx], want_g), update=_rel_l2(upd[keep], want_u[keep]),
            left_out=int((~keep).sum()),
            left_out_floor=int((np.abs(want_g) <= 1e-3 * rms).sum()),
            flips=int(flip.sum()),
            flip_ratio=float((np.abs(want_g[flip]) / rms).max(initial=0.0)) if rms else 0.0,
            dead_grad=float(np.abs(g[idx][dead]).max(initial=0.0)) / rms if rms else 0.0,
            dead_update=float(np.abs(upd[dead]).max(initial=0.0)) / lr,
            moved=int((dead & (upd != 0)).sum()))
    return gaps


def _rel_l2(got, want):
    den = float(np.linalg.norm(want.astype(np.float64)))
    num = float(np.linalg.norm(got.astype(np.float64) - want))
    return num / den if den > 0 else num


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict) else {prefix + k: v})
    return out


def train_oracle_steps(dev):
    """One step of each mode from the shipped checkpoints on the stored
    pairs against the stored JAX step (f32, TF32 off, cuDNN's deterministic
    algorithms). Prints every mode's figures, then raises if a gate failed;
    returns the printed figures per mode."""
    import torch

    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
    from airslam_tpu_torch.models.superpoint import SuperPoint
    from airslam_tpu_torch.parallel import train_plnet as tp

    g = TRAIN_GATES
    z = np.load(TRAIN_ORACLE)
    s0_tree = wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))
    sp_tree = wio.load_npz(wio.checkpoint_path("superpoint.npz"))
    report, failed = {}, []
    for mode in ("plnet", "superpoint", "distill"):
        prefix = "plnet" if mode == "plnet" else "superpoint"
        s0, s1 = (_to_dev(train_scene(z, prefix, v), dev) for v in (0, 1))
        if mode == "plnet":
            plnet, loi = PLNet(), LoiHeadS1()
            plnet.load_state_dict(wio.plnet_from_flax(s0_tree["plnet"]))
            loi.load_state_dict(wio.loi_s1_from_flax(s0_tree["loi"]))
            nets = {"plnet": plnet.to(dev), "loi": loi.to(dev)}
            draws = {k: torch.as_tensor(z[f"plnet/loi/{k}"], device=dev)[None]
                     for k in ("pos_jitter", "i", "j", "prop_jitter")}
            draws["i"], draws["j"] = draws["i"].long(), draws["j"].long()
            tgt = tp.scene_targets(s0)
            for f in ("kp_label", "junc_heat", "junc_mask", "line_mask"):
                _require(np.array_equal(getattr(tgt, f)[0].cpu().numpy(),
                                        z[f"plnet/target/{f}"]),
                         f"train targets: {f} differs from the JAX targets")

            def loss_fn():
                return tp.plnet_loss(plnet, loi, s0, s1, draws)

            def to_flax(get):
                return _flat({"plnet": wio.plnet_to_flax(get(plnet)),
                              "loi": wio.loi_s1_to_flax(get(loi))})
        else:
            sp = SuperPoint()
            sp.load_state_dict(wio.superpoint_from_flax(sp_tree))
            nets = {"sp": sp.to(dev)}
            if mode == "distill":
                frozen = PLNet()
                frozen.load_state_dict(wio.plnet_from_flax(s0_tree["plnet"]))
                frozen.to(dev).eval().requires_grad_(False)

                def loss_fn():
                    return tp.superpoint_distill_loss(sp, frozen, s0, s1)
            else:
                def loss_fn():
                    return tp.superpoint_loss(sp, s0, s1)

            def to_flax(get):
                return _flat(wio.superpoint_to_flax(get(sp)))
        params = [p for net in nets.values() for p in net.parameters()]
        with _no_tf32("f32"), _pinned_cudnn():
            loss, terms = loss_fn()
            opt = tp.ClippedAdam(params, lr=3e-4)
            before = to_flax(lambda m: {n: p.detach().clone() for n, p in m.named_parameters()})
            loss.backward()
            grads = to_flax(lambda m: {n: p.grad.clone() for n, p in m.named_parameters()})
            norm = opt.clip()
            opt.adam.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        after = to_flax(lambda m: {n: p.detach() for n, p in m.named_parameters()})
        term_gap = {k: abs(float(v.detach()) - float(z[f"{mode}/term/{k}"]))
                    / max(abs(float(z[f"{mode}/term/{k}"])), 1e-30) for k, v in terms.items()}
        _require(set(term_gap) == {k[len(f"{mode}/term/"):] for k in z.files
                                   if k.startswith(f"{mode}/term/")},
                 f"train {mode}: the loss has other terms than the JAX step's")
        worst, text, checks = _step_gate(z, mode, grads, before, after, opt.adam.defaults["lr"])
        report[mode] = dict(worst, terms=max(term_gap.values()), grad_norm=float(norm))
        print(f"train step {mode} against the stored JAX step (f32, TF32 off, cuDNN "
              f"deterministic): loss {float(loss.detach()):.6f} (JAX "
              f"{float(z[f'{mode}/loss']):.6f}); worst term gap {report[mode]['terms']:.2e} (gate "
              f"{g['term']}); {text}; global gradient norm {float(norm):.4f}")
        checks.insert(0, (all(v <= g["term"] for v in term_gap.values()),
                          f"loss terms {term_gap} beyond {g['term']} relative"))
        failed += [f"train {mode}: {msg}" for ok, msg in checks if not ok]
    _require(not failed, "; ".join(failed))
    return report


def _step_gate(z, mode, grads, before, after, lr, floor=0.0):
    """The stored step's leaf gates (``_leaf_gaps`` under ``TRAIN_GATES``,
    ``floor`` as there): returns the worst figures and totals (a dict),
    their text and the (ok, message) checks of the gradient, its norm, the
    update and the entries where JAX's gradient is exactly zero."""
    g = TRAIN_GATES
    gaps = _leaf_gaps(z, mode, grads, before, after, lr, floor)
    worst = {k: max(v[k] for v in gaps.values())
             for k in ("norm", "grad", "update", "flip_ratio", "dead_grad", "dead_update")}
    worst_leaf = {k: max(gaps, key=lambda leaf: gaps[leaf][k]) for k in worst}
    total = {k: sum(v[k] for v in gaps.values())
             for k in ("left_out", "left_out_floor", "flips", "moved")}
    stored = sum(len(z[f"{mode}/leaf/{k}/idx"]) for k in gaps)
    text = (f"over {len(gaps)} leaves worst gradient gap {worst['grad']:.2e} "
            f"({worst_leaf['grad']}), norm gap {worst['norm']:.2e} (gate {g['grad']}); worst "
            f"update gap {worst['update']:.2e} ({worst_leaf['update']}, gate {g['update']}) "
            f"over the stored entries whose |JAX gradient| exceeds {floor:g} of the leaf's "
            f"rms: {total['left_out']} of {stored} left out ({total['left_out_floor']} under "
            f"1e-3 of the rms), "
            f"{total['flips']} sign flips kept (largest |g|/rms "
            f"{worst['flip_ratio']:.2e}); where JAX's gradient is 0 the port's is at most "
            f"{worst['dead_grad']:.2e} of its rms ({worst_leaf['dead_grad']}, gate "
            f"{g['dead_grad']}), {total['moved']} moved, by at most "
            f"{worst['dead_update']:.3f} lr")
    checks = [
        (worst["norm"] <= g["grad"] and worst["grad"] <= g["grad"],
         f"gradient of {worst_leaf['grad']} / norm of {worst_leaf['norm']} "
         f"{worst['grad']:.3e} / {worst['norm']:.3e} beyond {g['grad']}"),
        (worst["update"] <= g["update"],
         f"Adam update of {worst_leaf['update']} {worst['update']:.3e} beyond {g['update']}"),
        (worst["dead_grad"] <= g["dead_grad"],
         f"gradient of {worst_leaf['dead_grad']} {worst['dead_grad']:.3e} of its rms where "
         f"JAX's is 0, beyond {g['dead_grad']}"),
        (worst["dead_update"] <= 1.0,
         f"{worst_leaf['dead_update']} moved by {worst['dead_update']:.3f} lr where JAX's "
         f"gradient is 0")]
    return dict(worst, leaves=len(gaps), stored=stored, **total), text, checks


@contextlib.contextmanager
def _pinned_cudnn():
    """cuDNN's deterministic algorithms, no autotuning, while the stored
    step is compared; restored after."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def phase_train(dev):
    """Detector training on the card: kernel B+T′, one step of each mode
    against the stored JAX step, then the training CLI in its three modes
    at full width. Returns (the kernel record, the launch counts of the
    ``plnet`` CLI run, launches per step)."""
    import torch

    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu_torch.models import weights as wio

    t_phase = time.perf_counter()
    record = phase_kernel_loi_backward(dev)
    train_oracle_steps(dev)

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import train_plnet_torch

    counted = _counted()
    frames, _ = oracle_pairs()
    steps, batch = TRAIN_CLI["steps"], TRAIN_CLI["batch"]
    runs = {}
    for mode, flags in TRAIN_MODES.items():
        out = os.path.join(train_plnet_torch.DEFAULT_OUT, f"smoke_{mode}")
        for fn in counted.values():
            fn.launches = 0
        rec = train_plnet_torch.main(flags + ["--steps", str(steps), "--batch", str(batch),
                                              "--device", "cuda", "--out", out,
                                              "--log_every", "5"])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        losses = np.asarray(rec["losses"])
        _require(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
                 f"train CLI {mode}: losses {losses}")
        _require(losses[-5:].mean() < losses[:5].mean(),
                 f"train CLI {mode}: the last 5 steps' mean loss {losses[-5:].mean():.4f} is not "
                 f"below the first 5's {losses[:5].mean():.4f}")
        on_path = 1 if mode == "plnet" else 0
        want = {k: 0 for k in counted}
        want["loi_features"] = want["loi_features_backward"] = on_path * steps
        _require(launches == want, f"train CLI {mode}: launched {launches}, not {want}")
        # the written checkpoint in the port's detector, on a stored pair
        os.environ["AIRSLAM_CHECKPOINT_DIR"] = out
        try:
            det = FeatureDetector(DetectorConfig(use_superpoint=mode != "plnet"), device=dev)
            tree = wio.load_npz(rec["ckpt"])
            net = det.plnet if mode == "plnet" else det.superpoint
            sd = (wio.plnet_from_flax(tree["plnet"]) if mode == "plnet"
                  else wio.superpoint_from_flax(tree))
            _require(all(torch.equal(net.state_dict()[k].cpu(), v) for k, v in sd.items()),
                     f"train CLI {mode}: the detector did not load the written checkpoint")
            f = det.detect(frames[0])
        finally:
            del os.environ["AIRSLAM_CHECKPOINT_DIR"]
        _require(all(bool(torch.isfinite(t.float()).all()) for t in f),
                 f"train CLI {mode}: the reloaded detector gave non-finite features")
        ms = rec["steady_ms"]
        runs[mode] = dict(launches=launches, ms=ms)
        print(f"train CLI {mode} (apps/train_plnet_torch.py, {steps} steps, batch {batch}, 512², "
              f"fresh init{' + the shipped plnet_s0 frozen' if mode == 'distill' else ''}): "
              f"loss first 5 {losses[:5].mean():.4f} -> last 5 {losses[-5:].mean():.4f}; "
              f"first step {rec['first_step_s']:.2f} s; {ms:.1f} ms per step after it, "
              f"{2 * batch * 1e3 / ms:.1f} images/s; launches {launches}; the checkpoint "
              f"reloads into FeatureDetector and detects a stored pair")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    plnet_launches = runs["plnet"]["launches"]
    return record, plnet_launches, {k: v // steps for k, v in plnet_launches.items()}


def unpack_leaves(z, mode):
    """The per-leaf entries ``{mode}/leaf/{leaf}/{norm,idx,grad,update}``
    that ``_leaf_gaps`` reads, from the matcher oracle's packed arrays
    (``scripts/make_torch_oracle.py``'s ``pack_leaves``)."""
    start = z[f"{mode}/leaf_start"]
    out = {}
    for i, name in enumerate(z[f"{mode}/leaves"]):
        key = f"{mode}/leaf/{name}"
        out[f"{key}/norm"] = z[f"{mode}/leaf_norm"][i]
        for f in ("idx", "grad", "update"):
            out[f"{key}/{f}"] = z[f"{mode}/leaf_{f}"][start[i]:start[i + 1]]
    return out


def matcher_oracle():
    """``tests/data/torch_matcher_oracle.npz`` as a dict, every mode's
    leaves unpacked."""
    with np.load(MATCHER_ORACLE) as f:
        z = {k: f[k] for k in f.files}
    for mode in MATCHER_MODES:
        z.update(unpack_leaves(z, mode))
    return z


def matcher_batch(z, tokens, arch):
    """The stored JAX batch of a pair set as the trainer's tuple for
    ``arch`` (numpy, a leading batch axis)."""
    return tuple(z[f"{tokens}/batch/{f}_{arch}" if f in ("k0", "k1") else f"{tokens}/batch/{f}"]
                 for f in MATCHER_FIELDS[tokens][arch])


def _tensor(a, dev):
    import torch

    t = torch.as_tensor(np.asarray(a), device=dev)
    return t.long() if t.dtype == torch.int32 else t


def matcher_model(arch):
    """LightGlue, or SuperGlue with 20 Sinkhorn iterations returning the
    whole plan, as the trainer builds them, from the shipped checkpoint;
    with its ``to_flax``."""
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.lightglue import LightGlue
    from airslam_tpu_torch.models.superglue import SG_SINKHORN_ITERS, SuperGlue

    if arch == "lightglue":
        model, conv = LightGlue(), (wio.lightglue_from_flax, wio.lightglue_to_flax)
    else:
        model = SuperGlue(sinkhorn_iterations=SG_SINKHORN_ITERS, return_full=True)
        conv = (wio.superglue_from_flax, wio.superglue_to_flax)
    model.load_state_dict(conv[0](wio.load_npz(wio.checkpoint_path(f"{arch}.npz"))))
    return model, conv[1]


def null_leaves(grads):
    """SuperGlue's attention key biases among the flat gradient leaves: a
    constant added to every key's logit leaves the softmax unchanged, so
    their gradient is zero in exact arithmetic and float32 noise in
    practice."""
    return [leaf for leaf in grads if leaf.endswith("/k/bias")]


def null_grad_ratio(grads, leaf):
    """A null leaf's gradient norm over its layer's key kernel's."""
    kernel = grads[leaf[:-len("bias")] + "kernel"]
    return float(np.linalg.norm(grads[leaf])) / float(np.linalg.norm(kernel))


def matcher_loss(arch, tokens):
    """The port's loss of a matcher-trainer mode."""
    from airslam_tpu_torch.parallel import training as tr

    return {("lightglue", "corners"): tr.rendered_match_loss,
            ("superglue", "corners"): tr.rendered_match_loss_sg,
            ("lightglue", "detected"): tr.detected_match_loss,
            ("superglue", "detected"): tr.detected_match_loss_sg}[arch, tokens]


def matcher_oracle_steps(dev):
    """One step of each matcher-trainer mode from the shipped checkpoint on
    the stored JAX batch against the stored JAX step (f32, TF32 off): the
    loss within ``TRAIN_GATES["term"]`` relative and the leaf gates of phase
    ``train`` (:func:`_step_gate`), Adam at the CLI's lr without clipping.
    Prints every mode's figures, then raises if a gate failed; returns the
    figures per mode."""
    import torch

    from airslam_tpu_torch.parallel import training

    g = TRAIN_GATES
    z = matcher_oracle()
    report, failed = {}, []
    for mode in MATCHER_MODES:
        arch, tokens = mode.split("_")
        model, to_flax = matcher_model(arch)
        model.to(dev)
        batch = tuple(_tensor(a, dev) for a in matcher_batch(z, tokens, arch))

        def flat(get):
            return _flat(to_flax({n: get(p) for n, p in model.named_parameters()}))

        with _no_tf32("f32"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            opt = training.adam(model.parameters(), MATCHER_LR)
            before = flat(lambda p: p.detach().clone())
            loss = matcher_loss(arch, tokens)(model, batch)
            loss.backward()
            grads = flat(lambda p: p.grad.clone())
            opt.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        after = flat(lambda p: p.detach())
        want = float(z[f"{mode}/loss"])
        loss_gap = abs(float(loss.detach()) - want) / abs(want)
        null = null_leaves(grads)
        null_ratio = max((null_grad_ratio(grads, leaf) for leaf in null), default=0.0)
        worst, text, checks = _step_gate(
            z, mode, {k: v for k, v in grads.items() if k not in null}, before, after,
            MATCHER_LR, MATCHER_GATES["update_floor"])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None
        report[mode] = dict(worst, loss_gap=loss_gap, peak_mib=peak, null_ratio=null_ratio)
        print(f"matcher step {mode} against the stored JAX step (f32, TF32 off, batch "
              f"{batch[0].shape[0]} x {batch[0].shape[1]} tokens): loss "
              f"{float(loss.detach()):.6f} (JAX {want:.6f}, gap {loss_gap:.2e}, gate "
              f"{g['term']}); {text}; {len(null)} key biases' gradients at most "
              f"{null_ratio:.2e} of their key kernel's (gate {MATCHER_GATES['null_grad']})"
              + (f"; peak memory {peak:.1f} MiB" if peak is not None else ""))
        checks.insert(0, (loss_gap <= g["term"], f"loss gap {loss_gap:.3e} beyond {g['term']}"))
        checks.append((null_ratio <= MATCHER_GATES["null_grad"],
                       f"key-bias gradient {null_ratio:.3e} of its kernel's"))
        failed += [f"matcher {mode}: {msg}" for ok, msg in checks if not ok]
    _require(not failed, "; ".join(failed))
    return report


def _matcher_scenes(z, tokens, dev):
    """Both views of a stored pair set as port Scenes (B pairs), from the
    16-bit images."""
    import torch

    from airslam_tpu_torch.frontend.synthgen import Scene

    img = torch.as_tensor(z[f"{tokens}/image"].astype(np.float32) / np.float32(65535),
                          device=dev)
    return [Scene(image=img[:, v], corners=_tensor(z[f"{tokens}/corners"][:, v], dev),
                  corner_mask=_tensor(z[f"{tokens}/corner_mask"][:, v], dev),
                  segments=None, segment_mask=None) for v in (0, 1)]


def _token_agreement(want, got, gate):
    """The detected tokens of the stored JAX batch and the port's, as sets
    per pair and view (``torch.topk`` orders ties freely): keyed by their
    scale-0.5 keypoints (exact: a power-of-two scale of the pixel). Returns
    the smallest share of agreeing tokens, the largest score and descriptor
    gaps and the count of target and negative disagreements on agreeing
    tokens (a target agrees when both are −1 or point at the same view-1
    keypoint)."""
    share, score_gap, desc_gap, wrong = 1.0, 0.0, 0.0, 0
    for b in range(want["k0"].shape[0]):
        maps = []
        for v in (0, 1):
            k, m = f"k{v}", f"m{v}"
            jw = {tuple(p): i for i, p in enumerate(want[k][b]) if want[m][b][i]}
            pw = {tuple(p): i for i, p in enumerate(got[k][b]) if got[m][b][i]}
            common = jw.keys() & pw.keys()
            share = min(share, len(common) / max(len(jw), len(pw), 1))
            ji = np.array([jw[p] for p in common], int)
            pi = np.array([pw[p] for p in common], int)
            score_gap = max(score_gap, float(np.abs(want[f"s{v}"][b][ji]
                                                    - got[f"s{v}"][b][pi]).max(initial=0)))
            desc_gap = max(desc_gap, float(np.abs(want[f"d{v}"][b][ji]
                                                  - got[f"d{v}"][b][pi]).max(initial=0)))
            wrong += int((want[f"neg{v}"][b][ji] != got[f"neg{v}"][b][pi]).sum())
            maps.append((ji, pi))
        ji, pi = maps[0]
        for a, p in zip(ji, pi):
            tj, tp = want["tgt"][b][a], got["tgt"][b][p]
            same = (tj < 0 and tp < 0) or (tj >= 0 and tp >= 0
                                           and tuple(want["k1"][b][tj]) == tuple(got["k1"][b][tp]))
            wrong += int(not same)
    _require(share >= gate, f"detected tokens: only {share:.4f} of a view's tokens agree "
                            f"(gate {gate})")
    return share, score_gap, desc_gap, wrong


def frozen_plnet(dev):
    """The shipped PLNet stage 0, frozen on ``dev``, as the matcher trainer
    runs it."""
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.plnet import PLNet

    plnet = PLNet()
    plnet.load_state_dict(wio.plnet_from_flax(wio.load_npz(wio.checkpoint_path(
        "plnet_s0.npz"))["plnet"]))
    return plnet.to(dev).eval().requires_grad_(False)


def matcher_batch_gaps(dev):
    """The port's batch builders (``training.rendered_batch`` /
    ``detected_batch``, the shipped PLNet frozen, f32 with TF32 off) on the
    stored 16-bit images against the stored JAX batch: corner tokens and
    masks exact, the valid corners' descriptors and scores within
    ``MATCHER_GATES``; the detected tokens as sets (:func:`_token_agreement`). Raises on a failed
    gate; returns the figures per pair set."""
    from airslam_tpu_torch.parallel import training

    gt = MATCHER_GATES
    z = np.load(MATCHER_ORACLE)
    plnet = frozen_plnet(dev)
    report = {}
    for tokens in ("corners", "detected"):
        s0, s1 = _matcher_scenes(z, tokens, dev)
        got = {}
        with _no_tf32("f32"):
            for arch in ("lightglue", "superglue"):
                if tokens == "corners":
                    out = training.rendered_batch(
                        plnet, s0, s1, _tensor(z["corners/jitter"], dev), arch == "superglue")
                else:
                    out = training.detected_batch(
                        plnet, s0, s1, _tensor(z["detected/A"], dev),
                        _tensor(z["detected/t"], dev), arch == "superglue")
                named = dict(zip(MATCHER_FIELDS[tokens][arch],
                                 (t.cpu().numpy() for t in out)))
                got.update({(f"{f}_{arch}" if f in ("k0", "k1") else f): v
                            for f, v in named.items()})
        want = {k[len(f"{tokens}/batch/"):]: z[k] for k in z.files
                if k.startswith(f"{tokens}/batch/")}
        _require(got.keys() == want.keys(), f"{tokens} batch: fields {sorted(got)}")
        if tokens == "corners":
            exact = [f for f in want if f[0] not in "ds"]
            for f in exact:
                _require(np.array_equal(got[f], want[f]), f"corners batch: {f} differs")
            # padded corners lie anywhere, off the image too, where the two
            # samplers clamp otherwise: no loss term reads them
            gaps = {f: float(np.abs(got[f] - want[f])[want[f"m{f[1]}"]].max())
                    for f in want if f[0] in "ds"}
            desc_gap = max(gaps["d0"], gaps["d1"])
            score_gap = max(gaps["s0"], gaps["s1"])
            report[tokens] = dict(desc=desc_gap, score=score_gap, exact=len(exact))
            print(f"matcher batch corners ({want['k0_lightglue'].shape[0]} pairs, "
                  f"{want['m0'].sum() + want['m1'].sum()} valid corners) against the JAX "
                  f"batch on the stored images: {len(exact)} token and mask tensors equal; "
                  f"on the valid corners descriptors within {desc_gap:.2e}, scores within "
                  f"{score_gap:.2e}")
        else:
            w = dict(want, k0=want["k0_lightglue"], k1=want["k1_lightglue"])
            p = dict(got, k0=got["k0_lightglue"], k1=got["k1_lightglue"])
            share, score_gap, desc_gap, wrong = _token_agreement(w, p, gt["token_share"])
            report[tokens] = dict(share=share, desc=desc_gap, score=score_gap, wrong=wrong)
            print(f"matcher batch detected ({want['k0_lightglue'].shape[0]} pairs at view "
                  f"{MATCHER_CLI['view']}) against the JAX batch on the stored images: "
                  f"at least {share:.4f} of each view's tokens agree (gate "
                  f"{gt['token_share']}); on them descriptors within {desc_gap:.2e}, scores "
                  f"within {score_gap:.2e}, {wrong} target or negative flags differ")
            _require(wrong == 0, f"detected batch: {wrong} targets or negatives differ on "
                                 f"agreeing tokens")
        _require(desc_gap <= gt["desc"] and score_gap <= gt["score"],
                 f"{tokens} batch: descriptors {desc_gap:.3e} / scores {score_gap:.3e} beyond "
                 f"{gt['desc']} / {gt['score']}")
    return report


def wide_pair_draws(z, i, dev):
    """The stored JAX draws of wide-viewpoint pair ``i`` as the port's draw
    dicts (a batch of one), each view's pixel noise numpy's
    (``default_rng(noise_seed + i)``, as the oracle rendered the JAX pair)."""
    import torch

    prefix = f"wide/{i}/"
    d = {}
    for k in z.files:
        if k.startswith(prefix) and k.count("/") == 3:
            stage, name = k[len(prefix):].split("/")
            d.setdefault(stage, {})[name] = torch.as_tensor(z[k], device=dev)[None]
    noise = np.random.default_rng(int(z["wide/noise_seed"]) + i).standard_normal(
        (2, 512, 512), dtype=np.float32)
    for v in (0, 1):
        d[f"render{v}"]["noise"] = torch.as_tensor(noise[v], device=dev)[None]
    return d


def wide_viewpoint_gate(dev, detector):
    """tests/test_trained_detector.py::test_wide_viewpoint_matching on the
    port: its three pairs (v = 2) rendered from the stored JAX draws, the
    port's detector (that test's configuration) and the shipped LightGlue
    (400 keypoints, 512²): mean count ≥ 60, mean precision > 0.9 (matches
    within 4 px of the true affine), each pair's count within 5 % of the
    JAX count. Returns (counts, precisions, JAX counts)."""
    import torch

    from airslam_tpu_torch.frontend import synthgen as sg
    from airslam_tpu_torch.frontend.matcher import MatcherConfig, PointMatcher

    gt = MATCHER_GATES
    z = np.load(MATCHER_ORACLE)
    matcher = PointMatcher(MatcherConfig(matcher=0, max_keypoints=400, image_width=512,
                                         image_height=512), device=dev)
    counts, precs, jax_counts = [], [], []
    n_pairs = len({k.split("/")[1] for k in z.files if k.startswith("wide/") and k.count("/") > 1})
    own = [int(z[f"wide/{i}/count_own_noise"]) for i in range(n_pairs)]
    for i in range(n_pairs):
        d = wide_pair_draws(z, i, dev)
        shapes = sg.sample_shapes(d["shapes"])
        A, t = sg.random_affine(d["affine"])
        JA, Jt = z[f"wide/{i}/A"], z[f"wide/{i}/t"]
        _require(np.abs(A[0].cpu().numpy() - JA).max() <= 1e-6
                 and np.abs(t[0].cpu().numpy() - Jt).max() <= 1e-4,
                 f"wide pair {i}: the affine differs from the JAX one")
        s0 = sg.render_from_shapes(shapes, d["render0"])
        s1 = sg.render_from_shapes(sg.warp_shapes(shapes, A, t), d["render1"])
        f = detector.detect(torch.cat([s0.image, s1.image]))
        views = [type(f)(*(x[v] for x in f)) for v in (0, 1)]
        pairs, _ = matcher.matching_points(views[0], views[1])
        kp0, kp1 = (v.keypoints.float().cpu().numpy() for v in views)
        counts.append(len(pairs))
        jax_counts.append(int(z[f"wide/{i}/count"]))
        if len(pairs):
            pred = kp0[pairs[:, 0]] @ JA.T + Jt
            precs.append(float((np.linalg.norm(pred - kp1[pairs[:, 1]], axis=-1) < 4.0).mean()))
    rel = [abs(c - j) / j for c, j in zip(counts, jax_counts)]
    print(f"matcher wide-viewpoint pairs (v = 2, the port's render, detector and shipped "
          f"LightGlue): counts {counts} (JAX {jax_counts}; on the JAX test's own pixel noise "
          f"{own}; worst gap {max(rel):.3f}, gate "
          f"{gt['wide_count_rel']}), mean {np.mean(counts):.1f} (gate >= {gt['wide_count']}); "
          f"precision {[round(p, 4) for p in precs]} (JAX "
          f"{[round(float(z[f'wide/{i}/precision']), 4) for i in range(n_pairs)]}), mean "
          f"{np.mean(precs):.4f} (gate > {gt['wide_precision']})")
    _require(np.mean(counts) >= gt["wide_count"], f"wide-viewpoint match counts {counts}")
    _require(len(precs) == n_pairs and np.mean(precs) > gt["wide_precision"],
             f"wide-viewpoint precision {precs}")
    _require(max(rel) <= gt["wide_count_rel"],
             f"wide-viewpoint counts {counts} not within {gt['wide_count_rel']} of JAX's "
             f"{jax_counts}")
    return counts, precs, jax_counts


def matcher_step_parts(dev, plnet, arch, tokens, batch, steps=5):
    """One CLI step of a mode cut into its three parts, each synchronised
    and timed over ``steps`` steps from a fresh initialisation (f32, TF32
    off): rendering the pairs, building the batch (the frozen PLNet and the
    tokens) and the matcher's loss, backward and Adam update. Returns
    {part: (mean ms, peak MiB of the part)}."""
    import torch

    from airslam_tpu_torch.frontend import synthgen
    from airslam_tpu_torch.parallel import training as tr

    model, _ = matcher_model(arch)
    init = tr.init_train_state if arch == "lightglue" else tr.init_train_state_sg
    state = init(model, lr=MATCHER_LR)  # on the CPU, as the CLI initialises
    model.to(dev)
    loss_fn = matcher_loss(arch, tokens)
    sg = arch == "superglue"
    gen = torch.Generator(device=dev).manual_seed(0)
    parts = {"render": [], "batch": [], "matcher": []}
    peaks = {k: 0.0 for k in parts}

    cuda = dev.type == "cuda"

    def timed(name, fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2 ** 20)
        parts[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def render():  # the draws and the render, as the CLI's step makes them
        if tokens == "corners":
            d = tr.rendered_draws(gen, batch)
            return synthgen.render_pair(d["pair"], augment=1.0) + (d["jitter"],)
        d = synthgen.pair_draws(gen, batch, augment=1.0, view=MATCHER_CLI["view"])
        return synthgen.render_pair_with_affine(d, augment=1.0)

    def build(s0, s1, *rest):
        if tokens == "corners":
            return tr.rendered_batch(plnet, s0, s1, *rest, superglue=sg)
        return tr.detected_batch(plnet, s0, s1, *rest, superglue=sg)

    def update(data):
        state.opt.zero_grad(set_to_none=True)
        loss_fn(model, data).backward()
        state.opt.step()

    with _no_tf32("f32"):
        for _ in range(steps + 1):  # the first step warms up and is dropped
            pairs = timed("render", render)
            data = timed("batch", lambda: build(*pairs))
            timed("matcher", lambda: update(data))
    return {k: (float(np.mean(v[1:])), peaks[k]) for k, v in parts.items()}


def phase_matcher(dev):
    """The matcher trainer on the card: one step of each mode against the
    stored JAX step, the batch builders against the stored JAX batch, the
    wide-viewpoint gate, then the training CLI in its four modes at full
    width. Returns the launch counts per step of the CLI runs (all 0)."""
    import torch

    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu_torch.frontend.matcher import MatcherConfig, PointMatcher
    from airslam_tpu_torch.models import weights as wio

    t_phase = time.perf_counter()
    matcher_oracle_steps(dev)
    matcher_batch_gaps(dev)
    detector = FeatureDetector(DetectorConfig(use_superpoint=False), device=dev)
    with _no_tf32("f32"):
        wide_viewpoint_gate(dev, detector)

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import train_matcher_torch

    counted = _counted()
    frames, _ = oracle_pairs()
    steps, batch = MATCHER_CLI["steps"], MATCHER_CLI["batch"]
    per_step = {k: 0 for k in counted}
    for mode in MATCHER_MODES:
        arch, tokens = mode.split("_")
        flags = ["--arch", arch, "--tokens", tokens]
        if tokens == "detected":
            flags += ["--view", str(MATCHER_CLI["view"])]
        out = os.path.join(train_matcher_torch.DEFAULT_OUT, f"smoke_{mode}")
        for fn in counted.values():
            fn.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = train_matcher_torch.main(flags + ["--steps", str(steps), "--batch", str(batch),
                                                "--device", dev.type, "--out", out,
                                                "--log_every", "5"])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None
        launches = {k: fn.launches for k, fn in counted.items()}
        losses = np.asarray(rec["losses"])
        _require(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
                 f"matcher CLI {mode}: losses {losses}")
        _require(losses[-5:].mean() < losses[:5].mean(),
                 f"matcher CLI {mode}: the last 5 steps' mean loss {losses[-5:].mean():.4f} is "
                 f"not below the first 5's {losses[:5].mean():.4f}")
        _require(all(v == 0 for v in launches.values()),
                 f"matcher CLI {mode}: launched {launches}, not 0 of every kernel")
        for k, v in launches.items():
            per_step[k] = max(per_step[k], v // steps)
        # the written checkpoint in the port's PointMatcher, on a stored pair
        os.environ["AIRSLAM_CHECKPOINT_DIR"] = out
        try:
            pm = PointMatcher(MatcherConfig(matcher=int(arch == "superglue"),
                                            sinkhorn_iterations=20 if arch == "superglue" else 0),
                              device=dev)
            from_flax = wio.lightglue_from_flax if arch == "lightglue" else wio.superglue_from_flax
            sd = from_flax(wio.load_npz(rec["ckpt"]))
            _require(all(torch.equal(pm.model.state_dict()[k].cpu(), v) for k, v in sd.items()),
                     f"matcher CLI {mode}: the PointMatcher did not load the written checkpoint")
            f = detector.detect(frames[0])
            views = [type(f)(*(x[v] for x in f)) for v in (0, 1)]
            pairs, scores = pm.matching_points(views[0], views[1])
        finally:
            del os.environ["AIRSLAM_CHECKPOINT_DIR"]
        _require(bool(np.isfinite(np.asarray(scores)).all()),
                 f"matcher CLI {mode}: the reloaded matcher gave non-finite scores")
        ms = rec["steady_ms"]
        print(f"matcher CLI {mode} (apps/train_matcher_torch.py, {steps} steps, batch {batch}, "
              f"512², fresh init{', --view 2' if tokens == 'detected' else ''}): loss first 5 "
              f"{losses[:5].mean():.4f} -> last 5 {losses[-5:].mean():.4f}; first step "
              f"{rec['first_step_s']:.2f} s; {ms:.1f} ms per step after it, "
              f"{batch * 1e3 / ms:.1f} pairs/s; peak memory "
              f"{'not measured' if peak is None else f'{peak:.0f} MiB'}; launches "
              f"{launches}; the checkpoint reloads into PointMatcher, {len(pairs)} matches on "
              f"a stored frontend pair")
    plnet = frozen_plnet(dev)
    for mode in MATCHER_MODES:
        parts = matcher_step_parts(dev, plnet, *mode.split("_"), batch)
        print(f"matcher step parts {mode} (batch {batch}, synchronised, mean of 5 steps): "
              + "; ".join(f"{k} {ms:.1f} ms (peak {mib:.0f} MiB)"
                          for k, (ms, mib) in parts.items()))
    print(f"matcher phase: {time.perf_counter() - t_phase:.1f} s")
    return per_step


def _pose_work(problem, rounds, iters):
    """(bytes, f32 operations, dependent reductions) of one solve: every
    operand read once and every result written once; the operations the
    solve needs over the rows (none skipped: masks are multiplied in): per
    round ``iters`` Jacobian passes and ``iters + 2`` robust costs (the
    round's start, each trial, the relabel), not the Jacobians the kernel
    also takes at the last trial and at rejected ones; and the length of the
    chain the bound ignores: the kernel's block reductions one after another,
    one per evaluated pose and the final count."""
    n_p, n_l = problem.points.shape[0], problem.lines.shape[0]
    n_bytes = (n_p * (12 + 12 + 1) + n_l * (24 + 32 + 1 + 1 + 4) + 4 * (9 + 3 + 9 + 3) + 1
               + 48 + n_p + n_l + 4)
    w = POSE_FLOPS
    per_cost = n_p * w["point_cost"] + n_l * w["line_cost"]
    per_jac = n_p * w["point_iter"] + n_l * w["line_iter"]
    n_flops = rounds * (iters * per_jac + (iters + 2) * per_cost)
    return n_bytes, n_flops, rounds * (iters + 1) + 1


def phase_kernel_p(dev):
    """Kernel P against its plain version, both float32 on the card."""
    import torch

    from airslam_tpu_torch.backend import gn, pose_gn

    cfg = gn.BAConfig()
    g = POSE_GATES

    def both(problem, intr, rounds=3, iters=10):
        got = pose_gn.pose_only_fast(problem, intr, cfg, rounds=rounds, iters=iters)
        want = pose_gn.pose_only_fast_plain(problem, intr, cfg, rounds=rounds, iters=iters)
        torch.cuda.synchronize()
        return got, want, pose_agreement(got, want)

    def gate(name, a, keys=("t", "R", "inlier_agree", "count_rel")):
        bad = [k for k in keys
               if (a[k] < g[k] if k == "inlier_agree" else a[k] > g[k])]
        _require(not bad, f"kernel P ({name}) disagrees with its plain version: "
                 + " ".join(f"{k}={a[k]:.3e}" for k in bad))

    report, worst = [], 0.0
    # (a) the kernel's full size, (b) the path's shape: 200 matched mappoints
    # padded to 256, the builder's single masked dummy line
    cases = {"full": tracking_problem(5, 512, 128, device=dev),
             "path": tracking_problem(6, 200, 1, n_masked_points=56, mask_lines=True, device=dev)}
    for name, (problem, intr, twb_true) in cases.items():
        got, want, a = both(problem, intr)
        gate(name, a)
        t_true = float(np.linalg.norm(got[0].frames.twb[0].double().cpu().numpy() - twb_true))
        _require(t_true < g["t_true"], f"kernel P ({name}) missed the true pose: {t_true:.3e}")
        again = pose_gn.pose_only_fast(problem, intr, cfg)
        _require(torch.equal(again[0].frames.twb, got[0].frames.twb)
                 and torch.equal(again[0].frames.Rwb, got[0].frames.Rwb)
                 and torch.equal(again[1], got[1]), f"kernel P ({name}): two runs differ")
        worst = max(worst, a["t"], a["R"])
        report.append(f"{name}: dt={a['t']:.2e} dR={a['R']:.2e} inlier_agree={a['inlier_agree']:.4f} "
                      f"inliers={a['num_inliers']} t_true={t_true:.2e}")
    # (c) a fixed pose comes back bit-unchanged
    problem, intr, _ = tracking_problem(7, 96, 12, outliers=False, device=dev)
    fixed = problem._replace(pose_fixed=torch.ones_like(problem.pose_fixed))
    out = pose_gn.pose_only_fast(fixed, intr, cfg, rounds=1, iters=3)[0]
    torch.cuda.synchronize()
    _require(torch.equal(out.frames.Rwb, fixed.frames.Rwb)
             and torch.equal(out.frames.twb, fixed.frames.twb),
             "kernel P moved a fixed pose")
    report.append("fixed: unchanged")
    # (d) no active point, lines only
    problem, intr, _ = tracking_problem(11, 1, 24, outliers=False, device=dev)
    problem = problem._replace(point_obs_mask=torch.zeros_like(problem.point_obs_mask))
    got, want, a = both(problem, intr, rounds=2, iters=8)
    gate("lines only", a)
    _require(a["num_inliers"] > 0, "kernel P (lines only) kept no line")
    worst = max(worst, a["t"], a["R"])
    report.append(f"lines-only: dt={a['t']:.2e} dR={a['R']:.2e} inliers={a['num_inliers']}")
    print("kernel P: " + "; ".join(report) + f" (gates t<={g['t']} R<={g['R']} "
          f"inlier_agree>={g['inlier_agree']} t_true<{g['t_true']})")

    for threads in POSE_THREADS:
        a = pose_gn.kernel_attributes(threads, 256, 1)
        print(f"kernel P instantiation threads={threads}: registers={a['registers']} "
              f"static_smem={a['static_smem']} dynamic_smem(256 pts, 1 line)={a['dynamic_smem']} "
              f"local_bytes={a['local_bytes']}")
    times = {}
    for name, (problem, intr, _) in cases.items():
        def kernel():
            return pose_gn.pose_only_fast(problem, intr, cfg)

        def plain():
            return pose_gn.pose_only_fast_plain(problem, intr, cfg)

        def sized(threads, ops=pose_gn._operands(problem), n=problem.points.shape[0],
                  m=problem.lines.shape[0]):
            return pose_gn._launch(ops, n, m, 1, intr, cfg, 3, 10, threads=threads)

        # block-size sweep, in turns so that a drift of the clock spreads over all
        sweep = {t: [] for t in POSE_THREADS}
        for t in POSE_THREADS + POSE_THREADS[::-1]:
            sweep[t].append(_time_ms(lambda: sized(t), iters=20))
        print(f"kernel P {name} block-size sweep ms: "
              + " ".join(f"threads={t}: {min(v):.5f}" for t, v in sweep.items()))
        n_bytes, n_flops, chain = _pose_work(problem, 3, 10)
        bound, by = _bound_ms(n_bytes, n_flops)
        # the plain version is thousands of small launches with host work
        # between them: timed eagerly, a graph of it would be no fairer
        times[name] = dict(ms=_time_ms(kernel, iters=20), eager_ms=_eager_ms(kernel, iters=100),
                           plain_ms=_eager_ms(plain, iters=3, warmup=1), bound_ms=bound,
                           bound_by=by)
        t = times[name]
        print(f"kernel P {name}: points={problem.points.shape[0]} lines={problem.lines.shape[0]} "
              f"ms={t['ms']:.5f} eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.3f}(eager) "
              f"bound_ms={bound:.6f} ({by}; the bound by bytes and operations ignores the "
              f"dependent chain of 3x10 iterations) chain={chain} block reductions one after "
              f"another, us_per_link={t['ms'] * 1e3 / chain:.3f} library_ms=none")
    rec = times["path"]  # the shape the main path gives the kernel
    return {"name": "pose_only_fast", "route": "cuda",
            "source": "airslam_tpu_torch/csrc/pose_gn.cu",
            "replaces": "airslam_tpu/backend/pose_gn_pallas.py:331", "max_abs_err": worst,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None}


def flash_attention_bound(batch, heads, nq, nk, d, size):
    """Bound of one fused attention call: q, k, v and the key mask read once,
    the output written once; QKᵀ and PV are 2·B·H·Nq·Nk·D operations each, the
    masked softmax about 5 per logit. ``size``: bytes per operand element
    (2: tensor-core bf16 rate, 4: the f32 rate outside the tensor cores)."""
    n_flops = batch * heads * nq * nk * (4 * d + 5)
    n_bytes = batch * heads * d * size * (2 * nq + 2 * nk) + batch * nk
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / (BF16_FLOPS if size == 2 else F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _attention_inputs(rng, lead, heads, nq, nk, d, qk_dtype, v_dtype, dev, n_valid=None,
                      all_masked=None):
    """q, k, v as LightGlue hands them over — transposed views of
    (…, N, H·D) projections — and a key mask with the keys from ``n_valid`` on
    masked (every key of batch entry ``all_masked``)."""
    import torch

    def proj(n, dtype):
        x = torch.as_tensor(rng.randn(*lead, n, heads * d).astype(np.float32), device=dev)
        x = x.to(dtype)
        return x.reshape(*lead, n, heads, d).transpose(-3, -2)

    q, k, v = proj(nq, qk_dtype), proj(nk, qk_dtype), proj(nk, v_dtype)
    mask = None
    if n_valid is not None:
        mask = torch.zeros(*lead, nk, dtype=torch.bool, device=dev)
        mask[..., :n_valid] = True
        if all_masked is not None:
            mask[all_masked] = False
    return q, k, v, mask


def phase_kernel_f(dev):
    """Kernel F against its plain version on the card, then its times."""
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.ops import attention
    from airslam_tpu_torch.ops.attention import flash_mha, flash_mha_plain, mha

    bf, f32 = torch.bfloat16, torch.float32
    rng = np.random.RandomState(0)
    # (label, lead, H, Nq, Nk, D, q/k type, v type, valid keys, all-masked entry)
    cases = [("stereo f32", (1,), 4, 400, 400, 64, f32, f32, 371, None),
             ("stereo bf16", (1,), 4, 400, 400, 64, bf, bf, 371, None),
             ("path f32", (2,), 4, 400, 400, 64, f32, f32, 388, None),
             ("path bf16", (2,), 4, 400, 400, 64, bf, bf, 388, None),
             ("unbatched 1024 f32", (), 4, 1024, 1024, 64, f32, f32, None, None),
             ("unbatched 1024 bf16", (), 4, 1024, 1024, 64, bf, bf, 1000, None),
             ("odd f32", (3,), 2, 77, 300, 32, f32, f32, 290, None),
             ("odd bf16", (3,), 2, 77, 300, 64, bf, bf, 290, None),
             ("all masked f32", (2,), 4, 400, 400, 64, f32, f32, 388, 1),
             ("all masked bf16", (2,), 4, 400, 400, 64, bf, bf, 388, 1),
             ("mixed f32 q/k, bf16 v", (2,), 4, 400, 400, 64, f32, bf, 388, None)]
    worst = {"f32": 0.0, "bf16": 0.0}
    notes = []
    for label, lead, h, nq, nk, d, tq, tv, n_valid, dead in cases:
        q, k, v, mask = _attention_inputs(rng, lead, h, nq, nk, d, tq, tv, dev, n_valid, dead)
        got = flash_mha(q, k, v, mask)
        again = flash_mha(q, k, v, mask)
        want = flash_mha_plain(q, k, v, mask)
        torch.cuda.synchronize()
        _require(got.shape == want.shape and got.dtype == q.dtype,
                 f"kernel F ({label}): output {tuple(got.shape)} {got.dtype}")
        _require(torch.equal(got, again), f"kernel F ({label}): two runs differ")
        _require(bool(torch.isfinite(got.float()).all()), f"kernel F ({label}): not finite")
        err = float((got.float() - want.float()).abs().max())
        # bf16 anywhere in the call: p is rounded to v's type against the
        # running maximum, and a bf16 output rounds once more
        kind = "f32" if (tq, tv) == (f32, f32) else "bf16"
        tol = (FLASH_GATES["f32"] if kind == "f32"
               else FLASH_GATES["bf16_rel"] * float(want.float().abs().max()))
        _require(err <= tol, f"kernel F ({label}) disagrees with its plain version: "
                             f"{err:.3e} > {tol:.3e}")
        if dead is not None:  # every key masked: the plain mean of v
            mean_v = v[dead].float().mean(dim=-2, keepdim=True).expand_as(got[dead])
            gap = float((got[dead].float() - mean_v).abs().max())
            _require(gap <= (1e-5 if kind == "f32" else 2e-2),
                     f"kernel F ({label}): an all-masked row is not the mean of v: {gap:.3e}")
        worst[kind] = max(worst[kind], err)
        notes.append(f"{label}: {err:.2e}")
    print("kernel F: " + "; ".join(notes)
          + f" (gates f32<={FLASH_GATES['f32']} bf16<={FLASH_GATES['bf16_rel']} of max; "
          "two runs bit-equal)")

    for (tq, tv), ws in (((bf, bf), FLASH_Q_WARPS), ((f32, f32), (0,)), ((f32, bf), (0,)),
                         ((bf, f32), (0,))):
        for d in (64, 32):
            for w in ws:
                a = attention.kernel_attributes(tq, tv, d, w)
                print(f"kernel F instantiation q/k={str(tq)[6:]} v={str(tv)[6:]} D={d} "
                      f"rows/block={a['rows']} threads={a['threads']}: "
                      f"registers={a['registers']} static_smem={a['static_smem']} "
                      f"dynamic_smem={a['dynamic_smem']} local_bytes={a['local_bytes']}")
    # the bf16 route's query tile: 16-row warps per block, in turns
    for batch in (2, 1):
        q, k, v, mask = _attention_inputs(rng, (batch,), 4, 400, 400, 64, bf, bf, dev, 388)
        sweep = {w: [] for w in FLASH_Q_WARPS}
        for w in FLASH_Q_WARPS + FLASH_Q_WARPS[::-1]:
            sweep[w].append(_time_ms(lambda: attention._launch(q, k, v, mask, q_warps=w)))
        print(f"kernel F bf16 ({batch}, 4, 400, 64) query-tile sweep ms: "
              + " ".join(f"{16 * w} rows ({-(-400 // (16 * w)) * 4 * batch} blocks): {min(t):.5f}"
                         for w, t in sweep.items()))

    rec = {}
    for label, dtype, size in (("bf16", bf, 2), ("f32", f32, 4)):
        for batch in (1, 2):
            q, k, v, mask = _attention_inputs(rng, (batch,), 4, 400, 400, 64, dtype, dtype, dev, 388)
            bias = mask[:, None, None, :]
            t = dict(
                ms=_time_ms(lambda: flash_mha(q, k, v, mask)),
                eager_ms=_eager_ms(lambda: flash_mha(q, k, v, mask)),
                plain_ms=_time_ms(lambda: flash_mha_plain(q, k, v, mask)),
                mha_ms=_time_ms(lambda: mha(q, k, v, mask)),
                mha_eager_ms=_eager_ms(lambda: mha(q, k, v, mask)),
                library_ms=_time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)))
            t["bound_ms"], t["bound_by"] = flash_attention_bound(batch, 4, 400, 400, 64, size)
            rec[(label, batch)] = t
            print(f"kernel F {label} q/k/v ({batch}, 4, 400, 64): ms={t['ms']:.5f} "
                  f"eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
                  f"mha_ms={t['mha_ms']:.5f} mha_eager_ms={t['mha_eager_ms']:.5f} "
                  f"sdpa_ms={t['library_ms']:.5f} bound_ms={t['bound_ms']:.6f} ({t['bound_by']})")
    t = rec[("bf16", 2)]  # what a tracked frame of the bf16 path launches
    return {"name": "flash_mha", "route": "cuda",
            "source": "airslam_tpu_torch/csrc/attention.cu",
            "replaces": "airslam_tpu/ops/attention.py:35", "max_abs_err": worst["f32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def _counted():
    """The seven kernel wrappers, by the name their record carries."""
    from airslam_tpu_torch.backend import pose_gn
    from airslam_tpu_torch.ops import attention, bilerp, remap as remap_mod

    return {fn.__name__: fn for fn in (remap_mod.remap, bilerp.bilerp_points,
                                       bilerp.bilerp_points_t, bilerp.loi_features,
                                       pose_gn.pose_only_fast, attention.flash_mha,
                                       bilerp.loi_features_backward)}


def _run_vo(builder, frames, rec, timed_ba=None):
    """``add_input`` over the stored sequence. Returns per frame (wall ms,
    launch counts, became a keyframe) and the frames."""
    import torch

    from airslam_tpu_torch.backend import windows

    counted = _counted()
    local_ba = windows.local_ba
    if timed_ba is not None:
        def local_ba_timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = local_ba(*args, **kw)
            torch.cuda.synchronize()
            timed_ba.append((time.perf_counter() - t0) * 1e3)
            return out

        windows.local_ba = local_ba_timed
    rows, out = [], []
    try:
        for i in range(len(frames)):
            before = {k: fn.launches for k, fn in counted.items()}
            n_kf = len(builder.map.keyframe_ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(builder.add_input(float(rec["timestamps"][i]), frames[i][0], frames[i][1]))
            torch.cuda.synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3,
                         {k: fn.launches - before[k] for k, fn in counted.items()},
                         len(builder.map.keyframe_ids) > n_kf))
    finally:
        windows.local_ba = local_ba
    return rows, out


def phase_vo(dev):
    """The VO main path over the stored sequence with ``use_flash=True``,
    gated against the stored JAX run. Returns the launch counts of a tracked
    frame of the bf16 run."""
    import tempfile

    import torch

    from airslam_tpu_torch.io.serialization import load_map, save_map
    from airslam_tpu_torch.io.trajectory import ate_rmse, load_tum

    cam, frames, rec = vo_oracle()
    n = len(frames)
    gt = list(zip(rec["timestamps"], rec["gt_Twc"]))
    counted = _counted()
    frame_launches = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gates = VO_GATES[label]
        with _no_tf32(label):
            builder = tracking_builder(cam, dtype, dev, identity_rectify=True, use_flash=True)
            ba_frames, ba_ms = [], []
            builder.map.on_local_ba = lambda f: ba_frames.append(f.frame_id)
            for fn in counted.values():
                fn.launches = 0
            rows, out = _run_vo(builder, frames, rec, timed_ba=ba_ms)
            totals = {k: fn.launches for k, fn in counted.items()}
        m = builder.map
        poses = np.stack([f.Twc for f in out])
        dt = np.abs(poses[:, :3, 3] - rec["Twc"][:, :3, 3]).max(axis=1)
        dR = np.abs(poses[:, :3, :3] - rec["Twc"][:, :3, :3]).reshape(n, -1).max(axis=1)
        _require(builder.init and len(builder.trajectory) == n and bool(np.isfinite(poses).all()),
                 f"VO {label}: {len(builder.trajectory)} of {n} frames tracked")
        _require(float(dt.max()) <= gates["t"], f"VO {label}: a pose is {dt.max():.3e} m off")
        n_pts = sum(p.is_valid for p in m.mappoints.values())
        n_lns = sum(l.is_valid for l in m.maplines.values())
        kf_Twc = np.stack([m.keyframes[f].Twc for f in m.keyframe_ids])
        note = (f"keyframes={m.keyframe_ids}(oracle {rec['keyframe_ids'].tolist()}) "
                f"max dt={dt.max():.2e}(<={gates['t']}) max dR={dR.max():.2e} "
                f"mappoints={n_pts}(oracle {int(rec['n_mappoints'])}) "
                f"maplines={n_lns}(oracle {int(rec['n_maplines'])})")
        if label == "f32":
            same_kf = m.keyframe_ids == rec["keyframe_ids"].tolist()
            _require(same_kf, f"VO f32: {note}")
            kdt = float(np.abs(kf_Twc[:, :3, 3] - rec["keyframe_Twc"][:, :3, 3]).max())
            kdR = float(np.abs(kf_Twc[:, :3, :3] - rec["keyframe_Twc"][:, :3, :3]).max())
            note += f" keyframes after the last BA: dt={kdt:.2e} dR={kdR:.2e}"
            ok = (float(dR.max()) <= gates["R"] and kdt <= gates["t"] and kdR <= gates["R"]
                  and abs(n_pts - int(rec["n_mappoints"])) <= gates["count_rel"] * rec["n_mappoints"]
                  and abs(n_lns - int(rec["n_maplines"])) <= gates["count_rel"] * rec["n_maplines"])
            _require(ok, f"VO f32 gates failed: {note}")
        _require(ba_frames == m.keyframe_ids[1:] and len(ba_ms) == len(ba_frames),
                 f"VO {label}: local BA ran for {ba_frames}, keyframes {m.keyframe_ids}")
        # launches: a tracked frame, and the whole run (the first frame has no
        # pose-only solve; every frame is one LightGlue pass of 36 calls)
        plain_rows = [r for r in rows[1:] if not r[2]]
        _require(all(r[1] == FRAME_LAUNCHES for r in rows[1:]),
                 f"VO {label}: a tracked frame launched {[r[1] for r in rows[1:]]}, "
                 f"not {FRAME_LAUNCHES}")
        want_totals = {k: v * n for k, v in FRAME_LAUNCHES.items()}
        want_totals["pose_only_fast"] = n - 1
        _require(totals == want_totals, f"VO {label}: the run launched {totals}")
        frame_launches[label] = plain_rows[0][1]

        with tempfile.TemporaryDirectory() as tmp:
            traj_path = os.path.join(tmp, "trajectory_v0.txt")
            builder.save_trajectory(traj_path)
            builder.save_keyframe_trajectory(os.path.join(tmp, "keyframes.txt"))
            m.check_map()
            save_map(m, os.path.join(tmp, "AirSLAM_mapv0.bin"))
            back, _ = load_map(os.path.join(tmp, "AirSLAM_mapv0.bin"), device=dev)
            traj = load_tum(traj_path)
        _require(back.keyframe_ids == m.keyframe_ids and len(back.mappoints) == len(m.mappoints)
                 and np.array_equal(back.keyframes[m.keyframe_ids[-1]].Twc, kf_Twc[-1])
                 and len(traj) == n
                 and float(np.abs(traj[-1][1] - builder.trajectory[-1][1]).max()) < 1e-6,
                 f"VO {label}: the saved map or trajectory did not read back")
        kf_rows = [r[0] for r in rows[2:] if r[2]]  # frame 1 carries the first-use costs
        print(f"VO {label} (use_flash): {note}; ATE={ate_rmse(builder.trajectory, gt):.4e} m; "
              f"tracked frame ms={np.median([r[0] for r in plain_rows]):.3f} "
              f"keyframe frame ms={np.median(kf_rows):.3f} "
              f"local_ba ms={[round(t, 1) for t in ba_ms]}; "
              f"frame launches={frame_launches[label]} run launches={totals}")

    # the frame with and without the fused attention, in turns inside one
    # call (the first run of each builder warms it up and is not counted)
    with _no_tf32("bf16"):
        per = {True: [], False: []}
        for use_flash in (False, True, True, False):
            builder = tracking_builder(cam, torch.bfloat16, dev, identity_rectify=True,
                                       use_flash=use_flash)
            _run_vo(builder, frames[:3], rec)
            for _ in range(2):  # five frames: two tracked without an insertion
                rows, _ = _run_vo(tracking_builder_like(builder), frames[:5], rec)
                per[use_flash] += [r[0] for r in rows[1:] if not r[2]]
    print("VO bf16 tracked frame, wall ms, median of "
          f"{len(per[True])} frames each: use_flash={np.median(per[True]):.3f} "
          f"mha={np.median(per[False]):.3f}")
    return frame_launches["bf16"]


@contextlib.contextmanager
def _timed(module, name, sink):
    """``module.name`` wrapped for the block: each call's wall ms between
    two ``synchronize()`` appended to ``sink`` as (ms, result, args,
    keywords)."""
    import torch

    fn = getattr(module, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append(((time.perf_counter() - t0) * 1e3, out, args, kw))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _profile_call(fn, top=4):
    """One call of ``fn`` under ``torch.profiler``: (CUDA kernels launched,
    their summed device ms, the wall ms under the profiler, the ``top``
    kernels by device ms as (name, ms, launches))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by.get(e.name, (0.0, 0))
            by[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(v[1] for v in by.values()), sum(v[0] for v in by.values()), wall,
            [(k[:60], round(v[0], 3), v[1]) for k, v in ranked])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-12))


def phase_vio(dev):
    """The stereo-inertial path in float32 against the stored JAX runs.
    (a) ``add_input`` with ``use_flash=True`` and the IMU batches over the 8
    stored frames; (b) ``track_features`` over the initialization stream.
    Returns the launch counts of a tracked frame of (a)."""
    import torch

    from airslam_tpu_torch.backend import windows
    from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder

    cam, imu, rec = vio_oracle()
    counted = _counted()
    vo_cam, frames, _ = vo_oracle()
    gates, vgates = VO_GATES["f32"], VIO_GATES

    # (a) the image path, before the IMU can initialize (0.4 s)
    with _no_tf32("f32"):
        builder = tracking_builder(cam, torch.float32, dev, identity_rectify=True,
                                   use_flash=True, imu=imu)
        for fn in counted.values():
            fn.launches = 0
        rows = []
        for i in range(len(frames)):
            before = {k: fn.launches for k, fn in counted.items()}
            n_kf = len(builder.map.keyframe_ids)
            batch = imu_batch(rec["a_imu_t"], rec["a_imu_gyr"], rec["a_imu_acc"],
                              *rec["a_imu_slices"][i])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = builder.add_input(float(rec["a_frame_t"][i]), frames[i][0], frames[i][1],
                                      batch)
            torch.cuda.synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3,
                         {k: fn.launches - before[k] for k, fn in counted.items()},
                         len(builder.map.keyframe_ids) > n_kf, frame.Twc.copy()))
        totals = {k: fn.launches for k, fn in counted.items()}
    m = builder.map
    poses = np.stack([r[3] for r in rows])
    dt = float(np.abs(poses[:, :3, 3] - rec["a_Twc"][:, :3, 3]).max())
    dR = float(np.abs(poses[:, :3, :3] - rec["a_Twc"][:, :3, :3]).max())
    n_pts = sum(p.is_valid for p in m.mappoints.values())
    n_lns = sum(l.is_valid for l in m.maplines.values())
    pre_ids = [f for f in m.keyframe_ids if m.keyframes[f].preintegration is not None]
    pre_gap = max(_rel(torch.stack([getattr(m.keyframes[f].preintegration.state, key)
                                    for f in pre_ids]).double().cpu().numpy(),
                       rec["a_preint_" + key]) for key in ("dT", "dR", "dV", "dP"))
    note = (f"keyframes={m.keyframe_ids}(oracle {rec['a_keyframe_ids'].tolist()}) "
            f"max dt={dt:.2e}(<={gates['t']}) max dR={dR:.2e}(<={gates['R']}) "
            f"mappoints={n_pts}(oracle {int(rec['a_n_mappoints'])}) "
            f"maplines={n_lns}(oracle {int(rec['a_n_maplines'])}) "
            f"preintegration rel gap={pre_gap:.2e}(<={vgates['preint_rel']})")
    ok = (m.keyframe_ids == rec["a_keyframe_ids"].tolist() and dt <= gates["t"]
          and dR <= gates["R"] and not m.imu_initialized
          and pre_ids == rec["a_preint_ids"].tolist() and pre_gap <= vgates["preint_rel"]
          and abs(n_pts - int(rec["a_n_mappoints"])) <= gates["count_rel"] * rec["a_n_mappoints"]
          and abs(n_lns - int(rec["a_n_maplines"])) <= gates["count_rel"] * rec["a_n_maplines"])
    _require(ok, f"VIO (a) gates failed: {note}")
    tracked = [r for r in rows[1:] if not r[2]]
    _require(tracked and all(r[1] == FRAME_LAUNCHES for r in rows[1:]),
             f"VIO (a): a tracked frame launched {[r[1] for r in rows[1:]]}, "
             f"not {FRAME_LAUNCHES}")
    print(f"VIO (a) image path, f32, use_flash: {note}; VI tracked frame (before the IMU "
          f"initializes) ms={np.median([r[0] for r in tracked]):.3f} over {len(tracked)}; "
          f"frame launches={tracked[0][1]} run launches={totals}")

    # (b) the initialization stream, through track_features
    n = len(rec["b_frame_t"])
    kf_cfg = KeyframeConfig(min_init_stereo_feature=40, max_num_match=500,
                            tracking_point_rate=2.0)
    pose_only = counted["pose_only_fast"]
    solves, bas, inits, init_gns = [], [], [], []
    with _no_tf32("f32"):
        builder = MapBuilder(StreamCamera(rec["b_noise"]), None, IdMatcher(), kf_cfg,
                             device=dev, dtype=torch.float32)
        m = builder.map
        init_kf, rows = -1, []
        with _timed(windows, "_pose_only_fast_vi", solves), _timed(windows, "local_ba", bas), \
                _timed(m, "initialize_imu", inits), \
                _timed(windows, "imu_initialization", init_gns):
            pose_only.launches = 0
            for i in range(n):
                before, was_init = pose_only.launches, m.imu_initialized
                n_ba = len(bas)
                fl, fr, pairs = stream_frame(rec, i)
                batch = (imu_batch(rec["b_imu_t"], rec["b_imu_gyr"], rec["b_imu_acc"],
                                   *rec["b_imu_slices"][i]) if i else None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                builder.track_features(float(rec["b_frame_t"][i]), fl, fr, pairs,
                                       imu_batch=batch)
                torch.cuda.synchronize()
                rows.append(((time.perf_counter() - t0) * 1e3, pose_only.launches - before,
                             was_init, len(bas) > n_ba))
                if m.imu_initialized and init_kf < 0:
                    init_kf = m.keyframe_ids[-1]
            p_total = pose_only.launches
    traj = np.stack([T for _, T in builder.trajectory])
    dt = float(np.abs(traj[:, :3, 3] - rec["b_trajectory"][:, :3, 3]).max())
    dR = float(np.abs(traj[:, :3, :3] - rec["b_trajectory"][:, :3, :3]).max())
    kfs = [m.keyframes[f] for f in m.keyframe_ids]
    n_pts = sum(p.is_valid for p in m.mappoints.values())
    last = kfs[-1]
    speeds = [float(np.linalg.norm(k.velocity)) for k in kfs[-5:]]
    rel_t = []
    pos_of = {int(t): p for t, p in zip(np.rint(rec["b_frame_t"] * 1e3), rec["b_true_pos"])}
    for a, b in zip(kfs[-4:-1], kfs[-3:]):
        d_est = np.linalg.norm(b.Twc[:3, 3] - a.Twc[:3, 3])
        d_gt = np.linalg.norm(pos_of[int(round(b.timestamp * 1e3))]
                              - pos_of[int(round(a.timestamp * 1e3))])
        rel_t.append(abs(float(d_est - d_gt)))
    same_kf = m.keyframe_ids == rec["b_keyframe_ids"].tolist()
    kf_gap = {}
    if same_kf:
        kf_gap = {"Twc": float(np.abs(np.stack([k.Twc for k in kfs]) - rec["b_keyframe_Twc"]).max()),
                  "velocity": float(np.abs(np.stack([k.velocity for k in kfs])
                                           - rec["b_keyframe_velocity"]).max()),
                  "bg": float(np.abs(np.stack([k.bg for k in kfs]) - rec["b_keyframe_bg"]).max()),
                  "ba": float(np.abs(np.stack([k.ba for k in kfs]) - rec["b_keyframe_ba"]).max())}
    bg_err = float(np.abs(last.bg - rec["b_true_bg"]).max())
    note = (f"keyframes={len(m.keyframe_ids)} same as the oracle's: {same_kf}; "
            f"IMU initialized at keyframe {init_kf}(oracle {int(rec['b_init_keyframe'])}); "
            f"max dt={dt:.2e}(<={gates['t']}) max dR={dR:.2e}(<={gates['R']}); "
            f"keyframe gaps {({k: f'{v:.2e}' for k, v in kf_gap.items()})}; "
            f"mappoints={n_pts}(oracle {int(rec['b_n_mappoints'])}); "
            f"|bg - true|={bg_err:.2e}(<={vgates['bg']}) max speed={max(speeds):.3f}"
            f"(<{vgates['speed']}) max |d - d_true|={max(rel_t):.2e}(<{vgates['rel_t']}); "
            f"Rwg=I: {bool(np.array_equal(m.Rwg, np.eye(3)))}")
    ok = (same_kf and init_kf == int(rec["b_init_keyframe"]) and m.imu_initialized
          and dt <= gates["t"] and dR <= gates["R"] and bg_err <= vgates["bg"]
          and max(speeds) < vgates["speed"] and max(rel_t) < vgates["rel_t"]
          and abs(n_pts - int(rec["b_n_mappoints"])) <= gates["count_rel"] * rec["b_n_mappoints"])
    _require(ok, f"VIO (b) gates failed: {note}")
    # P: once per tracked frame while the IMU waits, never after
    before = [r for r in rows[1:] if not r[2]]
    after = [r for r in rows[1:] if r[2]]
    _require(all(r[1] == 1 for r in before) and after and all(r[1] == 0 for r in after)
             and p_total == len(before),
             f"VIO (b): kernel P launched {[r[1] for r in rows]} (before/after init)")
    _require(len(inits) >= 1 and inits[-1][1] is True and solves,
             f"VIO (b): initialize_imu ran {len(inits)} times, the F=2 solve {len(solves)}")
    solve_ms, ba_ms = [r[0] for r in solves], [r[0] for r in bas]
    n_vision = sum(1 for r in rows if r[3] and not r[2])  # local BAs before the IMU ran
    print(f"VIO (b) initialization stream, f32: {note}")
    print("VIO timings, wall ms (synchronized): tracked frame before init "
          f"{np.median([r[0] for r in before if not r[3]]):.3f}, after init "
          f"{np.median([r[0] for r in after if not r[3]]):.3f} (no image path); "
          f"F=2 solve {np.median(solve_ms):.3f} (n={len(solve_ms)}, first {solve_ms[0]:.1f}); "
          f"initialize_imu {inits[-1][0]:.1f} (its GN {init_gns[-1][0]:.1f}; attempts "
          f"{len(inits)}, the others {[round(r[0], 1) for r in inits[:-1]]}); local_ba vision "
          f"{np.median(ba_ms[1:n_vision]):.1f} (n={n_vision}, first {ba_ms[0]:.1f}), "
          f"VI {np.median(ba_ms[n_vision:]):.1f} (n={len(ba_ms) - n_vision}); "
          f"kernel P launches per tracked frame: {len(before)} frames before init 1 each, "
          f"{len(after)} after 0")
    # where the time goes: one call of each again under the profiler (the VI
    # frame's solve and the VI window, bottlenecks 1 and 2 of PERF.md
    # section 5; imu_initialization's and the vision window's profiles, 13 s
    # of the script, are left out since phase tools came in)
    with _no_tf32("f32"):
        for label, (_, _, args, kw), fn in (
                ("F=2 solve", solves[-1], windows._pose_only_fast_vi),
                ("local_ba VI", bas[-1], windows.local_ba)):
            n_k, dev_ms, wall, _ = _profile_call(lambda: fn(*args, **kw))
            print(f"VIO profile {label}: {n_k} kernels, device ms={dev_ms:.3f}, wall ms under "
                  f"the profiler={wall:.1f}, device busy share={dev_ms / wall:.4f}")
    return tracked[0][1]


def _refine_voc(m, device):
    """tests/test_refinement.py's vocabulary (k 6, depth 3, seed 1, every
    third descriptor) trained by the port on the map's descriptors."""
    from airslam_tpu_torch.loopclosure.vocabulary import train_vocabulary

    desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask]
                           for f in m.keyframe_ids])
    return train_vocabulary(desc[::3], k=6, depth=3, seed=1, device=device)


def refined_ate(m):
    """Keyframe position RMSE of a corridor map against the ground truth
    (``loop_trajectory``) carried into the map's frame by the first
    keyframe's pose (the builder starts at its initial pose, and every BA
    keeps the first keyframe fixed)."""
    truth = loop_trajectory()
    anchor = m.keyframes[m.keyframe_ids[0]].Twc @ np.linalg.inv(truth[m.keyframe_ids[0]])
    return _keyframe_rmse(m, {f: anchor @ truth[f] for f in m.keyframe_ids})


def _keyframe_rmse(m, ref):
    return float(np.sqrt(np.mean([np.sum((m.keyframes[f].Twc[:3, 3] - ref[f][:3, 3]) ** 2)
                                  for f in m.keyframe_ids])))


def _dense_sparse(path, dev):
    """Map (a) through the dense and the sparse global BA (auto table
    width), float32 on the card. Returns (keyframe gap, mappoint gap, dense
    ms, sparse ms)."""
    import torch

    from airslam_tpu_torch.io.serialization import load_map

    maps, ms = [], []
    for sparse in (False, True):
        m, _ = load_map(path, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sparse:
            frames = [m.keyframes[f] for f in reversed(m.keyframe_ids)]
            fixed = np.zeros(len(frames), bool)
            fixed[-1] = True
            m._sparse_global_ba(frames, fixed,
                                [p for p in m.mappoints.values() if p.is_valid and p.observers],
                                [l for l in m.maplines.values() if l.is_valid and l.observers],
                                50, 40)
        else:
            m.global_bundle_adjustment(iters1=50, iters2=40)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        maps.append(m)

    a, b = maps
    kf = max(float(np.abs(a.keyframes[f].Twc[:3, 3] - b.keyframes[f].Twc[:3, 3]).max())
             for f in a.keyframe_ids)
    mp = max(float(np.abs(a.mappoints[i].position - b.mappoints[i].position).max())
             for i in a.mappoints if a.mappoints[i].is_valid and b.mappoints[i].is_valid)
    return kf, mp, ms[0], ms[1]


def _pose_graph_chain(n, dev):
    """A 1,000-keyframe pose graph: a circle of radius 30 m with odometry
    edges measured with noise (seed 7) and ten loop edges, the first pose
    fixed, the chain integrated from the noisy odometry."""
    import torch

    from airslam_tpu_torch.backend import windows

    rng = np.random.RandomState(7)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    R = np.stack([_rodrigues(np.array([0.0, 0.0, a])) for a in th])
    t = np.stack([30 * np.cos(th), 30 * np.sin(th), np.zeros(n)], -1)
    ei = list(range(n - 1)) + [int(k) for k in rng.randint(0, n // 2, 10)]
    ej = list(range(1, n)) + [int(k) + n // 2 for k in rng.randint(0, n // 2, 10)]
    Rm = np.stack([R[a].T @ R[b] @ _rodrigues(rng.randn(3) * 1e-3) for a, b in zip(ei, ej)])
    tm = np.stack([R[a].T @ (t[b] - t[a]) + rng.randn(3) * 5e-3 for a, b in zip(ei, ej)])
    R0, t0 = [R[0]], [t[0]]
    for k in range(n - 1):  # dead reckoning from the noisy odometry
        R0.append(R0[-1] @ Rm[k])
        t0.append(t0[-1] + R0[-2] @ tm[k])

    def f(a):
        return torch.as_tensor(np.asarray(a), device=dev).float()

    fixed = np.zeros(n, bool)
    fixed[0] = True
    return windows.PoseGraphProblem(
        Rwb=f(np.stack(R0)), twb=f(np.stack(t0)), fixed=torch.as_tensor(fixed, device=dev),
        edge_i=torch.as_tensor(ei, device=dev), edge_j=torch.as_tensor(ej, device=dev),
        R_meas=f(Rm), t_meas=f(tm), mask=torch.ones(len(ei), dtype=torch.bool, device=dev))


def phase_refine(dev):
    """Stage 2 on the card, float32, against the stored JAX refiner
    (``tests/data/torch_refine_oracle.npz``). Returns (launch counts of the
    refinement CLI's run, kernel P's ms at the refinement's shapes)."""
    import copy
    import tempfile

    import torch

    from airslam_tpu_torch.backend import gn, global_ba as gba, pose_gn, windows
    from airslam_tpu_torch.io.serialization import load_map, save_map
    from airslam_tpu_torch.loopclosure.vocabulary import train_vocabulary
    from airslam_tpu_torch.pipelines.map_refiner import MapRefiner

    z = np.load(REFINE_ORACLE)
    g = REFINE_GATES
    counted = _counted()
    t_phase = time.perf_counter()

    # map (a), rebuilt by the port's builder on the CPU in float64, against
    # the JAX map's digest before any refinement
    t0 = time.perf_counter()
    m64, clean = corridor_map()
    build_s = time.perf_counter() - t0
    ids = m64.keyframe_ids
    _require(ids == z["a_kf_ids"].tolist(), f"refine: keyframes {ids}, JAX {z['a_kf_ids']}")
    d_kf = float(np.abs(np.stack([m64.keyframes[f].Twc for f in ids]) - z["a_kf_Twc"]).max())
    valid = sorted(i for i, p in m64.mappoints.items() if p.is_valid)
    _require(valid == z["a_mp_ids"].tolist(), "refine: the rebuilt map's mappoints differ")
    d_mp = float(np.abs(np.stack([m64.mappoints[i].position for i in valid])
                        - z["a_mp_pos"]).max())
    _require(max(d_kf, d_mp) <= g["digest"], f"refine: the rebuilt map is {d_kf:.2e} / "
             f"{d_mp:.2e} m off the JAX map")
    print(f"refine: map (a) rebuilt on the CPU in float64 in {build_s:.1f} s: {len(ids)} "
          f"keyframes, {len(valid)} mappoints, poses within {d_kf:.2e} m and mappoints within "
          f"{d_mp:.2e} m of the JAX map (gate {g['digest']})")

    with tempfile.TemporaryDirectory() as tmp:
        mapv0 = os.path.join(tmp, "AirSLAM_mapv0.bin")
        save_map(m64, mapv0)
        voc = _refine_voc(m64, dev)
        _require(np.array_equal(voc.weights.cpu().numpy(), z["a_voc_weights"]),
                 "refine: the vocabulary is not the JAX one")
        desc = np.concatenate([m64.keyframes[f].kp_desc for f in ids])
        flips = int((voc.transform(desc)[0] != _refine_voc(m64, "cpu").transform(desc)[0]).sum())
        _require(flips == 0, f"refine: {flips} word ids differ between the card and the CPU")

        # (a) the corridor loop, float32 on the card
        m, _ = load_map(mapv0, device=dev, dtype=torch.float32)
        refiner = MapRefiner(m, IdMatcher(), voc)
        for fn in counted.values():
            fn.launches = 0
        n_loops = refiner.run(pose_graph_min_mappoints=10 ** 9)
        launches_a = {k: fn.launches for k, fn in counted.items()}
        loops = [[l.query_id, l.loop_id] for l in refiner.loop_pairs]
        _require(loops == z["a_loop"].tolist(), f"refine (a): loops {loops}, JAX "
                 f"{z['a_loop'].tolist()}")
        dR = float(np.abs(np.stack([l.Rlq for l in refiner.loop_pairs]) - z["a_Rlq"]).max())
        dt = float(np.abs(np.stack([l.tlq for l in refiner.loop_pairs]) - z["a_tlq"]).max())
        _require(dR <= g["loop_R"] and dt <= g["loop_t"],
                 f"refine (a): loop transforms {dR:.2e} / {dt:.2e} m off")
        merged = [refiner.n_merged_mappoints, refiner.n_merged_maplines]
        _require(merged == z["a_n_merged"].tolist(), f"refine (a): merged {merged}, JAX "
                 f"{z['a_n_merged'].tolist()}")
        Twc = np.stack([m.keyframes[f].Twc for f in m.keyframe_ids])
        pt = float(np.abs(Twc[:, :3, 3] - z["a_refined_Twc"][:, :3, 3]).max())
        pR = float(np.abs(Twc[:, :3, :3] - z["a_refined_Twc"][:, :3, :3]).max())
        ate = refined_ate(m)
        _require(pt <= g["pose_t"] and pR <= g["pose_R"] and ate <= g["ate"],
                 f"refine (a): refined poses {pt:.2e} m / {pR:.2e}, ATE {ate:.3e} m")
        n_p = launches_a["pose_only_fast"]
        _require(n_p == int(z["a_n_pose_only"]) == refiner.n_pose_only,
                 f"refine (a): kernel P launched {n_p} times, the JAX refiner solved "
                 f"{int(z['a_n_pose_only'])}")
        print(f"refine (a) f32: loops {loops} (JAX equal) Rlq within {dR:.2e} tlq within "
              f"{dt:.2e} m; merged {merged} (JAX equal); refined keyframes within {pt:.2e} m / "
              f"{pR:.2e} of the JAX ones, ATE {ate:.4e} m (gate {g['ate']}); P launches {n_p} "
              f"(JAX pose-only solves {int(z['a_n_pose_only'])}); stage ms "
              + " ".join(f"{k}={v:.1f}" for k, v in refiner.stage_ms.items()))

        # (b) the drifted map, pose graph on
        m, _ = load_map(mapv0, device=dev, dtype=torch.float32)
        m.apply_pose_corrections({f: drift_T(k / (len(ids) - 1)) @ m.keyframes[f].Twc
                                  for k, f in enumerate(ids)})
        ate_b = [_keyframe_rmse(m, clean)]
        corrections = {}
        apply = m.apply_pose_corrections

        def record(c):
            corrections.update(c)
            apply(c)
            ate_b.append(_keyframe_rmse(m, clean))

        m.apply_pose_corrections = record
        refiner_b = MapRefiner(m, IdMatcher(), voc)
        p0 = counted["pose_only_fast"].launches
        refiner_b.run(pose_graph_min_mappoints=1)
        ate_b.append(_keyframe_rmse(m, clean))
        loops_b = [[l.query_id, l.loop_id] for l in refiner_b.loop_pairs]
        _require(refiner_b.pose_graph_ran and loops_b == z["b_loop"].tolist(),
                 f"refine (b): pose graph ran {refiner_b.pose_graph_ran}, loops {loops_b}")
        dc = float(np.abs(np.stack([corrections[f] for f in ids]) - z["b_corrections"]).max())
        _require(dc <= g["correction"], f"refine (b): corrections {dc:.2e} off the JAX ones")
        _require(ate_b[2] < 0.25 * ate_b[0] and ate_b[2] < 0.03,
                 f"refine (b): ATE {ate_b[0]:.3e} -> {ate_b[2]:.3e} m")
        n_pb = counted["pose_only_fast"].launches - p0
        _require(n_pb == int(z["b_n_pose_only"]), f"refine (b): P launched {n_pb} times")
        print(f"refine (b) f32: loops {loops_b}; pose-graph corrections within {dc:.2e} of the "
              f"JAX ones (gate {g['correction']}); ATE before / after the pose graph / after the "
              f"run {ate_b[0]:.4e} / {ate_b[1]:.4e} / {ate_b[2]:.4e} m (JAX "
              + " / ".join(f"{v:.4e}" for v in z["b_ate"]) + f"); P launches {n_pb}; stage ms "
              + " ".join(f"{k}={v:.1f}" for k, v in refiner_b.stage_ms.items()))

        # dense against sparse global BA on map (a), float32
        kf_gap, mp_gap, dense_ms, sparse_ms = _dense_sparse(mapv0, dev)
        jkf, jmp = (float(v) for v in z["c_gap_f32"])
        lim_kf, lim_mp = (g["gap_factor"] * v + g["gap_add"] for v in (jkf, jmp))
        _require(kf_gap <= lim_kf and mp_gap <= lim_mp,
                 f"refine: dense vs sparse global BA {kf_gap:.3e} / {mp_gap:.3e} m apart "
                 f"(limits {lim_kf:.3e} / {lim_mp:.3e})")
        print(f"refine: dense vs sparse global BA (50 + 40, f32): keyframes {kf_gap:.3e} m, "
              f"mappoints {mp_gap:.3e} m apart (JAX f32 {jkf:.3e} / {jmp:.3e}; limits "
              f"{lim_kf:.3e} / {lim_mp:.3e}); dense {dense_ms:.1f} ms, sparse "
              f"{sparse_ms:.1f} ms")

        # the refinement CLI with the fused attention: the entry point a user
        # calls, on map (a)'s mapv0, against the JAX CLI's stored run
        sys.path.insert(0, os.path.join(REPO, "apps"))
        import map_refinement_torch

        voc_path = os.path.join(tmp, "voc.npz")
        train_vocabulary(np.concatenate([m64.keyframes[f].kp_desc[m64.keyframes[f].kp_mask]
                                         for f in ids]), k=10).save(voc_path)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _no_tf32("f32"):  # the CLI turns TF32 off; restored after it
            cli = map_refinement_torch.main([
                "--config_path", os.path.join(REPO, "configs", "map_refinement",
                                              "mr_euroc.yaml"),
                "--map_root", tmp, "--voc_path", voc_path, "--device", str(dev), "--use_flash"])
        cli_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        got = [len(cli.loop_pairs), cli.n_merged_mappoints, cli.n_merged_maplines]
        _require(got == z["e_counts"].tolist(), f"refine CLI: loops/merged {got}, JAX CLI "
                 f"{z['e_counts'].tolist()}")
        traj = np.loadtxt(os.path.join(tmp, "trajectory_v1.txt"))
        ct = float(np.abs(traj[:, 1:4] - z["e_traj_v1"][:, 1:4]).max())
        _require(ct <= g["cli_t"], f"refine CLI: trajectory_v1 {ct:.3e} m off the JAX CLI's")
        _require(launches["pose_only_fast"] == cli.n_pose_only > 0 and launches["flash_mha"] > 0,
                 f"refine CLI: launches {launches}, pose-only solves {cli.n_pose_only}")
        _require(os.path.exists(os.path.join(tmp, "AirSLAM_mapv1.bin")),
                 "refine CLI: no AirSLAM_mapv1.bin")
        back, dbs = load_map(os.path.join(tmp, "AirSLAM_mapv1.bin"), device=dev)
        _require("point" in dbs and back.keyframe_ids == ids, "refine CLI: mapv1 did not load")
        print(f"refine CLI (apps/map_refinement_torch.py --use_flash, f32): {cli_s:.1f} s wall; "
              f"loops/merged {got} (JAX CLI equal); trajectory_v1 within {ct:.3e} m of the JAX "
              f"CLI's; launches {launches}; stage ms "
              + " ".join(f"{k}={v:.1f}" for k, v in cli.stage_ms.items()))

    # the map-scale sparse BA: tests/test_global_ba.py's 1,000-keyframe scene
    intr = StreamCamera().intrinsics()
    cfg = gn.BAConfig()
    sc = map_scale_scene(*MAP_SCALE)
    t0 = time.perf_counter()
    prob = map_scale_problem(sc, torch.float32, dev)
    host_s = time.perf_counter() - t0
    twb_true = torch.as_tensor(sc["twb"], device=dev).float()
    with gn.full_f32():
        cost0 = float(gba._total_cost(prob, intr, cfg, False))
    err0 = float((prob.twb - twb_true).abs().mean())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = gba.optimize(prob, intr, cfg, iterations=3, robust=False, chunk=4096)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    with gn.full_f32():
        cost1 = float(gba._total_cost(out, intr, cfg, False))
    err1 = float((out.twb - twb_true).abs().mean())
    _require(cost1 < g["scale_cost"] * cost0 and err1 < g["scale_err"] * err0,
             f"refine map scale: cost {cost0:.4e} -> {cost1:.4e}, pose error {err0:.4e} -> "
             f"{err1:.4e} m")
    again = gba.optimize(prob, intr, cfg, iterations=3, robust=False, chunk=4096)
    rerun = float((again.twb - out.twb).abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gba.optimize(prob, intr, cfg, iterations=1, robust=False, chunk=4096)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3
    n_k, dev_ms, wall, top = _profile_call(
        lambda: gba.optimize(prob, intr, cfg, iterations=1, robust=False, chunk=4096))
    print(f"refine map scale (f32, {MAP_SCALE[0]} keyframes, {MAP_SCALE[1]} points, "
          f"{int(sc['ok'].sum())} of {len(sc['ok'])} observations valid, 3 LM iterations, "
          f"chunk 4096, table width 8): cost {cost0:.4e} -> {cost1:.4e} (gate < "
          f"{g['scale_cost']} of its start), mean pose error {err0:.4e} -> {err1:.4e} m (gate < "
          f"{g['scale_err']}); ms per iteration {first_ms:.1f} (first call) {iter_ms:.1f} "
          f"(warm); peak memory above the problem {peak:.0f} MiB; problem built on the host in "
          f"{host_s:.1f} s; two runs {rerun:.3e} apart; one iteration under the profiler: "
          f"{n_k} kernels, device {dev_ms:.1f} ms of {wall:.1f} ms wall (busy "
          f"{dev_ms / wall:.3f}), top kernels {top}")

    # the same scene cut to 100 keyframes and 10k points, against the JAX x64 solve
    sc = map_scale_scene(*REDUCED_SCENE)
    out = gba.optimize(map_scale_problem(sc, torch.float32, dev), intr, cfg, iterations=3,
                       robust=False, chunk=4096)
    rt = float(np.abs(out.twb.double().cpu().numpy() - z["d_twb"]).max())
    rp = float(np.abs(out.points.double().cpu().numpy() - z["d_points"]).max())
    _require(max(rt, rp) <= g["reduced"], f"refine reduced scene: {rt:.3e} / {rp:.3e} m off "
             "the JAX x64 solve")
    print(f"refine reduced scene {REDUCED_SCENE}: poses within {rt:.3e} m, points within "
          f"{rp:.3e} m of the JAX x64 solve (gate {g['reduced']})")

    # the pose graph at 1,000 keyframes
    pg = _pose_graph_chain(MAP_SCALE[0], dev)
    c0 = float(windows._pose_graph_cost(pg, pg.Rwb, pg.twb))
    windows.pose_graph_optimization(pg, iterations=2)  # first use of the solver's kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg_out = windows.pose_graph_optimization(pg, iterations=20)
    torch.cuda.synchronize()
    pg_ms = (time.perf_counter() - t0) * 1e3
    c1 = float(windows._pose_graph_cost(pg, pg_out.Rwb, pg_out.twb))
    _require(np.isfinite(c1) and c1 < c0, f"refine pose graph: cost {c0:.4e} -> {c1:.4e}")
    print(f"refine pose graph ({MAP_SCALE[0]} keyframes, {pg.edge_i.shape[0]} edges, 20 LM "
          f"iterations, f32): {pg_ms:.1f} ms, cost {c0:.4e} -> {c1:.4e}")

    # kernel P at the refinement's shapes against its plain version
    p_ms, report = {}, []
    for padded, matched in REFINE_P_SHAPES:
        problem, pintr, twb_true = refine_pose_problem(13, padded, matched, device=dev)
        got = pose_gn.pose_only_fast(problem, pintr, cfg)
        want = pose_gn.pose_only_fast_plain(problem, pintr, cfg)
        a = pose_agreement(got, want)
        pgate = POSE_GATES
        t_true = float(np.linalg.norm(got[0].frames.twb[0].double().cpu().numpy() - twb_true))
        _require(a["t"] <= pgate["t"] and a["R"] <= pgate["R"] and a["inlier_agree"]
                 >= pgate["inlier_agree"] and a["count_rel"] <= pgate["count_rel"]
                 and t_true < pgate["t_true"], f"kernel P at {padded} points: {a}, {t_true:.2e}")
        n_bytes, n_flops, chain = _pose_work(problem, 3, 10)
        bound, by = _bound_ms(n_bytes, n_flops)
        p_ms[padded] = _time_ms(lambda: pose_gn.pose_only_fast(problem, pintr, cfg), iters=20)
        plain = _eager_ms(lambda: pose_gn.pose_only_fast_plain(problem, pintr, cfg), iters=2,
                          warmup=1)
        report.append(f"{padded} points ({matched} matched): dt={a['t']:.2e} dR={a['R']:.2e} "
                      f"inlier_agree={a['inlier_agree']:.4f} t_true={t_true:.2e} "
                      f"ms={p_ms[padded]:.5f} plain_ms={plain:.3f}(eager) bound_ms={bound:.6f} "
                      f"({by})")
    print("kernel P at the refinement's shapes (1 masked line): " + "; ".join(report))
    print(f"refine: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, p_ms


def pnp_case(n=100, n_out=0, noise=0.0, seed=0):
    """tests/test_pnp.py's ``make_case`` in numpy alone (the same draws from
    the same seed): a known pose, ``n`` points in front of it, pixel noise
    and ``n_out`` gross outliers, padded to 128. Returns (intrinsics, Rcw,
    tcw, points, uv, mask, outlier indices or None)."""
    from airslam_tpu_torch.core.camera import Intrinsics

    rng = np.random.RandomState(seed)
    Rcw = _rodrigues(rng.randn(3) * 0.3)
    tcw = rng.randn(3) * 0.5 + [0, 0, 1.0]
    pw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(3, 10, n)], -1)
    pc = pw @ Rcw.T + tcw
    pw, pc = pw[pc[:, 2] > 0.5], pc[pc[:, 2] > 0.5]
    uv = np.stack([pc[:, 0] / pc[:, 2] * 450 + 376, pc[:, 1] / pc[:, 2] * 450 + 240], -1)
    if noise > 0:
        uv += rng.randn(*uv.shape) * noise
    idx = None
    if n_out:
        idx = rng.choice(len(uv), n_out, replace=False)
        uv[idx] += rng.uniform(80, 300, (n_out, 2)) * np.sign(rng.randn(n_out, 2))
    pts_p, uv_p, m = np.zeros((128, 3)), np.zeros((128, 2)), np.zeros(128, bool)
    k = min(len(uv), 128)
    pts_p[:k], uv_p[:k], m[:k] = pw[:k], uv[:k], True
    # tests/synthetic.default_intrinsics: fx = fy = 450, (376, 240), bf = 450 · 0.1
    return (Intrinsics(450.0, 450.0, 376.0, 240.0, 45.0), Rcw, tcw, pts_p, uv_p, m, idx)


# test_pnp.py's three cases: (make_case arguments, seed of the draws, valid
# entries kept)
PNP_CASES = {"exact": (dict(), 0, None),
             "outliers_and_noise": (dict(n_out=25, noise=0.5, seed=1), 1, None),
             "too_few_points": (dict(), 2, 5)}


def pnp_named(name):
    """(case, seed of the draws) of test_pnp.py's case ``name``, the mask cut
    to its first valid entries where the case keeps fewer than the minimal
    set."""
    kw, seed, keep = PNP_CASES[name]
    case = pnp_case(**kw)
    if keep is not None:
        case = case[:5] + (case[5] & (np.arange(len(case[5])) < keep),) + case[6:]
    return case, seed


def _pnp_check(name, R, t, inl, ok, case):
    """tests/test_pnp.py's assertions of case ``name``."""
    _, Rcw, tcw, _, _, m, out_idx = case
    if name == "too_few_points":
        return bool(np.isfinite(t).all())
    rot = float(np.arccos(np.clip((np.trace(R.T @ Rcw) - 1) / 2, -1, 1)))
    terr = float(np.abs(t - tcw).max())
    if name == "exact":
        return bool(ok) and terr < 1e-3 and rot < 1e-3 and int(inl.sum()) == int(m.sum())
    return bool(ok) and terr < 0.05 and rot < 0.01 and not inl[out_idx].any()


def phase_reloc(dev):
    """Stage 3 on the card, float32, against the stored JAX relocalizer
    (``tests/data/torch_reloc_oracle.npz``). Returns the launch counts of the
    relocalization CLI's run."""
    import dataclasses
    import tempfile

    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.backend import pnp
    from airslam_tpu_torch.frontend.detector import FeatureDetector
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io.config import SG_SINKHORN_ITERS, RelocalizationConfigs
    from airslam_tpu_torch.io.trajectory import load_tum
    from airslam_tpu_torch.loopclosure.database import Database
    from airslam_tpu_torch.ops import bilerp
    from airslam_tpu_torch.ops.attention import flash_mha, flash_mha_plain
    from airslam_tpu_torch.pipelines.map_user import MapUser

    t_phase = time.perf_counter()
    g = RELOC_GATES
    z = reloc_oracle()
    on = card()
    f32, bf = torch.float32, torch.bfloat16
    rng = np.random.RandomState(9)

    # loi_features with one view: the mono query's stage-1 head
    notes = []
    for map_dtype in (f32, bf):
        ops = loi_inputs(rng, 1, 512, 300, map_dtype, dev)
        for out_dtype in (f32, bf):
            got = bilerp.loi_features(*ops, out_dtype=out_dtype)
            want = bilerp.loi_features_plain(*ops, out_dtype=out_dtype)
            torch.cuda.synchronize()
            label = f"maps {str(map_dtype)[6:]} -> {str(out_dtype)[6:]}"
            _require(got.shape == want.shape == (1, 512, 496) and got.dtype == out_dtype,
                     f"reloc kernel LOI V=1 ({label}): output {tuple(got.shape)} {got.dtype}")
            err, tol, ok = loi_gate(got, want, ops[0])
            _require(ok, f"reloc kernel LOI V=1 ({label}): {err} > {tol}")
            notes.append(f"{label}: {err:.3e}" if out_dtype == f32 else f"{label}: {err} ulp")
    ops = loi_inputs(rng, 1, 512, 300, f32, dev)
    bound, by = _bound_ms(*_loi_work(ops, bilerp.loi_features(*ops)))
    print("reloc kernel LOI V=1 (1 view, 512 lines, 300 junctions): " + "; ".join(notes)
          + f"; f32 ms={_time_ms(lambda: bilerp.loi_features(*ops)):.5f} "
          f"eager_ms={_eager_ms(lambda: bilerp.loi_features(*ops)):.5f} "
          f"plain_ms={_time_ms(lambda: bilerp.loi_features_plain(*ops)):.5f} "
          f"bound_ms={bound:.6f} ({by}) library_ms={loi_library_ms(ops):.5f} (F.grid_sample "
          f"at the same samples, 3 calls) (phase l's gates) on {on}")

    # kernel F at the top-3 batch and matcher recovery's batch of up to 8
    for batch in RELOC_F_BATCHES:
        for label, dtype, size in (("f32", f32, 4), ("bf16", bf, 2)):
            q, k, v, mask = _attention_inputs(rng, (batch,), 4, 400, 400, 64, dtype, dtype, dev,
                                              388)
            got = flash_mha(q, k, v, mask)
            again = flash_mha(q, k, v, mask)
            want = flash_mha_plain(q, k, v, mask)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = (FLASH_GATES["f32"] if label == "f32"
                   else FLASH_GATES["bf16_rel"] * float(want.float().abs().max()))
            _require(torch.equal(got, again) and err <= tol,
                     f"reloc kernel F ({batch}, 4, 400, 64) {label}: {err:.3e} > {tol:.3e} or "
                     "two runs differ")
            bias = mask[:, None, None, :]
            bound, by = flash_attention_bound(batch, 4, 400, 400, 64, size)
            print(f"reloc kernel F {label} ({batch}, 4, 400, 64): err={err:.2e} (gate "
                  f"{tol:.2e}) ms={_time_ms(lambda: flash_mha(q, k, v, mask)):.5f} "
                  f"eager_ms={_eager_ms(lambda: flash_mha(q, k, v, mask)):.5f} "
                  f"plain_ms={_time_ms(lambda: flash_mha_plain(q, k, v, mask)):.5f} "
                  f"sdpa_ms={_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)):.5f} "
                  f"bound_ms={bound:.6f} ({by}) on {on}")

    # the relocalization CLI with the fused attention on the stored map
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import relocalization_torch

    counted = _counted()
    stages = {"detect": [], "match": [], "pnp": [], "refine": [], "bow": [], "recover": [],
              "junction_score": []}
    with tempfile.TemporaryDirectory() as tmp:
        map_root, qdir, names = write_reloc_tree(z, tmp)
        traj_path = os.path.join(tmp, "reloc.txt")
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _no_tf32("f32"), _timed(FeatureDetector, "detect", stages["detect"]), \
                _timed(PointMatcher, "matching_points_batched", stages["match"]), \
                _timed(MapUser, "_solve_pnp", stages["pnp"]), \
                _timed(MapUser, "_refine_pose", stages["refine"]), \
                _timed(Database, "frame_to_bow", stages["bow"]), \
                _timed(MapUser, "_recover_matches", stages["recover"]), \
                _timed(MapUser, "_junction_score", stages["junction_score"]):
            _, records = relocalization_torch.main([
                "--config_path", os.path.join(REPO, "configs", "relocalization",
                                              "reloc_euroc.yaml"),
                "--map_root", map_root, "--query_folder", qdir, "--traj_path", traj_path,
                "--device", str(dev), "--use_flash", "--diagnose"])
        cli_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        traj = load_tum(traj_path)
        gt = load_tum(os.path.join(tmp, "gt_tum.txt"))
        np.savetxt(os.path.join(tmp, "jax.txt"), z["cli_traj"], fmt="%.9f")
        jax_traj = load_tum(os.path.join(tmp, "jax.txt"))
    _require([r[0] for r in records] == names, f"reloc CLI: queries {[r[0] for r in records]}")
    ok = np.asarray([bool(r[1]) for r in records])
    recall, jax_recall = float(ok.mean()), float(np.asarray(z["ok"]).mean())
    ate, n_pairs = reloc_ate(traj, gt)
    jax_ate, _ = reloc_ate(jax_traj, gt)
    both = [i for i in range(len(names)) if ok[i] and bool(z["ok"][i])]
    dt = max((float(np.abs(records[i][2][:3, 3] - z["Twc"][i][:3, 3]).max()) for i in both),
             default=0.0)
    dR = max((float(np.abs(records[i][2][:3, :3] - z["Twc"][i][:3, :3]).max()) for i in both),
             default=0.0)
    _require(recall >= g["recall"] and recall >= jax_recall - g["recall_drop"],
             f"reloc CLI: recall {recall} (JAX {jax_recall})")
    _require(n_pairs == int(ok.sum()) and ate <= g["ate"],
             f"reloc CLI: ATE {ate:.4e} m over {n_pairs} poses")
    _require(dt <= g["pose_t"] and dR <= g["pose_R"],
             f"reloc CLI: poses {dt:.3e} m / {dR:.3e} off the JAX run's")
    n_match, n_refine = len(stages["match"]), len(stages["refine"])
    want_launches = {"remap": 0, "bilerp_points": 0, "bilerp_points_t": 0,
                     "loi_features": len(records), "flash_mha": 36 * n_match,
                     "pose_only_fast": n_refine, "loi_features_backward": 0}
    _require(launches == want_launches and n_refine > 0 and n_match >= len(records),
             f"reloc CLI: launches {launches}, expected {want_launches}")
    per_query = [r[4] for r in records]

    def ms(name):
        v = [s[0] for s in stages[name]]
        return f"{name}={np.median(v):.2f} ms (x{len(v)}, {sum(v) / len(records):.2f} per query)"

    # ms per query (after the first) that no timed stage covers: retrieval,
    # grouping and the match bookkeeping on the host
    rest = np.median(per_query[1:]) - sum(np.median([s[0] for s in v]) * len(v) / len(records)
                                          for v in stages.values())

    print(f"reloc CLI (apps/relocalization_torch.py --use_flash, f32): {cli_s:.1f} s wall with "
          f"the model loads; recall {recall:.3f} (JAX {jax_recall:.3f}, gates >= {g['recall']} "
          f"and >= JAX - {g['recall_drop']}); ATE {ate:.5f} m over {n_pairs} poses (gate "
          f"{g['ate']}; the JAX CLI's {jax_ate:.5f} m); {len(both)} queries both "
          f"accept within {dt:.3e} m / {dR:.3e} of the JAX poses (gates {g['pose_t']} / "
          f"{g['pose_R']}); launches {launches} ({n_match} LightGlue calls, {n_refine} pose "
          f"refinements); ms per query first {per_query[0]:.1f} median "
          f"{np.median(per_query[1:]):.1f}; per stage, median per call: "
          + ", ".join(ms(k) for k in stages) + f"; the rest about {rest:.1f} ms a query; "
          f"on {on}")

    # SuperGlue behind the port's detector on the frontend oracle's pairs
    cfg = RelocalizationConfigs.load(os.path.join(REPO, "configs", "relocalization",
                                                  "reloc_euroc.yaml"))
    det = FeatureDetector(dataclasses.replace(cfg.detector, dtype=f32), device=dev)
    sg = PointMatcher(dataclasses.replace(cfg.matcher, matcher=1, dtype=f32,
                                          sinkhorn_iterations=SG_SINKHORN_ITERS), device=dev)
    with _no_tf32("f32"):
        agree, n_port, n_jax = superglue_agreement(z, det, sg)
        frames, _ = oracle_pairs()
        f = det.detect(frames[0])
        views = [type(f)(*(t[v] for t in f)) for v in (0, 1)]
        sg_ms = _eager_ms(lambda: sg.matching_points(*views), iters=10, warmup=2)
    count_rel = abs(n_port - n_jax) / max(n_jax, 1)
    _require(np.mean(agree) >= g["sg_agree"] and count_rel <= g["sg_count"],
             f"reloc SuperGlue: agreement {agree}, count delta {count_rel:.4f}")
    print(f"reloc SuperGlue (matcher 1, Sinkhorn {SG_SINKHORN_ITERS}, f32, behind the port's "
          "detector): agreement " + " ".join(f"{a:.4f}" for a in agree)
          + f" (gate mean >= {g['sg_agree']}), matches {n_port} against JAX {n_jax} (delta "
          f"{count_rel:.4f}, gate <= {g['sg_count']}); ms per pair {sg_ms:.3f} on {on}")

    # the device PnP: tests/test_pnp.py's cases, then the same draws on the
    # CPU and the card in float64
    report = []
    for name in PNP_CASES:
        case, seed = pnp_named(name)
        intr, _, _, pts, uv, mask, _ = case
        t = [torch.as_tensor(a, device=dev) for a in (pts, uv, mask)]
        gen = torch.Generator(device=dev).manual_seed(seed)
        R, tt, inl, okp = pnp.solve_pnp_ransac(*t, intr, generator=gen)
        _require(_pnp_check(name, R.cpu().numpy(), tt.cpu().numpy(), inl.cpu().numpy(),
                            bool(okp), case), f"reloc device PnP ({name}) misses test_pnp.py")
        samples = pnp.draw_samples(torch.as_tensor(mask), 128,
                                   torch.Generator().manual_seed(seed))
        on_card = pnp.solve_pnp_ransac(*t, intr, samples=samples)
        on_cpu = pnp.solve_pnp_ransac(*(torch.as_tensor(a) for a in (pts, uv, mask)), intr,
                                      samples=samples)
        gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card[:2], on_cpu[:2]))
        # five valid points leave the DLT's null space more than one
        # dimension: there the two SVDs may pick different vectors
        _require(name == "too_few_points" or (gap <= 1e-6 and torch.equal(on_card[2].cpu(),
                                                                         on_cpu[2])),
                 f"reloc device PnP ({name}): card and CPU {gap:.3e} apart")
        t32 = [x.float() if x.is_floating_point() else x for x in t]
        gen = torch.Generator(device=dev)
        report.append(f"{name}: ok={bool(okp)} card/CPU f64 gap {gap:.2e} ms f32 "
                      f"{_eager_ms(lambda: pnp.solve_pnp_ransac(*t32, intr, generator=gen), iters=20, warmup=3):.3f}")
    print("reloc device PnP (test_pnp.py's cases and tolerances; 128 hypotheses, 5 GN steps): "
          + "; ".join(report) + f" on {on}")
    print(f"reloc: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def e2e_oracle():
    return np.load(E2E_ORACLE)


def _grey_gap(a, b):
    """(largest difference of two 8-bit images in grey levels, share of the
    pixels that differ)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _ate_between(est, ref):
    """Unaligned ATE of two runs of one sequence ([(t, Twc)] each, both in
    the first keyframe's frame) over their common stamps
    (scripts/verify_tpu_e2e.py's ``_ate_between``). Returns (m, poses)."""
    from airslam_tpu_torch.io.trajectory import ate_rmse

    a = {round(t, 6): T for t, T in est}
    b = {round(t, 6): T for t, T in ref}
    common = sorted(set(a) & set(b))
    if len(common) < 3:
        return float("inf"), len(common)
    return ate_rmse([(t, a[t]) for t in common], [(t, b[t]) for t in common], align=False), \
        len(common)


def _m(metres):
    return "lost" if metres is None else f"{metres:.5f} m"


def _tum_rows(rows):
    """[(t, Twc)] of (N, ≥4) rows t, x, y, z (an identity rotation: the
    runs are compared on positions)."""
    out = []
    for r in rows:
        T = np.eye(4)
        T[:3, 3] = r[1:4]
        out.append((float(r[0]), T))
    return out


def phase_synth(dev, root):
    """The card's render of the oracle's world: both sequences written by
    ``apps/make_synth_dataset_torch.py`` into ``root`` and held to the JAX
    PNGs of frames 0 and 19 and the JAX ground truth; ms per rendered stereo
    pair. Returns {sequence: mav0}."""
    import cv2
    import torch

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import benchmark_system_torch as bench
    import make_synth_dataset_torch as msd

    z = e2e_oracle()
    on = card()
    g, r = E2E_GATES, E2E_RUN
    trees, notes = {}, []
    for name in E2E_CAMERAS:
        extra = ["--distort_camera", os.path.join(REPO, E2E_CAMERAS[name])] if name == "dist" else []
        t0 = time.perf_counter()
        trees[name] = msd.main(["--out", os.path.join(root, name), "--frames", str(r["frames"]),
                                "--stride", str(r["stride"]), "--traj", r["traj"], "--world",
                                E2E_ORACLE, "--device", str(dev)] + extra)
        wall = time.perf_counter() - t0
        gt = np.loadtxt(os.path.join(trees[name], "state_groundtruth_estimate0", "data.csv"),
                        delimiter=",", ndmin=2)
        _require(np.array_equal(gt, z[f"{name}_gt"]), f"synth {name}: the ground truth differs")
        for cam in ("cam0", "cam1"):
            files = sorted(os.listdir(os.path.join(trees[name], cam, "data")))
            for i in (0, 19):
                want = cv2.imdecode(z[f"{name}_{cam}_{i}_png"], cv2.IMREAD_UNCHANGED)
                got = cv2.imread(os.path.join(trees[name], cam, "data", files[i]),
                                 cv2.IMREAD_UNCHANGED)
                gap, share = _grey_gap(got, want)
                _require(gap <= g["png_levels"] and share <= g["png_share"],
                         f"synth {name} {cam} frame {i}: {gap} grey levels on {share:.2e} of "
                         "the pixels off the JAX render")
                notes.append(f"{name} {cam}[{i}] {gap}/{share:.1e}")
        notes.append(f"{name} tree {wall:.2f} s")
    # the render alone: the 40-frame sequence, 8 frames (16 views) per call
    draws = bench.load_world(E2E_ORACLE, r["frames"], HEIGHT, WIDTH, device=dev)

    def render():
        bench.make_sequence(r["frames"], HEIGHT, WIDTH, draws, stride=r["stride"],
                            traj=r["traj"])

    render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render()
    host_ms = (time.perf_counter() - t0) * 1e3 / r["frames"]
    from airslam_tpu_torch.frontend import synthgen

    eye = torch.eye(3, device=dev).expand(16, 3, 3)
    tcw = torch.zeros(16, 3, device=dev)
    noise = draws["noise"][:8].reshape(16, HEIGHT, WIDTH)
    dev_ms = _eager_ms(lambda: synthgen.render_view3d(draws["world"], eye, tcw, 450.0, 450.0,
                                                       376.0, 240.0, HEIGHT, WIDTH, noise=noise),
                       iters=10, warmup=2) / 8
    print(f"synth: the card's render of the JAX world against the JAX PNGs (max grey levels / "
          f"share of pixels that differ; gates {g['png_levels']} / {g['png_share']}): "
          + "; ".join(notes) + f"; ms per stereo pair at {WIDTH}x{HEIGHT}: {dev_ms:.3f} "
          f"(render_view3d, 8 pairs per call, CUDA events), {host_ms:.3f} (make_sequence, "
          f"the host copy included) on {on}")
    return trees


def phase_e2e(dev, trees, root):
    """ROADMAP A.1: ``apps/visual_odometry_torch.py`` over the first 20
    frames of the rendered trees, f32 and bf16 (``--use_flash``) rectified
    and f32 distorted, against the JAX VO CLI's runs and the ground truth.
    Returns each run's launch counts."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import evaluate_torch
    import visual_odometry_torch

    from airslam_tpu_torch.io.serialization import load_map
    from airslam_tpu_torch.io.trajectory import load_tum

    z = e2e_oracle()
    on = card()
    g, n = E2E_GATES, E2E_RUN["run"]
    counted = _counted()
    launches = {}
    for label, (seq, extra) in E2E_RUNS.items():
        out = os.path.join(root, "vo " + label)
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _no_tf32("f32"):  # the CLI turns TF32 off; restored after it
            visual_odometry_torch.main([
                "--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
                "--camera_config_path", os.path.join(REPO, E2E_CAMERAS[seq]), "--dataroot",
                trees[seq], "--saving_dir", out, "--max_frames", str(n), "--device", str(dev)]
                + extra)
        wall = time.perf_counter() - t0
        launches[label] = {k: fn.launches for k, fn in counted.items()}
        m, _ = load_map(os.path.join(out, "AirSLAM_mapv0.bin"), device=dev)
        traj = load_tum(os.path.join(out, "trajectory_v0.txt"))
        jax_ids = [int(k) for k in z[f"{seq}_keyframe_ids"]]
        gt = _tum_rows(np.column_stack([z[f"{seq}_gt"][:, 0] * 1e-9, z[f"{seq}_gt"][:, 1:4]]))
        gap, n_common = _ate_between(traj, _tum_rows(z[f"{seq}_traj"]))
        ate, n_gt = evaluate_torch.evaluate(traj, gt)
        jax_ate, _ = evaluate_torch.evaluate(_tum_rows(z[f"{seq}_traj"]), gt)
        want = {"remap": n if seq == "dist" else 0, "bilerp_points": 0, "bilerp_points_t": 0,
                "loi_features": n, "pose_only_fast": n - 1,
                "flash_mha": 36 * n if "--use_flash" in extra else 0, "loi_features_backward": 0}
        note = (f"keyframes {m.keyframe_ids} (JAX {jax_ids}); {len(traj)} of {n} frames; "
                f"unaligned ATE to the JAX CLI {gap:.5f} m over {n_common} poses; aligned ATE "
                f"{_m(ate)} over {n_gt} poses (the JAX CLI's {_m(jax_ate)}); mappoints "
                f"{sum(p.is_valid for p in m.mappoints.values())} (JAX "
                f"{int(z[f'{seq}_n_mappoints'])}), maplines "
                f"{sum(l.is_valid for l in m.maplines.values())} (JAX "
                f"{int(z[f'{seq}_n_maplines'])}); launches {launches[label]}")
        _require(len(traj) == n and n_common == n, f"e2e {label}: {note}")
        _require(launches[label] == want, f"e2e {label}: launches {launches[label]}, not {want}")
        _require(gap <= g["traj"] and ate is not None and ate <= g["ate"],
                 f"e2e {label} (gates {g['traj']} m to the JAX CLI, {g['ate']} m ATE): {note}")
        if label == "bf16":
            _require(abs(len(m.keyframe_ids) - len(jax_ids)) <= g["kf_delta"],
                     f"e2e bf16: keyframe count delta above {g['kf_delta']}: {note}")
        else:
            parted = next((f for f in range(n) if (f in m.keyframe_ids) != (f in jax_ids)), None)
            _require(parted is None, f"e2e {label}: the keyframe decisions part at frame "
                                     f"{parted}: {note}")
        print(f"e2e {label} (apps/visual_odometry_torch.py {' '.join(extra)}, {seq}): {note}; "
              f"{wall:.1f} s wall with the model loads, {1e3 * wall / n:.1f} ms a frame, on {on}")
    return launches


def write_stage2_tree(z, root):
    """The JAX VO CLI's mapv0 of the whole rendered loop and the point
    vocabulary the JAX refinement CLI trained on it, as those CLIs left them:
    ``root/AirSLAM_mapv0.bin`` and ``root/point_voc_shared.npz``. Returns
    (map root, vocabulary path)."""
    import lzma

    os.makedirs(root, exist_ok=True)
    voc = os.path.join(root, "point_voc_shared.npz")
    for path, data in ((os.path.join(root, "AirSLAM_mapv0.bin"),
                        lzma.decompress(z["full_mapv0_xz"].tobytes())),
                       (voc, z["s2_point_voc"].tobytes())):
        with open(path, "wb") as f:
            f.write(data)
    return root, voc


def stage2_truth(z):
    """The rectified loop's ground truth as [(t, Twc)] (positions only)."""
    gt = z["rect_gt"]
    return _tum_rows(np.column_stack([gt[:, 0] * 1e-9, gt[:, 1:4]]))


def stage2_gaps(z, refiner, traj):
    """The port's refinement of the stored JAX mapv0 (``refiner`` and its
    ``trajectory_v1`` as [(t, Twc)]) against the JAX refinement CLI's run:
    the loop pairs and their largest Rlq / tlq gaps, the merged counts, the
    refined keyframes' largest position (m) and rotation-entry gaps, and
    both runs' Sim(3)-aligned ATE to the truth."""
    from airslam_tpu_torch.io.trajectory import load_tum

    loops = [[lp.query_id, lp.loop_id] for lp in refiner.loop_pairs]
    g = {"loops": loops, "jax_loops": z["s2_loop"].tolist(),
         "merged": [refiner.n_merged_mappoints, refiner.n_merged_maplines],
         "jax_merged": z["s2_n_merged"].tolist(), "loop_R": float("inf"),
         "loop_t": float("inf"), "pose_t": float("inf"), "pose_R": float("inf")}
    if loops == g["jax_loops"]:
        g["loop_R"] = max((float(np.abs(np.asarray(lp.Rlq) - R).max())
                           for lp, R in zip(refiner.loop_pairs, z["s2_Rlq"])), default=0.0)
        g["loop_t"] = max((float(np.abs(np.asarray(lp.tlq) - t).max())
                           for lp, t in zip(refiner.loop_pairs, z["s2_tlq"])), default=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        np.savetxt(os.path.join(tmp, "jax.txt"), z["s2_traj_v1"], fmt="%.9f")
        jax = load_tum(os.path.join(tmp, "jax.txt"))
    if [round(t, 6) for t, _ in traj] == [round(t, 6) for t, _ in jax]:
        g["pose_t"] = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for (_, a), (_, b)
                          in zip(traj, jax))
        g["pose_R"] = max(float(np.abs(a[:3, :3] - b[:3, :3]).max()) for (_, a), (_, b)
                          in zip(traj, jax))
    truth = stage2_truth(z)
    g["ate"], g["n_ate"] = reloc_ate(traj, truth)
    g["jax_ate"], _ = reloc_ate(jax, truth)
    g["keyframes"] = len(traj)
    return g


def stage2_failures(g):
    """The REFINE_GATES that the gaps of :func:`stage2_gaps` miss."""
    r = REFINE_GATES
    bad = []
    if g["loops"] != g["jax_loops"]:
        bad.append(f"loops {g['loops']}, JAX {g['jax_loops']}")
    if not (g["loop_R"] <= r["loop_R"] and g["loop_t"] <= r["loop_t"]):
        bad.append(f"loop transforms {g['loop_R']:.2e} / {g['loop_t']:.2e} m off")
    if g["merged"] != g["jax_merged"]:
        bad.append(f"merged {g['merged']}, JAX {g['jax_merged']}")
    if not (g["pose_t"] <= r["pose_t"] and g["pose_R"] <= r["pose_R"]):
        bad.append(f"refined keyframes {g['pose_t']:.2e} m / {g['pose_R']:.2e} off")
    if not g["ate"] <= r["ate"]:
        bad.append(f"ATE to the truth {g['ate']:.4e} m")
    return bad


def _launch_note(launches):
    return " ".join(f"{k}={v}" for k, v in launches.items() if v)


def phase_stage2(dev, trees, root):
    """Stage 2 against the JAX refinement CLI on the rendered loop, then the
    port's three CLIs chained over it against the truth (ROADMAP A.1).
    Returns the launch counts of each run."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import map_refinement_torch
    import relocalization_torch
    import visual_odometry_torch

    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io.serialization import load_map
    from airslam_tpu_torch.io.trajectory import load_tum
    from airslam_tpu_torch.pipelines.map_user import MapUser

    t_phase = time.perf_counter()
    z, zr = e2e_oracle(), reloc_oracle()
    on = card()
    counted = _counted()
    launches = {}
    mr_cfg = os.path.join(REPO, "configs", "map_refinement", "mr_euroc.yaml")

    def refine(map_root, extra, label):
        """The refinement CLI in this process, its launches held to the
        refiner's pose-only solves and LightGlue calls. Returns (refiner,
        trajectory_v1, seconds, LightGlue calls)."""
        calls = []
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _no_tf32("f32"), _timed(PointMatcher, "matching_points_batched", calls):
            r = map_refinement_torch.main(["--config_path", mr_cfg, "--map_root", map_root,
                                           "--device", str(dev)] + extra)
        wall = time.perf_counter() - t0
        launches[label] = {k: fn.launches for k, fn in counted.items()}
        want = {"remap": 0, "bilerp_points": 0, "bilerp_points_t": 0, "loi_features": 0,
                "pose_only_fast": r.n_pose_only,
                "flash_mha": 36 * len(calls) if "--use_flash" in extra else 0,
                "loi_features_backward": 0}
        _require(launches[label] == want, f"{label}: launches {launches[label]}, "
                                          f"expected {want}")
        return r, load_tum(os.path.join(map_root, "trajectory_v1.txt")), wall, len(calls)

    # (1) the refinement CLI on the stored JAX mapv0 and vocabulary, f32
    for label, extra in STAGE2_REFINE_RUNS.items():
        map_root, voc = write_stage2_tree(z, os.path.join(root, label))
        r, traj, wall, n_lg = refine(map_root, ["--voc_path", voc] + extra, label)
        g = stage2_gaps(z, r, traj)
        bad = stage2_failures(g)
        _require(not bad, f"{label}: " + "; ".join(bad))
        print(f"{label} (apps/map_refinement_torch.py {' '.join(extra)} on the JAX "
              f"mapv0 of {len(z['full_keyframe_ids'])} keyframes with the JAX CLI's point "
              f"vocabulary, f32): loops {g['loops']} (JAX equal), Rlq within "
              f"{g['loop_R']:.2e}, tlq within {g['loop_t']:.2e} m (gates {REFINE_GATES['loop_R']}"
              f" / {REFINE_GATES['loop_t']}); merged {g['merged']} (JAX equal); refined "
              f"keyframes within {g['pose_t']:.2e} m / {g['pose_R']:.2e} of the JAX CLI's "
              f"(gates {REFINE_GATES['pose_t']} / {REFINE_GATES['pose_R']}); aligned ATE to the "
              f"truth {g['ate']:.5f} m over {g['n_ate']} keyframes (gate {REFINE_GATES['ate']}; "
              f"the JAX CLI's {g['jax_ate']:.5f} m); {wall:.1f} s wall; P {r.n_pose_only} and F "
              f"{launches[label]['flash_mha']} launches ({n_lg} LightGlue calls); stage ms "
              + " ".join(f"{k}={v:.1f}" for k, v in r.stage_ms.items()) + f" on {on}")

    # (2) the port's own chain: VO over every frame, refinement with its own
    # vocabulary, relocalization of the ten hard queries
    n = E2E_RUN["frames"]
    vo_out = os.path.join(root, "chain vo")
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with _no_tf32("f32"):
        visual_odometry_torch.main([
            "--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
            "--camera_config_path", os.path.join(REPO, E2E_CAMERAS["rect"]), "--dataroot",
            trees["rect"], "--saving_dir", vo_out, "--device", str(dev), "--dtype", "f32"])
    vo_s = time.perf_counter() - t0
    launches["chain vo"] = {k: fn.launches for k, fn in counted.items()}
    m, _ = load_map(os.path.join(vo_out, "AirSLAM_mapv0.bin"), device=dev)
    traj = load_tum(os.path.join(vo_out, "trajectory_v0.txt"))
    jax_ids = [int(k) for k in z["full_keyframe_ids"]]
    truth = stage2_truth(z)
    gap, n_common = _ate_between(traj, _tum_rows(z["full_traj"]))
    ate, n_gt = reloc_ate(traj, truth)
    jax_ate, _ = reloc_ate(_tum_rows(z["full_traj"]), truth)
    want = {"remap": 0, "bilerp_points": 0, "bilerp_points_t": 0, "loi_features": n,
            "pose_only_fast": n - 1, "flash_mha": 0, "loi_features_backward": 0}
    note = (f"keyframes {m.keyframe_ids} (JAX {jax_ids}); {len(traj)} of {n} frames; "
            f"unaligned ATE to the JAX CLI {gap:.5f} m over {n_common} poses; aligned ATE "
            f"{ate:.5f} m over {n_gt} poses (the JAX CLI's {jax_ate:.5f} m); mappoints "
            f"{sum(p.is_valid for p in m.mappoints.values())} (JAX "
            f"{int(z['full_n_mappoints'])}), maplines "
            f"{sum(l.is_valid for l in m.maplines.values())} (JAX {int(z['full_n_maplines'])})")
    _require(len(traj) == n and n_common == n, f"stage2 chain VO: {note}")
    _require(launches["chain vo"] == want, f"stage2 chain VO: launches "
                                           f"{launches['chain vo']}, not {want}")
    _require(m.keyframe_ids == jax_ids, f"stage2 chain VO: the keyframes part: {note}")
    _require(gap <= E2E_GATES["traj"] and ate <= E2E_GATES["ate"],
             f"stage2 chain VO (gates {E2E_GATES['traj']} m to the JAX CLI, "
             f"{E2E_GATES['ate']} m ATE): {note}")
    print(f"stage2 chain VO (apps/visual_odometry_torch.py --dtype f32, all {n} frames of the "
          f"rectified tree): {note}; launches {_launch_note(launches['chain vo'])}; {vo_s:.1f} s "
          f"wall with the model loads, {1e3 * vo_s / n:.1f} ms a frame, on {on}")

    map_root = os.path.join(root, "chain map")
    os.makedirs(map_root)
    with open(os.path.join(vo_out, "AirSLAM_mapv0.bin"), "rb") as src, \
            open(os.path.join(map_root, "AirSLAM_mapv0.bin"), "wb") as dst:
        dst.write(src.read())
    r, traj1, wall, n_lg = refine(map_root, ["--use_flash"], "chain refine")
    ate1, n1 = reloc_ate(traj1, truth)
    loops = [[lp.query_id, lp.loop_id] for lp in r.loop_pairs]
    _require(ate1 <= REFINE_GATES["ate"], f"stage2 chain refinement: ATE {ate1:.4e} m")
    print(f"stage2 chain refinement (apps/map_refinement_torch.py --use_flash on the chain's "
          f"mapv0, its own point vocabulary): aligned ATE to the truth {ate1:.5f} m over {n1} "
          f"keyframes (gate {REFINE_GATES['ate']}); loops {loops} (the JAX chain "
          f"{z['s2_loop'].tolist()}), merged {[r.n_merged_mappoints, r.n_merged_maplines]} (JAX "
          f"{z['s2_n_merged'].tolist()}); {wall:.1f} s wall; P {r.n_pose_only} and F "
          f"{launches['chain refine']['flash_mha']} launches ({n_lg} LightGlue calls); stage "
          "ms " + " ".join(f"{k}={v:.1f}" for k, v in r.stage_ms.items()))

    _, qdir, names = write_reloc_tree(zr, os.path.join(root, "chain queries"))
    _require(np.array_equal(zr["gt_tum"], z["s3_gt_tum"]),
             "stage2: the relocalization oracle's queries are not the e2e tree's")
    gt = load_tum(os.path.join(root, "chain queries", "gt_tum.txt"))
    traj_path = os.path.join(root, "chain reloc.txt")
    batched, refines = [], []
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with _no_tf32("f32"), _timed(PointMatcher, "matching_points_batched", batched), \
            _timed(MapUser, "_refine_pose", refines):
        _, records = relocalization_torch.main([
            "--config_path", os.path.join(REPO, "configs", "relocalization", "reloc_euroc.yaml"),
            "--map_root", map_root, "--query_folder", qdir, "--traj_path", traj_path,
            "--device", str(dev), "--use_flash", "--diagnose"])
    rel_s = time.perf_counter() - t0
    launches["chain reloc"] = {k: fn.launches for k, fn in counted.items()}
    ok = np.asarray([bool(rec[1]) for rec in records])
    recall, jax_recall = float(ok.mean()), float(z["s3_recall"])
    rate, n_pairs = reloc_ate(load_tum(traj_path), gt)
    want = {"remap": 0, "bilerp_points": 0, "bilerp_points_t": 0,
            "loi_features": len(records), "flash_mha": 36 * len(batched),
            "pose_only_fast": len(refines), "loi_features_backward": 0}
    _require([rec[0] for rec in records] == names, "stage2 chain relocalization: queries "
                                                   f"{[rec[0] for rec in records]}")
    _require(launches["chain reloc"] == want, f"stage2 chain relocalization: launches "
                                              f"{launches['chain reloc']}, expected {want}")
    _require(recall >= RELOC_GATES["recall"]
             and recall >= jax_recall - RELOC_GATES["recall_drop"],
             f"stage2 chain relocalization: recall {recall} (JAX {jax_recall})")
    _require(n_pairs == int(ok.sum()) and rate <= RELOC_GATES["ate"],
             f"stage2 chain relocalization: ATE {rate:.4e} m over {n_pairs} poses")
    print(f"stage2 chain relocalization (apps/relocalization_torch.py --use_flash on the "
          f"chain's mapv1, the {len(names)} hard queries): recall {recall:.3f} (the JAX chain's "
          f"{jax_recall:.3f}; gates >= {RELOC_GATES['recall']} and >= JAX - "
          f"{RELOC_GATES['recall_drop']}); ATE {rate:.5f} m over {n_pairs} poses (gate "
          f"{RELOC_GATES['ate']}); launches {_launch_note(launches['chain reloc'])} "
          f"({len(batched)} LightGlue calls, {len(refines)} pose refinements); {rel_s:.1f} s "
          f"wall with the model loads on {on}")
    print(f"stage2: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_system(dev):
    """``apps/benchmark_system_torch.py --frames 60 --json`` on the oracle's
    world against the JAX benchmark's loop and the ground truth. Returns its
    launch counts."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import benchmark_system_torch
    import evaluate_torch

    z = e2e_oracle()
    g, n = E2E_GATES, E2E_RUN["system"]
    counted = _counted()
    for fn in counted.values():
        fn.launches = 0
    rec = benchmark_system_torch.main(["--frames", str(n), "--json", "--world", E2E_ORACLE,
                                       "--device", str(dev)])
    launches = {k: fn.launches for k, fn in counted.items()}
    gap, n_common = _ate_between(rec["trajectory"], _tum_rows(z["system_traj"]))
    ate, n_gt = evaluate_torch.evaluate(rec["trajectory"], rec["gt"])
    want = {"remap": 0, "bilerp_points": 0, "bilerp_points_t": 0, "loi_features": n,
            "pose_only_fast": n - 1, "flash_mha": 0, "loi_features_backward": 0}
    note = (f"{rec['tracked']} of {n} frames tracked; keyframes {rec['keyframes']} (JAX "
            f"{int(z['system_keyframes'])}); unaligned ATE to the JAX loop {gap:.5f} m over "
            f"{n_common} poses; aligned ATE {_m(ate)} over {n_gt} poses; launches {launches}")
    _require(rec["tracked"] == n and n_common == n, f"system: {note}")
    _require(launches == want, f"system: launches {launches}, not {want}")
    _require(gap <= g["traj"] and ate is not None and ate <= g["ate"]
             and abs(rec["keyframes"] - int(z["system_keyframes"])) <= g["kf_delta"],
             f"system (gates {g['traj']} m, {g['ate']} m, {g['kf_delta']} keyframe): {note}")
    stages = " ".join(f"{k}={v:.3f}" for k, v in rec["stage_ms"].items())
    print(f"system (apps/benchmark_system_torch.py --frames {n}, bf16, the oracle's world): "
          f"{note}; {rec['value']} Hz, {rec['ms_per_frame']:.2f} ms a frame, stages ms "
          f"{stages}, render {rec['render_ms_per_pair']:.3f} ms a pair, on {rec['device']}")
    return launches


def _pose_gap(est, ref):
    """Largest position gap (m) of two runs over their common stamps, and
    the number of common stamps."""
    a = {round(t, 6): T for t, T in est}
    b = {round(t, 6): T for t, T in ref}
    common = sorted(set(a) & set(b))
    gap = max((float(np.linalg.norm(a[t][:3, 3] - b[t][:3, 3])) for t in common), default=np.inf)
    return gap, len(common)


@contextlib.contextmanager
def _no_cudnn():
    """cuDNN off (PyTorch's own convolution kernels, whose per-image
    arithmetic does not depend on the batch); restored after."""
    import torch

    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def dp_plnet_step_gaps(dev, dp: int, batch: int):
    """Two ``plnet`` steps of the shipped checkpoint, single-device and
    data-parallel over a virtual mesh of ``dp`` (f32, TF32 off, cuDNN
    deterministic): per step (``per_step``) the gaps between the two runs'
    loss, terms and clipped gradients, each run's launches at the first
    step, and the time of the second step."""
    import torch

    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
    from airslam_tpu_torch.parallel import train_plnet as tp
    from airslam_tpu_torch.parallel.mesh import make_mesh

    counted = _counted()
    tree = wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))
    runs = {}
    for label, mesh in (("single", None), ("dp", make_mesh(tp=1, devices=[dev] * dp))):
        plnet, loi = PLNet(), LoiHeadS1()
        plnet.load_state_dict(wio.plnet_from_flax(tree["plnet"]))
        loi.load_state_dict(wio.loi_s1_from_flax(tree["loi"]))
        plnet.to(dev).train()
        loi.to(dev).train()
        opt = tp.ClippedAdam(list(plnet.parameters()) + list(loi.parameters()), 3e-4)
        step = tp.make_plnet_train_step(plnet, loi, opt, mesh=mesh)
        for fn in counted.values():
            fn.launches = 0
        gen = torch.Generator(device=dev).manual_seed(0)
        steps = []

        def take():
            loss, terms = step(gen, batch)
            torch.cuda.synchronize()
            return time.perf_counter(), float(loss), {k: float(v) for k, v in terms.items()}

        def grads():
            return [None if p.grad is None else p.grad.detach().double().cpu().numpy()
                    for p in opt.params]

        with _no_tf32("f32"), _pinned_cudnn():
            steps.append(take()[1:] + (grads(),))
            launched = {k: fn.launches for k, fn in counted.items()}
            # the second step's time: the first one's holds the warm-up
            t0 = time.perf_counter()
            t1, loss, terms = take()
            steps.append((loss, terms, grads()))
        runs[label] = (steps, launched, t1 - t0)
    (s1, n1, w1), (s2, n2, w2) = runs["single"], runs["dp"]
    per_step = []
    for (l1, t1, g1), (l2, t2, g2) in zip(s1, s2):
        flat1 = np.concatenate([a.ravel() for a in g1 if a is not None])
        flat2 = np.concatenate([b.ravel() for b in g2 if b is not None])
        per_step.append({
            "loss": abs(l2 - l1) / abs(l1),
            "terms": max(abs(t2[k] - t1[k]) / max(abs(t1[k]), 1e-12) for k in t1),
            "grad_leaf": max(_rel_l2(b, a) for a, b in zip(g1, g2) if a is not None),
            "grad_all": _rel_l2(flat2, flat1),
            "none_match": [a is None for a in g1] == [b is None for b in g2]})
    return dict(per_step=per_step, loss_single=s1[0][0], loss_dp=s2[0][0], launches_single=n1,
                launches_dp=n2, ms_single=1e3 * w1, ms_dp=1e3 * w2)


def phase_mesh(dev, trees, root):
    """The multi-device path on the card: ``entry.dryrun_multichip`` at the
    production shapes over a mesh of 8 (the card repeated); over the
    distorted 20-frame tree in f32, in this order, the VO CLI with
    ``--mesh_pipelined`` (the default mesh: one card, a chunk of 1) against
    phase e2e's sequential run of the same tree, ``MeshPipelinedRunner``
    over a virtual mesh of 4 (a chunk of 2, one image a shard) with cuDNN
    on, then with cuDNN off against the sequential loop with cuDNN off,
    each against the JAX CLI's run too; two data-parallel ``plnet`` steps
    against the single-device steps (``MESH_GATES``). Returns each run's
    launch counts."""
    import io

    import torch

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import visual_odometry_torch as vo

    from airslam_tpu_torch import entry
    from airslam_tpu_torch.io.serialization import load_map
    from airslam_tpu_torch.io.trajectory import load_tum
    from airslam_tpu_torch.parallel.mesh import make_mesh
    from airslam_tpu_torch.parallel.pipeline import MeshPipelinedRunner

    z = e2e_oracle()
    on = card()
    g, n = E2E_GATES, E2E_RUN["run"]
    t_phase = time.perf_counter()
    with _no_tf32("f32"):
        gaps = entry.dryrun_multichip(MESH_RUN["dryrun"], device=dev)
    dry_s = time.perf_counter() - t_phase
    print(f"mesh dryrun_multichip({MESH_RUN['dryrun']}, cuda) at the production shapes: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + f"; {dry_s:.1f} s")

    counted = _counted()
    args = ["--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
            "--camera_config_path", os.path.join(REPO, E2E_CAMERAS["dist"]), "--dataroot",
            trees["dist"], "--max_frames", str(n), "--device", str(dev), "--dtype", "f32"]

    def reset():
        for fn in counted.values():
            fn.launches = 0

    runs = {}
    # the CLI, its own timing printed (the frame loop without the model loads)
    out = os.path.join(root, "vo mesh")
    reset()
    text = io.StringIO()
    with _no_tf32("f32"), contextlib.redirect_stdout(text):
        vo.main(args + ["--saving_dir", out, "--mesh_pipelined"])
    fps = float(next(ln.split(":")[1] for ln in text.getvalue().splitlines()
                     if ln.startswith("Average FPS")))
    m, _ = load_map(os.path.join(out, "AirSLAM_mapv0.bin"), device=dev)
    runs["cli mesh"] = (load_tum(os.path.join(out, "trajectory_v0.txt")), m.keyframe_ids,
                        {k: fn.launches for k, fn in counted.items()}, 1e3 / fps)

    def virtual(builder, data):
        MeshPipelinedRunner(builder, make_mesh(devices=[dev] * MESH_RUN["virtual"])).run(
            data, max_frames=n)

    def sequential(builder, data):
        for i in range(n):
            builder.add_input(*data.get(i))

    for label, loop, cudnn in (("mesh4", virtual, True), ("mesh4 cudnn off", virtual, False),
                               ("seq cudnn off", sequential, False)):
        with _no_tf32("f32"), contextlib.nullcontext() if cudnn else _no_cudnn():
            builder, data, _ = vo.build(vo.parse_args(args + ["--saving_dir", root]))
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop(builder, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[label] = (builder.trajectory, builder.map.keyframe_ids,
                       {k: fn.launches for k, fn in counted.items()}, 1e3 * wall / n)

    jax_ids = [int(k) for k in z["dist_keyframe_ids"]]
    per_frame = {"remap": n, "bilerp_points": 0, "bilerp_points_t": 0, "loi_features": n,
                 "pose_only_fast": n - 1, "flash_mha": 0, "loi_features_backward": 0}
    # a chunk of 2 frames is 4 images, one per shard: the stage-1 head runs
    # once per image
    want = {"cli mesh": per_frame, "seq cudnn off": per_frame,
            "mesh4": dict(per_frame, loi_features=2 * n),
            "mesh4 cudnn off": dict(per_frame, loi_features=2 * n)}
    # the sequential run each is compared with, and whether that gap is
    # gated: a run with cuDNN on against phase e2e's (gated where the images
    # are detected in the same batches: the CLI's mesh of one card), the
    # runner with cuDNN off against this phase's sequential loop with cuDNN
    # off; the runs whose batches differ from their reference's are printed
    e2e_seq = load_tum(os.path.join(root, "vo dist f32", "trajectory_v0.txt"))
    ref = {"cli mesh": ("phase e2e's", e2e_seq, True), "mesh4": ("phase e2e's", e2e_seq, False),
           "mesh4 cudnn off": ("seq cudnn off's", runs["seq cudnn off"][0], True),
           "seq cudnn off": ("phase e2e's", e2e_seq, False)}
    notes, launches, failed = [], {}, []
    for label, (traj, ids, counts, ms) in runs.items():
        ref_name, ref_traj, gated = ref[label]
        gap, n_common = _ate_between(traj, _tum_rows(z["dist_traj"]))
        seq_gap, n_seq = _pose_gap(traj, ref_traj)
        parted = next((f for f in range(n) if (f in ids) != (f in jax_ids)), None)
        launches[label] = counts
        note = (f"{label}: keyframes {ids} (JAX {jax_ids}); {len(traj)} of {n} frames; "
                f"unaligned ATE to the JAX CLI {gap:.5f} m; largest gap to {ref_name} "
                f"sequential run {seq_gap:.2e} m over {n_seq} poses"
                + ("" if gated else " (printed, not gated)")
                + f"; {ms:.1f} ms a frame; launches {counts}")
        notes.append(note)
        failed += [f"mesh {label}: {msg}" for ok, msg in (
            (len(traj) == n and n_common == n and n_seq == n, "frames lost"),
            (parted is None, f"the keyframe decisions part at frame {parted}"),
            (gap <= g["traj"], f"ATE to the JAX CLI above {g['traj']} m"),
            (not gated or seq_gap <= MESH_GATES["seq"],
             f"a pose above {MESH_GATES['seq']} m from {ref_name} sequential run"),
            (counts == want[label], f"launches {counts}, not {want[label]}")) if not ok]

    dp = dp_plnet_step_gaps(dev, MESH_RUN["dp"], MESH_RUN["batch"])
    first, second = dp["per_step"]
    launches["dp plnet step"] = dp["launches_dp"]
    notes.append(
        f"dp plnet steps (batch {MESH_RUN['batch']} over {MESH_RUN['dp']}, f32, TF32 off): "
        f"first loss {dp['loss_dp']:.6f} against {dp['loss_single']:.6f}; "
        + "; ".join(f"step {i + 1}: loss {s['loss']:.2e} relative, term {s['terms']:.2e}, "
                    f"gradients {s['grad_leaf']:.2e} worst leaf / {s['grad_all']:.2e} all "
                    "leaves relative L2" + (" (printed, not gated)" if i else "")
                    for i, s in enumerate(dp["per_step"]))
        + f"; launches at the first step {dp['launches_dp']} (single "
        f"{dp['launches_single']}); {dp['ms_dp']:.1f} ms against "
        f"{dp['ms_single']:.1f} ms the second step")
    failed += [f"mesh dp plnet step: {msg}" for ok, msg in (
        (first["none_match"] and second["none_match"], "gradients flowed to other leaves"),
        (first["loss"] <= MESH_GATES["loss"] and first["terms"] <= MESH_GATES["loss"],
         f"the first step's loss or terms beyond {MESH_GATES['loss']}"),
        (first["grad_leaf"] <= MESH_GATES["grad_leaf"]
         and first["grad_all"] <= MESH_GATES["grad_all"],
         f"the first step's gradients beyond {MESH_GATES['grad_leaf']} / "
         f"{MESH_GATES['grad_all']}"),
        (second["loss"] <= MESH_GATES["step2"] and second["terms"] <= MESH_GATES["step2"],
         f"the second step's loss or terms beyond {MESH_GATES['step2']}"),
        (all(dp["launches_single"][k] == 1 and dp["launches_dp"][k] == MESH_RUN["dp"]
             for k in ("loi_features", "loi_features_backward")),
         "loi_features or B+T′ not launched once per shard")) if not ok]
    print("mesh runs over the distorted tree (f32, in this order): " + "; ".join(notes)
          + f"; the phase {time.perf_counter() - t_phase:.1f} s on {on}")
    _require(not failed, "; ".join(failed))
    return launches


def tools_sequences(dev, root):
    """The two 3-frame sequences of phase ``tools`` (``TOOLS_SEQUENCES``),
    rendered on ``dev`` by ``apps/make_synth_dataset_torch.py``, each under
    a dataset root of its own in ``root``. Returns {sequence: its root}."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import make_synth_dataset_torch as msd

    roots = {}
    for seq, extra in TOOLS_SEQUENCES.items():
        roots[seq] = os.path.join(root, "data " + seq)
        msd.main(["--out", roots[seq], "--seq", seq, "--frames", str(TOOLS_RUN["frames"]),
                  "--traj", "forward", "--device", str(dev)] + extra)
    return roots


def tools_cli_runs(device_name, roots, root):
    """Starts ``apps/run_batch_torch.py --stage vo`` over the first
    sequence's dataset root and ``apps/run_launch_torch.py`` on a launch
    file of one VO node over the second, at once, each in a thread (both run
    the VO CLI in a subprocess; the loop over several sequences is
    ``tests/test_torch_tools.py``'s). Returns a function that waits for both
    and returns {run: (exit status, saving dir, the sequence's mav0)}."""
    import threading

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import run_batch_torch
    import run_launch_torch

    cfg = os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml")
    cam = os.path.join(REPO, "configs", "camera", "synth_stereo.yaml")
    n = str(TOOLS_RUN["frames"])
    batch_seq, launch_seq = sorted(TOOLS_SEQUENCES)
    launch = os.path.join(root, "vo.launch")
    with open(launch, "w") as f:
        f.write(TOOLS_LAUNCH)
    out = {}

    def batch():
        try:
            res = run_batch_torch.main([
                "--stage", "vo", "--config_path", cfg, "--camera_config_path", cam,
                "--dataset_root", roots[batch_seq], "--out_root", os.path.join(root, "batch"),
                "--max_frames", n, "--device", device_name])
        except BaseException as e:  # reported by the caller
            res = {batch_seq: f"raised {e!r}"}
        out[f"run_batch {batch_seq}"] = (res.get(batch_seq, "not run"),
                                         os.path.join(root, "batch", batch_seq),
                                         os.path.join(roots[batch_seq], batch_seq, "mav0"))

    def launched():
        saving = os.path.join(root, "launch")
        mav0 = os.path.join(roots[launch_seq], launch_seq, "mav0")
        try:
            run_launch_torch.main([launch, f"config_path:={cfg}", f"camera_config_path:={cam}",
                                   f"dataroot:={mav0}", f"saving_dir:={saving}",
                                   "--device", device_name, "--max_frames", n])
            status = "ok"
        except SystemExit as e:
            status = f"exit {e.code}"
        except BaseException as e:
            status = f"raised {e!r}"
        out[f"run_launch {launch_seq}"] = (status, saving, mav0)

    threads = [threading.Thread(target=t) for t in (batch, launched)]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join()
        return out

    return wait


def phase_tools(dev):
    """The last bring-up slice on the card. The detector with the fast
    stage-1 head (the stored JAX seeded weights) against the stored JAX
    detection, and with ``detect_junctions=False``;
    ``apps/test_feature_torch.py`` over the oracle's three left images
    rectified with euroc.yaml (kernel R and ``loi_features`` once per image)
    against the stored JAX CLI's run; ``apps/run_batch_torch.py`` and
    ``apps/run_launch_torch.py`` running the VO CLI over one rendered 3-frame
    sequence each, their trajectories read by ``apps/evaluate_torch.py``; the
    ``backend/validate.py`` printers on ``apps/bench_backend_torch.py``'s
    window against the stored JAX dicts; ``apps/bench_backend_torch.py``
    against the stored JAX float32 ``local_ba`` (1e-4 m) and its ms per call.
    Returns the launch counts of the fast-head detection and of the
    test_feature CLI run."""
    import cv2
    import torch

    sys.path.insert(0, os.path.join(REPO, "apps"))
    import bench_backend_torch
    import evaluate_torch
    import run_batch_torch
    import test_feature_torch

    from airslam_tpu_torch.backend import validate, windows
    from airslam_tpu_torch.entry import _intrinsics, imu_chain, window_problem
    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu_torch.io.trajectory import load_tum

    t_phase = time.perf_counter()
    z = np.load(TOOLS_ORACLE)
    counted = _counted()
    failed, launches = [], {}

    def note(text):
        print(f"tools: {text}", flush=True)

    with tempfile.TemporaryDirectory() as root:
        # the CLI chains run in subprocesses while this process gates the rest
        roots = tools_sequences(dev, root)
        t_cli = time.perf_counter()
        wait = tools_cli_runs(dev.type, roots, root)

        try:
            # the fast head, f32 with TF32 off, the stored JAX seeded weights
            frames, _ = oracle_pairs()
            det = FeatureDetector(DetectorConfig(loi_head="fast", use_superpoint=False,
                                                 **TOOLS_FAST), device=dev,
                                  params={"loi": tools_loi_params(z)})
            for fn in counted.values():
                fn.launches = 0
            metrics, n_lines, jax_lines = [], [], []
            with _no_tf32("f32"):
                for i in range(frames.shape[0]):
                    f = det.detect(frames[i], detect_junctions=True)
                    metrics += [detection_metrics(
                        tools_detection(z, f"fast{i}_{v}_"),
                        {k: getattr(f, k)[v].cpu().numpy() for k in TOOLS_FIELDS}) for v in (0, 1)]
                    n_lines += [int(f.line_mask[v].sum()) for v in (0, 1)]
                    jax_lines += [int(z[f"fast{i}_{v}_line_mask"].sum()) for v in (0, 1)]
                off = det.detect(frames[0])
                torch.cuda.synchronize()
            launches["fast head"] = {k: fn.launches for k, fn in counted.items()}
            worst = {k: min(m[k] for m in metrics) for k in DETECT_GATES}
            note("fast head (3 pairs, both views, f32, TF32 off): worst view "
                 + " ".join(f"{k}={v:.4f}(>={DETECT_GATES[k]})" for k, v in worst.items())
                 + f"; lines {n_lines} (JAX {jax_lines}); launches "
                 f"{launches['fast head']}")
            junc_off = [k for k in ("junctions", "junc_scores", "junc_desc", "junc_mask")
                        if bool(getattr(off, k).any())]
            failed += [f"tools fast head: {msg}" for ok, msg in (
                (all(v >= DETECT_GATES[k] for k, v in worst.items()), f"gates: {worst}"),
                (not junc_off, f"detect_junctions=False returned {junc_off}"),
                (not any(launches["fast head"].values()),
                 f"launches {launches['fast head']}, not none")) if not ok]

            # test_feature_torch over the three left images, rectified
            img_dir = os.path.join(root, "images")
            os.makedirs(img_dir)
            for i, u8 in enumerate(np.load(ORACLE)["frames_u8"][:, 0]):
                cv2.imwrite(os.path.join(img_dir, f"{i:02d}.png"), u8)
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with _no_tf32("f32"):  # the CLI turns TF32 off; restored after it
                runs = test_feature_torch.main([
                    "--image_dir", img_dir, "--save_dir", os.path.join(root, "features"),
                    "--camera_config_path", os.path.join(REPO, "configs", "camera", "euroc.yaml"),
                    "--device", dev.type])
            wall = time.perf_counter() - t0
            launches["test feature"] = {k: fn.launches for k, fn in counted.items()}
            names = [n for n, _ in runs]
            want = dict({k: 0 for k in counted}, remap=len(runs), loi_features=len(runs))
            fmetrics = [detection_metrics(tools_detection(z, f"feature{i}_"),
                                          {k: np.asarray(getattr(f, k)) for k in TOOLS_FIELDS})
                        for i, (_, f) in enumerate(runs)]
            worst = {k: min((m[k] for m in fmetrics), default=0.0) for k in DETECT_GATES}
            drawn = [cv2.imread(os.path.join(root, "features", n)) for n in names]
            note(f"test_feature_torch ({len(runs)} images, euroc.yaml, f32): worst image "
                 + " ".join(f"{k}={v:.4f}(>={DETECT_GATES[k]})" for k, v in worst.items())
                 + f"; lines {[int(f.line_mask.sum()) for _, f in runs]} (JAX "
                 f"{[int(z[f'feature{i}_line_mask'].sum()) for i in range(len(names))]}); "
                 f"launches {launches['test feature']}; {wall:.2f} s with the model load")
            failed += [f"tools test_feature: {msg}" for ok, msg in (
                (names == [str(s) for s in z["feature_names"]], f"images {names}"),
                (all(v >= DETECT_GATES[k] for k, v in worst.items()), f"gates: {worst}"),
                (launches["test feature"] == want,
                 f"launches {launches['test feature']}, not {want}"),
                (all(d is not None and d.shape == (HEIGHT, WIDTH, 3) for d in drawn),
                 "an annotated image is missing or unreadable")) if not ok]

            # the validate printers on the card, on bench_backend's window, f32
            prob, scene = bench_backend_torch.window(*TOOLS_BENCH, torch.float32, dev)
            intr = _intrinsics()
            nf = int(prob.frames.twb.shape[0])
            chain = imu_chain(np.arange(nf - 1), np.arange(1, nf))
            prob_imu = window_problem(scene, Rwb=prob.frames.Rwb.cpu().numpy(),
                                      twb=prob.frames.twb.cpu().numpy(),
                                      points=prob.points.cpu().numpy(), dtype=torch.float32,
                                      device=dev, imu=chain)
            got = {"before": validate.validate_reprojection(prob, intr, "before"),
                   "after": validate.validate_reprojection(windows.local_ba(prob, intr)[0], intr,
                                                           "after"),
                   "imu": validate.validate_imu(prob_imu, "imu")}
            jv = json.loads(str(z["validate"]))
            rel = TOOLS_GATES["validate_rel"]
            for label in got:
                g, w = got[label], jv[label]
                failed += [f"tools validate {label}: {msg} ({g} against JAX {w})" for ok, msg in (
                    (list(g) == list(w), "other keys"),
                    (all(g[k] == v for k, v in w.items() if isinstance(v, int)), "other counts"),
                    # after the BA the chi² values are float32 rounding: held to convergence
                    (all(abs(g[k] - v) <= rel * abs(v) for k, v in w.items()
                         if isinstance(v, float)) if label != "after"
                     else g["point_chi2_max"] <= TOOLS_GATES["after_chi2"],
                     "values apart")) if not ok]
            note(f"validate (bench window, f32): {got} (JAX {jv})")
            t_own = time.perf_counter() - t_cli
        finally:  # the subprocesses end before their tree goes
            results = wait()
        note(f"the CLI chains took {time.perf_counter() - t_cli:.1f} s; this process's gates "
             f"{t_own:.1f} s meanwhile")
        for run, (status, saving, mav0) in sorted(results.items()):
            traj_path = os.path.join(saving, "trajectory_v0.txt")
            gt_path = os.path.join(saving, "gt_tum.txt")
            if status == "ok" and not os.path.exists(gt_path):
                run_batch_torch._euroc_gt_to_tum(
                    os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), gt_path)
            traj = load_tum(traj_path) if os.path.exists(traj_path) else []
            ate, n_gt = (evaluate_torch.evaluate(traj, load_tum(gt_path))
                         if os.path.exists(gt_path) else (None, "no ground truth"))
            note(f"{run}: {status}; {len(traj)} poses; ATE {_m(ate)} over {n_gt}")
            failed += [f"tools {run}: {msg}" for ok, msg in (
                (status == "ok", f"exited {status}"),
                (len(traj) == TOOLS_RUN["frames"], f"{len(traj)} poses written"),
                (ate is not None and ate <= E2E_GATES["ate"],
                 f"evaluate_torch: ATE {_m(ate)} ({n_gt}), gate {E2E_GATES['ate']} m")) if not ok]

    # bench_backend_torch alone on the card (after the subprocesses ended)
    rec = bench_backend_torch.main(["--device", dev.type, "--calls", str(TOOLS_RUN["calls"]),
                                    "--warmup", str(TOOLS_RUN["warmup"])])
    gap = float(np.abs(rec["twb"] - z["bench_twb"]).max())
    note(f"bench_backend_torch (F={TOOLS_BENCH[0]}, P={TOOLS_BENCH[1]}, f32): poses "
         f"{gap:.2e} m from the JAX f32 local_ba (gate {TOOLS_GATES['bench_t']}), error "
         f"to the ground truth {rec['err']:.2e} m (JAX {float(z['bench_err']):.2e}), "
         f"inliers {rec['inliers']}/{rec['n_obs']} (JAX {int(z['bench_inliers'])}); "
         f"{rec['ms']:.3f} ms a call, early_exit=1e-6 {rec['ms_early']:.3f} ms "
         f"(medians of {TOOLS_RUN['calls']}) on {rec['device']}")
    failed += [f"tools bench_backend: {msg}" for ok, msg in (
        (gap <= TOOLS_GATES["bench_t"], f"poses {gap:.2e} m from the JAX run"),
        (rec["inliers"] == int(z["bench_inliers"]), "other inliers")) if not ok]
    print(f"tools phase: {time.perf_counter() - t_phase:.1f} s")
    _require(not failed, "; ".join(failed))
    return launches


def tracking_builder_like(builder):
    """A fresh ``MapBuilder`` on ``builder``'s camera, detector and matcher
    (the networks stay loaded and warm)."""
    from airslam_tpu_torch.pipelines.map_builder import MapBuilder

    return MapBuilder(builder.camera, builder.detector, builder.matcher, device=builder.device)


def _outputs_np(out):
    """entry()-layout dict of numpy arrays (bf16 values widened to f32)."""
    import torch

    return {f"o{j}": (o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
            for j, o in enumerate(out)}


def phase_slice(dev, frames, refs):
    import torch

    from airslam_tpu_torch.entry import FrontendStep

    steps = {}
    for label, dtype, gates in (("bf16", torch.bfloat16, BF16_GATES),
                                ("f32", torch.float32, F32_GATES)):
        with _no_tf32(label):
            step = FrontendStep(dtype=dtype, device=dev)
            per_pair = [frontend_metrics(ref, _outputs_np(step(torch.as_tensor(pair, device=dev))))
                        for pair, ref in zip(frames, refs)]
        mean = {k: float(np.mean([m[k] for m in per_pair])) for k in gates}
        print(f"slice {label}: " + " ".join(f"{k}={v:.4f}(>={gates[k]})" for k, v in mean.items()))
        bad = [k for k, v in mean.items() if v < gates[k]]
        _require(not bad, f"slice {label} gates failed: {bad}")
        steps[label] = step
    return steps


def _track_gap(res, want):
    """Max abs gaps of a TrackResult to the oracle's record of that pair."""
    return (float(np.abs(res.Twc[:3, 3] - want["Twc"][:3, 3]).max()),
            float(np.abs(res.Twc[:3, :3] - want["Twc"][:3, :3]).max()))


def phase_tracking(dev, frames):
    """Initialise on pair 0, track pairs 1 and 2 against keyframe 0, gate
    against the stored JAX run. Returns the builders by label."""
    import torch

    cam, init, pairs = tracking_oracle()
    builders = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gates = TRACK_GATES[label]
        with _no_tf32(label):
            builder = tracking_builder(cam, dtype, dev, identity_rectify=True)
            raw = torch.as_tensor(frames[0], device=dev)
            _require(torch.equal(builder.rectify(raw[0], raw[1]), raw),
                     "the identity rectification changed the pixels")
            first = builder.add_input(0.0, frames[0][0], frames[0][1])
            _require(builder.init and first.good_stereo_points >= 90,
                     f"tracking {label}: pair 0 gave {first.good_stereo_points} stereo points, "
                     "no initialisation")
            lost = builder.kf_config.lost_num_match
            notes = [f"init stereo_points={first.good_stereo_points}"
                     f"(oracle {int(init['good_stereo_points'])})"]
            for i in sorted(pairs):
                want = pairs[i]
                res = builder.track_frame(0.05 * i, frames[i][0], frames[i][1])
                dt, dR = _track_gap(res, want)
                n_ref = int(want["num_inliers"])
                ok = dt <= gates["t"] and dR <= gates["R"] and res.num_inliers > lost
                if label == "f32":
                    ok = (ok and abs(res.num_inliers - n_ref) <= gates["inliers_rel"] * n_ref
                          and res.keyframe_decision == int(want["keyframe_decision"]))
                else:
                    ok = ok and res.num_inliers >= gates["inliers_min"] * n_ref
                notes.append(f"pair {i}: dt={dt:.2e}(<={gates['t']}) dR={dR:.2e}(<={gates['R']}) "
                             f"inliers={res.num_inliers}(oracle {n_ref}) "
                             f"decision={res.keyframe_decision}"
                             f"(oracle {int(want['keyframe_decision'])}) "
                             f"line_matches={int((res.line_matches >= 0).sum())}"
                             f"(oracle {int((want['line_matches'] >= 0).sum())})")
                _require(ok, f"tracking slice {label} gates failed: {notes[-1]}")
        print(f"tracking slice {label}: " + "; ".join(notes))
        builders[label] = builder
    return builders


def phase_path(dev, steps, builders, frames, grids_np):
    import torch

    from airslam_tpu_torch.backend import pose_gn
    from airslam_tpu_torch.ops import bilerp, remap as remap_mod

    grids = torch.as_tensor(grids_np, device=dev)
    raw = torch.as_tensor(frames[0], device=dev)
    counted = (remap_mod.remap, bilerp.loi_features, bilerp.bilerp_points, bilerp.bilerp_points_t)
    tracked = counted + (pose_gn.pose_only_fast,)
    # B's and T's work runs inside loi_features on the path
    want = {"remap": 1, "loi_features": 1, "bilerp_points": 0, "bilerp_points_t": 0}

    def frame(step):
        left, right = step.rectify(raw[0], raw[1], grids)
        return step(torch.stack([left, right]))

    launches = {}
    for label in ("bf16", "f32"):  # bf16 is the production program
        for fn in counted:
            fn.launches = 0
        with _no_tf32(label):
            out = frame(steps[label])
            torch.cuda.synchronize()
        launches[label] = {fn.__name__: fn.launches for fn in counted}
        tag = "kernels:" if label == "bf16" else "kernels f32:"
        print(tag + "".join(f" {k}={v}" for k, v in launches[label].items()))
        _require(launches[label] == want,
                 f"the {label} path launched {launches[label]}, not {want}")
        shapes = [(400, 2), (400, 2), (400,), (400,), (512, 4), (512,), (400, 256), (400,),
                  (2, 256, 2), (2, 256, 256), (2, 256)]
        _require([tuple(o.shape) for o in out] == shapes,
                 f"{label} path outputs have the wrong shapes")
        _require(all(bool(torch.isfinite(o.float()).all()) for o in out),
                 f"{label} path outputs are not finite")
        _require(int(out[7].sum()) > 0 and int(out[5].sum()) > 0 and int((out[2] >= 0).sum()) > 0,
                 f"{label} path found no keypoints, lines or matches")

    # one tracked frame: the main path of the system after initialisation
    want = dict(want, pose_only_fast=1)
    lost = builders["bf16"].kf_config.lost_num_match
    tracked_launches = {}
    for label in ("bf16", "f32"):
        for fn in tracked:
            fn.launches = 0
        with _no_tf32(label):
            res = builders[label].track_frame(0.05, frames[1][0], frames[1][1])
            torch.cuda.synchronize()
        tracked_launches[label] = {fn.__name__: fn.launches for fn in tracked}
        print(f"kernels tracked frame {label}:"
              + "".join(f" {k}={v}" for k, v in tracked_launches[label].items()))
        _require(tracked_launches[label] == want,
                 f"the {label} tracked frame launched {tracked_launches[label]}, not {want}")
        _require(res.Twc.shape == (4, 4) and bool(np.isfinite(res.Twc).all())
                 and res.num_inliers > lost and res.line_matches.shape == (512,),
                 f"the {label} tracked frame gave no usable pose")

    def timed(run):
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 20
        return start.elapsed_time(end) / 20, wall

    times, times_tracked = {}, {}
    for label in ("bf16", "f32"):
        with _no_tf32(label):
            times[label] = timed(lambda: frame(steps[label]))
            times_tracked[label] = timed(
                lambda: builders[label].track_frame(0.05, frames[1][0], frames[1][1]))
    print("path per-frame (rectify + frontend, 20 frames): " + " ".join(
        f"{k}: events_ms={v[0]:.3f} wall_ms={v[1]:.3f}" for k, v in times.items()))
    print("path per-frame (tracked frame, 20 frames): " + " ".join(
        f"{k}: events_ms={v[0]:.3f} wall_ms={v[1]:.3f}" for k, v in times_tracked.items()))
    return tracked_launches["bf16"]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="", help="comma-separated subset, for a short run")
    only = set(filter(None, ap.parse_args().phases.split(",")))

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "airslam_tpu_torch")):
        print("chip_smoke: the airslam_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)

    smi = card()
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    from airslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")

    grids_np = euroc_grids()
    if only:
        frames, refs = oracle_pairs()
        short = {"r": lambda: phase_kernel_r(dev, grids_np), "b": lambda: phase_kernel_bt(dev, "B"),
                 "t": lambda: phase_kernel_bt(dev, "T"), "l": lambda: phase_kernel_loi(dev),
                 "p": lambda: phase_kernel_p(dev),
                 "f": lambda: phase_kernel_f(dev), "vo": lambda: phase_vo(dev),
                 "vio": lambda: phase_vio(dev), "refine": lambda: phase_refine(dev),
                 "reloc": lambda: phase_reloc(dev), "train": lambda: phase_train(dev),
                 "matcher": lambda: phase_matcher(dev),
                 "system": lambda: phase_system(dev), "tools": lambda: phase_tools(dev)}
        for name in short:
            if name in only:
                short[name]()
        if only & {"synth", "e2e", "mesh", "stage2"}:
            with tempfile.TemporaryDirectory() as root:
                trees = phase_synth(dev, root)
                if only & {"e2e", "mesh"}:
                    phase_e2e(dev, trees, root)
                if "mesh" in only:
                    phase_mesh(dev, trees, root)
                if "stage2" in only:
                    phase_stage2(dev, trees, root)
        if "path" in only:
            phase_path(dev, phase_slice(dev, frames, refs), phase_tracking(dev, frames),
                       frames, grids_np)
        else:
            if "slice" in only:
                phase_slice(dev, frames, refs)
            if "tracking" in only:
                phase_tracking(dev, frames)
        print(f"chip_smoke: phases {sorted(only)} ran; no result line for a partial run")
        return 3
    def timed(name, fn, *args):
        """``fn(*args)``, its seconds printed: the script's time budget by phase."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    kernels = timed("kernels", lambda: [
        phase_kernel_r(dev, grids_np), phase_kernel_bt(dev, "B"), phase_kernel_bt(dev, "T"),
        phase_kernel_loi(dev), phase_kernel_p(dev), phase_kernel_f(dev)])
    frames, refs = oracle_pairs()
    steps = timed("slice", phase_slice, dev, frames, refs)
    builders = timed("tracking", phase_tracking, dev, frames)
    timed("path", phase_path, dev, steps, builders, frames, grids_np)
    launches = timed("vo", phase_vo, dev)
    # the main path's acceptance: the CLI over rendered sequences, the system loop
    with tempfile.TemporaryDirectory() as root:
        trees = timed("synth", phase_synth, dev, root)
        e2e_launches = timed("e2e", phase_e2e, dev, trees, root)
        # the multi-device path over the distorted tree
        mesh_launches = timed("mesh", phase_mesh, dev, trees, root)
        # stage 2 against the JAX refinement CLI, then the three CLIs chained
        stage2_launches = timed("stage2", phase_stage2, dev, trees, root)
    system_launches = timed("system", phase_system, dev)
    vi_launches = timed("vio", phase_vio, dev)
    refine_launches, refine_p_ms = timed("refine", phase_refine, dev)
    reloc_launches = timed("reloc", phase_reloc, dev)
    # the detector trainer: every count set to 0 before each CLI run
    train_record, train_launches, train_per_step = timed("train", phase_train, dev)
    # the matcher trainer: every count set to 0 before each CLI run
    matcher_per_step = timed("matcher", phase_matcher, dev)
    # the last slice's tools: every count set to 0 before the fast-head
    # detection and before the test_feature CLI run
    tools_launches = timed("tools", phase_tools, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_vi_frame"] = vi_launches[k["name"]]
        k["launches_refine"] = refine_launches[k["name"]]
        k["launches_reloc"] = reloc_launches[k["name"]]
        if k["name"] == "pose_only_fast":
            k["refine_ms"] = refine_p_ms
        if k["name"] in ("bilerp_points", "bilerp_points_t"):
            k["on_path"] = f"inside loi_features ({launches['loi_features']} per tracked frame)"
    # kernel B+T' runs on the training path only: its launches are the
    # plnet CLI run's
    kernels.append(dict(train_record, launches=train_launches["loi_features_backward"],
                        launches_vi_frame=vi_launches["loi_features_backward"],
                        launches_refine=refine_launches["loi_features_backward"],
                        launches_reloc=reloc_launches["loi_features_backward"],
                        on_path=f"training ({TRAIN_CLI['steps']} plnet steps)"))
    for k in kernels:
        k["launches_train_step"] = train_per_step[k["name"]]
        k["launches_matcher_step"] = matcher_per_step[k["name"]]
        for label, counts in e2e_launches.items():
            k["launches_e2e_" + label.replace(" ", "_")] = counts[k["name"]]
        k["launches_system"] = system_launches[k["name"]]
        k["launches_test_feature"] = tools_launches["test feature"][k["name"]]
        k["launches_fast_head"] = tools_launches["fast head"][k["name"]]
        for label, counts in list(mesh_launches.items()) + list(stage2_launches.items()):
            k["launches_" + label.replace(" ", "_")] = counts[k["name"]]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "on_path", "launches_vi_frame",
            "launches_refine", "launches_reloc", "launches_train_step",
            "launches_matcher_step", "refine_ms",
            "launches_e2e_f32", "launches_e2e_bf16", "launches_e2e_dist_f32", "launches_system",
            "launches_cli_mesh", "launches_mesh4", "launches_mesh4_cudnn_off",
            "launches_seq_cudnn_off", "launches_dp_plnet_step", "launches_test_feature",
            "launches_fast_head", "launches_stage2_refine", "launches_stage2_refine_flash",
            "launches_chain_vo", "launches_chain_refine", "launches_chain_reloc")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys if k in rec} for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
