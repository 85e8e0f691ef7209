"""Write the JAX oracles that the PyTorch port is gated against.

Frontend oracle
---------------

Renders the 3 textured stereo pairs that ``scripts/verify_tpu.py`` uses
(``apps.benchmark_system.make_sequence(3, 480, 752, seed=3, texture=0.1)``),
quantizes them to uint8, and runs ``__graft_entry__.entry(dtype=float32)`` on
the CPU over ``frames / 255``. Stores the frames and the entry() outputs the
frontend metrics read (keypoints, kp mask, idx1, lines, line mask, junctions,
junction mask) in ``tests/data/torch_frontend_oracle.npz``.

Tracking oracle
---------------
The same frames through the JAX ``MapBuilder`` on the CPU with float32
networks and ``use_superpoint=True`` (the shipped VO configuration) and the
rectified pinhole camera the frames were rendered with: pair 0 initialises
the map through ``add_input``; pairs 1 and 2 are tracked against keyframe 0
(``_build_frame`` → ``_track_frame`` → ``_keyframe_check``). Per tracked pair
``tests/data/torch_tracking_oracle.npz`` keeps the matched index pairs, the
PnP pose fed to the pose-only solve, the pose after it, ``num_inliers``, the
inlier flags, the keyframe decision and the line matches; no descriptors.

VO oracle
---------
``N_VO`` frames of the same rendered sequence (the first three are the pairs
above) through the JAX ``MapBuilder.add_input`` on the CPU: float32 networks,
float64 geometry, ``use_flash=False``. Initialisation, per-frame tracking,
keyframe insertions with triangulation and the sliding-window local BA.
``tests/data/torch_vo_oracle.npz`` keeps the frames as uint8, the ground-truth
poses, per frame the pose at the time the frame was tracked, the PnP result,
the inlier count and whether the frame became a keyframe, then the final
trajectory, the keyframe ids and poses after the last BA, and the counts of
valid mappoints and maplines.

VIO oracle
----------
Two stereo-inertial runs of the JAX ``MapBuilder`` on the CPU (float64
geometry), in ``tests/data/torch_vio_oracle.npz``:

(a) the image path: the ``N_VO`` stored frames of the VO oracle through
    ``add_input`` with float32 networks, ``use_flash=False``, on the frames'
    camera with ``use_imu`` and the noise densities of
    ``configs/camera/synth_stereo_imu.yaml``, and the IMU rows that
    ``apps/make_synth_dataset.py`` writes for that trajectory (``forward``,
    stride 1: zero body rates, the analytic acceleration plus g), chunked
    between frames by the JAX ``Dataset`` over an ASL tree of those stamps.
    Kept: the rows and each frame's slice of them, the frame stamps, every
    tracked pose, the keyframe decisions and ids, each keyframe's
    preintegration (dT, dR, dV, dP) and the landmark counts. 0.4 s does not
    initialize the IMU.
(b) the initialization stream: tests/test_vio.py::test_full_vio_pipeline's
    feature stream (``make_imu_sequence(8 s, bg)``, 600 world points, one
    frame per 0.2 s, the test's keyframe policy, which inserts a keyframe at
    every second frame) rendered at the VO configuration's 400-keypoint
    budget. Kept: per frame the left keypoints, right u, the world-point id
    behind each keypoint, the stamps and IMU slices; the world descriptors
    and the IMU rows; the true positions and gyro bias; the keyframe ids, the
    keyframe at which the IMU initialized, Rwg, every keyframe's Twc,
    velocity and biases, the full-rate trajectory and the landmark counts.

Refinement oracle
-----------------
Stage 2 of the JAX package on feature-stream maps, in
``tests/data/torch_refine_oracle.npz`` (outputs only, no map):
(a) the corridor loop of tests/test_refinement.py (``corridor_world``,
    ``loop_trajectory``, ``render_features``, FakeMatcher; float64
    geometry), saved and reloaded as the test does, then ``MapRefiner.run``
    with the test's vocabulary (k 6, depth 3, seed 1, every third
    descriptor) and the pose graph off. Kept: a digest of the mapv0
    (keyframe ids and poses, valid mappoint ids and positions), the
    vocabulary's weights, the loop pairs (query, loop, Rlq, tlq), the merged
    mappoint and mapline counts, the refined keyframe poses (trajectory_v1)
    and the number of pose-only solves.
(b) the same map with tests/test_pose_graph_refinement.py's drift injected,
    refined with the pose-graph branch taken: the loop pairs, the pose
    graph's corrections (keyframe poses), the pose-only solve count and the
    keyframe ATE against the clean poses before, after the pose graph and
    after the whole run.
(c) the gap between the JAX package's own dense and sparse global BA
    (50 + 40 iterations, the sparse one with the auto table width) on
    map (a)'s mapv0, computed in float32 (x64 off, as on the TPU), for the
    keyframe positions and the mappoints; the float64 gap beside it.
(d) tests/test_global_ba.py's map-scale scene cut to 100 keyframes and 10k
    points (``chip_smoke.map_scale_scene``), 3 LM iterations of the sparse
    solver in float64 (chunk 4096): the cost before and after, the poses and
    the points.
(e) ``apps/map_refinement.py --device cpu`` (the JAX CLI: LightGlue, float32)
    on map (a)'s mapv0 with a vocabulary trained on every descriptor (k 10,
    auto depth): its loop and merge counts and trajectory_v1.

Relocalization oracle
---------------------
Stage 3 of the JAX package through its CLIs, on the rendered sequence of
``scripts/verify_tpu_e2e.py:149-151`` (``apps/make_synth_dataset.py --frames
40 --stride 2 --traj loop --hard_queries 10``; 20 frames leave the JAX
relocalizer at recall 5 / 10, below the 0.8 gate): ``apps/visual_odometry.py
--device cpu`` over the whole sequence (``vo_euroc.yaml``,
``synth_stereo.yaml``), ``apps/map_refinement.py`` (``mr_euroc.yaml``, the
point vocabulary trained from the map) and ``apps/relocalization.py
--diagnose`` (``reloc_euroc.yaml``) on the 10 novel-view queries of
``hard0/data``. ``tests/data/torch_reloc_oracle.npz`` keeps the mapv1 and both
vocabularies (bytes, compressed), the query PNGs (bytes), ``hard0/gt_tum.txt``,
the CLI's recall line, trajectory and per-query diagnostics, and from the
same relocalizer run in process (the CLI's set-up, float32 as the CLI runs):
per query ``ok``, ``Twc``, ``last_stats`` (JSON) and the deputies of the top-3
match in order, and the JAX detector's features of the first
``N_RELOC_FEATS`` queries. Then SuperGlue: the JAX detector (the stage-3
configuration, float32) on both views of the 3 frontend-oracle pairs and the
JAX ``PointMatcher(matcher=1)`` (``superglue.npz``, Sinkhorn 20) on them: the
pixel coordinates of each accepted match (kp0 xy, kp1 xy) and its score,
which ``scripts/verify_tpu.py``'s SuperGlue gates compare.

E2E oracle
----------
The main path's acceptance: the JAX VO CLI over rendered sequences, and the
JAX system benchmark's loop, on one world that the port renders itself
(``tests/data/torch_e2e_oracle.npz``). The world is
``make_world3d(PRNGKey(E2E["seed"]))`` and the texture's angles those of
``PRNGKey(seed + 31)``, the keys ``apps/make_synth_dataset.py`` uses; they are
stored (about 1,600 floats) with the seed of the pixel noise. The noise is
numpy's, the one draw a card cannot rebuild from a JAX key:
``default_rng(noise_seed).standard_normal((N, 2, H, W), float32)``, added as
``render_view3d`` adds its own (× 0.01 on the clipped render, clipped to [0,
1]) to JAX's ``render_view3d(key=None)``. ``apps/make_synth_dataset.py``
writes the ASL trees with that render in place of its own: the stage-1
sequence of ``scripts/verify_tpu_e2e.py:149-151`` (``--frames 40 --stride 2
--traj loop``, seed 0, no texture), once rectified and once with
``--distort_camera configs/camera/synth_stereo_distorted.yaml``; then
``apps/visual_odometry.py --device cpu --max_frames 20`` on each
(``vo_euroc.yaml``; ``synth_stereo.yaml`` / the distorted rig's YAML). Kept
per sequence: the PNGs of frames 0 and 19 (both views), the ground truth,
the CLI's ``trajectory_v0.txt``, its keyframe ids (from its mapv0) and its
keyframe, valid mappoint and mapline counts. On the rectified tree, which
also gets the 10 hard queries of ``--hard_queries 10`` (JAX's own noise
keys; byte-equal to the relocalization oracle's, which is checked and
required, so their PNGs are not stored again), stages 1-3 of
``scripts/verify_tpu_e2e.py`` (:func:`e2e_stages`): ``apps/visual_odometry.py``
over all 40 frames (its keyframe ids, ``trajectory_v0.txt``, landmark counts
and the mapv0, LZMA-compressed: ``full_*``); ``apps/map_refinement.py
--voc_path`` on that mapv0, run in this process so that its refiner can be
read, training the shared point vocabulary (its bytes, the loop pairs with
their Rlq / tlq, the merged counts, ``trajectory_v1.txt`` and the junction
vocabulary's bytes: ``s2_*``); ``apps/relocalization.py --diagnose`` on the
refined map and the queries (recall, per-query ok and Twc from the CLI's
trajectory, NaN where rejected, and ``hard0/gt_tum.txt``: ``s3_*``). Then
``apps/benchmark_system.py``'s loop (bf16, 400 keypoints, no SuperPoint,
LightGlue, ``SynthCamera``) over ``SYSTEM_FRAMES`` frames of ``forward`` on
the same world with the numpy noise: its trajectory and keyframe count.

Train oracle
------------
One step of each mode of the JAX detector trainer
(``airslam_tpu/parallel/train_plnet.py``) from the shipped checkpoints,
batch 1, float32: for ``plnet`` the pair of PRNGKey 0's ``kd`` (augment 1)
and the LOI draws of its ``kl``; for ``superpoint`` and ``distill`` the pair
of PRNGKey 1. ``tests/data/torch_train_oracle.npz`` keeps the rendered pairs
(images rounded to 16 bits, on which both packages compute), their corners,
segments and masks, view 0's targets, the LOI draws, the loss terms, and per
parameter leaf the gradient's norm and its values and the one-step
clipped-Adam update's (lr 3e-4) at 256 fixed indices. The ``jax_*_draws``
functions rebuild every draw of the trainer from a key, by the port's names,
for the CPU tests.

Matcher oracle
--------------
One step of each mode of the JAX matcher trainer
(``airslam_tpu/parallel/training.py``, ``apps/train_matcher.py``): LightGlue
and SuperGlue on ``corners`` and on ``detected`` tokens, from the shipped
``lightglue.npz`` / ``superglue.npz`` (the JAX CLI's ``--resume`` path, so no
initial parameters are stored), batch 2, augment 1, float32, Adam at the
CLI's lr 2e-4. ``corners``: the pairs of ``make_rendered_batch(key)`` for the
two keys of ``split(PRNGKey(MATCHER_SEEDS["corners"]))`` (``kd, kj =
split(key)``); ``detected``: ``render_pair_with_affine(key, view=2)`` for
those of ``MATCHER_SEEDS["detected"]``. The images are rounded to 16 bits and
the JAX batch builders run on them (their render patched to return the
stored scenes, the rest the trainer's code); the losses are the trainer's
``loss_fn`` on that batch. ``tests/data/torch_matcher_oracle.npz`` keeps the
images, corners and masks, the jitter, the affines and their strength v, the
batch tensors (for both keypoint scales), and per mode the loss and per
parameter leaf the gradient's norm and its values and the one-step Adam
update's at ``LEAF_SAMPLES`` fixed indices (packed per mode into a few
arrays, :func:`pack_leaves`). Then the three pairs of
``tests/test_trained_detector.py::test_wide_viewpoint_matching`` (seeds 1000,
1002, 1004, v = 2): their JAX draws, except the pixel noise, which is
numpy's (``default_rng(WIDE_NOISE_SEED + i).standard_normal((2, 512, 512),
float32)``, the one draw a card cannot rebuild from a JAX key, as in the E2E
oracle), patched into JAX's ``render_from_shapes``; the JAX test's detector
and LightGlue on those renders: the accepted match count and precision per
pair (and, for the record, the count on the test's own renders).

Tools oracle
------------
The last bring-up slice's modules, in ``tests/data/torch_tools_oracle.npz``:
the JAX fast ``LoiHead``'s parameters as ``FeatureDetector`` initialises
them for seed ``TOOLS["seed"]`` (``_init_loi_params`` with the second key of
``split(PRNGKey(seed), 3)``; about 4.3 MB of float32); the JAX detector with
that head and the shipped PLNet (400 keypoints, line threshold 0.5, no
SuperPoint, float32, ``detect_junctions=True``) on both views of the 3 frontend-oracle pairs;
``apps/test_feature.py --camera_config_path configs/camera/euroc.yaml``
(float32) on their left images, written as PNGs: each image's detections
and printed line; the JAX float32 ``windows.local_ba`` on
``apps/bench_backend.py``'s window (``make_point_scene(f=5, p=230)`` from
``RandomState(0)`` and its perturbation): the poses, and the
``backend/validate.py`` dicts of that window before and after the BA and
with a synthetic IMU chain (``__graft_entry__._synthetic_imu_chain``).

    JAX_PLATFORMS=cpu python scripts/make_torch_oracle.py [frontend|tracking|vo|vio|refine|reloc|train|e2e|matcher|tools]

``chip_smoke.py`` and ``tests/test_torch_*.py`` read the files; the port
itself never imports JAX.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

OUT = os.path.join(REPO, "tests", "data", "torch_frontend_oracle.npz")
OUT_TRACKING = os.path.join(REPO, "tests", "data", "torch_tracking_oracle.npz")
# the camera make_sequence renders with: tests/synthetic.py:17-23
# (fx, fy, cx, cy) and its default baseline, apps/benchmark_system.py:50-51;
# the depth and row gates are SynthCamera's (apps/benchmark_system.py:126-129)
CAMERA = {"fx": 450.0, "fy": 450.0, "cx": 376.0, "cy": 240.0, "baseline": 0.11,
          "depth_lower_thr": 0.5, "depth_upper_thr": 25.0, "max_y_diff": 2.0,
          "image_height": 480, "image_width": 752}
OUT_VO = os.path.join(REPO, "tests", "data", "torch_vo_oracle.npz")
OUT_VIO = os.path.join(REPO, "tests", "data", "torch_vio_oracle.npz")
OUT_REFINE = os.path.join(REPO, "tests", "data", "torch_refine_oracle.npz")
OUT_RELOC = os.path.join(REPO, "tests", "data", "torch_reloc_oracle.npz")
OUT_TRAIN = os.path.join(REPO, "tests", "data", "torch_train_oracle.npz")
OUT_MATCHER = os.path.join(REPO, "tests", "data", "torch_matcher_oracle.npz")
OUT_E2E = os.path.join(REPO, "tests", "data", "torch_e2e_oracle.npz")
OUT_TOOLS = os.path.join(REPO, "tests", "data", "torch_tools_oracle.npz")
# the fast head's seed and detector configuration (apps/test_feature.py's line
# threshold: at the default 0.75 the seeded head, whose scores sit just above
# 0.5, keeps no line); apps/bench_backend.py's window (frames, points, seed)
TOOLS = {"seed": 0, "fast_cfg": {"max_keypoints": 400, "line_threshold": 0.5},
         "bench": (5, 230, 0)}
TOOLS_FIELDS = ("keypoints", "kp_mask", "lines", "line_mask", "junctions", "junc_mask")
# the stage-1 sequence of scripts/verify_tpu_e2e.py:149-151 (E2E_TPU.json)
E2E = {"frames": 40, "run": 20, "stride": 2, "traj": "loop", "seed": 0, "noise_seed": 1,
       "queries": 10}
E2E_PNG_FRAMES = (0, 19)  # frames whose PNGs gate the card's render
E2E_SEQUENCES = {"rect": ("configs/camera/synth_stereo.yaml", []),
                 "dist": ("configs/camera/synth_stereo_distorted.yaml",
                          ["--distort_camera", "configs/camera/synth_stereo_distorted.yaml"])}
SYSTEM_FRAMES = 60  # apps/benchmark_system.py's loop (forward)
TRAIN_SEEDS = {"plnet": 0, "superpoint": 1}  # PRNGKey of each mode's pair (distill: superpoint's)
LEAF_SAMPLES = 256  # gradient / update values kept per leaf (every value of a smaller leaf)
MATCHER_SEEDS = {"corners": 0, "detected": 1}  # PRNGKey split into each pair set's keys
MATCHER_BATCH = 2
MATCHER_LR = 2e-4  # apps/train_matcher.py's default
MATCHER_VIEW = 2.0  # the detected pairs' curriculum (apps/train_matcher.py --view 2)
WIDE_SEEDS = (1000, 1002, 1004)  # tests/test_trained_detector.py::test_wide_viewpoint_matching
WIDE_NOISE_SEED = 1000  # numpy's pixel noise of the wide pairs: default_rng(seed + pair)
RELOC_FRAMES = 40  # apps/make_synth_dataset.py --frames (stride 2, loop, 10 hard queries)
N_RELOC_FEATS = 2  # queries whose JAX detector features are kept
FEATURE_FIELDS = ("keypoints", "kp_scores", "kp_desc", "kp_mask", "lines", "line_scores",
                  "line_mask", "junctions", "junc_scores", "junc_desc", "junc_mask")
REDUCED_SCENE = (100, 10_000)  # keyframes, points of the reduced map-scale scene
# configs/camera/synth_stereo_imu.yaml:35-40
IMU_NODE = {"rate_hz": 200.0, "gyroscope_noise_density": 0.001,
            "gyroscope_random_walk": 1.0e-05, "accelerometer_noise_density": 0.01,
            "accelerometer_random_walk": 1.0e-04, "g_value": 9.81}
# tests/test_vio.py::test_full_vio_pipeline's stream, at the VO budget
STREAM = {"duration": 8.0, "bg": (0.01, -0.015, 0.02), "n_points": 600, "world_seed": 5,
          "frame_stride": 40, "k_budget": 400,
          "noise": (1e-3, 1e-2, 1e-5, 1e-4)}  # gyr/acc noise, gyr/acc walk (√rate-scaled)
N_PAIRS = 3
N_VO = 8  # frames of the VO sequence: at least three keyframes after the first
FRAME_SEED = 3
# entry() tuple slots the metrics need: kp0, kp1, idx1, lines0, line_mask0,
# kp_mask0, junctions (both views), junction mask (both views)
KEEP = (0, 1, 2, 4, 5, 7, 8, 10)


def jax_builder(dtype=None, imu=None):
    """The JAX ``MapBuilder`` with the shipped checkpoints, SuperPoint
    keypoints and the frames' camera (float32 networks unless ``dtype``;
    ``imu``: the camera's IMU block, see ``chip_smoke.camera_node``)."""
    import jax.numpy as jnp

    from airslam_tpu.core.camera import Camera
    from airslam_tpu.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu.frontend.matcher import MatcherConfig, PointMatcher
    from airslam_tpu.models import weights as wio
    from airslam_tpu.pipelines.map_builder import MapBuilder

    dtype = dtype or jnp.float32
    det_params, mat_params = wio.load_default_frontend(use_superpoint=True)
    detector = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=True,
                                              dtype=dtype), params=det_params)
    matcher = PointMatcher(MatcherConfig(matcher=0, max_keypoints=400, dtype=dtype),
                           params=mat_params)
    # the node builder is chip_smoke.py's, which reads CAMERA back from the file
    from chip_smoke import camera_node

    return MapBuilder(Camera(node=camera_node(CAMERA, imu)), detector, matcher)


def jax_frontend(builder, pair):
    """What ``MapBuilder.add_input`` runs before ``track_features``: detect
    both views, pull the tree to the host, match. Returns (f0, f1,
    stereo_pairs, temporal_pairs-or-None)."""
    import jax
    import jax.tree_util as jtu

    left, right = builder.rectify(pair[0], pair[1])
    feats = jax.device_get(builder.detector.detect(np.stack([left, right]),
                                                   detect_junctions=True))
    f0 = jtu.tree_map(lambda t: t[0], feats)
    f1 = jtu.tree_map(lambda t: t[1], feats)
    return (f0, f1) + tuple(builder._stereo_and_temporal(f0, f1))


def jax_track(builder, timestamp, f0, f1, stereo_pairs, matches, pnp=None):
    """Track one frame against the builder's last keyframe through
    ``_build_frame`` → ``_track_frame`` → ``_keyframe_check`` and report what
    happened. ``pnp``: an optional (Twc, n_inliers) to use in place of
    ``_solve_pnp`` (OpenCV's RANSAC draws differ between versions)."""
    from airslam_tpu.frontend.lines import match_lines_by_points

    seen = {}
    solve_pnp, pose_only = builder._solve_pnp, builder._pose_only

    def pose_only_spy(cur, matched, imu_ref=None):
        seen["pnp_Twc"] = cur.Twc.copy()
        n_in, flags = pose_only(cur, matched, imu_ref)
        seen["flags"] = flags
        return n_in, flags

    def solve_pnp_spy(cur, matched):
        seen["pnp_raw"] = (pnp if pnp is not None else solve_pnp(cur, matched))
        return seen["pnp_raw"]

    builder._pose_only, builder._solve_pnp = pose_only_spy, solve_pnp_spy
    try:
        ref = builder.last_keyframe
        frame = builder._build_frame(timestamp, f0, f1, stereo_pairs)
        num_inliers = builder._track_frame(ref, frame, matches)
        decision = builder._keyframe_check(ref, frame, matches)
    finally:
        del builder._pose_only, builder._solve_pnp
    builder.last_tracked_frame = frame
    k = ref.keypoints.shape[0]
    idx1 = np.full(k, -1, np.int32)
    msk = np.zeros(k, bool)
    m = np.asarray(matches)
    idx1[m[:, 0]] = m[:, 1]
    msk[m[:, 0]] = True
    line_matches = np.asarray(match_lines_by_points(ref.points_on_lines, frame.points_on_lines,
                                                    idx1, msk))
    return {"matches": np.asarray(matches, np.int32),
            "stereo_pairs": np.asarray(stereo_pairs, np.int32),
            "good_stereo_points": np.int32(frame.good_stereo_points),
            "pnp_Twc": seen["pnp_Twc"], "pnp_raw_Twc": np.asarray(seen["pnp_raw"][0]),
            "pnp_inliers": np.int32(seen["pnp_raw"][1]), "Twc": frame.Twc.copy(),
            "num_inliers": np.int32(num_inliers),
            "inlier_flags": np.asarray(seen["flags"], np.int32).reshape(-1, 2),
            "keyframe_decision": np.int32(decision),
            "line_matches": line_matches.astype(np.int32)}


def write_tracking_oracle():
    z = np.load(OUT)
    frames = z["frames_u8"].astype(np.float32) / np.float32(255.0)
    builder = jax_builder()
    blob = {"camera_" + k: np.float64(v) for k, v in CAMERA.items()}
    first = builder.add_input(0.0, frames[0][0], frames[0][1])
    assert builder.init, f"pair 0 gave {first.good_stereo_points} stereo points: no keyframe"
    blob["init_good_stereo_points"] = np.int32(first.good_stereo_points)
    blob["init_Twc"] = first.Twc.copy()
    blob["init_mappoints"] = np.int32(sum(p.is_valid for p in builder.map.mappoints.values()))
    blob["init_maplines"] = np.int32(sum(l.is_valid for l in builder.map.maplines.values()))
    print(f"pair 0: good_stereo_points={first.good_stereo_points} "
          f"mappoints={blob['init_mappoints']} maplines={blob['init_maplines']}")
    for i in range(1, frames.shape[0]):
        f0, f1, pairs, temporal = jax_frontend(builder, frames[i])
        got = jax_track(builder, 0.05 * i, f0, f1, pairs, temporal)
        for k, v in got.items():
            blob[f"p{i}_{k}"] = v
        print(f"pair {i}: matches={len(got['matches'])} pnp_inliers={got['pnp_inliers']} "
              f"num_inliers={got['num_inliers']} decision={got['keyframe_decision']} "
              f"line_matches={int((got['line_matches'] >= 0).sum())} t={got['Twc'][:3, 3]}")
    np.savez_compressed(OUT_TRACKING, **blob)
    print(f"oracle written: {OUT_TRACKING} ({os.path.getsize(OUT_TRACKING)} bytes)")


def write_vo_oracle():
    from apps.benchmark_system import make_sequence

    ts, L, R, gt = make_sequence(N_VO, 480, 752, seed=FRAME_SEED, texture=0.1)
    frames_u8 = np.clip(np.rint(np.stack([L, R], axis=1) * 255.0), 0, 255).astype(np.uint8)
    frames = frames_u8.astype(np.float32) / np.float32(255.0)
    builder = jax_builder()
    seen = {}
    solve_pnp, pose_only = builder._solve_pnp, builder._pose_only

    def solve_pnp_spy(cur, matched):
        seen["pnp"] = solve_pnp(cur, matched)
        return seen["pnp"]

    def pose_only_spy(cur, matched, imu_ref=None):
        seen["n_in"] = pose_only(cur, matched, imu_ref)
        return seen["n_in"]

    builder._solve_pnp, builder._pose_only = solve_pnp_spy, pose_only_spy
    blob = {"camera_" + k: np.float64(v) for k, v in CAMERA.items()}
    blob.update(frames_u8=frames_u8, timestamps=np.asarray(ts, np.float64),
                gt_Twc=np.stack(gt))
    Twc, inliers, pnp_Twc, pnp_inliers, is_kf = [], [], [], [], []
    for i in range(N_VO):
        seen.clear()
        n_kf = len(builder.map.keyframe_ids)
        frame = builder.add_input(float(ts[i]), frames[i][0], frames[i][1])
        Twc.append(frame.Twc.copy())
        inliers.append(seen["n_in"][0] if "n_in" in seen else -1)
        pnp_Twc.append(np.asarray(seen["pnp"][0]) if "pnp" in seen else np.eye(4))
        pnp_inliers.append(seen["pnp"][1] if "pnp" in seen else -1)
        is_kf.append(len(builder.map.keyframe_ids) > n_kf)
        print(f"frame {i}: inliers={inliers[-1]} keyframe={is_kf[-1]} t={frame.Twc[:3, 3]}")
    m = builder.map
    blob.update(
        Twc=np.stack(Twc), num_inliers=np.asarray(inliers, np.int32),
        pnp_Twc=np.stack(pnp_Twc), pnp_inliers=np.asarray(pnp_inliers, np.int32),
        is_keyframe=np.asarray(is_kf), trajectory=np.stack([T for _, T in builder.trajectory]),
        keyframe_ids=np.asarray(m.keyframe_ids, np.int32),
        keyframe_Twc=np.stack([m.keyframes[f].Twc for f in m.keyframe_ids]),
        n_mappoints=np.int32(sum(p.is_valid for p in m.mappoints.values())),
        n_maplines=np.int32(sum(l.is_valid for l in m.maplines.values())))
    print(f"keyframes={m.keyframe_ids} mappoints={blob['n_mappoints']} "
          f"maplines={blob['n_maplines']}")
    assert len(m.keyframe_ids) >= 4, "fewer than three keyframes after the first"
    np.savez_compressed(OUT_VO, **blob)
    print(f"oracle written: {OUT_VO} ({os.path.getsize(OUT_VO)} bytes)")


def dataset_imu_slices(frame_t, imu_t, gyr, acc):
    """The JAX ``Dataset``'s IMU chunking of these rows between these frames,
    read from an ASL tree of their nanosecond stamps (the images are empty
    files: the loader reads them only in ``get``). Returns (frame stamps,
    row stamps as the loader parsed them, (N, 2) [lo, hi) row slice per
    frame)."""
    import tempfile

    from airslam_tpu.io.dataset import Dataset

    with tempfile.TemporaryDirectory() as root:
        for cam in ("cam0", "cam1"):
            os.makedirs(os.path.join(root, cam, "data"))
            for t in frame_t:
                open(os.path.join(root, cam, "data", f"{int(round(t * 1e9))}.png"), "w").close()
        os.makedirs(os.path.join(root, "imu0"))
        with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
            for k, t in enumerate(imu_t):
                f.write(",".join([str(int(round(t * 1e9)))]
                                 + [repr(float(v)) for v in (*gyr[k], *acc[k])]) + "\n")
        ds = Dataset(root, use_imu=True)
    assert len(ds) == len(frame_t), "a frame fell outside the IMU's range"
    parsed = np.asarray([int(round(t * 1e9)) * 1e-9 for t in imu_t])
    slices = []
    for batch in ds.imu_batches:
        lo = int(np.nonzero(parsed == batch[0].timestamp)[0][0]) if batch else 0
        slices.append((lo, lo + len(batch)))
        assert all(r.timestamp == parsed[lo + j] for j, r in enumerate(batch))
    return np.asarray(ds.timestamps), parsed, np.asarray(slices, np.int32)


def synth_imu_rows(frame_t):
    """``apps/make_synth_dataset.py:173-182``'s IMU for the ``forward``
    trajectory at stride 1: one sample before the first frame to one past the
    last, zero body rates, the analytic acceleration plus g on z."""
    from apps.make_synth_dataset import G_VALUE, IMU_RATE, traj_accel

    t_imu = np.arange(-1, int(frame_t[-1] * IMU_RATE) + 2) / IMU_RATE
    acc = traj_accel(np.maximum(t_imu, 0.0), "forward", None)
    acc[:, 2] += G_VALUE
    return t_imu, np.zeros_like(acc), acc


def _rows(imu_t, gyr, acc, lo, hi):
    from airslam_tpu.core.imu import ImuData

    return [ImuData(float(imu_t[k]), gyr[k], acc[k]) for k in range(lo, hi)]


def _keyframe_preints(m, blob, prefix):
    ids = [f for f in m.keyframe_ids if m.keyframes[f].preintegration is not None]
    pres = [m.keyframes[f].preintegration for f in ids]
    blob[prefix + "preint_ids"] = np.asarray(ids, np.int32)
    for key in ("dT", "dR", "dV", "dP"):
        blob[prefix + "preint_" + key] = np.stack([np.asarray(getattr(p.state, key))
                                                   for p in pres])


def write_vio_oracle():
    vo = np.load(OUT_VO)
    frames = vo["frames_u8"].astype(np.float32) / np.float32(255.0)
    blob = {"camera_" + k: np.float64(v) for k, v in CAMERA.items()}
    blob.update({"imu_" + k: np.float64(v) for k, v in IMU_NODE.items()})

    # (a) the image path
    t_imu, gyr, acc = synth_imu_rows(vo["timestamps"])
    frame_t, imu_t, slices = dataset_imu_slices(vo["timestamps"], t_imu, gyr, acc)
    builder = jax_builder(imu=IMU_NODE)
    Twc, is_kf = [], []
    for i in range(len(frames)):
        n_kf = len(builder.map.keyframe_ids)
        frame = builder.add_input(float(frame_t[i]), frames[i][0], frames[i][1],
                                  _rows(imu_t, gyr, acc, *slices[i]))
        Twc.append(frame.Twc.copy())
        is_kf.append(len(builder.map.keyframe_ids) > n_kf)
        print(f"(a) frame {i}: keyframe={is_kf[-1]} t={frame.Twc[:3, 3]}")
    m = builder.map
    assert not m.imu_initialized
    blob.update(a_frame_t=frame_t, a_imu_t=imu_t, a_imu_gyr=gyr, a_imu_acc=acc,
                a_imu_slices=slices, a_Twc=np.stack(Twc), a_is_keyframe=np.asarray(is_kf),
                a_keyframe_ids=np.asarray(m.keyframe_ids, np.int32),
                a_n_mappoints=np.int32(sum(p.is_valid for p in m.mappoints.values())),
                a_n_maplines=np.int32(sum(l.is_valid for l in m.maplines.values())))
    _keyframe_preints(m, blob, "a_")
    print(f"(a) keyframes={m.keyframe_ids} mappoints={blob['a_n_mappoints']} "
          f"maplines={blob['a_n_maplines']}")

    # (b) the initialization stream
    from airslam_tpu.pipelines.map_builder import KeyframeConfig, MapBuilder
    from tests import test_vo_pipeline as jvo
    from tests.synthetic import make_imu_sequence

    seq = make_imu_sequence(duration=STREAM["duration"], bg=np.asarray(STREAM["bg"]))
    rng = np.random.RandomState(STREAM["world_seed"])
    n = STREAM["n_points"]
    pts = np.stack([rng.uniform(-4, 6, n), rng.uniform(-3, 3, n), rng.uniform(3, 11, n)],
                   axis=-1)
    desc = rng.randn(n, 256).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cam = jvo.FakeCamera()
    cam.use_imu = True
    cam.gyr_noise, cam.acc_noise, cam.gyr_walk, cam.acc_walk = STREAM["noise"]
    builder = MapBuilder(cam, detector=None, matcher=jvo.FakeMatcher(),
                         kf_config=KeyframeConfig(min_init_stereo_feature=40,
                                                  max_num_match=500, tracking_point_rate=2.0))
    jvo.K_BUDGET = STREAM["k_budget"]  # the renderer reads its budget at call time
    times = seq["times"]
    idx = np.arange(0, len(times), STREAM["frame_stride"])
    kp, ur, ids, slices, init_kf = [], [], [], [], -1
    last_i = 0
    for n_frame, i in enumerate(idx):
        T = np.eye(4)
        T[:3, :3] = seq["Rwb"][i]
        T[:3, 3] = seq["pos"][i]
        fl, fr, pairs = jvo.render_features(pts, desc, T, cam, rng)
        k = int(fl.kp_mask.sum())
        sim = fl.kp_desc[:k] @ desc.T
        ids.append(np.concatenate([sim.argmax(1), np.full(len(fl.kp_mask) - k, -1)]))
        kp.append(fl.keypoints)
        ur.append(fr.keypoints[:, 0])
        lo, hi = (max(last_i - 1, 0), i + 2) if n_frame else (0, 0)
        slices.append((lo, min(hi, len(times))))
        builder.track_features(times[i], fl, fr, pairs,
                               imu_batch=_rows(times, seq["gyr"], seq["acc"], *slices[-1])
                               if n_frame else None)
        if builder.map.imu_initialized and init_kf < 0:
            init_kf = builder.map.keyframe_ids[-1]
        last_i = i
        print(f"(b) frame {n_frame}: keyframes={len(builder.map.keyframe_ids)} "
              f"imu_initialized={builder.map.imu_initialized}")
    m = builder.map
    assert m.imu_initialized and init_kf >= 0
    kfs = [m.keyframes[f] for f in m.keyframe_ids]
    blob.update(
        b_frame_t=times[idx], b_frame_idx=idx.astype(np.int32),
        b_kp=np.stack(kp).astype(np.float32), b_ur=np.stack(ur).astype(np.float32),
        b_ids=np.stack(ids).astype(np.int16), b_desc=desc, b_imu_t=times,
        b_imu_gyr=seq["gyr"], b_imu_acc=seq["acc"], b_imu_slices=np.asarray(slices, np.int32),
        b_true_pos=seq["pos"][idx], b_true_bg=np.asarray(STREAM["bg"]),
        b_noise=np.asarray(STREAM["noise"]), b_n_lines=np.int32(jvo.L_BUDGET),
        b_n_junctions=np.int32(8),
        b_keyframe_ids=np.asarray(m.keyframe_ids, np.int32), b_init_keyframe=np.int32(init_kf),
        b_Rwg=m.Rwg, b_keyframe_Twc=np.stack([f.Twc for f in kfs]),
        b_keyframe_velocity=np.stack([f.velocity for f in kfs]),
        b_keyframe_bg=np.stack([f.bg for f in kfs]), b_keyframe_ba=np.stack([f.ba for f in kfs]),
        b_trajectory=np.stack([T for _, T in builder.trajectory]),
        b_n_mappoints=np.int32(sum(p.is_valid for p in m.mappoints.values())),
        b_n_maplines=np.int32(sum(l.is_valid for l in m.maplines.values())))
    print(f"(b) keyframes={m.keyframe_ids} init at {init_kf} bg={kfs[-1].bg} "
          f"mappoints={blob['b_n_mappoints']}")
    np.savez_compressed(OUT_VIO, **blob)
    print(f"oracle written: {OUT_VIO} ({os.path.getsize(OUT_VIO)} bytes)")


def write_frontend_oracle():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import entry
    from apps.benchmark_system import make_sequence

    _, L, R, _ = make_sequence(N_PAIRS, 480, 752, seed=FRAME_SEED, texture=0.1)
    frames = np.stack([np.stack([L[i], R[i]]) for i in range(N_PAIRS)])
    frames_u8 = np.clip(np.rint(frames * 255.0), 0, 255).astype(np.uint8)
    blob = {"frames_u8": frames_u8}

    fn, args = entry(dtype=jnp.float32)
    plp, loip, lgp, _ = args
    fnj = jax.jit(fn)
    for i in range(N_PAIRS):
        pair = jnp.asarray(frames_u8[i].astype(np.float32) / np.float32(255.0))
        out = fnj(plp, loip, lgp, pair)
        for j in KEEP:
            blob[f"p{i}_o{j}"] = np.asarray(out[j])
        print(f"pair {i}: kps={int(np.asarray(out[7]).sum())} "
              f"lines={int(np.asarray(out[5]).sum())} "
              f"matches={int((np.asarray(out[2]) >= 0).sum())}")

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **blob)
    print(f"oracle written: {OUT} ({os.path.getsize(OUT)} bytes)")


def _keyframe_ate(m, ref_poses):
    """Keyframe position RMSE against ``ref_poses`` (no alignment)."""
    err = [np.linalg.norm(m.keyframes[f].Twc[:3, 3] - ref_poses[f][:3, 3])
           for f in m.keyframe_ids]
    return float(np.sqrt(np.mean(np.square(err))))


def _refine_voc(m):
    """tests/test_refinement.py's vocabulary for a map."""
    from airslam_tpu.loopclosure.vocabulary import train_vocabulary

    all_desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask]
                               for f in m.keyframe_ids])
    return train_vocabulary(all_desc[::3], k=6, depth=3, seed=1)


def _counting_refiner(m, voc):
    """A JAX ``MapRefiner`` that counts its pose-only solves."""
    from airslam_tpu.pipelines.map_refiner import MapRefiner
    from tests.test_vo_pipeline import FakeMatcher

    r = MapRefiner(m, FakeMatcher(), voc)
    r.n_pose_only = 0
    solve = r._pose_only

    def counted(*args):
        r.n_pose_only += 1
        return solve(*args)

    r._pose_only = counted
    return r


def _dense_sparse_gap(path):
    """Max keyframe-position and mappoint gaps between the JAX dense and
    sparse global BA on the map at ``path``, in the process's float type."""
    import copy

    from airslam_tpu.io.serialization import load_map

    base, _ = load_map(path)
    dense, sparse = copy.deepcopy(base), copy.deepcopy(base)
    dense.global_bundle_adjustment(iters1=50, iters2=40)
    frames = [sparse.keyframes[f] for f in reversed(sparse.keyframe_ids)]
    fixed = np.zeros(len(frames), bool)
    fixed[-1] = True
    sparse._sparse_global_ba(
        frames, fixed, [p for p in sparse.mappoints.values() if p.is_valid and p.observers],
        [l for l in sparse.maplines.values() if l.is_valid and l.observers], 50, 40)
    kf = max(np.abs(dense.keyframes[f].Twc[:3, 3] - sparse.keyframes[f].Twc[:3, 3]).max()
             for f in dense.keyframe_ids)
    mp = max(np.abs(dense.mappoints[i].position - sparse.mappoints[i].position).max()
             for i in dense.mappoints if dense.mappoints[i].is_valid
             and sparse.mappoints[i].is_valid)
    return float(kf), float(mp)


def write_refine_oracle():
    import copy
    import subprocess
    import tempfile

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from airslam_tpu.backend import gn, global_ba as gba
    from airslam_tpu.io.serialization import load_map, save_map
    from airslam_tpu.loopclosure.vocabulary import train_vocabulary
    from airslam_tpu.pipelines.map_builder import KeyframeConfig, MapBuilder
    from tests import test_refinement as tref
    from tests.test_pose_graph_refinement import _drift_T
    from tests.synthetic import default_intrinsics
    from tests.test_vo_pipeline import FakeCamera, FakeMatcher, render_features

    tmp = tempfile.mkdtemp()
    builder = MapBuilder(FakeCamera(), detector=None, matcher=FakeMatcher(),
                         kf_config=KeyframeConfig(min_init_stereo_feature=50, max_num_match=200,
                                                  tracking_point_rate=0.95))
    pts, desc = tref.corridor_world()
    rng = np.random.RandomState(11)
    for i, T in enumerate(tref.loop_trajectory()):
        builder.track_features(i * 0.1, *render_features(pts, desc, T, FakeCamera(), rng,
                                                         max_depth=tref.MAX_DEPTH))
    mapv0 = os.path.join(tmp, "AirSLAM_mapv0.bin")
    save_map(builder.map, mapv0)
    blob = {}

    # (a) the corridor loop
    m, _ = load_map(mapv0)
    ids = list(m.keyframe_ids)
    valid = sorted(i for i, p in m.mappoints.items() if p.is_valid)
    clean = {f: m.keyframes[f].Twc.copy() for f in ids}
    blob.update(a_kf_ids=np.asarray(ids), a_kf_Twc=np.stack([clean[f] for f in ids]),
                a_mp_ids=np.asarray(valid),
                a_mp_pos=np.stack([m.mappoints[i].position for i in valid]))
    voc = _refine_voc(m)
    blob["a_voc_weights"] = np.asarray(voc.weights)
    r = _counting_refiner(m, voc)
    r.run(pose_graph_min_mappoints=10 ** 9)
    blob.update(
        a_loop=np.asarray([[lp.query_id, lp.loop_id] for lp in r.loop_pairs]).reshape(-1, 2),
        a_Rlq=np.asarray([lp.Rlq for lp in r.loop_pairs]).reshape(-1, 3, 3),
        a_tlq=np.asarray([lp.tlq for lp in r.loop_pairs]).reshape(-1, 3),
        a_n_merged=np.asarray([r.n_merged_mappoints, r.n_merged_maplines]),
        a_refined_ts=np.asarray([m.keyframes[f].timestamp for f in m.keyframe_ids]),
        a_refined_Twc=np.stack([m.keyframes[f].Twc for f in m.keyframe_ids]),
        a_n_pose_only=np.asarray(r.n_pose_only))
    print(f"(a) {len(ids)} keyframes, {len(valid)} mappoints; loops {blob['a_loop'].tolist()}, "
          f"merged {blob['a_n_merged'].tolist()}, pose-only solves {r.n_pose_only}")

    # (b) the drifted map, pose graph on
    m, _ = load_map(mapv0)
    m.apply_pose_corrections({f: _drift_T(k / (len(ids) - 1)) @ m.keyframes[f].Twc
                              for k, f in enumerate(ids)})
    ate = [_keyframe_ate(m, clean)]
    r = _counting_refiner(m, _refine_voc(m))
    corrections = {}
    apply = m.apply_pose_corrections

    def record(c):
        corrections.update(c)
        apply(c)
        ate.append(_keyframe_ate(m, clean))

    m.apply_pose_corrections = record
    r.run(pose_graph_min_mappoints=1)
    ate.append(_keyframe_ate(m, clean))
    blob.update(
        b_loop=np.asarray([[lp.query_id, lp.loop_id] for lp in r.loop_pairs]).reshape(-1, 2),
        b_corrections=np.stack([corrections[f] for f in ids]),
        b_ate=np.asarray(ate), b_n_pose_only=np.asarray(r.n_pose_only))
    print(f"(b) loops {blob['b_loop'].tolist()}, ATE before / after the pose graph / after "
          f"the run: {ate}")

    # (c) dense against sparse global BA, float32 as on the TPU, float64 beside
    gap64 = _dense_sparse_gap(mapv0)
    jax.config.update("jax_enable_x64", False)
    try:
        gap32 = _dense_sparse_gap(mapv0)
    finally:
        jax.config.update("jax_enable_x64", True)
    blob.update(c_gap_f32=np.asarray(gap32), c_gap_f64=np.asarray(gap64))
    print(f"(c) dense vs sparse global BA, keyframes / mappoints: f32 {gap32}, f64 {gap64}")

    # (d) the reduced map-scale scene, float64
    sc = chip_smoke.map_scale_scene(*REDUCED_SCENE)
    dt = jnp.float64
    sp = gba.SparseBAProblem(
        Rwb=jnp.asarray(sc["Rwb"], dt), twb=jnp.asarray(sc["twb0"], dt),
        pose_fixed=jnp.asarray(sc["pose_fixed"]), points=jnp.asarray(sc["pts0"], dt),
        pobs_pidx=jnp.asarray(sc["pidx"], jnp.int32), pobs_fidx=jnp.asarray(sc["fidx"], jnp.int32),
        pobs=jnp.asarray(sc["pobs"], dt), pobs_mask=jnp.asarray(sc["ok"]),
        point_obs_table=jnp.asarray(sc["table"], jnp.int32),
        lines=jnp.asarray([[1.0, 0, 0, 0, 1, 0]], dt), lobs_lidx=jnp.zeros(1, jnp.int32),
        lobs_fidx=jnp.zeros(1, jnp.int32), lobs=jnp.zeros((1, 8), dt),
        lobs_stereo=jnp.zeros(1, bool), lobs_mask=jnp.zeros(1, bool),
        lobs_sigma=jnp.full((1,), 0.001, dt), line_obs_table=jnp.full((1, 1), 1, jnp.int32),
        Rcb=jnp.eye(3, dtype=dt), tcb=jnp.zeros(3, dt))
    intr, cfg = default_intrinsics(dt), gn.BAConfig()
    cost0 = float(gba._total_cost(sp, intr, cfg, False))
    out = gba.optimize(sp, intr, cfg, iterations=3, robust=False, chunk=4096)
    blob.update(d_cost=np.asarray([cost0, float(gba._total_cost(out, intr, cfg, False))]),
                d_twb=np.asarray(out.twb), d_points=np.asarray(out.points, np.float32))
    print(f"(d) {REDUCED_SCENE} scene, {int(sc['ok'].sum())} observations: cost "
          f"{blob['d_cost'].tolist()}")

    # (e) the JAX CLI on map (a)'s mapv0
    m, _ = load_map(mapv0)
    all_desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask] for f in ids])
    voc_path = os.path.join(tmp, "voc.npz")
    train_vocabulary(all_desc, k=10).save(voc_path)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "map_refinement.py"), "--config_path",
         os.path.join(REPO, "configs", "map_refinement", "mr_euroc.yaml"), "--map_root", tmp,
         "--voc_path", voc_path, "--device", "cpu"], capture_output=True, text=True,
        check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    counts = {}
    for ln in res.stdout.splitlines():
        if ln.startswith("loop pairs:"):
            counts["loops"] = int(ln.split()[-1])
        if ln.startswith("merged mappoints:"):
            counts["points"], counts["lines"] = int(ln.split()[2]), int(ln.split()[-1])
    blob.update(e_counts=np.asarray([counts["loops"], counts["points"], counts["lines"]]),
                e_traj_v1=np.loadtxt(os.path.join(tmp, "trajectory_v1.txt")))
    print(f"(e) the JAX CLI: loops {counts['loops']}, merged {counts['points']} / "
          f"{counts['lines']}")

    np.savez_compressed(OUT_REFINE, **blob)
    print(f"oracle written: {OUT_REFINE} ({os.path.getsize(OUT_REFINE)} bytes)")


def _jax_reloc_user(map_root, cfg_path):
    """The JAX relocalization CLI's set-up (apps/relocalization.py:391-429)
    in this process: map, databases, f32 networks, MapUser."""
    from airslam_tpu.frontend.detector import FeatureDetector
    from airslam_tpu.frontend.matcher import PointMatcher
    from airslam_tpu.io.config import RelocalizationConfigs
    from airslam_tpu.io.serialization import load_map
    from airslam_tpu.loopclosure.database import Database
    from airslam_tpu.loopclosure.vocabulary import Vocabulary
    from airslam_tpu.models.weights import load_default_frontend
    from airslam_tpu.pipelines.map_user import MapUser

    cfg = RelocalizationConfigs.load(cfg_path)
    m, dbs = load_map(os.path.join(map_root, "AirSLAM_mapv1.bin"))
    point_db = Database(Vocabulary.load(os.path.join(map_root, "point_voc.npz")))
    point_db.load_state_dict(dbs["point"])
    junction_db = None
    if os.path.exists(os.path.join(map_root, "junction_voc.npz")):
        junction_db = Database(Vocabulary.load(os.path.join(map_root, "junction_voc.npz")))
        if "junction" in dbs:
            junction_db.load_state_dict(dbs["junction"])
    det_params, mat_params = load_default_frontend(cfg.detector.use_superpoint,
                                                   cfg.matcher.matcher)
    return MapUser(m, FeatureDetector(cfg.detector, params=det_params),
                   PointMatcher(cfg.matcher, params=mat_params), point_db, junction_db,
                   min_inlier_num=cfg.min_inlier_num, pose_refinement=cfg.pose_refinement)


def _superglue_oracle(blob):
    """The JAX detector (stage-3 configuration) and SuperGlue on the 3
    frontend-oracle pairs: each accepted match's coordinates and score."""
    import dataclasses

    from airslam_tpu.frontend.detector import FeatureDetector
    from airslam_tpu.frontend.matcher import PointMatcher
    from airslam_tpu.io.config import RelocalizationConfigs
    from airslam_tpu.models.weights import load_default_frontend

    cfg = RelocalizationConfigs.load(os.path.join(REPO, "configs", "relocalization",
                                                  "reloc_euroc.yaml"))
    det_params, sg_params = load_default_frontend(False, 1)
    det = FeatureDetector(cfg.detector, params=det_params)
    sg = PointMatcher(dataclasses.replace(cfg.matcher, matcher=1, sinkhorn_iterations=20),
                      params=sg_params)
    frames = np.load(OUT)["frames_u8"].astype(np.float32) / np.float32(255.0)
    for i in range(frames.shape[0]):
        f = det.detect(frames[i], detect_junctions=True)
        m = sg.match(*(np.asarray(getattr(f, k)[v]) for v in (0, 1)
                       for k in ("keypoints", "kp_scores", "kp_desc", "kp_mask")))
        ok = np.asarray(m.mask)
        kp0, kp1 = np.asarray(f.keypoints[0]), np.asarray(f.keypoints[1])
        blob[f"sg{i}_pairs"] = np.concatenate([kp0[ok], kp1[np.asarray(m.idx1)[ok]]], -1)
        blob[f"sg{i}_score"] = np.asarray(m.score)[ok]
        print(f"superglue pair {i}: {int(ok.sum())} matches")


def write_reloc_oracle():
    import json
    import lzma
    import shutil
    import subprocess
    import tempfile

    import cv2

    from airslam_tpu.io.trajectory import load_tum

    tmp = tempfile.mkdtemp()
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run(args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable] + args, cwd=REPO, capture_output=True, text=True,
                             env=env)
        if res.returncode:
            raise RuntimeError(f"{args[0]} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(f"{args[0]}: {time.perf_counter() - t0:.1f} s")
        return res.stdout

    run(["apps/make_synth_dataset.py", "--out", os.path.join(tmp, "ds"), "--frames",
         str(RELOC_FRAMES), "--stride", "2", "--traj", "loop", "--hard_queries", "10"])
    mav0 = os.path.join(tmp, "ds", "SYNTH_01", "mav0")
    vo_dir, map_root = os.path.join(tmp, "vo"), os.path.join(tmp, "map")
    run(["apps/visual_odometry.py", "--config_path",
         "configs/visual_odometry/vo_euroc.yaml", "--camera_config_path",
         "configs/camera/synth_stereo.yaml", "--dataroot", mav0, "--saving_dir", vo_dir,
         "--device", "cpu"])
    os.makedirs(map_root)
    shutil.copy(os.path.join(vo_dir, "AirSLAM_mapv0.bin"), map_root)
    voc_shared = os.path.join(tmp, "point_voc_shared.npz")
    run(["apps/map_refinement.py", "--config_path", "configs/map_refinement/mr_euroc.yaml",
         "--map_root", map_root, "--voc_path", voc_shared, "--device", "cpu"])
    shutil.copy(voc_shared, os.path.join(map_root, "point_voc.npz"))
    qdir = os.path.join(mav0, "hard0", "data")
    cfg_path = os.path.join(REPO, "configs", "relocalization", "reloc_euroc.yaml")
    traj = os.path.join(tmp, "reloc.txt")
    out = run(["apps/relocalization.py", "--config_path", cfg_path, "--map_root", map_root,
               "--query_folder", qdir, "--traj_path", traj, "--diagnose", "--device", "cpu"])
    diag = [ln for ln in out.splitlines() if ln.startswith("diag ")]
    recall = [ln for ln in out.splitlines() if ln.startswith("recall:")][-1]
    print(recall)

    def read(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)

    names = sorted(os.listdir(qdir), key=lambda n: float(os.path.splitext(n)[0]))
    # the mapv1 pickle, LZMA-compressed: its dictionary reaches the mappoint
    # descriptors' copies of keyframe rows
    blob = {"mapv1_xz": np.frombuffer(lzma.compress(
                read(os.path.join(map_root, "AirSLAM_mapv1.bin")).tobytes(),
                preset=9 | lzma.PRESET_EXTREME), np.uint8),
            "point_voc": read(os.path.join(map_root, "point_voc.npz")),
            "junction_voc": read(os.path.join(map_root, "junction_voc.npz")),
            "query_names": np.asarray(names),
            "gt_tum": read(os.path.join(mav0, "hard0", "gt_tum.txt")),
            "cli_recall": np.asarray(recall), "cli_diag": np.asarray(diag),
            "cli_traj": np.loadtxt(traj, ndmin=2)}
    for i, n in enumerate(names):
        blob[f"q{i}_png"] = read(os.path.join(qdir, n))

    # the same relocalizer in this process: Twc of every query, last_stats,
    # the deputies of the top-3 match and the detector's features
    user = _jax_reloc_user(map_root, cfg_path)
    detect, batched = user.detector.detect, user.matcher.matching_points_batched
    seen = {}

    def detect_rec(images, detect_junctions=False):
        f = detect(images, detect_junctions)
        seen["feats"] = f
        return f

    def batched_rec(pairs, *a, **k):
        seen.setdefault("deputies", [kf.frame_id for _, kf in pairs])
        return batched(pairs, *a, **k)

    user.detector.detect, user.matcher.matching_points_batched = detect_rec, batched_rec
    ok_all, Twc_all, stats_all, dep_all = [], [], [], []
    for i, n in enumerate(names):
        img = cv2.imread(os.path.join(qdir, n), cv2.IMREAD_GRAYSCALE)
        seen.clear()
        ok, Twc = user.relocalize_image(img.astype(np.float32) / 255.0)
        ok_all.append(bool(ok))
        Twc_all.append(np.asarray(Twc, np.float64))
        stats_all.append(json.dumps(user.last_stats, default=lambda o: o.item()))
        dep_all.append(seen.get("deputies", []))
        if i < N_RELOC_FEATS:
            for k in FEATURE_FIELDS:
                blob[f"q{i}_{k}"] = np.asarray(getattr(seen["feats"], k)[0])
        same = diag[i].split(" ok=")[1].startswith(str(bool(ok)))
        print(f"query {i} {n}: ok={ok} stats={stats_all[-1]} deputies={dep_all[-1]}"
              f"{'' if same else ' (the CLI decided otherwise)'}")
    blob.update(ok=np.asarray(ok_all), Twc=np.stack(Twc_all), stats=np.asarray(stats_all),
                deputies=np.asarray([d + [-1] * (3 - len(d)) for d in dep_all]))
    acc = [i for i, ok in enumerate(ok_all) if ok]
    if len(acc) == len(blob["cli_traj"]):
        d = max((float(np.abs(Twc_all[i][:3, 3] - blob["cli_traj"][j, 1:4]).max())
                 for j, i in enumerate(acc)), default=0.0)
        print(f"in-process poses against the CLI's trajectory: {d:.3e} m")
    gt = {round(t, 6): T for t, T in load_tum(os.path.join(mav0, "hard0", "gt_tum.txt"))}
    print(f"gt stamps {len(gt)}")

    _superglue_oracle(blob)
    np.savez_compressed(OUT_RELOC, **blob)
    print(f"oracle written: {OUT_RELOC} ({os.path.getsize(OUT_RELOC)} bytes)")


def jax_world_sequence(n_frames, height, width, noise, seed=0, baseline=0.11, stride=1,
                       traj="forward", intrinsics=None):
    """``apps.benchmark_system.make_sequence`` without texture or photometrics,
    with ``noise`` (N, 2, H, W) standard normal in place of JAX's pixel
    noise: ``render_view3d(key=None)`` of ``make_world3d(PRNGKey(seed))``,
    then + 0.01 × noise, clipped to [0, 1]."""
    import jax
    import jax.numpy as jnp

    from airslam_tpu.frontend import synthgen
    from apps.benchmark_system import traj_position

    fx, fy, cx, cy = intrinsics or (CAMERA["fx"], CAMERA["fy"], CAMERA["cx"], CAMERA["cy"])
    fx, fy, cx, cy = (float(v) for v in (fx, fy, cx, cy))
    world = synthgen.make_world3d(jax.random.PRNGKey(seed))
    render = jax.jit(lambda tcw: synthgen.render_view3d(
        world, jnp.eye(3, dtype=jnp.float32), tcw, fx, fy, cx, cy, height, width, None))
    ts = np.arange(n_frames) * 0.05 * stride
    total = float(n_frames * 0.05 * stride)
    gt, lefts, rights = [], [], []
    for k in range(n_frames):
        T = np.eye(4)
        T[:3, 3] = traj_position(ts[k], traj, total)
        gt.append(T)
        for v, out in ((0, lefts), (1, rights)):
            tcw = -T[:3, 3] - np.array([baseline * v, 0.0, 0.0])
            img = np.asarray(render(jnp.asarray(tcw, jnp.float32)))
            out.append(np.clip(img + noise[k, v] * 0.01, 0.0, 1.0))
    return ts, np.stack(lefts), np.stack(rights), gt


def e2e_noise(n_frames, height=480, width=752):
    return np.random.default_rng(E2E["noise_seed"]).standard_normal(
        (n_frames, 2, height, width), dtype=np.float32)


def e2e_stages(blob, mav0, work, env):
    """Stages 1-3 of ``scripts/verify_tpu_e2e.py`` on the rectified tree at
    ``mav0``, float32 on the CPU: the JAX VO CLI over every frame, the JAX
    refinement CLI (run in this process, so that its loop pairs can be read)
    on that mapv0 with the shared point vocabulary it trains, and the JAX
    relocalization CLI on the tree's hard queries. The queries are the
    relocalization oracle's: the same world, trajectory and JAX noise keys
    (checked byte for byte), so only their ground truth is stored again."""
    import lzma
    import shutil
    import subprocess

    import airslam_tpu.pipelines.map_refiner as mr
    import apps.map_refinement as amr
    from airslam_tpu.io.serialization import load_map

    def read(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)

    def run(args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable] + args, cwd=REPO, capture_output=True, text=True,
                             env=env)
        if res.returncode:
            raise RuntimeError(f"{args[0]} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(f"{args[0]}: {time.perf_counter() - t0:.1f} s")
        return res.stdout

    qdir = os.path.join(mav0, "hard0", "data")
    names = sorted(os.listdir(qdir), key=lambda n: float(os.path.splitext(n)[0]))
    reloc = np.load(OUT_RELOC)
    same = ([str(n) for n in reloc["query_names"]] == names
            and np.array_equal(reloc["gt_tum"], read(os.path.join(mav0, "hard0", "gt_tum.txt")))
            and all(np.array_equal(reloc[f"q{i}_png"], read(os.path.join(qdir, n)))
                    for i, n in enumerate(names)))
    if not same:
        raise RuntimeError("the hard queries differ from the relocalization oracle's: "
                           "regenerate that oracle first")

    vo_dir, map_root = os.path.join(work, "vo"), os.path.join(work, "map")
    run(["apps/visual_odometry.py", "--config_path", "configs/visual_odometry/vo_euroc.yaml",
         "--camera_config_path", "configs/camera/synth_stereo.yaml", "--dataroot", mav0,
         "--saving_dir", vo_dir, "--device", "cpu"])
    mapv0 = os.path.join(vo_dir, "AirSLAM_mapv0.bin")
    m, _ = load_map(mapv0)
    blob.update(
        full_keyframe_ids=np.asarray(m.keyframe_ids),
        full_n_mappoints=np.asarray(sum(p.is_valid for p in m.mappoints.values())),
        full_n_maplines=np.asarray(sum(l.is_valid for l in m.maplines.values())),
        full_traj=np.loadtxt(os.path.join(vo_dir, "trajectory_v0.txt"), ndmin=2),
        # the mapv0 pickle, LZMA-compressed as the relocalization oracle's mapv1
        full_mapv0_xz=np.frombuffer(lzma.compress(read(mapv0).tobytes(),
                                                  preset=9 | lzma.PRESET_EXTREME), np.uint8))
    print(f"full: keyframes {m.keyframe_ids}, {int(blob['full_n_mappoints'])} mappoints, "
          f"{int(blob['full_n_maplines'])} maplines")

    # the refinement CLI in this process, its refiner kept
    os.makedirs(map_root)
    shutil.copy(mapv0, map_root)
    voc_shared = os.path.join(work, "point_voc_shared.npz")
    made = []

    class Recording(mr.MapRefiner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    saved = mr.MapRefiner, sys.argv
    mr.MapRefiner = Recording
    sys.argv = ["map_refinement.py", "--config_path", os.path.join(
        REPO, "configs", "map_refinement", "mr_euroc.yaml"), "--map_root", map_root,
        "--voc_path", voc_shared, "--device", "cpu"]
    t0 = time.perf_counter()
    try:
        amr.main()
    finally:
        mr.MapRefiner, sys.argv = saved
    print(f"apps/map_refinement.py (in process): {time.perf_counter() - t0:.1f} s")
    r = made[0]
    pairs = r.loop_pairs
    blob.update(
        s2_point_voc=read(voc_shared),
        s2_junction_voc=read(os.path.join(map_root, "junction_voc.npz")),
        s2_loop=np.asarray([[lp.query_id, lp.loop_id] for lp in pairs]).reshape(-1, 2),
        s2_Rlq=np.asarray([np.asarray(lp.Rlq) for lp in pairs], np.float64).reshape(-1, 3, 3),
        s2_tlq=np.asarray([np.asarray(lp.tlq) for lp in pairs], np.float64).reshape(-1, 3),
        s2_n_merged=np.asarray([r.n_merged_mappoints, r.n_merged_maplines]),
        s2_traj_v1=np.loadtxt(os.path.join(map_root, "trajectory_v1.txt"), ndmin=2))
    print(f"refinement: loops {blob['s2_loop'].tolist()}, merged "
          f"{blob['s2_n_merged'].tolist()}, pose graph {bool(r.pose_graph_ran)}")

    # the relocalization CLI on the refined map and the shared vocabulary
    shutil.copy(voc_shared, os.path.join(map_root, "point_voc.npz"))
    traj = os.path.join(work, "reloc.txt")
    out = run(["apps/relocalization.py", "--config_path", "configs/relocalization/reloc_euroc.yaml",
               "--map_root", map_root, "--query_folder", qdir, "--traj_path", traj,
               "--diagnose", "--device", "cpu"])
    diag = [ln for ln in out.splitlines() if ln.startswith("diag ")]
    ok = np.asarray([ln.split(" ok=")[1].startswith("True") for ln in diag])
    rows = np.loadtxt(traj, ndmin=2)
    stamps = {round(float(n[:-4]) * 1e-9, 6): i for i, n in enumerate(names)}
    Twc = np.full((len(names), 4, 4), np.nan)
    from scipy.spatial.transform import Rotation

    for row in rows:
        i = stamps[round(row[0], 6)]
        Twc[i] = np.eye(4)
        Twc[i, :3, :3] = Rotation.from_quat(row[4:8]).as_matrix()
        Twc[i, :3, 3] = row[1:4]
    recall = [ln for ln in out.splitlines() if ln.startswith("recall:")][-1]
    blob.update(s3_ok=ok, s3_Twc=Twc, s3_recall=np.asarray(float(ok.mean())),
                s3_gt_tum=read(os.path.join(mav0, "hard0", "gt_tum.txt")))
    print(f"relocalization: {recall}, ok {ok.astype(int).tolist()}")


def write_e2e_oracle():
    import shutil
    import subprocess
    import tempfile

    import jax

    import apps.benchmark_system as bs
    import apps.make_synth_dataset as msd
    from airslam_tpu.frontend import synthgen
    from airslam_tpu.io.serialization import load_map

    seed = E2E["seed"]
    world = synthgen.make_world3d(jax.random.PRNGKey(seed))
    blob = {f"world_{k}": np.asarray(v) for k, v in world._asdict().items()}
    blob["texture_theta"] = np.asarray(jax_texture_draws(jax.random.PRNGKey(seed + 31))["theta"])
    blob["noise_seed"] = np.asarray(E2E["noise_seed"])
    tmp = tempfile.mkdtemp()
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def fake_sequence(n_frames, height, width, seed=0, baseline=0.11, stride=1,
                      traj="forward", texture=0.0, photometric="none", intrinsics=None):
        assert texture == 0.0 and photometric == "none"
        return jax_world_sequence(n_frames, height, width, e2e_noise(n_frames, height, width),
                                  seed, baseline, stride, traj, intrinsics)

    def read(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)

    for name, (cam_yaml, extra) in E2E_SEQUENCES.items():
        out = os.path.join(tmp, name)
        saved = bs.make_sequence, sys.argv
        bs.make_sequence = fake_sequence
        sys.argv = ["make_synth_dataset.py", "--out", out, "--frames", str(E2E["frames"]),
                    "--stride", str(E2E["stride"]), "--traj", E2E["traj"], "--seed",
                    str(seed)] + extra
        if name == "rect":  # the relocalization queries (JAX's own noise)
            sys.argv += ["--hard_queries", str(E2E["queries"])]
        try:
            msd.main()
        finally:
            bs.make_sequence, sys.argv = saved
        mav0 = os.path.join(out, "SYNTH_01", "mav0")
        vo_dir = os.path.join(tmp, f"vo_{name}")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "apps/visual_odometry.py", "--config_path",
             "configs/visual_odometry/vo_euroc.yaml", "--camera_config_path", cam_yaml,
             "--dataroot", mav0, "--saving_dir", vo_dir, "--device", "cpu", "--max_frames",
             str(E2E["run"])], cwd=REPO, capture_output=True, text=True, env=env)
        if res.returncode:
            raise RuntimeError(f"visual_odometry.py failed:\n{res.stdout[-3000:]}\n"
                               f"{res.stderr[-3000:]}")
        print(f"{name}: JAX VO CLI {time.perf_counter() - t0:.1f} s")
        m, _ = load_map(os.path.join(vo_dir, "AirSLAM_mapv0.bin"))
        blob[f"{name}_keyframe_ids"] = np.asarray(m.keyframe_ids)
        blob[f"{name}_n_mappoints"] = np.asarray(sum(p.is_valid for p in m.mappoints.values()))
        blob[f"{name}_n_maplines"] = np.asarray(sum(l.is_valid for l in m.maplines.values()))
        blob[f"{name}_traj"] = np.loadtxt(os.path.join(vo_dir, "trajectory_v0.txt"), ndmin=2)
        blob[f"{name}_gt"] = np.loadtxt(
            os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), delimiter=",",
            ndmin=2)
        for cam in ("cam0", "cam1"):
            names = sorted(os.listdir(os.path.join(mav0, cam, "data")))
            for i in E2E_PNG_FRAMES:
                blob[f"{name}_{cam}_{i}_png"] = read(os.path.join(mav0, cam, "data", names[i]))
        print(f"{name}: keyframes {m.keyframe_ids}, {int(blob[f'{name}_n_mappoints'])} "
              f"mappoints, {int(blob[f'{name}_n_maplines'])} maplines")
        if name == "rect":
            e2e_stages(blob, mav0, os.path.join(tmp, "stages"), env)
    shutil.rmtree(tmp, ignore_errors=True)

    # apps/benchmark_system.py's loop (:199-219) on the same world
    import jax.numpy as jnp

    from airslam_tpu.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu.frontend.matcher import MatcherConfig, PointMatcher
    from airslam_tpu.models import weights as wio
    from airslam_tpu.pipelines.map_builder import MapBuilder

    n = SYSTEM_FRAMES
    ts, lefts, rights, gt = jax_world_sequence(n, 480, 752, e2e_noise(n), seed)
    det_params, mat_params = wio.load_default_frontend(use_superpoint=False)
    detector = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=False,
                                              dtype=jnp.bfloat16), params=det_params)
    matcher = PointMatcher(MatcherConfig(matcher=0, max_keypoints=400, dtype=jnp.bfloat16),
                           params=mat_params)
    builder = MapBuilder(bs.SynthCamera(480, 752), detector, matcher)
    t0 = time.perf_counter()
    for i in range(n):
        builder.add_input(ts[i], lefts[i], rights[i], None)
    traj = builder.trajectory
    blob["system_traj"] = np.asarray([[t] + list(T[:3, 3]) for t, T in traj])
    blob["system_keyframes"] = np.asarray(len(builder.map.keyframes))
    print(f"system: {len(traj)} of {n} frames tracked, {len(builder.map.keyframes)} keyframes "
          f"in {time.perf_counter() - t0:.1f} s")
    np.savez_compressed(OUT_E2E, **blob)
    print(f"oracle written: {OUT_E2E} ({os.path.getsize(OUT_E2E)} bytes)")


# ---------------------------------------------------------------------------
# detector training: the JAX draws of airslam_tpu/frontend/synthgen.py and
# parallel/train_plnet.py rebuilt from a key, stage by stage, as the port's
# draw functions name them (airslam_tpu_torch/frontend/synthgen.py)
# ---------------------------------------------------------------------------


def jax_shape_draws(key, size=512):
    """The draws of ``synthgen.sample_shapes(key, size)``."""
    import jax
    import jax.numpy as jnp

    from airslam_tpu.frontend import synthgen as sg

    u = jax.random.uniform
    ks = jax.random.split(key, 12)
    m = 24.0
    d = {"p1": u(ks[0], (sg.N_SEG, 2), minval=m, maxval=size - m),
         "p2": u(ks[1], (sg.N_SEG, 2), minval=m, maxval=size - m)}
    for name, k, n, nv, lo, hi in (("tri", ks[2], sg.N_TRI, 3, 40.0, 110.0),
                                   ("quad", ks[3], sg.N_QUAD, 4, 50.0, 130.0)):
        parts = {"center": [], "base": [], "jitter": [], "radius": []}
        for i in range(n):
            kc, kr, ka = jax.random.split(jax.random.fold_in(k, i), 3)
            parts["center"].append(u(kc, (2,), minval=size * 0.2, maxval=size * 0.8))
            parts["base"].append(u(ka, (), minval=0.0, maxval=6.28))
            parts["jitter"].append(u(kr, (nv,), minval=-0.35, maxval=0.35))
            parts["radius"].append(u(jax.random.fold_in(kr, 1), (nv,), minval=lo, maxval=hi))
        for p, vals in parts.items():
            d[f"{name}_{p}"] = jnp.stack(vals)
    d["fill_shade"] = u(ks[4], (sg.N_TRI + sg.N_QUAD,), minval=-0.45, maxval=0.45)
    d["stroke"] = u(ks[5], (sg.MAX_SEGMENTS,), minval=-0.5, maxval=0.5)
    k6, k7, k8, k9 = jax.random.split(ks[6], 4)
    d["checker_on"] = u(k6, ())
    d["pitch"] = u(k7, (), minval=44.0, maxval=80.0)
    d["origin"] = u(k8, (2,), minval=-80.0, maxval=0.0)
    d["delta"] = u(k9, (), minval=0.10, maxval=0.30)
    d["delta_sign"] = u(jax.random.fold_in(k9, 1), ())
    return d


def jax_affine_draws(key, max_rot=0.35, scale_range=(0.85, 1.15), max_shift=40.0, v=1.0):
    """The draws of ``synthgen.random_affine(key, ...)``; ``v`` is the
    strength of the ``view`` widening that set the ranges (kept as the
    port's ``affine_draws`` keeps it)."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform
    return {"v": jnp.asarray(v, jnp.float32),
            "theta": u(k1, (), minval=-max_rot, maxval=max_rot),
            "scale": u(k2, (), minval=scale_range[0], maxval=scale_range[1]),
            "shift": u(k3, (2,), minval=-max_shift, maxval=max_shift)}


def jax_render_draws(key, size=512):
    """The draws of ``synthgen.render_from_shapes(key, shapes, size)``."""
    import jax

    ks = jax.random.split(key, 4)
    u = jax.random.uniform
    return {"bg": u(ks[0], (4, 4), minval=0.35, maxval=0.85),
            "bg_noise": u(ks[1], (32, 32), minval=-0.04, maxval=0.04),
            "noise": jax.random.normal(ks[2], (size, size))}


def jax_augment_draws(key, size=512):
    """The draws of ``synthgen.photometric_augment(key, img, strength)``;
    the draws whose bounds scale with the strength stay in [0, 1)."""
    import jax

    ks = jax.random.split(key, 9)
    u = jax.random.uniform
    return {"strength": u(ks[8], (), minval=0.15, maxval=1.0), "brightness": u(ks[0], ()),
            "gamma": u(ks[1], ()), "contrast": u(ks[2], ()),
            "center": u(ks[3], (2,), minval=0.3, maxval=0.7), "vignette": u(ks[4], ()),
            "gradient_dir": jax.random.normal(ks[5], (2,)), "gradient": u(ks[6], ()),
            "noise": jax.random.normal(ks[7], (size, size))}


def jax_scene_draws(key, size=512, augment=0.0):
    """The draws of ``synthgen.render_scene(key, size, augment)``, by stage."""
    import jax

    k1, k2 = jax.random.split(key)
    d = {"shapes": jax_shape_draws(k1, size), "render": jax_render_draws(k2, size)}
    if augment > 0:
        d["augment"] = jax_augment_draws(jax.random.fold_in(key, 17), size)
    return d


def jax_pair_draws(key, size=512, augment=0.0, view=1.0):
    """The draws of ``synthgen.render_pair_with_affine(key, size, augment,
    view)``: with ``view`` > 1 the affine's strength v from ``fold_in(key,
    23)`` and the ranges it scales (synthgen.py:385-389)."""
    import jax

    k1, k2, k3, k4 = jax.random.split(key, 4)
    if view > 1.0:
        v = 1.0 + (view - 1.0) * jax.random.uniform(jax.random.fold_in(key, 23))
        affine = jax_affine_draws(k2, max_rot=0.35 * v, scale_range=(1.0 - 0.15 * v,
                                                                    1.0 + 0.15 * v),
                                  max_shift=40.0 * v, v=v)
    else:
        affine = jax_affine_draws(k2)
    d = {"shapes": jax_shape_draws(k1, size), "affine": affine,
         "render0": jax_render_draws(k3, size), "render1": jax_render_draws(k4, size)}
    if augment > 0:
        d["augment0"] = jax_augment_draws(jax.random.fold_in(key, 18), size)
        d["augment1"] = jax_augment_draws(jax.random.fold_in(key, 19), size)
    return d


def jax_loi_draws(key):
    """The draws of ``train_plnet.detector_loss``'s LOI branch."""
    import jax

    from airslam_tpu.frontend import synthgen as sg
    from airslam_tpu.parallel import train_plnet as tp

    k1, k2, k3, k4 = jax.random.split(key, 4)
    s, n = sg.MAX_SEGMENTS, 2 * tp.NEG_PAIRS
    u = jax.random.uniform
    return {"pos_jitter": u(k1, (s, 4), minval=-0.4, maxval=0.4),
            "i": jax.random.randint(k2, (n,), 0, sg.MAX_CORNERS),
            "j": jax.random.randint(k3, (n,), 0, sg.MAX_CORNERS),
            "prop_jitter": u(k4, (s + n, 4), minval=-2.0, maxval=2.0)}


def jax_world3d_draws(key, n_seg=48, n_blob=320):
    """The draws of ``synthgen.make_world3d(key)``, by the port's names."""
    import jax

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = jax.random.uniform
    return {"seg_a": u(k1, (n_seg, 3)), "seg_dir": jax.random.normal(k2, (n_seg, 3)),
            "seg_axis": jax.random.randint(k3, (n_seg,), 0, 3),
            "seg_length": u(jax.random.fold_in(k2, 1), (n_seg, 1), minval=0.8, maxval=3.0),
            "seg_shade": u(jax.random.fold_in(k2, 2), (n_seg,), minval=0.25, maxval=0.55),
            "seg_sign": u(jax.random.fold_in(k2, 3), (n_seg,)),
            "blobs": u(k4, (n_blob, 3)), "blob_shade": u(k5, (n_blob,), minval=0.3, maxval=0.6),
            "blob_sign": u(jax.random.fold_in(k5, 1), (n_blob,))}


def jax_texture_draws(key, octaves=5):
    """The angles ``render_view3d(..., texture_key=key)`` draws: (plane,
    octave, 3), the floor's then the back wall's."""
    import jax
    import jax.numpy as jnp

    return {"theta": jnp.stack([jnp.stack([
        jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, plane), k), (3,),
                           minval=0.0, maxval=6.28318) for k in range(octaves)])
        for plane in (0, 1)])}


def jax_sequence_noise(seed, n_frames, height, width, dark=False):
    """The pixel noise ``apps/benchmark_system.make_sequence`` draws: (N, 2,
    H, W) for the left and right views; with ``dark`` also the
    ``dark_transform`` noise of each view."""
    import jax

    keys = [jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed + 1), i), 4)
            for i in range(n_frames)]
    out = {"noise": np.stack([[np.asarray(jax.random.normal(k[v], (height, width)))
                               for v in (0, 1)] for k in keys])}
    if dark:
        out["dark"] = np.stack([[np.asarray(jax.random.normal(k[v], (height, width)))
                                 for v in (2, 3)] for k in keys])
    return out


def batch_draws(draws_list):
    """Stack per-key draws (nested dicts of arrays) into numpy batches."""
    first = draws_list[0]
    if isinstance(first, dict):
        return {k: batch_draws([d[k] for d in draws_list]) for k in first}
    return np.stack([np.asarray(d) for d in draws_list])


def jax_plnet_terms(params, s0, s1, kl):
    """The JAX trainer's per-image PLNet loss (``make_plnet_train_step``'s
    ``loss_fn``, train_plnet.py:225-250) on given scenes: (total, terms)."""
    import jax
    import jax.numpy as jnp

    from airslam_tpu.models.plnet import LoiHeadS1, PLNet
    from airslam_tpu.parallel import train_plnet as tp

    imgs = jnp.stack([s0.image, s1.image])[..., None]
    out = PLNet().apply(params["plnet"], imgs)
    out0 = jax.tree_util.tree_map(lambda t: t[0], out)
    out1 = jax.tree_util.tree_map(lambda t: t[1], out)
    terms = tp.detector_loss(out0, tp.scene_targets(s0), kl, loi_apply=LoiHeadS1().apply,
                             loi_params=params["loi"], scene=s0)
    terms["desc"] = tp.descriptor_loss(out0["descriptors"], out1["descriptors"], s0, s1)
    return sum(tp.WEIGHTS[k] * v for k, v in terms.items()), terms


def jax_superpoint_terms(params, s0, s1):
    """``make_superpoint_train_step``'s ``loss_fn`` on given scenes."""
    import jax
    import jax.numpy as jnp
    import optax

    from airslam_tpu.models.superpoint import SuperPoint
    from airslam_tpu.parallel import train_plnet as tp

    out = SuperPoint().apply(params, jnp.stack([s0.image, s1.image])[..., None])
    ce = optax.softmax_cross_entropy_with_integer_labels(
        out["kp_logits"][0], tp.scene_targets(s0).kp_label).mean()
    dl = tp.descriptor_loss(out["descriptors"][0], out["descriptors"][1], s0, s1)
    return ce + dl, {"kp": ce, "desc": dl}


def jax_distill_terms(params, plnet_params, s0, s1):
    """``make_superpoint_distill_step``'s ``loss_fn`` on given scenes."""
    import jax
    import jax.numpy as jnp
    import optax

    from airslam_tpu.models.plnet import PLNet
    from airslam_tpu.models.superpoint import SuperPoint
    from airslam_tpu.ops.gridsample import sample_descriptors
    from airslam_tpu.parallel import train_plnet as tp

    imgs = jnp.stack([s0.image, s1.image])[..., None]
    out = SuperPoint().apply(params, imgs)
    ce = optax.softmax_cross_entropy_with_integer_labels(
        out["kp_logits"][0], tp.scene_targets(s0).kp_label).mean()
    pl = jax.lax.stop_gradient(PLNet().apply(plnet_params, imgs)["descriptors"])
    dist = 0.0
    for v, s in ((0, s0), (1, s1)):
        dsp = sample_descriptors(out["descriptors"][v].transpose(2, 0, 1), s.corners, stride=8)
        dpl = sample_descriptors(pl[v].transpose(2, 0, 1), s.corners, stride=8)
        cos = jnp.sum(dsp * dpl, axis=-1)
        m = s.corner_mask
        dist = dist + jnp.sum(jnp.where(m, 1.0 - cos, 0.0)) / jnp.maximum(jnp.sum(m), 1.0)
    dist = dist * 0.5
    return ce + 4.0 * dist, {"kp": ce, "distill": dist}


def jax_adam_step(params, grads, lr=3e-4):
    """The JAX CLI's optimizer (``apps/train_plnet.py:62``), one step from a
    fresh state: the updated params."""
    import optax

    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def quantized(scene):
    """The scene with its image rounded to 16 bits (as stored) and decoded
    to float32: what both packages are given."""
    q = np.round(np.asarray(scene.image, np.float64) * 65535).astype(np.uint16)
    return scene._replace(image=q.astype(np.float32) / np.float32(65535)), q


def _record_step(blob, mode, loss, terms, grads, params, new):
    """Loss terms, per-leaf gradient norms, and gradient and update values
    at LEAF_SAMPLES fixed indices per leaf (every value of a smaller leaf)."""
    blob[f"{mode}/loss"] = np.float32(loss)
    for k, v in terms.items():
        blob[f"{mode}/term/{k}"] = np.float32(v)
    g, p, n = flat_tree(grads), flat_tree(params), flat_tree(new)
    for i, leaf in enumerate(sorted(g)):
        flat = g[leaf].reshape(-1)
        if flat.size <= LEAF_SAMPLES:
            idx = np.arange(flat.size)
        else:
            idx = np.sort(np.random.RandomState(i).choice(flat.size, LEAF_SAMPLES, replace=False))
        blob[f"{mode}/leaf/{leaf}/norm"] = np.float64(np.linalg.norm(flat.astype(np.float64)))
        blob[f"{mode}/leaf/{leaf}/idx"] = idx.astype(np.int32)
        blob[f"{mode}/leaf/{leaf}/grad"] = flat[idx]
        blob[f"{mode}/leaf/{leaf}/update"] = (n[leaf].reshape(-1) - p[leaf].reshape(-1))[idx]


def write_train_oracle():
    """One train step of each mode of the JAX detector trainer from the
    shipped checkpoints, batch 1, float32: the JAX-rendered pair (images
    rounded to 16 bits), its scenes, view 0's targets, the LOI draws, the
    loss terms, and per leaf the gradient's norm and its values and the
    clipped-Adam update's at fixed indices. The losses are the trainer's
    ``loss_fn`` on the stored images (``jax_*_terms``); the trainer's own
    jitted step renders inside the program, which XLA rounds otherwise."""
    import jax

    from airslam_tpu.frontend import synthgen as JS
    from airslam_tpu.models import weights as jw
    from airslam_tpu.parallel import train_plnet as tp

    blob = {}
    plnet_params = jw.load_params(os.path.join(REPO, "airslam_tpu", "checkpoints", "plnet_s0.npz"))
    sp_params = jw.load_params(os.path.join(REPO, "airslam_tpu", "checkpoints", "superpoint.npz"))

    def store_pair(prefix, s0, s1):
        (s0, q0), (s1, q1) = quantized(s0), quantized(s1)
        blob[f"{prefix}/image"] = np.stack([q0, q1])
        for f in ("corners", "corner_mask", "segments", "segment_mask"):
            blob[f"{prefix}/{f}"] = np.stack([np.asarray(getattr(s, f)) for s in (s0, s1)])
        return s0, s1

    def grad_step(fn, params):
        (loss, terms), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
        return loss, terms, grads, jax_adam_step(params, grads)

    t0 = time.time()
    kd, kl = jax.random.split(jax.random.PRNGKey(TRAIN_SEEDS["plnet"]))
    s0, s1 = store_pair("plnet", *JS.render_pair(kd, augment=1.0))
    for f, v in tp.scene_targets(s0)._asdict().items():
        blob[f"plnet/target/{f}"] = np.asarray(v)
    for k, v in jax_loi_draws(kl).items():
        blob[f"plnet/loi/{k}"] = np.asarray(v)
    loss, terms, grads, new = grad_step(lambda p: jax_plnet_terms(p, s0, s1, kl), plnet_params)
    _record_step(blob, "plnet", loss, terms, grads, plnet_params, new)
    print(f"plnet step: loss {float(loss):.6f} ({time.time() - t0:.0f} s)")

    s0, s1 = store_pair("superpoint", *JS.render_pair(
        jax.random.PRNGKey(TRAIN_SEEDS["superpoint"]), augment=1.0))
    blob["superpoint/target/kp_label"] = np.asarray(tp.scene_targets(s0).kp_label)
    loss, terms, grads, new = grad_step(lambda p: jax_superpoint_terms(p, s0, s1), sp_params)
    _record_step(blob, "superpoint", loss, terms, grads, sp_params, new)
    print(f"superpoint step: loss {float(loss):.6f} ({time.time() - t0:.0f} s)")
    loss, terms, grads, new = grad_step(
        lambda p: jax_distill_terms(p, plnet_params["plnet"], s0, s1), sp_params)
    _record_step(blob, "distill", loss, terms, grads, sp_params, new)
    print(f"distill step: loss {float(loss):.6f} ({time.time() - t0:.0f} s)")
    np.savez_compressed(OUT_TRAIN, **blob)
    print(f"oracle written: {OUT_TRAIN} ({os.path.getsize(OUT_TRAIN)} bytes)")


# ---------------------------------------------------------------------------
# matcher training: the JAX batch builders on stored scenes, the trainer's
# losses, and the wide-viewpoint pairs of tests/test_trained_detector.py
# ---------------------------------------------------------------------------

def pack_leaves(rec, mode):
    """``_record_step``'s per-leaf entries of ``mode`` packed into a few
    arrays (the npz's per-entry overhead would exceed the data):
    ``{mode}/leaves`` (names), ``/leaf_norm``, ``/leaf_start`` (offsets into)
    ``/leaf_idx``, ``/leaf_grad``, ``/leaf_update``; the loss as is.
    ``chip_smoke.unpack_leaves`` inverts it."""
    names = sorted({k.split("/leaf/")[1].rsplit("/", 1)[0] for k in rec if "/leaf/" in k})
    parts = {f: [rec[f"{mode}/leaf/{n}/{f}"] for n in names] for f in ("idx", "grad", "update")}
    sizes = [len(a) for a in parts["idx"]]
    out = {f"{mode}/loss": rec[f"{mode}/loss"], f"{mode}/leaves": np.asarray(names),
           f"{mode}/leaf_norm": np.asarray([rec[f"{mode}/leaf/{n}/norm"] for n in names]),
           f"{mode}/leaf_start": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)}
    for f, arrays in parts.items():
        out[f"{mode}/leaf_{f}"] = np.concatenate(arrays)
    return out


def wide_noise(i):
    """The numpy pixel noise of wide-viewpoint pair ``i``: (2, 512, 512)."""
    return np.random.default_rng(WIDE_NOISE_SEED + i).standard_normal((2, 512, 512),
                                                                       dtype=np.float32)


def jax_matcher_batch(tokens, arch, key, s0, s1, A=None, t=None):
    """The JAX trainer's batch of one pair (``make_rendered_batch`` /
    ``make_detected_batch`` with ``key``, the CLI's options for ``arch``)
    with its render replaced by the given scenes."""
    from unittest import mock

    from airslam_tpu.frontend import synthgen as JS
    from airslam_tpu.models import weights as jw
    from airslam_tpu.models.plnet import PLNet
    from airslam_tpu.parallel import training as jt

    params = jw.load_params(os.path.join(REPO, "airslam_tpu", "checkpoints",
                                         "plnet_s0.npz"))["plnet"]
    sg = arch == "superglue"
    scale = 0.7 if sg else 0.5
    if tokens == "corners":
        with mock.patch.object(JS, "render_pair", lambda kd, augment: (s0, s1)):
            return jt.make_rendered_batch(PLNet().apply, params, key, norm_scale=scale,
                                          with_scores=sg)
    with mock.patch.object(JS, "render_pair_with_affine",
                           lambda k, augment, view: (s0, s1, A, t)):
        return jt.make_detected_batch(PLNet().apply, params, key, norm_scale=scale,
                                      with_scores=sg, view=MATCHER_VIEW)


def jax_matcher_loss(tokens, arch):
    """``loss(params, batch)`` of the JAX trainer's mode."""
    from airslam_tpu.models.lightglue import LightGlue
    from airslam_tpu.models.superglue import SuperGlue
    from airslam_tpu.parallel import training as jt

    if arch == "lightglue":
        model = LightGlue()
        fn = jt.rendered_match_loss if tokens == "corners" else jt.detected_match_loss
    else:
        model = SuperGlue(sinkhorn_iterations=jt.SG_SINKHORN_ITERS, return_full=True)
        fn = jt.rendered_match_loss_sg if tokens == "corners" else jt.detected_match_loss_sg
    return lambda p, batch: fn(model, p, batch)


def write_matcher_oracle():
    """One step of each matcher-trainer mode on stored pairs (see the module
    docstring), and the wide-viewpoint pairs with the JAX test's counts."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import optax

    import chip_smoke
    from airslam_tpu.frontend import synthgen as JS
    from airslam_tpu.models import weights as jw

    blob = {}
    ckpt = os.path.join(REPO, "airslam_tpu", "checkpoints")
    t0 = time.time()
    for tokens, seed in MATCHER_SEEDS.items():
        keys = jax.random.split(jax.random.PRNGKey(seed), MATCHER_BATCH)
        scenes, per_arch = [], {"lightglue": [], "superglue": []}
        for key in keys:
            if tokens == "corners":
                kd, kj = jax.random.split(key)
                s0, s1 = JS.render_pair(kd, augment=1.0)
                jit = jax.random.uniform(kj, (2,) + s0.corners.shape, minval=-1.0, maxval=1.0)
                A = t = None
                extra = {"jitter": np.asarray(jit)}
            else:
                s0, s1, A, t = JS.render_pair_with_affine(key, augment=1.0, view=MATCHER_VIEW)
                v = 1.0 + (MATCHER_VIEW - 1.0) * jax.random.uniform(jax.random.fold_in(key, 23))
                extra = {"A": np.asarray(A), "t": np.asarray(t), "v": np.asarray(v)}
            (s0, q0), (s1, q1) = quantized(s0), quantized(s1)
            for arch in per_arch:
                per_arch[arch].append(jax_matcher_batch(tokens, arch, key, s0, s1, A, t))
            scenes.append(dict(extra, image=np.stack([q0, q1]),
                               corners=np.stack([np.asarray(s.corners) for s in (s0, s1)]),
                               corner_mask=np.stack([np.asarray(s.corner_mask)
                                                     for s in (s0, s1)])))
        for f in scenes[0]:
            blob[f"{tokens}/{f}"] = np.stack([sc[f] for sc in scenes])
        batches = {arch: tuple(np.stack([np.asarray(b[i]) for b in bs])
                               for i in range(len(bs[0]))) for arch, bs in per_arch.items()}
        named = {arch: dict(zip(chip_smoke.MATCHER_FIELDS[tokens][arch], b))
                 for arch, b in batches.items()}
        for f, v in named["superglue"].items():
            if f in ("k0", "k1"):
                for arch in named:
                    blob[f"{tokens}/batch/{f}_{arch}"] = named[arch][f]
            else:
                if f in named["lightglue"]:  # the tuples share these bit for bit
                    assert np.array_equal(named["lightglue"][f], v), (tokens, f)
                blob[f"{tokens}/batch/{f}"] = v
        for arch in ("lightglue", "superglue"):
            params = jw.load_params(os.path.join(ckpt, f"{arch}.npz"))
            loss_fn = jax_matcher_loss(tokens, arch)
            batch = tuple(jnp.asarray(a) for a in chip_smoke.matcher_batch(blob, tokens, arch))
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
            tx = optax.adam(MATCHER_LR)
            updates, _ = tx.update(grads, tx.init(params), params)
            new = optax.apply_updates(params, updates)
            rec = {}
            _record_step(rec, f"{arch}_{tokens}", loss, {}, grads, params, new)
            blob.update(pack_leaves(rec, f"{arch}_{tokens}"))
            print(f"{arch} {tokens} step: loss {float(loss):.6f} ({time.time() - t0:.0f} s)")

    # the wide-viewpoint pairs and the JAX test's counts
    import jax.tree_util as jtu

    from airslam_tpu.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu.frontend.matcher import MatcherConfig, PointMatcher

    p = jw.load_params(os.path.join(ckpt, "plnet_s0.npz"))
    det = FeatureDetector(DetectorConfig(use_superpoint=False),
                          params={"plnet": p["plnet"], "loi": p["loi"]})
    pm = PointMatcher(MatcherConfig(matcher=0, max_keypoints=400, image_width=512,
                                    image_height=512),
                      params=jw.load_params(os.path.join(ckpt, "lightglue.npz")))
    v = MATCHER_VIEW

    def count(s0, s1, A, t):
        f0, f1 = (jtu.tree_map(lambda x: np.asarray(x[0]), det.detect(np.asarray(s.image)[None]))
                  for s in (s0, s1))
        pairs, _ = pm.matching_points(f0, f1)
        pred = f0.keypoints[pairs[:, 0]] @ A.T + t
        err = np.linalg.norm(pred - f1.keypoints[pairs[:, 1]], axis=-1)
        return len(pairs), float((err < 4.0).mean()) if len(pairs) else 0.0

    blob["wide/noise_seed"] = np.int64(WIDE_NOISE_SEED)
    for i, seed in enumerate(WIDE_SEEDS):
        k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
        shapes = JS.sample_shapes(k1, 512)
        A, t = JS.random_affine(k2, 512, max_rot=0.35 * v,
                                scale_range=(1.0 - 0.15 * v, 1.0 + 0.15 * v),
                                max_shift=40.0 * v)
        warped = JS.warp_shapes(shapes, A, t)
        An, tn = np.asarray(A), np.asarray(t)
        # the test's own pairs, for the record
        own = count(JS.render_from_shapes(k3, shapes, 512),
                    JS.render_from_shapes(k4, warped, 512), An, tn)
        noise = wide_noise(i)
        views = []
        for k, shp, n in ((k3, shapes, noise[0]), (k4, warped, noise[1])):
            with mock.patch.object(jax.random, "normal",
                                   lambda key, shape, n=n: jnp.asarray(n)):
                views.append(JS.render_from_shapes(k, shp, 512))
        n_pairs, prec = count(views[0], views[1], An, tn)
        draws = flat_tree({"shapes": jax_shape_draws(k1), "render0": jax_render_draws(k3),
                           "render1": jax_render_draws(k4),
                           "affine": jax_affine_draws(k2, max_rot=0.35 * v,
                                                      scale_range=(1.0 - 0.15 * v,
                                                                   1.0 + 0.15 * v),
                                                      max_shift=40.0 * v, v=v)})
        for k, a in draws.items():
            if not k.endswith("/noise"):  # numpy's noise takes its place
                blob[f"wide/{i}/{k}"] = a
        blob[f"wide/{i}/A"], blob[f"wide/{i}/t"] = An, tn
        blob[f"wide/{i}/count"], blob[f"wide/{i}/precision"] = np.int32(n_pairs), np.float64(prec)
        blob[f"wide/{i}/count_own_noise"] = np.int32(own[0])
        print(f"wide pair {seed}: {n_pairs} matches, precision {prec:.3f} (the test's own "
              f"render: {own[0]}, {own[1]:.3f}) ({time.time() - t0:.0f} s)")
    np.savez_compressed(OUT_MATCHER, **blob)
    print(f"oracle written: {OUT_MATCHER} ({os.path.getsize(OUT_MATCHER)} bytes)")



def jax_fast_detector(seed=0, dtype=None, **cfg):
    """The JAX ``FeatureDetector`` with the fast ``LoiHead`` as it
    initialises the head for ``seed`` and the shipped PLNet (no SuperPoint)."""
    import jax
    import jax.numpy as jnp

    from airslam_tpu.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu.models.weights import load_default_frontend

    shipped, _ = load_default_frontend(use_superpoint=False)
    det = FeatureDetector(DetectorConfig(loi_head="fast", use_superpoint=False,
                                         dtype=dtype or jnp.float32, **cfg),
                          params={"plnet": shipped["plnet"]})
    det.params["loi"] = det._init_loi_params(jax.random.split(jax.random.PRNGKey(seed), 3)[1])
    return det


def jax_bench_window(frames, points, seed, dtype=None):
    """``apps/bench_backend.py``'s window: (the perturbed problem in
    ``dtype`` (float32 by default, as the app runs it), its intrinsics, the
    scene)."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from airslam_tpu.core.camera import Intrinsics
    from tests.synthetic import build_problem, make_point_scene

    dtype = dtype or jnp.float32
    rng = np.random.RandomState(seed)
    scene = make_point_scene(f=frames, p=points, rng=rng)
    Rwb0, twb0 = scene["Rwb"].copy(), scene["twb"].copy()
    for i in range(1, frames):
        Rwb0[i] = Rwb0[i] @ Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        twb0[i] = twb0[i] + rng.randn(3) * 0.05
    pts0 = scene["points"] + rng.randn(*scene["points"].shape) * 0.05
    prob = build_problem(scene, Rwb=Rwb0, twb=twb0, points=pts0, dtype=dtype)
    i64 = scene["intr"]
    intr = Intrinsics(fx=dtype(i64.fx), fy=dtype(i64.fy), cx=dtype(i64.cx), cy=dtype(i64.cy),
                      bf=dtype(i64.bf), width=752, height=480)
    return prob, intr, scene


def jax_test_feature(image_dir, save_dir, extra=()):
    """``apps/test_feature.py`` on ``image_dir``: [(name, FrameFeatures of
    the image as numpy)] and its printed lines. Its compilation cache is not
    written."""
    import contextlib
    import io

    import jax.tree_util as jtu

    import apps.test_feature as tf
    from airslam_tpu.frontend import detector as jdetector
    from airslam_tpu.utils import jaxcache

    got = []
    detect = jdetector.FeatureDetector.detect

    def recording(self, images, detect_junctions=False):
        out = detect(self, images, detect_junctions=detect_junctions)
        got.append(jtu.tree_map(lambda t: np.asarray(t[0]), out))
        return out

    saved = sys.argv, jdetector.FeatureDetector.detect, jaxcache.enable
    sys.argv = ["test_feature.py", "--image_dir", image_dir, "--save_dir", save_dir,
                "--device", "cpu", *extra]
    jdetector.FeatureDetector.detect = recording
    jaxcache.enable = lambda *a, **k: None
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            tf.main()
    finally:
        sys.argv, jdetector.FeatureDetector.detect, jaxcache.enable = saved
    lines = buf.getvalue().strip().splitlines()
    return list(zip([ln.split(":")[0] for ln in lines], got)), lines


def write_tools_oracle():
    import json
    import tempfile

    import cv2
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _synthetic_imu_chain
    from airslam_tpu.backend import validate, windows

    blob = {}
    fr = np.load(OUT)
    frames = fr["frames_u8"].astype(np.float32) / np.float32(255.0)
    with jax.enable_x64(False):  # float32, as the JAX CLIs run
        det = jax_fast_detector(TOOLS["seed"], **TOOLS["fast_cfg"])
        for k, v in flat_tree(det.params["loi"]).items():
            blob["loi/" + k] = np.asarray(v, np.float32)
        for i in range(frames.shape[0]):
            f = det.detect(frames[i], detect_junctions=True)
            for v in range(2):
                for name in TOOLS_FIELDS:
                    blob[f"fast{i}_{v}_{name}"] = np.asarray(getattr(f, name)[v])
            print(f"fast head, pair {i}: lines {np.asarray(f.line_mask).sum(-1)}")

        with tempfile.TemporaryDirectory() as tmp:
            img_dir, out_dir = os.path.join(tmp, "images"), os.path.join(tmp, "out")
            os.makedirs(img_dir)
            for i in range(frames.shape[0]):
                cv2.imwrite(os.path.join(img_dir, f"{i:02d}.png"), fr["frames_u8"][i, 0])
            runs, printed = jax_test_feature(
                img_dir, out_dir, ["--camera_config_path",
                                   os.path.join(REPO, "configs", "camera", "euroc.yaml")])
        for i, (name, f) in enumerate(runs):
            for field in TOOLS_FIELDS:
                blob[f"feature{i}_{field}"] = np.asarray(getattr(f, field))
        blob["feature_names"] = np.array([n for n, _ in runs])
        blob["feature_printed"] = np.array(printed)
        print("\n".join(printed))

        prob, intr, scene = jax_bench_window(*TOOLS["bench"])
        out, p_in, _ = windows.local_ba(prob, intr)
        f = prob.frames.twb.shape[0]
        prob_imu = prob._replace(imu=_synthetic_imu_chain(np.arange(f - 1), np.arange(1, f),
                                                          jnp.float32))
        dicts = {"before": validate.validate_reprojection(prob, intr, "before"),
                 "after": validate.validate_reprojection(out, intr, "after"),
                 "imu": validate.validate_imu(prob_imu, "imu")}
        blob["bench_twb"] = np.asarray(out.frames.twb)
        blob["bench_Rwb"] = np.asarray(out.frames.Rwb)
        blob["bench_inliers"] = np.int64(np.asarray(p_in).sum())
    blob["bench_err"] = np.float64(np.abs(blob["bench_twb"] - scene["twb"]).max())
    blob["validate"] = np.array(json.dumps(dicts))
    print(f"bench window: pose err {float(blob['bench_err']):.2e} m, "
          f"inliers {int(blob['bench_inliers'])}")

    np.savez_compressed(OUT_TOOLS, **blob)
    print(f"oracle written: {OUT_TOOLS} ({os.path.getsize(OUT_TOOLS)} bytes)")

def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "frontend"):
        write_frontend_oracle()
    if which in ("all", "tracking"):
        write_tracking_oracle()
    if which in ("all", "vo"):
        write_vo_oracle()
    if which in ("all", "vio"):
        write_vio_oracle()
    if which in ("all", "refine"):
        write_refine_oracle()
    if which in ("all", "train"):
        # float32, as the JAX trainer runs (apps/train_plnet.py enables no x64)
        with jax.enable_x64(False):
            write_train_oracle()
    if which in ("all", "matcher"):
        # float32, as the JAX matcher trainer runs
        with jax.enable_x64(False):
            write_matcher_oracle()
    if which in ("all", "tools"):
        write_tools_oracle()
    if which in ("all", "reloc", "e2e"):
        # float32, as the JAX CLIs run (they enable no x64)
        jax.config.update("jax_enable_x64", False)
    if which in ("all", "reloc"):
        write_reloc_oracle()
    if which in ("all", "e2e"):
        write_e2e_oracle()


if __name__ == "__main__":
    main()
