"""Visual(-inertial) odometry pipeline.

Port of ``airslam_tpu/pipelines/map_builder.py`` (which replaces
``src/map_builder.cc``). Same stages, same decision logic:

1. input: rectify both views (``ops/remap.remap``; on the card kernel R)
2. detect both views, then ONE batched matcher pass for the stereo pair and
   the match against the last keyframe
3. stereo gating + frame construction (frame.cc:139-199)
4. track vs last keyframe: IMU preintegration since the last keyframe, line
   matches from point matches (map_builder.cc:230-283), initial pose by IMU
   prediction / PnP-RANSAC / last pose (map_builder.cc:285-315), pose-only
   optimization (vision: on the card the whole-solver kernel of
   ``backend/pose_gn.py``; once the IMU is initialized the F=2 solve with the
   IMU factor to the last keyframe), inlier track-id propagation
5. keyframe policy ``AddKeyframeCheck`` (map_builder.cc:429-466)
6. keyframe insertion → Map (landmark creation, triangulation, local BA,
   IMU initialization)

The bookkeeping (``Frame``, ``Mappoint``, track ids) is numpy on the host, as
in the JAX package; the feature tree is pulled to the host once per frame.
The host loop is sequential by default; ``parallel/pipeline.py``'s
``PipelinedRunner`` queues frame t+1's rectification and detection on the
device before frame t's features are pulled, so the device works while the
host tracks. The initial pose comes
from OpenCV's RANSAC PnP on the host, or with ``use_jax_pnp=True`` from the
device-resident RANSAC of ``backend/pnp.py`` (the JAX package's name for the
option).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.core.imu import Preintegration
from airslam_tpu_torch.frontend.lines import frame_relations, match_lines_by_points
from airslam_tpu_torch.ops.remap import remap
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.map import Map, preintegration_information


@dataclasses.dataclass
class KeyframeConfig:
    """configs/visual_odometry/*.yaml `keyframe` block."""

    min_init_stereo_feature: int = 90
    lost_num_match: int = 10
    min_num_match: int = 30
    max_num_match: int = 80
    tracking_point_rate: float = 0.65
    tracking_parallax_rate: float = 0.1


# init pose convention of the reference (map_builder.cc:182-185): camera
# z-forward mapped into a z-up world.
INIT_TWC = np.array(
    [[0.0, 0.0, 1.0, 0.0],
     [-1.0, 0.0, 0.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]]
)


class TrackResult(NamedTuple):
    """What tracking one frame against the last keyframe gives."""

    Twc: np.ndarray  # (4, 4) camera-in-world pose after the pose-only solve
    num_inliers: int
    inlier_flags: list  # [(keypoint index in the frame, inlier)] per matched mappoint
    keyframe_decision: int  # 0 = this frame, 1 = the next frame, 2 = none
    line_matches: np.ndarray  # (L,) index of the frame's line per keyframe line, −1 = none


def _as_np_features(feats):
    """FrameFeatures of numpy arrays from one of numpy arrays or tensors
    (bfloat16 leaves, which numpy lacks, widen to float32)."""

    def leaf(t):
        if not torch.is_tensor(t):
            return np.asarray(t)
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return type(feats)(*(leaf(t) for t in feats))


def _match_table(matches, k: int):
    """(M, 2) index pairs -> per-keypoint (idx1 (k,) int32, matched (k,) bool)."""
    idx1 = np.full(k, -1, np.int32)
    msk = np.zeros(k, bool)
    if len(matches):
        m = np.asarray(matches)
        idx1[m[:, 0]] = m[:, 1].astype(np.int32)
        msk[m[:, 0]] = True
    return idx1, msk


class MapBuilder:
    def __init__(self, camera, detector, matcher, kf_config: Optional[KeyframeConfig] = None,
                 ba_config=None, match_threshold: Optional[float] = None, publisher=None,
                 device=None, dtype=torch.float32, use_jax_pnp: bool = False):
        """detector/matcher: FeatureDetector / PointMatcher (or test doubles
        with the same interface). ``publisher``: optional io.publisher.Publisher
        receiving frame-pose / keyframe / map messages (the RosPublisher role,
        map_builder.cc:497-548). ``use_jax_pnp``: the device-resident RANSAC
        DLT (backend/pnp.py) instead of cv2.solvePnPRansac. ``device``: where
        the pipeline's tensor work (rectification, line relations, the
        preintegration, the pose-only
        problem) runs — ``cuda`` unless the caller passes another. ``dtype``:
        the float type of that work; the tracking kernel on the card is
        float32."""
        self.camera = camera
        self.detector = detector
        self.matcher = matcher
        self.kf_config = kf_config or KeyframeConfig()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.map = Map(camera, ba_config, device=self.device, dtype=dtype)
        self.match_threshold = match_threshold
        self.publisher = publisher
        self.use_jax_pnp = use_jax_pnp

        self.init = False
        self.insert_next_keyframe = True
        self.last_keyframe: Optional[Frame] = None
        self.last_tracked_frame: Optional[Frame] = None
        self.frame_counter = 0
        self.track_id_counter = 0
        self.line_track_id_counter = 0
        self.preintegration: Optional[Preintegration] = None
        # per-frame trajectory as (timestamp, ref_keyframe, T_ref_frame):
        # composing against the reference keyframe's CURRENT pose keeps every
        # entry consistent after map-wide corrections
        self._trajectory: List[tuple] = []
        self._pose_problem_tmpl = {}  # (P, f) -> BAProblem whose constant leaves stay on the device
        self.stage_timer = None  # utils.timing.Timer: add_input's per-stage breakdown

        self._maps = None
        if hasattr(camera, "rectify_maps"):
            ml, mr = camera.rectify_maps(self.device)
            if ml is not None:
                self._maps = torch.stack([ml, mr]).contiguous()

    # ------------------------------------------------------------------

    def rectify(self, image_left, image_right):
        """Both views through one remap call (kernel R on the card). Returns
        the (2, H, W) float32 pair on the builder's device; the input pair
        unchanged in value when the camera is already rectified."""
        pair = torch.stack([torch.as_tensor(image_left), torch.as_tensor(image_right)])
        pair = pair.to(self.device, torch.float32).contiguous()
        if self._maps is None:
            return pair
        with torch.profiler.record_function("rectify"):
            return remap(pair, self._maps)

    def add_input(self, timestamp: float, image_left, image_right, imu_batch=None):
        """One stereo frame (+ IMU rows since the previous frame). Images:
        (H, W) grayscale in [0, 1]. Returns the tracked Frame.

        Set ``self.stage_timer`` (``utils.timing.Timer``) for a per-stage
        breakdown under the JAX package's names (rectify / detect /
        stereo_match / track); each section then ends with a synchronization
        of the card, so it holds the card's time, not the dispatch's."""
        feats_left, feats_right, pairs, temporal = self._frontend(image_left, image_right)
        with self._stage("track"):
            return self.track_features(timestamp, feats_left, feats_right, pairs, imu_batch,
                                       temporal_matches=temporal)

    @contextlib.contextmanager
    def _stage(self, name):
        """A section of ``stage_timer``, or nothing when no timer is set."""
        timer = self.stage_timer
        if timer is None:
            yield
            return
        with timer.section(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _match_detected(self, feats, j: int = 0):
        """ONE host pull of the feature tree (none when it is already on the
        host) → frame ``j``'s batched stereo and temporal match, its views
        at rows 2j and 2j + 1. Returns (feats_left, feats_right,
        stereo_pairs, temporal_pairs-or-None)."""
        feats = _as_np_features(feats)
        f0 = type(feats)(*(t[2 * j] for t in feats))
        f1 = type(feats)(*(t[2 * j + 1] for t in feats))
        with torch.profiler.record_function("stereo+temporal match"):
            pairs, temporal = self._stereo_and_temporal(f0, f1)
        return f0, f1, pairs, temporal

    def _frontend(self, image_left, image_right):
        """rectify → detect → the host pull and match, each a section of
        ``stage_timer``. With a timer the detect section ends with the card
        synchronized, so the pull left to stereo_match is the copy alone."""
        with self._stage("rectify"):
            pair = self.rectify(image_left, image_right)
        with self._stage("detect"):
            feats_dev = self.detector.detect(pair)
        with self._stage("stereo_match"):
            return self._match_detected(feats_dev)

    def _stereo_and_temporal(self, f0, f1):
        """ONE batched matcher pass per frame: the stereo pair and (once
        tracking) the temporal match against the last keyframe. Returns
        (stereo_pairs, temporal_pairs-or-None)."""
        if (self.init and self.last_keyframe is not None
                and hasattr(self.matcher, "matching_points_batched")):
            res = self.matcher.matching_points_batched(
                [(f0, f1), (self.last_keyframe, f0)], threshold=self.match_threshold)
            return res[0][0], res[1][0]
        pairs, _ = self.matcher.matching_points(f0, f1, threshold=self.match_threshold)
        return pairs, None

    # ------------------------------------------------------------------

    def track_features(self, timestamp, feats_left, feats_right, stereo_pairs,
                       imu_batch=None, temporal_matches=None):
        """Core pipeline entry taking pre-computed features (also the test
        surface). feats_*: FrameFeatures-like; stereo_pairs: (M, 2);
        ``temporal_matches``: optional precomputed last-keyframe matches
        (from the batched pass in :meth:`_stereo_and_temporal`)."""
        frame = self._build_frame(timestamp, feats_left, feats_right, stereo_pairs)

        if self.camera_uses_imu() and imu_batch is not None and self.last_keyframe is not None:
            if self.preintegration is None:
                self.preintegration = self._new_preintegration()
            self.preintegration.add_batch(
                imu_batch, self.last_keyframe.timestamp
                if self.preintegration.start_time < 0 else self.preintegration.end_time,
                timestamp)

        if not self.init:
            if frame.good_stereo_points >= self.kf_config.min_init_stereo_feature:
                self._initialize(frame)
            return frame

        matches = (temporal_matches if temporal_matches is not None
                   else self._match_frames(self.last_keyframe, frame))
        num_inliers = self._track_frame(self.last_keyframe, frame, matches)

        self._trajectory.append((
            timestamp, self.last_keyframe,
            np.linalg.inv(self.last_keyframe.Twc) @ frame.Twc,
        ))

        if num_inliers <= self.kf_config.lost_num_match:
            self.last_tracked_frame = frame
            self.insert_next_keyframe = True
            return frame

        decision = self._keyframe_check(self.last_keyframe, frame, matches)
        if decision == 0 or self.insert_next_keyframe:
            self._insert_keyframe(frame)
            self.insert_next_keyframe = False
        elif decision == 1:
            self.insert_next_keyframe = True

        self.last_tracked_frame = frame
        self._publish(frame)
        return frame

    def _publish(self, frame: Frame):
        if self.publisher is None:
            return
        from airslam_tpu_torch.io import publisher as pub

        self.publisher.publish_frame_pose(
            pub.FramePoseMessage(time=frame.timestamp, pose=frame.Twc.copy()))
        m = self.map
        self.publisher.publish_keyframes(pub.KeyframeMessage(
            time=frame.timestamp, ids=list(m.keyframe_ids),
            poses=[m.keyframes[f].Twc.copy() for f in m.keyframe_ids]))
        pts = np.asarray([p.position for p in m.mappoints.values() if p.is_valid])
        self.publisher.publish_map(pub.MapMessage(time=frame.timestamp, points=pts))
        ends = np.asarray([l.endpoints for l in m.maplines.values()
                           if l.is_valid and l.endpoints_valid])
        self.publisher.publish_maplines(
            pub.MaplineMessage(time=frame.timestamp, endpoints=ends))

    def track_frame(self, timestamp, image_left, image_right) -> TrackResult:
        """The tracking path of one frame against the last keyframe, up to
        and including the keyframe decision: what :meth:`add_input` runs for a
        frame after initialisation, without the keyframe insertion that may
        follow it. The last keyframe stays, so any number of frames
        can be tracked against it."""
        if not self.init:
            raise RuntimeError("track_frame needs an initialised builder: "
                               "feed add_input a frame with enough stereo points first")
        f0, f1, pairs, temporal = self._frontend(image_left, image_right)
        return self.track_frame_features(timestamp, f0, f1, pairs, temporal)

    def track_frame_features(self, timestamp, feats_left, feats_right, stereo_pairs,
                             temporal_matches=None) -> TrackResult:
        """:meth:`track_frame` on pre-computed features and matches."""
        ref = self.last_keyframe
        frame = self._build_frame(timestamp, feats_left, feats_right, stereo_pairs)
        matches = (temporal_matches if temporal_matches is not None
                   else self._match_frames(ref, frame))
        num_inliers, inlier_flags, line_matches = self._track(ref, frame, matches)
        self.last_tracked_frame = frame
        return TrackResult(frame.Twc.copy(), num_inliers, inlier_flags,
                           self._keyframe_check(ref, frame, matches), line_matches)

    # ------------------------------------------------------------------

    def camera_uses_imu(self):
        return bool(getattr(self.camera, "use_imu", False))

    def _new_preintegration(self):
        c = self.camera
        return Preintegration(noise=(c.gyr_noise, c.acc_noise, c.gyr_walk, c.acc_walk),
                              dtype=self.dtype, device=self.device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    def _build_frame(self, timestamp, feats_left, feats_right, stereo_pairs):
        with torch.profiler.record_function("build_frame"):
            frame = Frame(self.frame_counter, timestamp, feats_left, self.camera)
            self.frame_counter += 1
            pairs = np.asarray(stereo_pairs).reshape(-1, 2)
            fr = _as_np_features(feats_right)
            frame.good_stereo_points = frame.add_right_features(fr, pairs, self.camera)

            # left point-on-line relation + right relation + stereo line
            # match in one call on the builder's device, one pull back
            idx1, msk = _match_table(pairs, frame.keypoints.shape[0])
            t, dev = self._tensor, self.device
            rel, lm = frame_relations(
                t(frame.lines), torch.as_tensor(frame.line_mask, device=dev),
                t(frame.keypoints), torch.as_tensor(frame.kp_mask, device=dev),
                t(fr.lines), torch.as_tensor(fr.line_mask, device=dev),
                t(fr.keypoints), torch.as_tensor(fr.kp_mask, device=dev),
                torch.as_tensor(idx1, device=dev), torch.as_tensor(msk, device=dev))
            frame.points_on_lines = rel.cpu().numpy()
            lm = lm.cpu().numpy()
            sel = np.nonzero(lm >= 0)[0]
            frame.lines_right[sel] = fr.lines[lm[sel]]
            frame.lines_right_valid[sel] = True
        return frame

    def _initialize(self, frame: Frame):
        """map_builder.cc:181-199: fixed init pose, assign track ids, insert."""
        frame.set_pose(INIT_TWC)
        self._assign_new_track_ids(frame)
        frame.previous_frame = None
        self.map.insert_keyframe(frame)
        self.last_keyframe = frame
        self.last_tracked_frame = frame
        self.init = True
        self._trajectory.append((frame.timestamp, frame, np.eye(4)))

    def _assign_new_track_ids(self, frame: Frame):
        for i in np.nonzero(frame.kp_mask)[0]:
            if frame.track_ids[i] < 0:
                frame.track_ids[i] = self.track_id_counter
                self.track_id_counter += 1
        for i in np.nonzero(frame.line_mask)[0]:
            if frame.line_track_ids[i] < 0:
                frame.line_track_ids[i] = self.line_track_id_counter
                self.line_track_id_counter += 1

    def _match_frames(self, ref: Frame, cur: Frame):
        m = self.matcher.match(
            ref.keypoints, ref.kp_scores, ref.kp_desc, ref.kp_mask,
            cur.keypoints, cur.kp_scores, cur.kp_desc, cur.kp_mask,
            threshold=self.match_threshold,
        )
        mask = m.mask.cpu().numpy()
        i0 = np.nonzero(mask)[0]
        i1 = m.idx1.cpu().numpy()[i0]
        return (np.stack([i0, i1], axis=-1).astype(np.int32) if len(i0)
                else np.zeros((0, 2), np.int32))

    # -- tracking (map_builder.cc:230-426) ---------------------------------

    def _track_frame(self, ref: Frame, cur: Frame, matches) -> int:
        return self._track(ref, cur, matches)[0]

    def _track(self, ref: Frame, cur: Frame, matches):
        """Track ``cur`` against ``ref``: returns (num_inliers, inlier_flags,
        line_matches (L,) into ``cur``'s lines, −1 = none)."""
        idx1, msk = _match_table(matches, ref.keypoints.shape[0])
        dev = self.device
        line_matches = match_lines_by_points(
            torch.as_tensor(ref.points_on_lines, device=dev),
            torch.as_tensor(cur.points_on_lines, device=dev),
            torch.as_tensor(idx1, device=dev), torch.as_tensor(msk, device=dev)).cpu().numpy()

        # gather tracked mappoints for pose optimization
        matched_mpt_idx = []  # (cur_idx, mappoint)
        for i0, i1 in matches:
            tid = int(ref.track_ids[i0])
            mpt = self.map.mappoints.get(tid)
            if mpt is not None and mpt.is_valid:
                matched_mpt_idx.append((int(i1), mpt))

        num_inliers, inlier_flags = self._frame_pose_optimization(ref, cur, matched_mpt_idx)

        if num_inliers > self.kf_config.lost_num_match:
            inlier_set = set(i for i, ok in inlier_flags if ok)
            for i0, i1 in matches:
                if ref.track_ids[i0] >= 0 and (int(i1) in inlier_set or
                                               int(ref.track_ids[i0]) not in self.map.mappoints):
                    cur.track_ids[i1] = ref.track_ids[i0]
                    cur.mappoint_ids[i1] = ref.mappoint_ids[i0]
            for i, j in enumerate(line_matches):
                if j >= 0 and ref.line_track_ids[i] >= 0:
                    cur.line_track_ids[j] = ref.line_track_ids[i]
                    cur.mapline_ids[j] = ref.mapline_ids[i]
        return num_inliers, inlier_flags, line_matches

    def _frame_pose_optimization(self, ref: Frame, cur: Frame, matched):
        """IMU-predict / PnP initial pose + pose-only GN
        (map_builder.cc:285-426). ``matched``: [(cur_idx, Mappoint)]."""
        imu_running = (self.map.imu_initialized and self.preintegration is not None
                       and self.preintegration.valid())
        Twc = np.eye(4)
        predicted = False
        if imu_running and self.preintegration.dT < 2.0:
            Twb0 = ref.imu_pose(self.camera.Tcb)
            Twb1, vwb1 = self.preintegration.predict(Twb0, ref.velocity, self.camera.g_value)
            Twc = Twb1 @ np.linalg.inv(self.camera.Tcb)
            if np.linalg.norm(Twc[:3, 3] - self.last_tracked_frame.Twc[:3, 3]) < 1.0:
                predicted = True
                cur.velocity = vwb1

        if not predicted:
            with torch.profiler.record_function("pnp"):
                Twc, n_pnp = self._solve_pnp(cur, matched)
            if (
                np.linalg.norm(Twc[:3, 3] - self.last_tracked_frame.Twc[:3, 3]) > 1.0
                or n_pnp < self.kf_config.lost_num_match
            ):
                Twc = self.last_tracked_frame.Twc.copy()

        cur.set_pose(Twc)

        if not matched:
            return 0, []
        with torch.profiler.record_function("pose_only"):
            return self._pose_only(cur, matched, ref if imu_running else None)

    def _solve_pnp(self, cur: Frame, matched):
        """PnP-RANSAC initial pose (g2o_optimization.cc:1085-1134: 100 iters,
        20 px, 0.99): OpenCV on the host, or with ``use_jax_pnp`` the
        device-resident RANSAC."""
        if len(matched) < 8:
            return self.last_tracked_frame.Twc.copy(), 0
        if self.use_jax_pnp:
            return self._solve_pnp_jax(cur, matched)
        try:
            import cv2
        except ImportError:
            return self._solve_pnp_jax(cur, matched)
        obj = np.asarray([m.position for _, m in matched], np.float64)
        img = np.asarray([cur.keypoints[i] for i, _ in matched], np.float64)
        K = np.array(
            [[self.camera.fx, 0, self.camera.cx], [0, self.camera.fy, self.camera.cy], [0, 0, 1]]
        )
        try:
            ok, rvec, tvec, inl = cv2.solvePnPRansac(
                obj, img, K, np.zeros(5), iterationsCount=100,
                reprojectionError=20.0, confidence=0.99,
            )
        except cv2.error:
            return self.last_tracked_frame.Twc.copy(), 0
        if not ok:
            return self.last_tracked_frame.Twc.copy(), 0
        Rcw, _ = cv2.Rodrigues(rvec)
        Twc = np.eye(4)
        Twc[:3, :3] = Rcw.T
        Twc[:3, 3] = -Rcw.T @ tvec[:, 0]
        return Twc, 0 if inl is None else len(inl)

    def _solve_pnp_jax(self, cur: Frame, matched):
        """Device-resident RANSAC PnP (backend/pnp.py) on the builder's
        device, points padded to a power of two (at least 128), the draws
        seeded by the frame id."""
        from airslam_tpu_torch.backend.pnp import solve_pnp_ransac

        n = max(128, 1 << (len(matched) - 1).bit_length())
        pts = np.zeros((n, 3))
        uv = np.zeros((n, 2))
        mask = np.zeros(n, bool)
        for j, (i, mpt) in enumerate(matched):
            pts[j] = mpt.position
            uv[j] = cur.keypoints[i]
            mask[j] = True
        gen = torch.Generator(device=self.device).manual_seed(int(cur.frame_id))
        R, t, inl, ok = solve_pnp_ransac(self._tensor(pts), self._tensor(uv),
                                         torch.as_tensor(mask, device=self.device),
                                         self.map._intr, generator=gen)
        if not bool(ok):
            return self.last_tracked_frame.Twc.copy(), 0
        R, t = R.double().cpu().numpy(), t.double().cpu().numpy()
        Twc = np.eye(4)
        Twc[:3, :3] = R.T
        Twc[:3, 3] = -R.T @ t
        return Twc, int(inl.sum())

    def _pose_only(self, cur: Frame, matched, imu_ref: Optional[Frame] = None):
        """Pose-only GN (FrameOptimization equiv) on the builder's device,
        points padded to a power of two, one masked dummy line. Vision: the
        F=1 problem. With ``imu_ref`` the problem holds the IMU factor to the
        last keyframe with that frame's states fixed (map_builder.cc:320-395):
        F=2, frame 0 the fixed reference, frame 1 the current frame (pose,
        velocity and biases free)."""
        f = 2 if imu_ref is not None else 1
        cur_col = f - 1
        p = len(matched)
        P = max(64, 1 << (p - 1).bit_length())
        dt = np.float64 if self.dtype == torch.float64 else np.float32
        points = np.zeros((P, 3), dt)
        obs = np.zeros((P, f, 3), dt)
        obs[..., 2] = -1.0
        mask = np.zeros((P, f), bool)
        for j, (i, mpt) in enumerate(matched):
            points[j] = mpt.position
            obs[j, cur_col] = cur.keypoint_position(i)
            mask[j, cur_col] = True

        Tcb = self.camera.Tcb
        Twbs = [cur.Twc @ Tcb]
        states = [cur]
        if imu_ref is not None:
            Twbs.insert(0, imu_ref.imu_pose(Tcb))
            states.insert(0, imu_ref)
        Twbs = np.stack(Twbs)
        t, dev = self._tensor, self.device
        fstates = gn.FrameStates(
            Rwb=t(Twbs[:, :3, :3]), twb=t(Twbs[:, :3, 3]),
            vel=t(np.stack([s.velocity for s in states])),
            bg=t(np.stack([s.bg for s in states])), ba=t(np.stack([s.ba for s in states])))
        imu_factors = self._tracking_imu_factor() if imu_ref is not None else None
        # every leaf that does not change between frames is put on the device
        # ONCE per (P, f) and reused via _replace: most of the problem's
        # leaves are constants, and per-leaf transfers would dominate the
        # host cost of this per-frame assembly
        tmpl = self._pose_problem_tmpl.get((P, f))
        if tmpl is None:
            pose_fixed = np.zeros(f, bool)
            vel_fixed = np.ones(f, bool)
            if imu_ref is not None:
                pose_fixed[0] = True
                vel_fixed[1] = False
            tmpl = gn.BAProblem(
                frames=fstates,
                pose_fixed=torch.as_tensor(pose_fixed, device=dev),
                vel_fixed=torch.as_tensor(vel_fixed, device=dev),
                points=t(points),
                point_fixed=torch.ones(P, dtype=torch.bool, device=dev),
                point_obs=t(obs),
                point_obs_mask=torch.as_tensor(mask, device=dev),
                lines=t([[1.0, 0, 0, 0, 1.0, 0]]),
                line_fixed=torch.ones(1, dtype=torch.bool, device=dev),
                line_obs=torch.zeros((1, f, 8), dtype=self.dtype, device=dev),
                line_obs_stereo=torch.zeros((1, f), dtype=torch.bool, device=dev),
                line_obs_mask=torch.zeros((1, f), dtype=torch.bool, device=dev),
                line_obs_sigma=torch.full((1, f), 0.5, dtype=self.dtype, device=dev),
                Rwg=t(self.map.Rwg),
                gravity_free=torch.zeros((), dtype=self.dtype, device=dev),
                imu=imu_factors,
                Rcb=t(Tcb[:3, :3]),
                tcb=t(Tcb[:3, 3]),
                g_value=self.map.g_value,
            )
            self._pose_problem_tmpl[(P, f)] = tmpl
            problem = tmpl
        else:
            problem = tmpl._replace(
                frames=fstates, points=t(points), point_obs=t(obs),
                point_obs_mask=torch.as_tensor(mask, device=dev), Rwg=t(self.map.Rwg),
                imu=imu_factors)
        out, p_in, _, n_in = windows.pose_only_optimization(
            problem, self.map._intr, self.map.ba_config,
            vi_tracking=True if imu_factors is not None else None)
        n_in = int(n_in)  # the frame's one read of the solve back to the host
        if n_in > self.kf_config.lost_num_match:
            Rwb, twb, vel, bg, ba = (a[cur_col].double().cpu().numpy() for a in out.frames)
            Twb_new = np.eye(4)
            Twb_new[:3, :3] = Rwb
            Twb_new[:3, 3] = twb
            cur.Twc = Twb_new @ np.linalg.inv(Tcb)
            if imu_ref is not None:
                cur.velocity, cur.bg, cur.ba = vel, bg, ba
        p_in = p_in[:, cur_col].cpu().numpy()
        flags = [(i, bool(p_in[j])) for j, (i, _) in enumerate(matched)]
        return n_in, flags

    def _tracking_imu_factor(self):
        """IMUFactors (K=1, frames 0→1) from the live preintegration; its
        information matrices are computed on the host (numpy) from the
        state's covariance, the deltas stay on the device."""
        pre = self.preintegration
        st = pre.state
        info9, walk = preintegration_information(st.cov)
        t, dev = self._tensor, self.device
        return gn.IMUFactors(
            idx_i=torch.zeros(1, dtype=torch.long, device=dev),
            idx_j=torch.ones(1, dtype=torch.long, device=dev),
            dR=st.dR[None], dV=st.dV[None], dP=st.dP[None],
            JRg=st.JRg[None], JVg=st.JVg[None], JVa=st.JVa[None],
            JPg=st.JPg[None], JPa=st.JPa[None],
            bg_lin=t(pre.bg[None]), ba_lin=t(pre.ba[None]), dT=st.dT[None],
            info=t(info9[None]), info_walk=t(walk[None]),
            mask=torch.ones(1, dtype=torch.bool, device=dev),
        )

    # -- keyframe policy (map_builder.cc:429-466) ---------------------------

    def _keyframe_check(self, ref: Frame, cur: Frame, matches) -> int:
        """0 = this frame, 1 = next frame, 2 = none."""
        match_num = len(matches)
        if match_num < self.kf_config.min_num_match:
            return 0
        rate_thr = self.kf_config.tracking_point_rate
        parallax_thr = self.kf_config.tracking_parallax_rate
        if self.camera_uses_imu() and not self.map.imu_initialized:
            rate_thr *= 1.1
            parallax_thr *= 0.7

        n_ref = max(ref.valid_keypoint_count(), 1)
        n_cur = max(cur.valid_keypoint_count(), 1)
        if (
            match_num / n_ref < rate_thr
            or match_num / n_cur < rate_thr
            or match_num < self.kf_config.max_num_match
        ):
            return 1

        d = ref.keypoints[matches[:, 0]] - cur.keypoints[matches[:, 1]]
        avg_parallax = float((d * d).sum()) / match_num
        image_size = self.camera.image_height * self.camera.image_width
        if avg_parallax > image_size * parallax_thr * parallax_thr:
            return 1
        return 2

    def _insert_keyframe(self, frame: Frame):
        # this frame's own pose will keep being refined — make its trajectory
        # entry self-referential so it tracks the keyframe, not the old ref
        if self._trajectory and self._trajectory[-1][0] == frame.timestamp:
            self._trajectory[-1] = (frame.timestamp, frame, np.eye(4))
        self._assign_new_track_ids(frame)
        frame.previous_frame = self.last_keyframe
        if self.camera_uses_imu() and self.preintegration is not None:
            frame.preintegration = self.preintegration
            frame.bg = self.preintegration.bg.copy()
            frame.ba = self.preintegration.ba.copy()
            self.preintegration = None
        self.map.insert_keyframe(frame)
        self.last_keyframe = frame

    # ------------------------------------------------------------------

    @property
    def trajectory(self):
        """Full-rate (timestamp, Twc) list, composed against the reference
        keyframes' current (post-correction) poses."""
        return [(ts, ref.Twc @ rel) for ts, ref, rel in self._trajectory]

    def save_trajectory(self, path: str):
        from airslam_tpu_torch.io.trajectory import save_tum

        save_tum(path, self.trajectory)

    def save_keyframe_trajectory(self, path: str):
        from airslam_tpu_torch.io.trajectory import save_tum

        save_tum(path, self.map.keyframe_trajectory())

