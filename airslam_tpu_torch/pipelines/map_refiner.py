"""Offline map refinement pipeline (stage 2).

Port of ``airslam_tpu/pipelines/map_refiner.py`` (which replaces
``src/map_refiner.cc``): load mapv0 → BoW database build + loop
detection → (large maps) pose-graph refinement → landmark merging → global
BA → junction vocabulary/database → save mapv1.

Loop detection gates mirror map_refiner.cc:95-234:
- shared-word filter ≥ max(0.5·max_sharing, 8), older frames only, no
  covisibles;
- covisibility grouping with deputy frames (covisible weight > 10);
- distance gate 3% of accumulated odometry length;
- LightGlue match against the best candidate, > 50 matches;
- pose-only optimization vs the loop frame's mappoints, ≥ 50 points and ≥ 50
  inliers (RelativatePoseEstimation, map_refiner.cc:237-460) with epipolar +
  reprojection-gated match recovery through the loop group's inverted file.

The registries, the union-find, the epipolar gate and the match recovery
are host work in numpy, as in the JAX package. The vocabulary's transform,
the pose-only solve, the pose graph and the global BA run on the map's
device in its dtype: on a CUDA map the pose-only solve is one launch of
kernel P (``backend/pose_gn.py``), and LightGlue's attention goes through
kernel F when the matcher was built with ``use_flash``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import time

import numpy as np
import torch

from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.loopclosure.database import Database
from airslam_tpu_torch.loopclosure.vocabulary import Vocabulary, train_vocabulary
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.landmarks import Mappoint
from airslam_tpu_torch.slam.map import Map
from airslam_tpu_torch.utils import native


@dataclasses.dataclass
class LoopFramePair:
    query_id: int
    loop_id: int
    Rlq: np.ndarray
    tlq: np.ndarray


class MapRefiner:
    def __init__(self, m: Map, matcher, point_voc: Vocabulary,
                 match_threshold: Optional[float] = None):
        self.map = m
        self.matcher = matcher
        self.database = Database(point_voc)
        self.junction_database: Optional[Database] = None
        self.match_threshold = match_threshold
        self.odometry_length = 0.0
        self.loop_pairs: List[LoopFramePair] = []
        self.merged_mappoints: Dict[int, Set[int]] = {}
        self.n_merged_mappoints = 0
        self.n_merged_maplines = 0
        self.pose_graph_ran = False
        self.n_pose_only = 0  # pose-only solves run by the loop detection
        self.stage_ms: Dict[str, float] = {}  # wall ms of each stage of run()

    # ------------------------------------------------------------------

    def run(self, pose_graph_min_mappoints: int = 80000):
        """The whole refinement; each stage's wall time goes to
        ``stage_ms`` (each stage ends by pulling its results to the host)."""
        def stage(name, fn):
            t0 = time.perf_counter()
            out = fn()
            self.stage_ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        self.map.update_covisibility_graph()
        n_loops = stage("loop_detection", self.loop_detection)
        if len(self.map.mappoints) >= pose_graph_min_mappoints and self.loop_pairs:
            stage("pose_graph", self.pose_graph_refinement)
            self.pose_graph_ran = True
        stage("merge_map", self.merge_map)
        stage("global_map_optimization", self.global_map_optimization)
        stage("build_junction_database", self.build_junction_database)
        return n_loops

    # ------------------------------------------------------------------
    # loop detection (map_refiner.cc:65-234)
    # ------------------------------------------------------------------

    def loop_detection(self) -> int:
        last_pos = None
        for fid in self.map.keyframe_ids:
            frame = self.map.keyframes[fid]
            pos = frame.Twc[:3, 3]
            if last_pos is not None:
                self.odometry_length += float(np.linalg.norm(pos - last_pos))
            last_pos = pos

            vec, wids, word_features = self.database.frame_to_bow(
                frame.kp_desc, frame.kp_mask
            )
            frame.bow_vector = vec
            frame.word_of_features = wids
            self._detect_sentences(frame, wids)
            self._loop_detect_one(frame, vec, word_features)
            self.database.add_frame_bow(fid, vec, wids, word_features)
        return len(self.loop_pairs)

    def _detect_sentences(self, frame: Frame, wids):
        """Words per line — the 'sentences' used by the junction structure
        graph (frame.cc:512-528)."""
        sentences = []
        for li in np.nonzero(frame.line_mask)[0]:
            on_line = np.nonzero(frame.points_on_lines[li])[0]
            words = {int(wids[i]) for i in on_line if wids[i] >= 0}
            sentences.append(words)
        frame.sentences = sentences

    def _loop_detect_one(self, frame: Frame, vec, word_features):
        fid = frame.frame_id
        counts = self.database.query(vec)
        if not counts:
            return
        max_sharing = max(counts.values())
        thr = max(int(max_sharing * 0.5), 8)
        covis = set(self.map.covisible_frames(fid))
        cands = {
            f: c for f, c in counts.items()
            if f < fid and c >= thr and f not in covis
        }
        if not cands:
            return

        cand_ids = list(cands)
        scores = dict(zip(cand_ids, self.database.batched_scores(vec, cand_ids)))

        # grouping with deputies (map_refiner.cc:132-172)
        groups: Dict[int, dict] = {}
        best_deputy, best_score = None, -1.0
        for f, s in scores.items():
            deputy, dscore = f, s
            members = {f}
            gscore = s
            for cf in self.map.covisible_frames(f, min_shared=11):
                if cf in scores:
                    members.add(cf)
                    gscore += scores[cf]
                    if scores[cf] > dscore:
                        deputy, dscore = cf, scores[cf]
            if deputy not in groups or groups[deputy]["score"] < gscore:
                groups[deputy] = dict(score=gscore, members=members)
                if gscore > best_score:
                    best_score, best_deputy = gscore, deputy

        if best_deputy is None:
            return

        # distance gate (map_refiner.cc:176-191)
        cur_pos = frame.Twc[:3, 3]
        dist_thr = self.odometry_length * 0.03
        groups = {
            d: g for d, g in groups.items()
            if np.linalg.norm(self.map.keyframes[d].Twc[:3, 3] - cur_pos) <= dist_thr
        }
        if not groups:
            return
        if len(groups) > 3:
            groups = {d: g for d, g in groups.items() if g["score"] >= best_score * 0.5}

        ordered = sorted(groups.items(), key=lambda kv: -kv[1]["score"])[:5]

        best_matches, best_candidate = None, None
        for deputy, _ in ordered:
            loop_frame = self.map.keyframes[deputy]
            pairs, _ = self.matcher.matching_points(
                frame, loop_frame, outlier_rejection=True,
                threshold=self.match_threshold,
            )
            if best_matches is None or len(pairs) > len(best_matches):
                best_matches, best_candidate = pairs, deputy

        if best_matches is None or len(best_matches) <= 50:
            return
        self._relative_pose_estimation(
            frame, word_features, best_candidate, best_matches, groups
        )

    # ------------------------------------------------------------------

    def _relative_pose_estimation(self, frame, word_features, loop_id, matches, groups):
        loop_frame = self.map.keyframes[loop_id]
        matched: Dict[int, Mappoint] = {}
        untriangulated = []  # (query idx, loop idx, mappoint)
        for qi, li in matches:
            tid = int(loop_frame.track_ids[li])
            mpt = self.map.mappoints.get(tid)
            if mpt is None:
                continue
            if mpt.is_valid:
                matched[int(qi)] = mpt
            else:
                untriangulated.append((int(qi), int(li), mpt))
        if len(matched) < 50:
            return

        out_pose, inliers, n_in = self._pose_only(frame, matched)
        if n_in < 50:
            return

        Twq = out_pose
        Twl = loop_frame.Twc
        Rlq = Twl[:3, :3].T @ Twq[:3, :3]
        tlq = Twl[:3, :3].T @ (Twq[:3, 3] - Twl[:3, 3])

        # untriangulated matches: epipolar gate vs the loop frame, then add
        # the observation and retry triangulation (map_refiner.cc:415-433)
        self._epipolar_recover(frame, loop_frame, untriangulated, Twq)

        # match recovery through the loop group (epipolar + reprojection gates)
        group_frames = set(groups[loop_id]["members"]) - {loop_id}
        recovered = self._find_more_matches(
            frame, word_features, matched, inliers, Twq, group_frames
        )

        self.loop_pairs.append(LoopFramePair(frame.frame_id, loop_id, Rlq, tlq))

        # record merge candidates (map_refiner.cc:440-459)
        for qi, mpt in {**matched, **recovered}.items():
            own_tid = int(frame.track_ids[qi])
            own = self.map.mappoints.get(own_tid)
            if own is None:
                frame.track_ids[qi] = mpt.id
                frame.mappoint_ids[qi] = mpt.id
                mpt.add_observer(frame.frame_id, qi)
                continue
            if own.id != mpt.id:
                self.merged_mappoints.setdefault(own.id, set()).add(mpt.id)

    def _epipolar_recover(self, frame, loop_frame, untriangulated, Twq):
        """Fundamental-matrix gate for matched-but-untriangulated mappoints
        (map_refiner.cc:337-353 + 415-424): |x2ᵀ F x1| / |l| < 10 px admits
        the query observation, then multi-view triangulation is retried."""
        if not untriangulated:
            return
        cam = self.map.camera
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
        Twl = loop_frame.Twc
        Rlq = Twl[:3, :3].T @ Twq[:3, :3]
        tlq = Twl[:3, :3].T @ (Twq[:3, 3] - Twl[:3, 3])
        tx = np.array([[0, -tlq[2], tlq[1]], [tlq[2], 0, -tlq[0]], [-tlq[1], tlq[0], 0]])
        # standard two-view fundamental matrix K⁻ᵀ [t]× R K⁻¹ (the reference
        # composes with K on the right, map_refiner.cc:341 — we use the
        # geometrically correct form)
        F = np.linalg.inv(K).T @ tx @ Rlq @ np.linalg.inv(K)
        for qi, li, mpt in untriangulated:
            p1 = np.append(frame.keypoints[qi], 1.0)
            p2 = np.append(loop_frame.keypoints[li], 1.0)
            el = F @ p1
            s = np.linalg.norm(el[:2])
            if s < 1e-9:
                continue
            if abs(p2 @ el) / s < 10.0:
                mpt.add_observer(frame.frame_id, qi)
                frame.track_ids[qi] = mpt.id
                frame.mappoint_ids[qi] = mpt.id
                self.map.triangulate_mappoint(mpt)

    def _find_more_matches(self, frame, word_features, matched, inlier_map,
                           Twq, group_frames):
        """Inverted-file search through the loop group with a reprojection
        gate (map_refiner.cc:343-400 find_more_matches_in_group)."""
        cam = self.map.camera
        Rwq, twq = Twq[:3, :3], Twq[:3, 3]
        cfg = self.map.ba_config
        found: Dict[int, Mappoint] = {}
        for wid, idxs in word_features.items():
            inv = self.database.inverted_file.get(wid, {})
            for qi in idxs:
                if qi in matched and inlier_map.get(qi, True):
                    continue
                qd = frame.kp_desc[qi]
                best, best_dist = None, 5.0
                for f2, cand_idxs in inv.items():
                    if f2 not in group_frames:
                        continue
                    kf2 = self.map.keyframes[f2]
                    for ci in cand_idxs:
                        dist = 1.0 - float(qd @ kf2.kp_desc[ci])
                        if dist < best_dist:
                            tid = int(kf2.track_ids[ci])
                            mpt = self.map.mappoints.get(tid)
                            if mpt is not None and mpt.is_valid:
                                best, best_dist = mpt, dist
                if best is None:
                    continue
                # reprojection gate
                pc = Rwq.T @ (best.position - twq)
                if pc[2] <= 0:
                    continue
                u = pc[0] / pc[2] * cam.fx + cam.cx
                v = pc[1] / pc[2] * cam.fy + cam.cy
                d = frame.keypoints[qi] - [u, v]
                if d @ d < cfg.mono_point:
                    found[int(qi)] = best
        return found

    def _pose_only(self, frame, matched):
        """Pose-only optimization of the query frame against the fixed loop
        mappoints, padded to a power of two (at least 64) with one masked
        line: kernel P on a CUDA map. Returns (Twc, {idx: inlier},
        n_inliers)."""
        p = len(matched)
        P = max(64, 1 << (p - 1).bit_length())
        points = np.zeros((P, 3))
        obs = np.zeros((P, 1, 3))
        obs[..., 2] = -1.0
        mask = np.zeros((P, 1), bool)
        order = list(matched.items())
        for j, (qi, mpt) in enumerate(order):
            points[j] = mpt.position
            obs[j, 0] = frame.keypoint_position(qi)
            mask[j, 0] = True

        m = self.map
        t, dev = m._tensor, m.device

        def flag(a):
            return torch.as_tensor(np.asarray(a, bool), device=dev)

        Tcb = m.camera.Tcb
        Twb = frame.Twc @ Tcb
        zeros = t(np.zeros((1, 3)))
        problem = gn.BAProblem(
            frames=gn.FrameStates(Rwb=t(Twb[None, :3, :3]), twb=t(Twb[None, :3, 3]),
                                  vel=zeros, bg=zeros, ba=zeros),
            pose_fixed=flag([False]), vel_fixed=flag([True]),
            points=t(points), point_fixed=flag(np.ones(P)),
            point_obs=t(obs), point_obs_mask=flag(mask),
            lines=t([[1.0, 0, 0, 0, 1.0, 0]]), line_fixed=flag([True]),
            line_obs=t(np.zeros((1, 1, 8))), line_obs_stereo=flag([[False]]),
            line_obs_mask=flag([[False]]), line_obs_sigma=t(np.full((1, 1), 0.5)),
            Rwg=t(m.Rwg), gravity_free=t(0.0), imu=None,
            Rcb=t(Tcb[:3, :3]), tcb=t(Tcb[:3, 3]), g_value=m.g_value,
        )
        out, p_in, _, n_in = windows.pose_only_optimization(problem, m._intr, m.ba_config)
        self.n_pose_only += 1
        Twb_new = np.eye(4)
        Twb_new[:3, :3] = out.frames.Rwb[0].double().cpu().numpy()
        Twb_new[:3, 3] = out.frames.twb[0].double().cpu().numpy()
        Twc = Twb_new @ np.linalg.inv(Tcb)
        p_in = p_in.cpu().numpy()[:, 0]
        inliers = {qi: bool(p_in[j]) for j, (qi, _) in enumerate(order)}
        return Twc, inliers, int(n_in)

    # ------------------------------------------------------------------
    # pose graph (map_refiner.cc:463-591)
    # ------------------------------------------------------------------

    def pose_graph_refinement(self):
        ids = self.map.keyframe_ids
        idx = {fid: k for k, fid in enumerate(ids)}
        f = len(ids)
        Rwb = np.zeros((f, 3, 3))
        twb = np.zeros((f, 3))
        for k, fid in enumerate(ids):
            T = self.map.keyframes[fid].Twc
            Rwb[k] = T[:3, :3]
            twb[k] = T[:3, 3]

        ei, ej, Rm, tm = [], [], [], []

        def add_edge(a, b):
            Ta = self.map.keyframes[a].Twc
            Tb = self.map.keyframes[b].Twc
            ei.append(idx[a])
            ej.append(idx[b])
            Rm.append(Ta[:3, :3].T @ Tb[:3, :3])
            tm.append(Ta[:3, :3].T @ (Tb[:3, 3] - Ta[:3, 3]))

        for a, b in zip(ids[:-1], ids[1:]):
            add_edge(a, b)
        for lp in self.loop_pairs:
            ei.append(idx[lp.loop_id])
            ej.append(idx[lp.query_id])
            Rm.append(lp.Rlq)
            tm.append(lp.tlq)

        fixed = np.zeros(f, bool)
        fixed[0] = True
        t, dev = self.map._tensor, self.map.device
        problem = windows.PoseGraphProblem(
            Rwb=t(Rwb), twb=t(twb), fixed=torch.as_tensor(fixed, device=dev),
            edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
            edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
            R_meas=t(np.stack(Rm)), t_meas=t(np.stack(tm)),
            mask=torch.ones(len(ei), dtype=torch.bool, device=dev),
        )
        out = windows.pose_graph_optimization(problem, iterations=20)
        Rwb_out = out.Rwb.double().cpu().numpy()
        twb_out = out.twb.double().cpu().numpy()
        corrections = {}
        for k, fid in enumerate(ids):
            T = np.eye(4)
            T[:3, :3] = Rwb_out[k]
            T[:3, 3] = twb_out[k]
            corrections[fid] = T
        self.map.apply_pose_corrections(corrections)

    # ------------------------------------------------------------------
    # merging (map_refiner.cc:593-954)
    # ------------------------------------------------------------------

    def merge_map(self):
        self.merge_mappoints()
        if len(self.map.keyframes) >= 2:
            self.map.global_bundle_adjustment(iters1=10, iters2=10)
        self.merge_maplines()

    def merge_mappoints(self):
        """Union-find grouping of matched mappoints (native kernel); keep the
        lowest id, transfer observers, drop the rest."""
        self.n_merged_mappoints = getattr(self, "n_merged_mappoints", 0)
        pair_list = [(a, b) for a, bs in self.merged_mappoints.items() for b in bs]
        if not pair_list:
            return
        # compact ids → union-find over dense range → groups
        ids = sorted({x for ab in pair_list for x in ab})
        dense = {x: i for i, x in enumerate(ids)}
        pairs = np.asarray([[dense[a], dense[b]] for a, b in pair_list], np.int64)
        roots = native.union_find(pairs, len(ids))
        groups: Dict[int, Set[int]] = {}
        for i, r in enumerate(roots):
            if r != i:
                groups.setdefault(ids[int(r)], set()).add(ids[i])
        for root in list(groups):
            groups[root].add(root)

        for root, members in groups.items():
            keeper = self.map.mappoints.get(root)
            if keeper is None:
                continue
            for mid in members:
                if mid == root:
                    continue
                victim = self.map.mappoints.get(mid)
                if victim is None:
                    continue
                for fid, kidx in victim.observers.items():
                    kf = self.map.keyframes.get(fid)
                    if kf is not None:
                        kf.track_ids[kidx] = root
                        kf.mappoint_ids[kidx] = root
                    if fid not in keeper.observers:
                        keeper.add_observer(fid, kidx)
                del self.map.mappoints[mid]
                self.n_merged_mappoints += 1
        self.map.update_covisibility_graph()

    def merge_maplines(self):
        """Merge duplicate maplines after mappoint merging
        (``MergeMaplines``, map_refiner.cc:715-954):

        1. associate mappoints ↔ maplines through the per-frame
           points-on-lines relations;
        2. count shared mappoints per mapline pair (keyed by each sharing
           point's first mapline, like the reference's std::set ordering);
        3. pair gating: ≥5 shared mappoints merges outright; 3..4 shared
           additionally require the geometric same-line check — project the
           keeper's 3D line into every observer of the other and bound the
           normalized endpoint-to-line distance (map_refiner.cc:758-813; the
           shipped binary short-circuits this lambda with an early
           ``return true`` — we run the actual check it contains);
        4. union-find over the pair graph (replacing the reference's
           iterative group-relabeling, map_refiner.cc:851-888);
        5. per group keep the first valid line, absorb observers,
           re-triangulate if needed, delete the rest
           (``MergeMaplineGroup``, map_refiner.cc:909-954).
        """
        self.n_merged_maplines = getattr(self, "n_merged_maplines", 0)
        m = self.map
        # 1. mappoint -> set of mapline ids
        maplines_of_mpt: Dict[int, Set[int]] = {}
        for kf in m.keyframes.values():
            for lidx in np.nonzero(kf.mapline_ids >= 0)[0]:
                mid = int(kf.mapline_ids[lidx])
                if mid not in m.maplines:
                    continue
                for pidx in np.nonzero(kf.points_on_lines[lidx])[0]:
                    pid = int(kf.mappoint_ids[pidx])
                    if pid >= 0 and pid in m.mappoints:
                        maplines_of_mpt.setdefault(pid, set()).add(mid)

        # 2. shared-support counts keyed by the pair's smallest id
        counts: Dict[int, Dict[int, int]] = {}
        for mpl_ids in maplines_of_mpt.values():
            if len(mpl_ids) < 2:
                continue
            best = min(mpl_ids)
            row = counts.setdefault(best, {})
            for mid in mpl_ids:
                row[mid] = row.get(mid, 0) + 1

        # 3. gate pairs (SharingMappointNum1=3, Num2=5, map_refiner.cc:817)
        parent: Dict[int, int] = {}

        def find(x):
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        for best, row in counts.items():
            if best not in m.maplines:
                continue
            for mid, num in row.items():
                if mid == best or num < 3 or mid not in m.maplines:
                    continue
                if num < 5:
                    a, b = m.maplines[best], m.maplines[mid]
                    if a.is_valid:
                        ok = self._check_is_same_line(a, b, 0.25)
                    elif b.is_valid:
                        ok = self._check_is_same_line(b, a, 0.25)
                    else:
                        ok = False
                    if not ok:
                        continue
                union(best, mid)

        groups: Dict[int, List[int]] = {}
        for mid in list(parent):
            groups.setdefault(find(mid), []).append(mid)

        # 5. merge each group
        for members in groups.values():
            if len(members) < 2:
                continue
            members = sorted(members)
            keeper_id = next((i for i in members if m.maplines[i].is_valid),
                             members[0])
            keeper = m.maplines[keeper_id]
            for mid in members:
                if mid == keeper_id:
                    continue
                victim = m.maplines[mid]
                for fid, lidx in victim.observers.items():
                    kf = m.keyframes.get(fid)
                    if kf is not None:
                        kf.line_track_ids[lidx] = keeper_id
                        kf.mapline_ids[lidx] = keeper_id
                    if fid not in keeper.observers:
                        keeper.add_observer(fid, lidx)
                del m.maplines[mid]
                self.n_merged_maplines += 1
            if not keeper.is_valid:
                m.triangulate_mapline_by_mappoints(keeper)
            if keeper.is_valid:
                m.update_mapline_endpoints(keeper)

    def _check_is_same_line(self, mpl1, mpl2, thr: float) -> bool:
        """Geometric same-line gate: reproject ``mpl1``'s 3D line into every
        observer of ``mpl2``; both endpoints of the observed 2D segment must
        lie within the normalized point-to-line bound
        error² ≤ H·W·thr² (map_refiner.cc:758-813)."""
        m = self.map
        cam = m.camera
        intr = m._intr
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)
        H = float(getattr(cam, "image_height", 480))
        W = float(getattr(cam, "image_width", 752))
        err_thr = H * W * thr * thr
        lw = np.asarray(mpl1.line3d)  # Plücker (w, d)
        for fid, lidx in mpl2.observers.items():
            kf = m.keyframes.get(fid)
            if kf is None:
                continue
            obs = kf.lines[lidx]  # (x1, y1, x2, y2)
            Twc = kf.Twc
            Rcw = Twc[:3, :3].T
            tcw = -Rcw @ Twc[:3, 3]
            # Plücker transform: w_c = R w + [t]× R d, d_c = R d
            w_c = Rcw @ lw[:3] + np.cross(tcw, Rcw @ lw[3:])
            l2d = np.array([
                fy * w_c[0],
                fx * w_c[1],
                -fy * cx * w_c[0] - fx * cy * w_c[1] + fx * fy * w_c[2],
            ])
            nrm = np.hypot(l2d[0], l2d[1])
            if nrm < 1e-12:
                return False
            e1 = (obs[0] * l2d[0] + obs[1] * l2d[1] + l2d[2]) / nrm
            e2 = (obs[2] * l2d[0] + obs[3] * l2d[1] + l2d[2]) / nrm
            if e1 * e1 > err_thr or e2 * e2 > err_thr:
                return False
        return True

    # ------------------------------------------------------------------

    def global_map_optimization(self):
        if len(self.map.keyframes) >= 2:
            self.map.global_bundle_adjustment(iters1=50, iters2=40)

    def build_junction_database(self, k: int = 10, depth: int = 3):
        """Train the junction vocabulary (k=10, L=3 TF-IDF L1) on all
        keyframe junction descriptors and index them
        (map_refiner.cc:956-999)."""
        descs = []
        for fid in self.map.keyframe_ids:
            kf = self.map.keyframes[fid]
            if kf.junc_mask.any():
                descs.append(kf.junc_desc[kf.junc_mask])
        if not descs:
            self.junction_database = None
            return
        all_desc = np.concatenate(descs)
        voc = train_vocabulary(all_desc, k=k, depth=depth, seed=0,
                               device=self.database.voc.device)
        self.junction_database = Database(voc)
        for fid in self.map.keyframe_ids:
            kf = self.map.keyframes[fid]
            if kf.junc_mask.any():
                vec, wids = self.junction_database.add_frame(
                    fid, kf.junc_desc, kf.junc_mask
                )
                kf.junction_bow_vector = vec
                kf.junction_words = wids

    # ------------------------------------------------------------------

    def save(self, path: str):
        from airslam_tpu_torch.io.serialization import save_map

        dbs = {"point": self.database}
        if self.junction_database is not None:
            dbs["junction"] = self.junction_database
        save_map(self.map, path, databases=dbs)
