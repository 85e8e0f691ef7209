"""Relocalization pipeline: a monocular query against a refined map.

Port of ``airslam_tpu/pipelines/map_user.py`` (which replaces
``src/map_user.cc``): detect (PLNet points, lines and junctions) → point and
junction BoW → shared-word filter (≥ max(0.3·max, 8)) → covisibility groups
(group score = the top-5 member scores) → junction structure-graph re-rank
(score += junction_score·(1 + line-preserving match rate)) → one batched
matcher pass against the top-3 groups → PnP → projection recovery → optional
pose-only refinement → matcher recovery; success iff the inliers reach
``min_inlier_num`` (45).

The retrieval, grouping and match bookkeeping are host code in numpy and
Python containers, as in the JAX package; candidate and group order come
from dict insertion order and Python's stable ``sorted``, as there. The
detector and the matcher run on their device; the pose-only refinement is
the F = 1 problem of ``windows.pose_only_optimization`` on the map's device
(kernel P on the card). The PnP is OpenCV's RANSAC on the host, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.loopclosure.database import Database
from airslam_tpu_torch.pipelines.map_builder import _as_np_features
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.map import Map


def junction_connections(junctions_xy, junc_mask, lines, line_mask, radius: float = 2.0):
    """Junction graph from line endpoints: junction j connects to k iff some
    line's endpoints fall within a (2r+1)² window of each
    (``Frame::FindJunctionConnections``, frame.cc:581-629). Returns
    list[set[int]] per junction."""
    conns = [set() for _ in range(len(junctions_xy))]
    valid_j = np.nonzero(junc_mask)[0]
    if len(valid_j) == 0:
        return conns
    jxy = junctions_xy[valid_j]
    for li in np.nonzero(line_mask)[0]:
        x1, y1, x2, y2 = lines[li]
        e1 = valid_j[np.max(np.abs(jxy - [x1, y1]), axis=1) <= radius]
        e2 = valid_j[np.max(np.abs(jxy - [x2, y2]), axis=1) <= radius]
        for a in e1:
            for b in e2:
                if a != b:
                    conns[a].add(int(b))
                    conns[b].add(int(a))
    return conns


class MapUser:
    def __init__(self, m: Map, detector, matcher, point_db: Database,
                 junction_db: Optional[Database], min_inlier_num: int = 45,
                 pose_refinement: bool = False, match_threshold=None,
                 projection_recovery: bool = True):
        self.map = m
        self.detector = detector
        self.matcher = matcher
        self.database = point_db
        self.junction_database = junction_db
        self.min_inlier_num = min_inlier_num
        self.pose_refinement = pose_refinement
        self.match_threshold = match_threshold
        # after a PnP pose, recover extra matches by projecting the loop
        # group's mappoints into the query (SearchByProjection semantics,
        # map.cc:945-998; the refiner's recovery through the loop group,
        # map_refiner.cc:237-460)
        self.projection_recovery = projection_recovery
        # perfect-recall retrieval for envelope attribution: every keyframe
        # is a candidate, so the recall measured is the matching ceiling
        self.oracle_retrieval = False
        # wide-baseline bootstrap: with recovery on, a candidate whose raw
        # match count is below min_inlier_num can still seed PnP; acceptance
        # keeps the min_inlier_num gate (the reference gates the attempt
        # itself at min_inlier_num, map_user.cc:377-383)
        self.bootstrap_min = (max(12, min_inlier_num // 3)
                              if projection_recovery else min_inlier_num)
        # stage diagnostics of the last relocalize_frame call: candidate
        # counts and the per-attempt pair / PnP / recovery numbers
        self.last_stats: dict = {}
        self._frame_counter = 10_000_000
        self._kf_junc_conns: Dict[int, list] = {
            fid: junction_connections(m.keyframes[fid].junctions, m.keyframes[fid].junc_mask,
                                      m.keyframes[fid].lines, m.keyframes[fid].line_mask)
            for fid in m.keyframe_ids}

    # ------------------------------------------------------------------

    def relocalize_image(self, image):
        """image: (H, W) grayscale in [0, 1]; the map camera's rectify grids
        are applied when it has them (a map loaded from a file keeps
        intrinsics only, so its queries are not remapped, as in the JAX
        package). Returns (ok, Twc)."""
        if self.detector is None:
            raise RuntimeError("detector required for image queries")
        dev = self.detector.device
        image = torch.as_tensor(image).to(dev, torch.float32)
        ml, _ = self.map.camera.rectify_maps(device=dev)
        if ml is not None:
            from airslam_tpu_torch.ops.remap import remap

            image = remap(image.contiguous(), ml)
        feats = self.detector.detect(image[None], detect_junctions=True)
        f0 = _as_np_features(type(feats)(*(t[0] for t in feats)))
        frame = Frame(self._frame_counter, 0.0, f0, self.map.camera)
        self._frame_counter += 1
        return self.relocalize_frame(frame)

    def _match(self, cands):
        """The matcher over (frame, keyframe) pairs: one batched pass when the
        matcher has one."""
        if hasattr(self.matcher, "matching_points_batched"):
            return self.matcher.matching_points_batched(
                cands, outlier_rejection=True, threshold=self.match_threshold)
        return [self.matcher.matching_points(a, b, outlier_rejection=True,
                                             threshold=self.match_threshold)
                for a, b in cands]

    def relocalize_frame(self, frame: Frame):
        """Core entry taking a built Frame (also the test surface)."""
        vec, wids, _ = self.database.frame_to_bow(frame.kp_desc, frame.kp_mask)
        jvec = {}
        jwids = np.full(len(frame.junc_mask), -1)
        if self.junction_database is not None and frame.junc_mask.any():
            jvec, jwids, _ = self.junction_database.frame_to_bow(frame.junc_desc,
                                                                 frame.junc_mask)

        self.last_stats = {"n_candidates": 0, "n_groups": 0, "pair_counts": [], "attempts": []}
        counts = self.database.query(vec)
        if self.oracle_retrieval:
            cands = {f: counts.get(f, 0) for f in self.map.keyframe_ids}
        else:
            if not counts:
                return False, np.eye(4)
            thr = max(int(max(counts.values()) * 0.3), 8)
            cands = {f: c for f, c in counts.items() if c >= thr}
            # joint point + junction retrieval: frames that clear the
            # junction-sharing gate join even when they miss the point gate
            # (extends map_user.cc:148-179, which queries points only)
            if self.junction_database is not None and jvec:
                jcounts = self.junction_database.query(jvec)
                if jcounts:
                    jthr = max(int(max(jcounts.values()) * 0.5), 4)
                    for f, c in jcounts.items():
                        if c >= jthr and f not in cands:
                            cands[f] = counts.get(f, 0)
        if not cands:
            return False, np.eye(4)

        cand_ids = list(cands)
        scores = dict(zip(cand_ids, self.database.batched_scores(vec, cand_ids)))

        # grouping (map_user.cc:180-242); group score = the top-5 member
        # scores; members are every covisible keyframe, scored or not
        groups: Dict[int, dict] = {}
        for f, s in scores.items():
            deputy, dscore = f, s
            members = {f}
            for cf in self.map.covisible_frames(f, min_shared=11):
                members.add(cf)
                if cf in scores and scores[cf] > dscore:
                    deputy, dscore = cf, scores[cf]
            gscore = sum(sorted((scores.get(m, 0.0) for m in members), reverse=True)[:5])
            if deputy not in groups or groups[deputy]["score"] < gscore:
                groups[deputy] = dict(score=gscore, members=members)

        # the junction structure-graph re-rank (map_user.cc:285-349), before
        # the survivor pruning
        if self.junction_database is not None and frame.junc_mask.any():
            q_conns = junction_connections(frame.junctions, frame.junc_mask, frame.lines,
                                           frame.line_mask)
            for deputy, g in groups.items():
                g["score"] += self._junction_score(deputy, jvec, jwids, q_conns)

        best_score = max(g["score"] for g in groups.values())
        if len(groups) > 3 and not self.oracle_retrieval:
            groups = {d: g for d, g in groups.items() if g["score"] >= 0.5 * best_score}

        ordered = sorted(groups.items(), key=lambda kv: -kv[1]["score"])
        if not self.oracle_retrieval:
            ordered = ordered[:3]  # the top-3 groups (map_user.cc:242)

        # the top-3 candidates in ONE batched pass (map_user.cc:360-376)
        results = self._match([(frame, self.map.keyframes[d]) for d, _ in ordered])
        # attempt candidates best-match-count first, falling through to the
        # next when PnP or the refinement fails
        order = sorted(range(len(results)), key=lambda i: -len(results[i][0]))
        self.last_stats = stats = {
            "n_candidates": len(counts),
            "n_groups": len(groups),
            "pair_counts": [len(results[bi][0]) for bi in order],
            "attempts": [],
        }
        last_Twc = np.eye(4)
        for bi in order:
            pairs = results[bi][0]
            if len(pairs) < self.bootstrap_min:
                break  # sorted: nothing later can pass either
            loop_kf = self.map.keyframes[ordered[bi][0]]
            group_fids = groups[ordered[bi][0]]["members"]
            matched = {}
            for qi, li in pairs:
                mpt = self.map.mappoints.get(int(loop_kf.track_ids[li]))
                if mpt is not None and mpt.is_valid:
                    matched[int(qi)] = mpt

            att = {"pairs": len(pairs), "seed_matched": len(matched)}
            stats["attempts"].append(att)
            ok, Twc, n_inliers = self._solve_pnp(frame, matched)
            att["pnp_ok"], att["pnp_inliers"] = ok, n_inliers
            if not ok:
                continue

            if self.projection_recovery:
                # two rounds: the pose of round 1 projects more accurately;
                # a bootstrap seed's coarser pose searches wider first
                for ri in range(2):
                    radius = 20.0 if (ri == 0 and len(matched) < self.min_inlier_num) else 15.0
                    extra = self._recover_matches(frame, Twc, loop_kf, matched, radius=radius,
                                                  extra_fids=group_fids)
                    if not extra:
                        break
                    matched.update(extra)
                    ok2, Twc2, n2 = self._solve_pnp(frame, matched)
                    if ok2 and n2 >= n_inliers:
                        Twc, n_inliers = Twc2, n2
                    else:
                        break
                att["recovered_matched"] = len(matched)
                att["recovered_inliers"] = n_inliers

            frame.set_pose(Twc)
            last_Twc = Twc

            if self.pose_refinement:
                if len(matched) < max(10, self.bootstrap_min):
                    continue
                Twc, n_inliers = self._refine_pose(frame, matched)
                last_Twc = Twc
                if self.projection_recovery and n_inliers < self.min_inlier_num:
                    # one recovery round at the refined pose, then refine again
                    extra = self._recover_matches(frame, Twc, loop_kf, matched,
                                                  extra_fids=group_fids)
                    if extra:
                        matched.update(extra)
                        frame.set_pose(Twc)
                        Twc, n_inliers = self._refine_pose(frame, matched)
                        last_Twc = Twc

            if (self.pose_refinement and self.projection_recovery
                    and self.bootstrap_min <= n_inliers < self.min_inlier_num):
                # a marginal wide-baseline query: the learned matcher against
                # the loop group's members in one batched pass, the new
                # mappoint matches unioned; acceptance is unchanged
                extra = self._matcher_recovery(frame, Twc, loop_kf, group_fids, matched)
                att["matcher_recovered"] = len(extra)
                if extra:
                    matched.update(extra)
                    ok3, Twc3, n3 = self._solve_pnp(frame, matched)
                    if ok3:
                        # re-anchor on the RANSAC pose, one projection round,
                        # refine again
                        more = self._recover_matches(frame, Twc3, loop_kf, matched,
                                                     extra_fids=group_fids)
                        matched.update(more)
                        frame.set_pose(Twc3)
                        Twc4, n4 = self._refine_pose(frame, matched)
                        if n4 > n_inliers:
                            Twc, n_inliers = Twc4, n4
                            last_Twc = Twc

            att["final_inliers"] = n_inliers
            if n_inliers >= self.min_inlier_num:
                att["accepted"] = True
                return True, Twc
        return False, last_Twc

    # ------------------------------------------------------------------

    def _junction_score(self, kf_id: int, jvec: dict, jwids, q_conns):
        """score = junction L1 score × (1 + line-preserving match rate)."""
        kf = self.map.keyframes[kf_id]
        if kf.junction_bow_vector is None:
            return 0.0
        jscore = self.junction_database.score(kf.junction_bow_vector, jvec)

        inv = self.junction_database.inverted_file
        kf_conns = self._kf_junc_conns.get(kf_id, [])
        nq, nk = len(jwids), len(kf_conns)

        # M[i, j]: query junction i and keyframe junction j share a word;
        # Cq / Ck: junctions joined by a detected line. The reference's
        # quadruple loop (map_user.cc:285-349) counts, per match (i, j), the
        # partner matches (a, b) with a~i, b~j and M[a, b]: Σ M ⊙ (Cq M Ckᵀ)
        M = np.zeros((nq, max(nk, 1)), bool)
        for i, wid in enumerate(jwids):
            if wid < 0:
                continue
            for j in inv.get(int(wid), {}).get(kf_id, ()):
                if j < nk:
                    M[i, j] = True
        if not M.any():
            return jscore

        Cq = np.zeros((nq, nq), bool)
        for i, conns in enumerate(q_conns):
            for a in conns:
                if a < nq:
                    Cq[i, a] = True
        Ck = np.zeros((max(nk, 1), max(nk, 1)), bool)
        for j, conns in enumerate(kf_conns):
            for b in conns:
                if b < nk:
                    Ck[j, b] = True

        has_q = np.asarray([bool(c) for c in q_conns] + [False] * (nq - len(q_conns)))
        match_num = int(M[has_q[:nq]].sum())
        Mi = M.astype(np.int32)
        line_match_num = int(((Cq.astype(np.int32) @ Mi @ Ck.T.astype(np.int32)) * Mi).sum())
        rate = line_match_num / match_num if match_num > 0 else 0.0
        return jscore * (1.0 + rate)

    def _matcher_recovery(self, frame, Twc, loop_kf, group_fids, matched, k: int = 8):
        """Learned-matcher recovery through the loop group: the matcher of
        the query against up to ``k`` member or covisible keyframes, the
        nearest views under the current pose first, in ONE batched pass.
        Returns NEW {query keypoint index: Mappoint} matches (the analogue of
        the reference's inverted-file recovery, map_refiner.cc:237-460)."""
        pool = set(group_fids) | set(self.map.covisible_frames(loop_kf.frame_id, min_shared=11))
        pool.discard(loop_kf.frame_id)
        kfs = [self.map.keyframes[f] for f in pool if f in self.map.keyframes]
        if not kfs:
            return {}
        c, z = Twc[:3, 3], Twc[:3, 2]
        kfs.sort(key=lambda kf: float(np.linalg.norm(kf.Twc[:3, 3] - c) - kf.Twc[:3, 2] @ z))
        kfs = kfs[:k]
        results = self._match([(frame, kf) for kf in kfs])
        matched_tids = {id(m) for m in matched.values()}
        out, best = {}, {}
        for kf, (pairs, scores) in zip(kfs, results):
            if scores is None or len(scores) != len(pairs):
                scores = np.ones(len(pairs))
            for (qi, li), sc in zip(pairs, scores):
                qi = int(qi)
                if qi in matched:
                    continue
                mpt = self.map.mappoints.get(int(kf.track_ids[li]))
                if mpt is None or not mpt.is_valid or id(mpt) in matched_tids:
                    continue
                if qi not in best or best[qi] < sc:
                    best[qi] = float(sc)
                    out[qi] = mpt
        return out

    def _recover_matches(self, frame, Twc, loop_kf, matched, radius: float = 15.0,
                         dist_thr: float = 0.35, ratio: float = 0.85, extra_fids=()):
        """Project the loop group's mappoints through the pose and claim the
        unmatched query keypoints near their projections. Descriptor gates
        of ``Map::SearchByProjection`` (map.cc:977-994): best 1−dot distance
        < ``dist_thr`` and < ``ratio``·second best, radius 15 px. A mappoint
        without a descriptor takes its observing keyframe's. Returns
        {query keypoint index: Mappoint} of NEW matches only."""
        cam = self.map.camera
        Rwc = Twc[:3, :3]
        twc = Twc[:3, 3]

        matched_tids = {id(m) for m in matched.values()}
        cand_pos, cand_desc, cand_mpt = [], [], []
        fids = [loop_kf.frame_id] + list(self.map.covisible_frames(loop_kf.frame_id,
                                                                   min_shared=11))
        # the retrieval group's members widen the projection pool
        fids += [f for f in extra_fids if f not in fids]
        seen = set()
        for fid in fids:
            kf = self.map.keyframes.get(fid)
            if kf is None:
                continue
            for idx, tid in enumerate(kf.track_ids):
                tid = int(tid)
                if tid < 0 or tid in seen:
                    continue
                seen.add(tid)
                mpt = self.map.mappoints.get(tid)
                if mpt is None or not mpt.is_valid or id(mpt) in matched_tids:
                    continue
                desc = mpt.descriptor
                if desc is None:
                    desc = kf.kp_desc[idx]
                cand_pos.append(mpt.position)
                cand_desc.append(np.asarray(desc, np.float32))
                cand_mpt.append(mpt)
        if not cand_mpt:
            return {}

        pc = (np.asarray(cand_pos) - twc) @ Rwc  # Rcw (pw − twc)
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = pc[:, 0] / z * cam.fx + cam.cx
            v = pc[:, 1] / z * cam.fy + cam.cy
        w = getattr(cam, "image_width", getattr(cam, "width", 752))
        h = getattr(cam, "image_height", getattr(cam, "height", 480))
        vis = (z > 0.2) & (u > 0) & (u < w) & (v > 0) & (v < h)
        if not vis.any():
            return {}

        free = [i for i in range(len(frame.keypoints)) if frame.kp_mask[i] and i not in matched]
        if not free:
            return {}
        kp = np.asarray([frame.keypoints[i] for i in free])
        kdesc = np.stack([np.asarray(frame.kp_desc[i], np.float32) for i in free])

        uv = np.stack([u, v], -1)[vis]
        mdesc = np.stack(cand_desc)[vis]
        mpts = [m for m, ok in zip(cand_mpt, vis) if ok]

        d2 = ((uv[:, None, :] - kp[None, :, :]) ** 2).sum(-1)  # (M, Q)
        dist = np.where(d2 <= radius * radius, 1.0 - mdesc @ kdesc.T, 4.0)  # utils.cc:15

        order = np.argsort(dist, axis=1)
        best_q = order[:, 0]
        best = dist[np.arange(len(mpts)), best_q]
        second = (dist[np.arange(len(mpts)), order[:, 1]] if dist.shape[1] > 1
                  else np.full(len(mpts), 4.0))
        accept = (best < dist_thr) & (best < ratio * second)

        out, claimed = {}, {}
        for mi in np.nonzero(accept)[0]:
            qi = free[int(best_q[mi])]
            if qi in claimed and claimed[qi] <= best[mi]:
                continue
            claimed[qi] = best[mi]
            out[qi] = mpts[mi]
        return out

    def _solve_pnp(self, frame, matched):
        """OpenCV's RANSAC PnP on the host (100 iterations, 20 px, 0.99).
        Returns (ok, Twc, n_inliers)."""
        if len(matched) < 8:
            return False, np.eye(4), 0
        import cv2

        cam = self.map.camera
        obj = np.asarray([m.position for m in matched.values()], np.float64)
        img = np.asarray([frame.keypoints[i] for i in matched], np.float64)
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
        try:
            ok, rvec, tvec, inl = cv2.solvePnPRansac(
                obj, img, K, np.zeros(5), iterationsCount=100, reprojectionError=20.0,
                confidence=0.99)
        except cv2.error:
            return False, np.eye(4), 0
        if not ok:
            return False, np.eye(4), 0
        Rcw, _ = cv2.Rodrigues(rvec)
        Twc = np.eye(4)
        Twc[:3, :3] = Rcw.T
        Twc[:3, 3] = -Rcw.T @ tvec[:, 0]
        return True, Twc, 0 if inl is None else len(inl)

    def _refine_pose(self, frame, matched):
        """Pose-only optimization against the matched mappoints: the F = 1
        problem, points padded to max(64, 2^k) with one masked line (kernel P
        on a CUDA map). Returns (Twc, n_inliers)."""
        p = len(matched)
        P = max(64, 1 << (p - 1).bit_length())
        points = np.zeros((P, 3))
        obs = np.zeros((P, 1, 3))
        obs[..., 2] = -1.0
        mask = np.zeros((P, 1), bool)
        for j, (qi, mpt) in enumerate(matched.items()):
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
        out, _, _, n_in = windows.pose_only_optimization(problem, m._intr, m.ba_config)
        Twb_new = np.eye(4)
        Twb_new[:3, :3] = out.frames.Rwb[0].double().cpu().numpy()
        Twb_new[:3, 3] = out.frames.twb[0].double().cpu().numpy()
        return Twb_new @ np.linalg.inv(Tcb), int(n_in)
