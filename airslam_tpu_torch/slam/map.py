"""Map: keyframe/landmark registries and optimization orchestration.

Port of the VO part of ``airslam_tpu/slam/map.py`` (which replaces
``src/map.cc``): keyframe insertion creates/extends landmarks and triangulates
(map.cc:30-120), sliding-window local BA over the last 5 keyframes plus their
fixed observers, with IMU factors once the IMU is initialized (map.cc:556-849),
landmark lifecycle and outlier write-back (map.cc:859-943), mapline endpoint
maintenance (map.cc:192-340), the covisibility graph (map.cc:1385-1425), the
keyframe trajectory (map.cc:1000-1008), the IMU initialization with the
gravity alignment of the whole map (map.cc:1046-1209) and keyframe deletion.

The window optimization is built as a dense (landmark × frame) ``BAProblem``
padded to shape buckets, so every local BA runs the same few shapes. The
registries are host-side (numpy), as in the JAX package; the triangulations,
the BA and the IMU initialization's solves run on the map's device in its
dtype, and each pulls its result to the host once. The preintegration
information matrices are inverted on the host in numpy, from the state's
values, as the JAX package does.

The map refinement's part (stage 2) is here too: the global BA over every
keyframe (the dense window program up to ``DENSE_BA_MAX_FRAMES`` keyframes,
the sparse observation-list solver of ``backend/global_ba.py`` past it), the
pose-graph corrections, the whole covisibility rebuild, single-landmark
triangulation, the representative descriptor, the text export and the map
scale. Relocalization's (stage 3) projection search ``search_by_projection``
is here as well.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.backend import gn, triangulate, windows
from airslam_tpu_torch.core import lie
from airslam_tpu_torch.frontend.lines import endpoint_trim_rows_np
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.landmarks import LandmarkType, Mapline, Mappoint
from airslam_tpu_torch.utils.timing import span

WINDOW_SIZE = 5  # map.cc:576 MaxFrameNumber
MAX_FIXED_FRAMES = 10  # static cap on fixed observer frames (ref: unbounded)

def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _pow2_bucket(n: int, lo: int = 8) -> int:
    """Power-of-two pad: bounds the number of distinct shapes to log2(max)."""
    b = lo
    while b < n:
        b *= 2
    return b


def triangulate_stereo_lines_frame(frame, intr, min_x_diff, max_x_diff,
                                   device="cpu", dtype=torch.float32):
    """Every stereo line triangulation of a frame in ONE fixed-shape call
    (line_processor.cc:196-245 runs per line). Returns (endpoints_w (L, 6),
    ok (L,)) as tensors on ``device``."""
    from airslam_tpu_torch.frontend.lines import triangulate_stereo_lines

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return triangulate_stereo_lines(
        t(frame.lines), t(frame.lines_right),
        torch.as_tensor(frame.lines_right_valid, device=device),
        t(frame.Twc[:3, :3]), t(frame.Twc[:3, 3]), intr, min_x_diff, max_x_diff)


def preintegration_information(cov):
    """(info9 (9, 9), walk (6, 6)) of a preintegration covariance (15, 15):
    the PSD-projected inverse of its 9×9 block and the inverses of the two
    bias random-walk blocks, computed on the host in numpy from the
    covariance's values (its dtype, promoted by the float64 regularizer), as
    the JAX package does (map.py:507-517, map_builder.py:566-572)."""
    cov = cov.cpu().numpy() if torch.is_tensor(cov) else np.asarray(cov)
    info9 = np.linalg.inv(cov[:9, :9] + 1e-12 * np.eye(9))
    info9 = 0.5 * (info9 + info9.T)
    w, v = np.linalg.eigh(info9)
    info9 = v @ np.diag(np.clip(w, 0, None)) @ v.T  # PSD projection
    walk = np.zeros((6, 6))
    walk[:3, :3] = np.linalg.inv(cov[9:12, 9:12] + 1e-12 * np.eye(3))
    walk[3:, 3:] = np.linalg.inv(cov[12:15, 12:15] + 1e-12 * np.eye(3))
    return info9, walk


class Map:
    """``device``: where the map's tensor work runs (``cuda`` unless the
    caller passes another); ``dtype``: its float type."""

    def __init__(self, camera, ba_config: Optional[gn.BAConfig] = None, device=None,
                 dtype=torch.float32):
        self.camera = camera
        self.device = resolve_device(device)
        self.dtype = dtype
        self.keyframes: Dict[int, Frame] = {}
        self.keyframe_ids: List[int] = []
        self.mappoints: Dict[int, Mappoint] = {}
        self.maplines: Dict[int, Mapline] = {}
        self.covisibility: Dict[int, Dict[int, int]] = {}
        self.ba_config = ba_config or gn.BAConfig()
        # opt-in early-exit LM for local BA (YAML optimization.early_exit;
        # 0.0 = reference-parity fixed iteration schedule)
        self.ba_early_exit = 0.0
        self.imu_initialized = False
        self.Rwg = np.eye(3)
        self._imu_init_frame: Optional[Frame] = None
        self.on_local_ba = None  # optional callback(frame) for observability

        self.g_value = float(getattr(camera, "g_value", 9.81))
        self._intr = camera.intrinsics() if hasattr(camera, "intrinsics") else camera

    # ------------------------------------------------------------------
    # keyframe insertion (map.cc:30-120)
    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: Frame):
        with span("insert_keyframe"):
            self._insert_keyframe(frame)

    def _insert_keyframe(self, frame: Frame):
        fid = frame.frame_id
        self.keyframes[fid] = frame
        self.keyframe_ids.append(fid)

        Rwc = frame.Twc[:3, :3]
        twc = frame.Twc[:3, 3]

        # points — back-projections vectorized (map.cc:45-72 runs per point)
        idxs = np.nonzero(frame.kp_mask & (frame.track_ids >= 0))[0]
        depths = frame.depth[idxs]
        xn = (frame.keypoints[idxs, 0] - self.camera.cx) / self.camera.fx
        yn = (frame.keypoints[idxs, 1] - self.camera.cy) / self.camera.fy
        pts_c = np.stack([xn, yn, np.ones_like(xn)], axis=-1) * depths[:, None]
        pts_w = pts_c @ Rwc.T + twc
        need_triangulation = []
        for j, i in enumerate(idxs):
            tid = int(frame.track_ids[i])
            mpt = self.mappoints.get(tid)
            if mpt is None:
                mpt = Mappoint(tid, descriptor=frame.kp_desc[i].copy())
                if depths[j] > 0:
                    mpt.set_position(pts_w[j])
                self.mappoints[tid] = mpt
            frame.mappoint_ids[i] = tid
            mpt.add_observer(fid, int(i))
            if mpt.type == LandmarkType.UNTRIANGULATED and len(mpt.observers) > 2:
                need_triangulation.append(mpt)
        if need_triangulation:
            self.triangulate_mappoints_batch(need_triangulation)

        # lines — stereo triangulation for the WHOLE frame in one call
        line_ids = np.nonzero(frame.line_mask)[0]
        stereo_ends, stereo_ok = None, None
        if len(line_ids) and frame.lines_right_valid.any():
            with span("triangulate"):
                ends_all, ok_all = triangulate_stereo_lines_frame(
                    frame, self._intr, self.camera.min_x_diff, self.camera.max_x_diff,
                    self.device, self.dtype)
                stereo_ends = ends_all.double().cpu().numpy()
                stereo_ok = ok_all.cpu().numpy()
        need_line_triangulation = []
        for i in line_ids:
            ltid = int(frame.line_track_ids[i])
            if ltid < 0:
                continue
            mpl = self.maplines.get(ltid)
            if mpl is None:
                mpl = Mapline(ltid)
                if stereo_ok is not None and stereo_ok[i]:
                    mpl.set_endpoints(stereo_ends[i])
                    mpl.endpoint_status[fid] = 1
                self.maplines[ltid] = mpl
            frame.mapline_ids[i] = ltid
            mpl.add_observer(fid, int(i))
            mpl.endpoint_status.setdefault(fid, 0)
            if mpl.type == LandmarkType.UNTRIANGULATED and len(mpl.observers) >= 2:
                need_line_triangulation.append(mpl)
        if need_line_triangulation:
            self.triangulate_maplines_by_mappoints_batch(need_line_triangulation)

        self._update_covisibility(frame)

        if len(self.keyframes) < 2:
            self._imu_init_frame = frame
        else:
            self.local_map_optimization(frame)
            if not self.imu_initialized and getattr(self.camera, "use_imu", False):
                self.initialize_imu(frame)

    # ------------------------------------------------------------------
    # triangulation
    # ------------------------------------------------------------------

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    def triangulate_mappoint(self, mpt: Mappoint) -> bool:
        return self.triangulate_mappoints_batch([mpt]) > 0

    def triangulate_mappoints_batch(self, mpts, max_obs: int = 8) -> int:
        """Triangulate many mappoints in ONE call: observations padded to
        (B_bucket, max_obs) grids, batched midpoint solve (a per-landmark call,
        the naive port of Map::TriangulateMappoint, costs a device round trip
        each). Returns #successfully triangulated."""
        cands = []
        for mpt in mpts:
            obs = [(f, i) for f, i in mpt.observers.items() if f in self.keyframes]
            if len(obs) >= 2:
                cands.append((mpt, obs[:max_obs]))
        if not cands:
            return 0
        B = _bucket(len(cands), 32)
        Rcw = np.zeros((B, max_obs, 3, 3))
        Rcw[:] = np.eye(3)
        tcw = np.zeros((B, max_obs, 3))
        uv = np.zeros((B, max_obs, 2))
        mask = np.zeros((B, max_obs), bool)
        for b, (mpt, obs) in enumerate(cands):
            for k, (fid, idx) in enumerate(obs):
                kf = self.keyframes[fid]
                Rwc = kf.Twc[:3, :3]
                Rcw[b, k] = Rwc.T
                tcw[b, k] = -Rwc.T @ kf.Twc[:3, 3]
                uv[b, k] = kf.keypoints[idx]
                mask[b, k] = True
        t = self._tensor
        with span("triangulate"):
            xs, oks = triangulate.triangulate_points_batch(
                t(Rcw), t(tcw), t(uv), torch.as_tensor(mask, device=self.device), self._intr)
            xs = xs.double().cpu().numpy()
            oks = oks.cpu().numpy()
        good = 0
        for b, (mpt, _) in enumerate(cands):
            if oks[b]:
                mpt.set_position(xs[b])
                good += 1
        return good

    def triangulate_mapline_by_mappoints(self, mpl: Mapline) -> bool:
        """Robust 3D line from the mappoints lying on the observed 2D lines
        (map.cc:416-504)."""
        return self.triangulate_maplines_by_mappoints_batch([mpl]) > 0

    def triangulate_maplines_by_mappoints_batch(self, mpls, max_pts: int = 64) -> int:
        """Fit many maplines from their supporting mappoints in ONE batched
        call (map.cc:416-504 runs per line). The point gather stays in numpy;
        the (B, max_pts, 3) grid is power-of-two bucketed, and a line keeps at
        most its first ``max_pts`` supporting points. Returns #successfully
        fit."""
        cands = []
        for mpl in mpls:
            pts = []
            for fid, lidx in mpl.observers.items():
                kf = self.keyframes.get(fid)
                if kf is None:
                    continue
                for pidx in np.nonzero(kf.points_on_lines[lidx])[0]:
                    tid = int(kf.track_ids[pidx])
                    mpt = self.mappoints.get(tid)
                    if mpt is not None and mpt.is_valid:
                        pts.append(mpt.position)
            if len(pts) >= 2:
                cands.append((mpl, pts[:max_pts]))
        if not cands:
            return 0
        B = _pow2_bucket(len(cands))
        buf = np.zeros((B, max_pts, 3))
        mask = np.zeros((B, max_pts), bool)
        for b, (_, pts) in enumerate(cands):
            buf[b, : len(pts)] = pts
            mask[b, : len(pts)] = True
        with span("triangulate"):
            ends, oks = triangulate.fit_lines_batch(
                self._tensor(buf), torch.as_tensor(mask, device=self.device))
            ends, oks = ends.double().cpu().numpy(), oks.cpu().numpy()
        good = 0
        for b, (mpl, _) in enumerate(cands):
            if oks[b]:
                mpl.set_endpoints(ends[b])
                good += 1
        return good

    def update_mapline_endpoints(self, mpl: Mapline):
        """Refresh one line's endpoints after BA moved it (map.cc:192-340)."""
        self.update_maplines_endpoints_batch([mpl])

    def update_maplines_endpoints_batch(self, mpls):
        """Endpoint maintenance after BA moved the infinite lines
        (map.cc:192-340), for MANY maplines in one vectorized numpy pass on
        the host: each observation's 2D endpoints are projected onto its 3D
        line (one flattened (line, observer) row batch) and the extreme pair
        per line is kept (segment min/max)."""
        rows_obs, rows_Twc, rows_seg = [], [], []
        live = []
        for mpl in mpls:
            if mpl.type != LandmarkType.GOOD:
                continue
            s = len(live)
            any_obs = False
            for fid, lidx in mpl.observers.items():
                kf = self.keyframes.get(fid)
                if kf is None:
                    continue
                rows_obs.append(kf.lines[lidx])
                rows_Twc.append(kf.Twc)
                rows_seg.append(s)
                any_obs = True
            if any_obs:
                live.append(mpl)
            # else: segment s unused; the next live line reuses it
        if not live:
            return
        seg = np.asarray(rows_seg)
        Twc = np.asarray(rows_Twc, np.float64)  # (M, 4, 4)
        Rcw = np.swapaxes(Twc[:, :3, :3], -1, -2)
        tcw = -np.einsum("nij,nj->ni", Rcw, Twc[:, :3, 3])

        lines = np.asarray([m.line3d for m in live], np.float64)  # (S, 6)
        w3, d3 = lines[:, 0:3], lines[:, 3:6]
        nd = np.clip(np.linalg.norm(d3, axis=-1, keepdims=True), 1e-12, None)
        dvec = d3 / nd
        p0 = np.cross(dvec, w3 / nd)  # (S, 3)

        ends = endpoint_trim_rows_np(
            p0[seg], dvec[seg], np.asarray(rows_obs, np.float64), Rcw, tcw,
            float(self.camera.fx), float(self.camera.fy),
            float(self.camera.cx), float(self.camera.cy),
        )  # (M, 6)
        pts = np.concatenate([ends[:, 0:3], ends[:, 3:6]], axis=0)  # (2M, 3)
        seg2 = np.concatenate([seg, seg])
        t = np.einsum("ni,ni->n", pts - p0[seg2], dvec[seg2])
        S = len(live)
        t_min = np.full(S, np.inf)
        t_max = np.full(S, -np.inf)
        np.minimum.at(t_min, seg2, t)
        np.maximum.at(t_max, seg2, t)
        for s, mpl in enumerate(live):
            mpl.endpoints = np.concatenate(
                [p0[s] + t_min[s] * dvec[s], p0[s] + t_max[s] * dvec[s]])
            mpl.endpoints_valid = True
            mpl.to_update_endpoints = False

    # ------------------------------------------------------------------
    # local BA (map.cc:556-849)
    # ------------------------------------------------------------------

    def _window_frames(self, new_frame: Frame):
        frames = [new_frame]
        f = new_frame
        while len(frames) < min(WINDOW_SIZE, len(self.keyframes)):
            f = f.previous_frame
            if f is None:
                break
            frames.append(f)
        return frames

    def local_map_optimization(self, new_frame: Frame):
        with span("local_map.build"):
            window = self._window_frames(new_frame)
            window_ids = {f.frame_id for f in window}
            first_kf_id = self.keyframe_ids[0]

            # landmarks observed by the window
            mpts: List[Mappoint] = []
            mpls: List[Mapline] = []
            fixed_votes: Dict[int, int] = {}
            seen_p, seen_l = set(), set()
            for f in window:
                for tid in f.mappoint_ids[f.mappoint_ids >= 0]:
                    mpt = self.mappoints.get(int(tid))
                    if mpt is None or not mpt.is_valid or int(tid) in seen_p:
                        continue
                    seen_p.add(int(tid))
                    mpts.append(mpt)
                    for ofid in mpt.observers:
                        if ofid not in window_ids and ofid in self.keyframes:
                            fixed_votes[ofid] = fixed_votes.get(ofid, 0) + 1
                for ltid in f.mapline_ids[f.mapline_ids >= 0]:
                    mpl = self.maplines.get(int(ltid))
                    if mpl is None or not mpl.is_valid or int(ltid) in seen_l:
                        continue
                    seen_l.add(int(ltid))
                    mpls.append(mpl)
                    for ofid in mpl.observers:
                        if ofid not in window_ids and ofid in self.keyframes:
                            fixed_votes[ofid] = fixed_votes.get(ofid, 0) + 1

            fixed_ids = [fid for fid, _ in sorted(fixed_votes.items(), key=lambda kv: -kv[1])]
            fixed_ids = fixed_ids[:MAX_FIXED_FRAMES]
            all_frames = window + [self.keyframes[fid] for fid in fixed_ids]

            pose_fixed = np.zeros(len(all_frames), bool)
            for k, f in enumerate(all_frames):
                # oldest window frame + first keyframe + observers are fixed
                if k >= len(window) or f.frame_id == first_kf_id or k == len(window) - 1:
                    pose_fixed[k] = True

            problem, layout = self._build_problem(
                all_frames, pose_fixed, mpts, mpls,
                pad_frames=WINDOW_SIZE + MAX_FIXED_FRAMES,
            )
        if problem is None:
            return
        with span("local_ba"):
            out, p_in, l_in = windows.local_ba(problem, self._intr, self.ba_config,
                                               early_exit=self.ba_early_exit)
        with span("local_map.write_back"):
            self._write_back(out, p_in, l_in, all_frames, pose_fixed, mpts, mpls, layout)
        if self.on_local_ba is not None:
            self.on_local_ba(new_frame)

    def _build_problem(self, frames, pose_fixed, mpts, mpls, pad_frames: int = 0):
        """Build the dense BAProblem on the map's device. ``pad_frames``: pad
        the frame dimension to this static size (identity dummy frames, fixed)
        so every local BA has ONE shape regardless of window/observer counts."""
        f_real = len(frames)
        f = max(pad_frames, f_real)
        p_real, l_real = len(mpts), len(mpls)
        if p_real == 0 and l_real == 0:
            return None, None
        P = _bucket(max(p_real, 1))
        L = _bucket(max(l_real, 1), 32)
        frame_index = {fr.frame_id: k for k, fr in enumerate(frames)}
        if f > f_real:
            pose_fixed = np.concatenate([pose_fixed, np.ones(f - f_real, bool)])

        # observation grids filled per FRAME with vectorized gathers
        point_obs = np.zeros((P, f, 3))
        point_obs[..., 2] = -1.0
        point_mask = np.zeros((P, f), bool)
        points = np.zeros((P, 3))
        row_of_tid = {mpt.id: j for j, mpt in enumerate(mpts)}
        for j, mpt in enumerate(mpts):
            points[j] = mpt.position
        for k, fr in enumerate(frames):
            ids = fr.mappoint_ids
            sel = np.nonzero(ids >= 0)[0]
            if len(sel) == 0:
                continue
            rows = np.asarray([row_of_tid.get(int(t), -1) for t in ids[sel]])
            ok = rows >= 0
            sel, rows = sel[ok], rows[ok]
            point_obs[rows, k, 0:2] = fr.keypoints[sel]
            point_obs[rows, k, 2] = fr.u_right[sel]
            point_mask[rows, k] = True

        line_obs = np.zeros((L, f, 8))
        line_mask = np.zeros((L, f), bool)
        line_stereo = np.zeros((L, f), bool)
        line_sigma = np.full((L, f), 0.001)
        lines = np.tile(np.array([1.0, 0, 0, 0, 1.0, 0]), (L, 1))
        lrow_of_tid = {mpl.id: j for j, mpl in enumerate(mpls)}
        for j, mpl in enumerate(mpls):
            lines[j] = mpl.line3d
            # pixel_sigma = 0.1 for well-observed lines, 0.001 otherwise
            # (map.cc:724)
            line_sigma[j] = 0.1 if len(mpl.observers) > 3 else 0.001
        for k, fr in enumerate(frames):
            ids = fr.mapline_ids
            sel = np.nonzero(ids >= 0)[0]
            if len(sel) == 0:
                continue
            rows = np.asarray([lrow_of_tid.get(int(t), -1) for t in ids[sel]])
            ok = rows >= 0
            sel, rows = sel[ok], rows[ok]
            line_obs[rows, k, 0:4] = fr.lines[sel]
            stereo = fr.lines_right_valid[sel]
            line_obs[rows[stereo], k, 4:8] = fr.lines_right[sel[stereo]]
            line_stereo[rows[stereo], k] = True
            line_mask[rows, k] = True

        Tcb = self.camera.Tcb if hasattr(self.camera, "Tcb") else np.eye(4)
        Rwb = np.tile(np.eye(3), (f, 1, 1))  # identity for padded frames
        twb = np.zeros((f, 3))
        vel = np.zeros((f, 3))
        bg = np.zeros((f, 3))
        ba = np.zeros((f, 3))
        for k, fr in enumerate(frames):
            Twb = fr.Twc @ Tcb  # Twb = Twc · Tcb
            Rwb[k] = Twb[:3, :3]
            twb[k] = Twb[:3, 3]
            vel[k] = fr.velocity
            bg[k] = fr.bg
            ba[k] = fr.ba

        point_fixed = np.zeros(P, bool)
        point_fixed[p_real:] = True
        line_fixed = np.zeros(L, bool)
        line_fixed[l_real:] = True

        t, dev = self._tensor, self.device

        def flag(a):
            return torch.as_tensor(a, device=dev)

        problem = gn.BAProblem(
            frames=gn.FrameStates(Rwb=t(Rwb), twb=t(twb), vel=t(vel), bg=t(bg), ba=t(ba)),
            pose_fixed=flag(pose_fixed),
            vel_fixed=flag(pose_fixed if self.imu_initialized else np.ones(f, bool)),
            points=t(points),
            point_fixed=flag(point_fixed),
            point_obs=t(point_obs),
            point_obs_mask=flag(point_mask),
            lines=t(lines),
            line_fixed=flag(line_fixed),
            line_obs=t(line_obs),
            line_obs_stereo=flag(line_stereo),
            line_obs_mask=flag(line_mask),
            line_obs_sigma=t(line_sigma),
            Rwg=t(self.Rwg),
            gravity_free=torch.zeros((), dtype=self.dtype, device=dev),
            imu=self._imu_factors(frames) if self.imu_initialized else None,
            Rcb=t(Tcb[:3, :3]),
            tcb=t(Tcb[:3, 3]),
            g_value=self.g_value,
        )
        return problem, (frame_index, p_real, l_real)

    def _imu_factors(self, frames):
        """Consecutive-window preintegration factors (when the IMU is
        running), or None. ``frames`` is newest-first: factor (k, k−1) runs
        from the older frame to the newer."""
        rows = []
        for k in range(len(frames) - 1, 0, -1):
            pre = frames[k - 1].preintegration
            if pre is None or not pre.valid():
                continue
            info9, walk = preintegration_information(pre.state.cov)
            rows.append((k, k - 1, pre, info9, walk))
        if not rows:
            return None
        dev = self.device

        def stack(key):
            return torch.stack([getattr(r[2].state, key) for r in rows]).to(self.dtype)

        return gn.IMUFactors(
            idx_i=torch.as_tensor([r[0] for r in rows], device=dev),
            idx_j=torch.as_tensor([r[1] for r in rows], device=dev),
            dR=stack("dR"), dV=stack("dV"), dP=stack("dP"),
            JRg=stack("JRg"), JVg=stack("JVg"), JVa=stack("JVa"),
            JPg=stack("JPg"), JPa=stack("JPa"), dT=stack("dT"),
            bg_lin=self._tensor(np.stack([r[2].bg for r in rows])),
            ba_lin=self._tensor(np.stack([r[2].ba for r in rows])),
            info=self._tensor(np.stack([r[3] for r in rows])),
            info_walk=self._tensor(np.stack([r[4] for r in rows])),
            mask=torch.ones(len(rows), dtype=torch.bool, device=dev),
        )

    def _write_back(self, out, p_in, l_in, frames, pose_fixed, mpts, mpls, layout):
        frame_index, p_real, l_real = layout
        Tcb = self.camera.Tcb if hasattr(self.camera, "Tcb") else np.eye(4)
        Tbc = np.linalg.inv(Tcb)
        # the whole state is pulled once: per-frame indexing of a device
        # tensor costs a transfer each
        Rwb, twb, vel, bg, ba, pts, lns = (a.double().cpu().numpy() for a in (
            *out.frames, out.points, out.lines))
        p_in, l_in = p_in.cpu().numpy(), l_in.cpu().numpy()
        for k, fr in enumerate(frames):
            if pose_fixed[k]:
                continue
            Twb = np.eye(4)
            Twb[:3, :3] = Rwb[k]
            Twb[:3, 3] = twb[k]
            fr.Twc = Twb @ Tbc
            if self.imu_initialized:
                fr.velocity = vel[k]
                fr.bg = bg[k]
                fr.ba = ba[k]

        for j, mpt in enumerate(mpts):
            mpt.set_position(pts[j])
            # outlier observation removal (map.cc:859-943)
            for fid in list(mpt.observers):
                k = frame_index.get(fid)
                if k is not None and not p_in[j, k]:
                    kf = self.keyframes.get(fid)
                    if kf is not None:
                        idx = mpt.observers[fid]
                        kf.mappoint_ids[idx] = -1
                        kf.track_ids[idx] = -1
                    mpt.remove_observer(fid)
            if len(mpt.observers) == 0:
                mpt.set_bad()

        refresh = []
        for j, mpl in enumerate(mpls):
            mpl.set_line3d(lns[j])
            for fid in list(mpl.observers):
                k = frame_index.get(fid)
                if k is not None and not l_in[j, k]:
                    kf = self.keyframes.get(fid)
                    if kf is not None:
                        idx = mpl.observers[fid]
                        kf.mapline_ids[idx] = -1
                        kf.line_track_ids[idx] = -1
                    mpl.remove_observer(fid)
            if len(mpl.observers) == 0:
                mpl.set_bad()
            else:
                refresh.append(mpl)
        self.update_maplines_endpoints_batch(refresh)

    # ------------------------------------------------------------------
    # global BA (g2o_optimization.cc:1488-1959)
    # ------------------------------------------------------------------

    # beyond this many keyframes the dense (P, F) grid formulation gives way
    # to the sparse observation-list solver (backend/global_ba.py)
    DENSE_BA_MAX_FRAMES = 64

    def global_bundle_adjustment(self, iters1: int = 50, iters2: int = 40):
        """Full-map BA over every keyframe and landmark (``GlobalBA``): robust
        pass → outlier rejection → second pass, the oldest keyframe fixed.
        Up to ``DENSE_BA_MAX_FRAMES`` keyframes it runs the dense window
        program; past it the sparse observation-list solver."""
        if len(self.keyframes) < 2:
            return
        frames = [self.keyframes[fid] for fid in reversed(self.keyframe_ids)]
        pose_fixed = np.zeros(len(frames), bool)
        pose_fixed[-1] = True  # oldest keyframe (newest-first ordering)
        mpts = [m for m in self.mappoints.values() if m.is_valid and m.observers]
        mpls = [l for l in self.maplines.values() if l.is_valid and l.observers]
        if len(frames) > self.DENSE_BA_MAX_FRAMES:
            self._sparse_global_ba(frames, pose_fixed, mpts, mpls, iters1, iters2)
            return
        problem, layout = self._build_problem(frames, pose_fixed, mpts, mpls,
                                              pad_frames=_bucket(len(frames), 8))
        if problem is None:
            return
        out, p_in, l_in = windows.local_ba(problem, self._intr, self.ba_config,
                                           iters1=iters1, iters2=iters2)
        self._write_back(out, p_in, l_in, frames, pose_fixed, mpts, mpls, layout)

    def _sparse_global_ba(self, frames, pose_fixed, mpts, mpls, iters1, iters2,
                          max_obs: Optional[int] = None):
        """Map-scale GlobalBA on the sparse solver; with the IMU initialized
        the keyframe preintegration chain joins the problem (15 dof a frame,
        gravity pinned).

        ``max_obs`` (None = auto): the width of the per-landmark Schur
        pairing table. The auto rule takes the real maximum observation
        count, bucketed to multiples of 8 with a ceiling of 64, so the pairing
        is exact on typical maps (a fixed cap of 16 leaves about 3e-2 of pose
        error on dense-coverage scenes: the truncated pairing disagrees with
        the full-gradient landmark blocks). Landmarks past 64 keep their
        first 64 observations in the pairing; every observation still adds
        its gradient and is gated."""
        from airslam_tpu_torch.backend import global_ba as gba

        prob, layout = self._build_sparse_problem(frames, pose_fixed, mpts, mpls,
                                                  max_obs=max_obs)
        if prob is None:
            return
        out, p_in, l_in = gba.global_ba(prob, self._intr, self.ba_config,
                                        iters1=iters1, iters2=iters2)
        self._write_back_sparse(out, p_in, l_in, frames, pose_fixed, mpts, mpls, layout)

    def _build_sparse_problem(self, frames, pose_fixed, mpts, mpls,
                              max_obs: Optional[int] = None):
        """The ``SparseBAProblem`` of these frames and landmarks on the map's
        device: observation lists padded to buckets (points to 256, lines to
        64), the observation tables, the body poses, and with the IMU running
        the velocities, biases and preintegration factors. Returns (problem,
        (frame_index, real point observations, real line observations))."""
        from airslam_tpu_torch.backend import global_ba as gba

        f = len(frames)
        p_real, l_real = len(mpts), len(mpls)
        if p_real == 0 and l_real == 0:
            return None, None
        frame_index = {fr.frame_id: k for k, fr in enumerate(frames)}
        if max_obs is None:
            widest = 1
            for lm in list(mpts) + list(mpls):
                widest = max(widest, sum(1 for fid in lm.observers if fid in frame_index))
            max_obs = min(_bucket(widest, 8), 64)

        points = np.zeros((max(p_real, 1), 3))
        pobs_pidx, pobs_fidx, pobs = [], [], []
        for j, mpt in enumerate(mpts):
            points[j] = mpt.position
            for fid, idx in mpt.observers.items():
                k = frame_index.get(fid)
                if k is None:
                    continue
                kf = self.keyframes.get(fid) or frames[k]
                pobs_pidx.append(j)
                pobs_fidx.append(k)
                pobs.append(kf.keypoint_position(idx))
        n_real = len(pobs)
        N = _bucket(max(n_real, 1), 256)
        pobs_arr = np.zeros((N, 3))
        pobs_arr[:, 2] = -1.0
        if n_real:
            pobs_arr[:n_real] = np.asarray(pobs)
        ppidx = np.zeros(N, np.int64)
        pfidx = np.zeros(N, np.int64)
        ppidx[:n_real] = pobs_pidx
        pfidx[:n_real] = pobs_fidx
        pmask = np.zeros(N, bool)
        pmask[:n_real] = True

        lines = np.tile(np.array([1.0, 0, 0, 0, 1.0, 0]), (max(l_real, 1), 1))
        lobs_lidx, lobs_fidx, lobs, lster, lsig = [], [], [], [], []
        for j, mpl in enumerate(mpls):
            lines[j] = mpl.line3d
            sig = 0.1 if len(mpl.observers) > 3 else 0.001  # map.cc:724
            for fid, idx in mpl.observers.items():
                k = frame_index.get(fid)
                if k is None:
                    continue
                kf = self.keyframes.get(fid) or frames[k]
                row = np.zeros(8)
                row[0:4] = kf.lines[idx]
                stereo = bool(kf.lines_right_valid[idx])
                if stereo:
                    row[4:8] = kf.lines_right[idx]
                lobs_lidx.append(j)
                lobs_fidx.append(k)
                lobs.append(row)
                lster.append(stereo)
                lsig.append(sig)
        m_real = len(lobs)
        M = _bucket(max(m_real, 1), 64)
        lobs_arr = np.zeros((M, 8))
        if m_real:
            lobs_arr[:m_real] = np.asarray(lobs)
        llidx = np.zeros(M, np.int64)
        lfidx = np.zeros(M, np.int64)
        llidx[:m_real] = lobs_lidx
        lfidx[:m_real] = lobs_fidx
        lmask = np.zeros(M, bool)
        lmask[:m_real] = True
        lster_arr = np.zeros(M, bool)
        lster_arr[:m_real] = lster
        lsig_arr = np.full(M, 0.001)
        lsig_arr[:m_real] = lsig

        ptable = gba.build_obs_table(points.shape[0], ppidx, pmask, N, max_obs)
        ltable = gba.build_obs_table(lines.shape[0], llidx, lmask, M, max_obs)

        Tcb = self.camera.Tcb if hasattr(self.camera, "Tcb") else np.eye(4)
        Rwb = np.tile(np.eye(3), (f, 1, 1))
        twb = np.zeros((f, 3))
        for k, fr in enumerate(frames):
            Twb = fr.Twc @ Tcb
            Rwb[k] = Twb[:3, :3]
            twb[k] = Twb[:3, 3]

        t, dev = self._tensor, self.device

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        def flag(a):
            return torch.as_tensor(a, device=dev)

        vi = {}
        if self.imu_initialized:
            imu = self._imu_factors(frames)
            if imu is not None:
                vi = dict(vel=t(np.stack([fr.velocity for fr in frames])),
                          bg=t(np.stack([fr.bg for fr in frames])),
                          ba=t(np.stack([fr.ba for fr in frames])),
                          vel_fixed=flag(pose_fixed), Rwg=t(self.Rwg), imu=imu)
        prob = gba.SparseBAProblem(
            Rwb=t(Rwb), twb=t(twb), pose_fixed=flag(pose_fixed), points=t(points),
            pobs_pidx=idx(ppidx), pobs_fidx=idx(pfidx), pobs=t(pobs_arr),
            pobs_mask=flag(pmask), point_obs_table=idx(ptable),
            lines=t(lines), lobs_lidx=idx(llidx), lobs_fidx=idx(lfidx), lobs=t(lobs_arr),
            lobs_stereo=flag(lster_arr), lobs_mask=flag(lmask), lobs_sigma=t(lsig_arr),
            line_obs_table=idx(ltable), Rcb=t(Tcb[:3, :3]), tcb=t(Tcb[:3, 3]),
            g_value=self.g_value, **vi)
        return prob, (frame_index, n_real, m_real)

    def _write_back_sparse(self, out, p_in, l_in, frames, pose_fixed, mpts, mpls, layout):
        frame_index, n_real, m_real = layout
        Tcb = self.camera.Tcb if hasattr(self.camera, "Tcb") else np.eye(4)
        Tbc = np.linalg.inv(Tcb)

        def host(a):
            return None if a is None else a.double().cpu().numpy()

        # the whole state is pulled once
        Rwb, twb, vel, bgs, bas, pts, lns = (host(a) for a in (
            out.Rwb, out.twb, out.vel, out.bg, out.ba, out.points, out.lines))
        p_in, l_in = p_in.cpu().numpy(), l_in.cpu().numpy()
        pidx, fidx = out.pobs_pidx.cpu().numpy(), out.pobs_fidx.cpu().numpy()
        lidx, lfidx = out.lobs_lidx.cpu().numpy(), out.lobs_fidx.cpu().numpy()
        for k, fr in enumerate(frames):
            if pose_fixed[k]:
                continue
            Twb = np.eye(4)
            Twb[:3, :3] = Rwb[k]
            Twb[:3, 3] = twb[k]
            fr.Twc = Twb @ Tbc
            if vel is not None:
                fr.velocity = vel[k]
                fr.bg = bgs[k]
                fr.ba = bas[k]

        inv_frame = {k: fid for fid, k in frame_index.items()}
        for j, mpt in enumerate(mpts):
            mpt.set_position(pts[j])
        for oi in range(n_real):
            if p_in[oi]:
                continue
            mpt = mpts[pidx[oi]]
            fid = inv_frame[fidx[oi]]
            if fid in mpt.observers:
                kf = self.keyframes.get(fid)
                if kf is not None:
                    idx = mpt.observers[fid]
                    kf.mappoint_ids[idx] = -1
                    kf.track_ids[idx] = -1
                mpt.remove_observer(fid)
        for mpt in mpts:
            if len(mpt.observers) == 0:
                mpt.set_bad()

        for j, mpl in enumerate(mpls):
            mpl.set_line3d(lns[j])
        for oi in range(m_real):
            if l_in[oi]:
                continue
            mpl = mpls[lidx[oi]]
            fid = inv_frame[lfidx[oi]]
            if fid in mpl.observers:
                kf = self.keyframes.get(fid)
                if kf is not None:
                    idx = mpl.observers[fid]
                    kf.mapline_ids[idx] = -1
                    kf.line_track_ids[idx] = -1
                mpl.remove_observer(fid)
        refresh = []
        for mpl in mpls:
            if len(mpl.observers) == 0:
                mpl.set_bad()
            else:
                refresh.append(mpl)
        self.update_maplines_endpoints_batch(refresh)

    def apply_pose_corrections(self, corrections):
        """Move keyframes to their corrected poses and every landmark with
        its first observer's correction T_new · T_old⁻¹ (map_refiner.cc:540-591).
        Host work in float64."""
        old_poses = {fid: self.keyframes[fid].Twc.copy() for fid in corrections}
        for fid, Twc_new in corrections.items():
            self.keyframes[fid].set_pose(Twc_new)
        for mpt in self.mappoints.values():
            if not mpt.is_valid or not mpt.observers:
                continue
            first = min(mpt.observers)
            if first in corrections:
                A = corrections[first] @ np.linalg.inv(old_poses[first])
                mpt.position = A[:3, :3] @ mpt.position + A[:3, 3]
        for mpl in self.maplines.values():
            if not mpl.is_valid or not mpl.observers:
                continue
            first = min(mpl.observers)
            if first in corrections:
                A = corrections[first] @ np.linalg.inv(old_poses[first])
                mpl.line3d = lie.line_transform(
                    torch.as_tensor(A[:3, :3]), torch.as_tensor(A[:3, 3]),
                    torch.as_tensor(np.asarray(mpl.line3d, np.float64))).numpy()
                if mpl.endpoints_valid:
                    e = mpl.endpoints
                    mpl.endpoints = np.concatenate(
                        [A[:3, :3] @ e[:3] + A[:3, 3], A[:3, :3] @ e[3:] + A[:3, 3]])

    def update_covisibility_graph(self):
        """Rebuild the whole covisibility graph (map.cc:1385-1418)."""
        self.covisibility = {}
        for fid in self.keyframe_ids:
            self._update_covisibility(self.keyframes[fid])

    # ------------------------------------------------------------------
    # covisibility (map.cc:1385-1425)
    # ------------------------------------------------------------------

    def _update_covisibility(self, frame: Frame):
        counts: Dict[int, int] = {}
        for tid in frame.mappoint_ids[frame.mappoint_ids >= 0]:
            mpt = self.mappoints.get(int(tid))
            if mpt is None:
                continue
            for ofid in mpt.observers:
                if ofid != frame.frame_id:
                    counts[ofid] = counts.get(ofid, 0) + 1
        self.covisibility[frame.frame_id] = counts
        for ofid, c in counts.items():
            self.covisibility.setdefault(ofid, {})[frame.frame_id] = c

    def covisible_frames(self, frame_id: int, min_shared: int = 1):
        return [fid for fid, c in self.covisibility.get(frame_id, {}).items()
                if c >= min_shared]

    # ------------------------------------------------------------------
    # IMU initialization (map.cc:1046-1209)
    # ------------------------------------------------------------------

    def initialize_imu(self, frame: Frame):
        """Full VI initialization (``Map::InitializeIMU``, map.cc:1046-1209):
        requires ≥ 10 keyframes spanning ≥ 3 s with ≥ 5 mm inter-keyframe
        motion; closed-form gyro-bias + velocity/gravity seeds, GN refinement
        of velocities/shared bias/gravity, then gravity alignment of the
        whole map (keyframes, landmarks, velocities) so Rwg = I. Returns
        whether the IMU is now initialized."""
        init_frame = self._imu_init_frame
        if init_frame is None:
            return False
        if frame.timestamp - init_frame.timestamp < 3.0 or len(self.keyframes) < 10:
            return False

        # chain from current back to init frame (oldest-first afterwards)
        chain_frames = [frame]
        f = frame.previous_frame
        while f is not None and f.timestamp >= init_frame.timestamp:
            chain_frames.append(f)
            f = f.previous_frame
        if len(chain_frames) < 10:
            return False
        chain_frames = chain_frames[::-1]

        # motion check (map.cc:1057-1064)
        for a, b in zip(chain_frames[:-1], chain_frames[1:]):
            if np.linalg.norm(a.Twc[:3, 3] - b.Twc[:3, 3]) < 0.005:
                self._imu_init_frame = b
                return False

        preints = []
        for kf in chain_frames[1:]:
            if kf.preintegration is None or not kf.preintegration.valid():
                return False
            preints.append(kf.preintegration)

        Tcb = self.camera.Tcb
        t = self._tensor
        Rwb = t(np.stack([(kf.Twc @ Tcb)[:3, :3] for kf in chain_frames]))
        twb = t(np.stack([(kf.Twc @ Tcb)[:3, 3] for kf in chain_frames]))

        def stack(key):
            return torch.stack([getattr(p.state, key) for p in preints]).to(self.dtype)

        # 1. closed-form gyro bias, then repropagate all preints at it
        dbg = windows.compute_gyr_bias(Rwb, stack("dR"), stack("JRg")).double().cpu().numpy()
        bg0 = preints[0].bg + dbg
        for p in preints:
            p.set_bias(bg0, p.ba)

        # 2. closed-form velocities + gravity
        vels, gravity = windows.compute_velocity(Rwb, twb, stack("dP"), stack("dV"),
                                                 stack("dT"), self.camera.g_value)
        if float(torch.linalg.norm(gravity)) < 1e-6:
            return False
        Rwg0 = windows.gravity_to_rwg(gravity)

        # 3. GN refinement over velocities / shared bias / gravity dir
        preint_t = {k: stack(k) for k in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg",
                                          "JPa", "dT")}
        preint_t["info"] = t(np.stack([preintegration_information(p.state.cov)[0]
                                       for p in preints]))
        ba0 = t(preints[0].ba)
        with span("imu_initialization"):
            vels_r, bg_r, ba_r, Rwg = windows.imu_initialization(
                Rwb, twb, vels, t(bg0), ba0, Rwg0, preint_t, self.camera.g_value, t(bg0), ba0)
        vels_r, bg_r, ba_r, Rwg = (a.double().cpu().numpy() for a in (vels_r, bg_r, ba_r, Rwg))

        # 4. write back states
        for kf, v in zip(chain_frames, vels_r):
            kf.velocity = v
            kf.bg = bg_r.copy()
            kf.ba = ba_r.copy()
        for p in preints:
            p.update_bias(bg_r, ba_r)

        # 5. drop keyframes before the init frame (map.cc:1158-1166)
        for fid in [i for i in self.keyframe_ids if i < init_frame.frame_id]:
            self.delete_keyframe(fid)

        # 6. rotate the whole map into the gravity-aligned frame
        Rgw = Rwg.T
        tgw = -Rgw @ (init_frame.Twc @ Tcb)[:3, 3]
        Tgw = np.eye(4)
        Tgw[:3, :3] = Rgw
        Tgw[:3, 3] = tgw
        Tbc = np.linalg.inv(Tcb)
        for kf in self.keyframes.values():
            kf.set_imu_pose(Tgw @ kf.imu_pose(Tcb), Tbc)
            kf.velocity = Rgw @ kf.velocity
        for mpt in self.mappoints.values():
            if mpt.is_valid:
                mpt.position = Rgw @ mpt.position + tgw
        mpls = [mpl for mpl in self.maplines.values() if mpl.is_valid]
        if mpls:
            # every line in one call on the map's device
            lines = lie.line_transform(t(Rgw), t(tgw), t(np.stack([m.line3d for m in mpls])))
            for mpl, line in zip(mpls, lines.double().cpu().numpy()):
                mpl.line3d = line
                if mpl.endpoints_valid:
                    e = mpl.endpoints
                    mpl.endpoints = np.concatenate([Rgw @ e[:3] + tgw, Rgw @ e[3:] + tgw])

        init_frame.preintegration = None
        self.Rwg = np.eye(3)
        self.imu_initialized = True
        return True

    def delete_keyframe(self, fid: int):
        """Remove a keyframe and its landmark observations (map.cc's
        DeleteKeyframe)."""
        kf = self.keyframes.pop(fid, None)
        if kf is None:
            return
        self.keyframe_ids = [i for i in self.keyframe_ids if i != fid]
        for tid in kf.mappoint_ids[kf.mappoint_ids >= 0]:
            mpt = self.mappoints.get(int(tid))
            if mpt is not None:
                mpt.remove_observer(fid)
                if not mpt.observers:
                    mpt.set_bad()
        for ltid in kf.mapline_ids[kf.mapline_ids >= 0]:
            mpl = self.maplines.get(int(ltid))
            if mpl is not None:
                mpl.remove_observer(fid)
                if not mpl.observers:
                    mpl.set_bad()
        self.covisibility.pop(fid, None)
        for d in self.covisibility.values():
            d.pop(fid, None)

    # ------------------------------------------------------------------
    # export (map.cc:1000-1008)
    # ------------------------------------------------------------------

    def keyframe_trajectory(self):
        """[(timestamp, Twc)] in keyframe order."""
        return [(self.keyframes[fid].timestamp, self.keyframes[fid].Twc)
                for fid in self.keyframe_ids]

    def update_mappoint_descriptor(self, mpt: Mappoint) -> bool:
        """Representative descriptor = the observation with the least median
        distance to the others (``Map::UpdateMappointDescriptor``,
        map.cc:506-554)."""
        descs = []
        for fid, idx in mpt.observers.items():
            kf = self.keyframes.get(fid)
            if kf is not None and idx >= 0:
                descs.append(kf.kp_desc[idx])
        if not descs:
            return False
        if len(descs) <= 2:
            mpt.descriptor = np.asarray(descs[0]).copy()
            return True
        d = np.stack(descs)
        dist = 1.0 - d @ d.T  # DescriptorDistance, utils.cc:15-17
        mpt.descriptor = d[int(np.argmin(np.median(dist, axis=1)))].copy()
        return True

    def search_by_projection(self, frame: Frame, mpts, thr: int = 1,
                             dist_thr: float = 0.35, ratio_thr: float = 0.6):
        """Projection-guided match search (``Map::SearchByProjection``,
        map.cc:945-998): project each valid mappoint into the frame, find the
        keypoints within r = 15·thr px (the native radius search), accept the
        best descriptor match under the distance and Lowe-ratio gates.
        Returns [(keypoint_idx, mappoint)]."""
        from airslam_tpu_torch.utils import native

        cam = self.camera
        Rwc = frame.Twc[:3, :3]
        twc = frame.Twc[:3, 3]
        r = 15.0 * thr
        good = []
        kp32 = frame.keypoints.astype(np.float32)
        for mpt in mpts:
            if mpt is None or not mpt.is_valid or mpt.descriptor is None:
                continue
            pc = Rwc.T @ (mpt.position - twc)
            if pc[2] <= 0:
                continue
            u = pc[0] / pc[2] * cam.fx + cam.cx
            v = pc[1] / pc[2] * cam.fy + cam.cy
            if not (0 < u < cam.image_width and 0 < v < cam.image_height):
                continue
            cand = native.radius_search(kp32, frame.kp_mask, float(u), float(v), r)
            if len(cand) == 0:
                continue
            dists = native.descriptor_distances(mpt.descriptor, frame.kp_desc[cand])
            order = np.argsort(dists)
            best = float(dists[order[0]])
            second = float(dists[order[1]]) if len(order) > 1 else 4.0
            if best < dist_thr and best < ratio_thr * second:
                good.append((int(cand[order[0]]), mpt))
        return good

    def export_text(self, map_root: str):
        """Plain-text map dump (``Map::SaveMap``, map.cc:1227-1278):
        frames/<id>.txt with the pose and per-feature (track_id, score, x, y,
        descriptor) rows, and mappoints.txt with (id, x, y, z)."""
        import os

        frame_root = os.path.join(map_root, "frames")
        os.makedirs(frame_root, exist_ok=True)
        for fid in self.keyframe_ids:
            kf = self.keyframes[fid]
            lines = [",".join([str(fid)] + [f"{kf.Twc[i, j]:.6f}"
                                            for i in range(3) for j in range(4)])]
            for i in np.nonzero(kf.kp_mask)[0]:
                row = [str(int(kf.track_ids[i])), f"{kf.kp_scores[i]:.6f}",
                       f"{kf.keypoints[i, 0]:.3f}", f"{kf.keypoints[i, 1]:.3f}"]
                row += [f"{v:.6f}" for v in kf.kp_desc[i]]
                lines.append(",".join(row))
            with open(os.path.join(frame_root, f"{fid}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        rows = []
        for mid, mpt in self.mappoints.items():
            if mpt.is_valid:
                p = mpt.position
                rows.append(f"{mid},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f}")
        with open(os.path.join(map_root, "mappoints.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")

    def map_scale(self) -> float:
        """3× the largest per-axis standard deviation of the valid mappoints
        (``Map::MapScale``, map.cc:1428-1446)."""
        pts = np.asarray([m.position for m in self.mappoints.values() if m.is_valid])
        if len(pts) == 0:
            return 0.0
        return float(3.0 * pts.std(axis=0).max())

    def check_map(self):
        """Consistency assertions (Map::CheckMap, map.cc:1448-1485)."""
        for tid, mpt in self.mappoints.items():
            for fid, idx in mpt.observers.items():
                kf = self.keyframes.get(fid)
                assert kf is not None, f"mappoint {tid} observes missing kf {fid}"
                assert kf.mappoint_ids[idx] == tid or kf.mappoint_ids[idx] == -1
        for ltid, mpl in self.maplines.items():
            for fid, idx in mpl.observers.items():
                assert fid in self.keyframes
