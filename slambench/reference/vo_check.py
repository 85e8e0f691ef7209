"""The correctness comparison of the VO cells.

The plain reference (``slambench/reference/nets``: PLNet with its stage-1
head, SuperPoint, LightGlue, the decoders, all plain PyTorch copied from the
port and run without its kernels) reads the shipped checkpoints itself,
rectifies the same 8-bit frames the program was handed with its own grids
(OpenCV's, from the configuration's camera block) and detects and
stereo-matches both views as the program's frame construction does. The
program's ``Frame`` objects of the sampled window frames are then held
against it, and the program's whole trajectory against the rendered truth.

Numbers (each with its limit in the workload file's ``check.limits``):

- ``kp_unpaired``: over the sampled frames, the share of keypoints of either
  side with no keypoint of the other within 0.5 px;
- ``desc_gap``: the largest difference of one descriptor entry between
  paired keypoints (descriptors have unit norm);
- ``line_unpaired``: the share of lines of either side with no line of the
  other whose endpoints both lie within 1 px;
- ``stereo_unpaired``: the share of paired keypoints whose stereo match
  differs (one side has a right-view position the other lacks, or the two
  lie over 0.5 px apart);
- the local BA, on calls of the window drawn from the seed (``check.
  local_ba_calls`` of them, or all): the plain window BA
  (``slambench/reference/window_ba.py``) solves the problem the program's map
  built for that keyframe again, in float64, and the program's result is held
  against it, each number the median over the calls (a window's LM steps at
  the smallest damping solve a nearly singular system, so on about one call in
  twenty two sound float64 solvers part along a barely observed direction;
  the worst call is printed, not compared): ``lba_pose_gap_m``, the largest distance of a
  free pose's position from the reference's; ``lba_rot_gap``, the largest
  Frobenius norm of a free pose's rotation minus the reference's;
  ``lba_point_gap_m``, the median distance of an observed point from the
  reference's (the largest swings with the few points that two observations
  barely pin); ``lba_cost_gap``, the Huber cost over every observation at the
  program's result relative to the cost at the reference's, minus 1 (its
  magnitude); ``lba_flag_flips``, the observations whose final inlier flag
  differs. The problem is the program's own state (its map's window): the
  map that builds it is judged by the trajectory and the frontend numbers;
- ``ate_m``: the Sim(3)-aligned RMSE of the tracked frames' positions
  against the rendered truth, as ``evo_ape -as`` computes it, over each run
  of ``trajectory_gate_frames`` consecutive tracked frames (the last one
  ending at the last frame), the largest of them: its limit is the
  configuration's own (``trajectory_gate_m``), which the repository sets on
  sequences of that length, and it does not tighten as a faster program
  tracks more of the stream;
- ``untracked_frames``: frames handed over from the first tracked one on
  that have no pose in the trajectory. An exact comparison: limit 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slambench.harness.common import Check
from slambench.reference import window_ba
from slambench.traffic.rig import rectification
from slambench.traffic.stereo_stream import as_delivered

KP_RADIUS = 0.5  # px
LINE_RADIUS = 1.0  # px
STEREO_RADIUS = 0.5  # px


def rectify_grids(camera: dict):
    """(2, H, W, 2) float32 source grids of the rig, as ``cv2`` computes them."""
    import cv2

    r = rectification(camera)
    size = (r["width"], r["height"])
    grids = []
    for K, D, R, P in ((r["K0"], r["D0"], r["R0"], r["P0"]), (r["K1"], r["D1"], r["R1"], r["P1"])):
        m1, m2 = cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], size, cv2.CV_32FC1)
        grids.append(np.stack([m1, m2], -1))
    return np.stack(grids), r


def reference_frames(images, config: dict, device, tf32: bool = False):
    """The reference's left-view keypoints, descriptors, lines and stereo
    right-view positions of each (2, H, W) uint8 frame in ``images``.
    ``tf32``: the products in TF32 (the lower precision of the control)."""
    from slambench.reference.nets import detector as rdet
    from slambench.reference.nets import matcher as rmat
    from slambench.reference.nets.gridsample import remap

    node, cam = config["vo"], config["camera"]
    p = node["plnet"]
    dcfg = rdet.DetectorConfig(
        max_keypoints=int(p["max_keypoints"]), keypoint_threshold=float(p["keypoint_threshold"]),
        remove_borders=int(p["remove_borders"]), line_threshold=float(p["line_threshold"]),
        line_length_threshold=float(p["line_length_threshold"]),
        use_superpoint=bool(int(p["use_superpoint"])))
    mcfg = rmat.MatcherConfig(image_width=int(node["point_matcher"]["image_width"]),
                              image_height=int(node["point_matcher"]["image_height"]))
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        det = rdet.FeatureDetector(dcfg, device)
        mat = rmat.PointMatcher(mcfg, device)
        grids_np, r = rectify_grids(cam)
        grids = torch.as_tensor(grids_np, device=device)
        bf = r["bf"]
        lo = bf / float(cam["depth_upper_thr"])
        hi = bf / float(cam["depth_lower_thr"])
        max_dy = float(cam["max_y_diff"])
        out = []
        for img in images:
            views = [torch.as_tensor(v, device=device) for v in as_delivered(img)]
            pair = torch.stack([remap(views[s], grids[s]) for s in range(2)])
            feats = det.detect(pair, detect_junctions=True)
            f0 = type(feats)(*(t[0] for t in feats))
            f1 = type(feats)(*(t[1] for t in feats))
            pairs, _ = mat.matching_points_batched([(f0, f1)])[0]
            kl = f0.keypoints.cpu().numpy().astype(np.float64)
            kr = f1.keypoints.cpu().numpy().astype(np.float64)
            u_right = np.full(kl.shape[0], -1.0)
            if len(pairs):
                il, ir = pairs[:, 0], pairs[:, 1]
                dx = kl[il, 0] - kr[ir, 0]
                dy = np.abs(kl[il, 1] - kr[ir, 1])
                ok = (dx > lo) & (dx < hi) & (dy <= max_dy)
                u_right[il[ok]] = kr[ir[ok], 0]
            out.append({"keypoints": kl, "kp_mask": f0.kp_mask.cpu().numpy(),
                        "kp_desc": f0.kp_desc.float().cpu().numpy(),
                        "lines": f0.lines.cpu().numpy().astype(np.float64),
                        "line_mask": f0.line_mask.cpu().numpy(), "u_right": u_right})
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _nearest(a: np.ndarray, b: np.ndarray):
    """For each row of ``a`` (n, d), the index of the nearest row of ``b``
    by the largest coordinate-pair distance, and that distance."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(len(a), np.int64), np.full(len(a), np.inf)
    d = np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=-1)
    if a.shape[1] == 4:  # lines: both endpoints, either orientation
        d_same = np.maximum(d, np.linalg.norm(a[:, None, 2:] - b[None, :, 2:], axis=-1))
        d_flip = np.maximum(np.linalg.norm(a[:, None, :2] - b[None, :, 2:], axis=-1),
                            np.linalg.norm(a[:, None, 2:] - b[None, :, :2], axis=-1))
        d = np.minimum(d_same, d_flip)
    j = d.argmin(1)
    return j, d[np.arange(len(a)), j]


def compare_frame(prog: dict, ref: dict) -> dict:
    """Counts and gaps of one frame: program ``prog`` against reference ``ref``."""
    pk, pm = np.asarray(prog["keypoints"], np.float64), np.asarray(prog["kp_mask"], bool)
    rk, rm = ref["keypoints"], np.asarray(ref["kp_mask"], bool)
    pi, ri = np.nonzero(pm)[0], np.nonzero(rm)[0]
    j, d = _nearest(pk[pi], rk[ri])
    paired = d <= KP_RADIUS
    _, db = _nearest(rk[ri], pk[pi])
    a, b = pi[paired], ri[j[paired]]
    desc = (np.abs(np.asarray(prog["kp_desc"], np.float64)[a] - ref["kp_desc"][b]).max()
            if len(a) else 0.0)
    up, ur = np.asarray(prog["u_right"], np.float64)[a], ref["u_right"][b]
    has_p, has_r = up > 0, ur > 0
    stereo_bad = (has_p != has_r) | (has_p & has_r & (np.abs(up - ur) > STEREO_RADIUS))
    pl = np.asarray(prog["lines"], np.float64)[np.asarray(prog["line_mask"], bool)]
    rl = ref["lines"][np.asarray(ref["line_mask"], bool)]
    _, dl = _nearest(pl, rl)
    _, dlb = _nearest(rl, pl)
    return {"kp_total": len(pi) + len(ri),
            "kp_unpaired": int((~paired).sum() + (db > KP_RADIUS).sum()),
            "desc_gap": float(desc),
            "line_total": len(pl) + len(rl),
            "line_unpaired": int((dl > LINE_RADIUS).sum() + (dlb > LINE_RADIUS).sum()),
            "stereo_total": len(a), "stereo_unpaired": int(stereo_bad.sum())}


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error RMSE after the Umeyama Sim(3) alignment of
    the estimate onto the truth. A still truth fixes no scale (the fitted
    one is 0, which would hide any drift): the estimate then keeps its own,
    and the error is its spread about its mean."""
    n = len(est_t)
    if n < 3:
        return float("inf")
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    E, G = est_t - mu_e, gt_t - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E / n)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    var = (E * E).sum() / n
    still = (G * G).sum() / n < 1e-12
    s = np.trace(np.diag(S) @ D) / var if var > 0 and not still else 1.0
    est = (s * (R @ est_t.T)).T + (mu_g - s * R @ mu_e)
    err = est - gt_t
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def trajectory_error(trajectory, stream, segment: int) -> float:
    """``ate_m`` of the program's (timestamp, Twc) list against the truth:
    the largest over its runs of ``segment`` consecutive entries."""
    if len(trajectory) < 3:
        return float("inf")
    dt = float(stream.timestamps[1] - stream.timestamps[0])
    idx = np.array([int(round(ts / dt)) for ts, _ in trajectory])
    est = np.array([np.asarray(T)[:3, 3] for _, T in trajectory], np.float64)
    if not np.isfinite(est).all():
        return float("inf")
    gt = stream.gt_Twc[idx, :3, 3]
    n = len(est)
    starts = list(range(0, max(n - segment, 0) + 1, segment))
    if starts[-1] + segment < n:
        starts.append(n - segment)
    return max(ate_rmse(est[s:s + segment], gt[s:s + segment]) for s in starts)


def program_frame(frame) -> dict:
    """The fields of a program ``Frame`` the comparison reads (none of a
    frame that returned nothing: nothing pairs with it)."""
    if frame is None:
        return {"keypoints": np.zeros((0, 2)), "kp_mask": np.zeros(0, bool),
                "kp_desc": np.zeros((0, 256)), "lines": np.zeros((0, 4)),
                "line_mask": np.zeros(0, bool), "u_right": np.zeros(0)}
    return {k: getattr(frame, k) for k in ("keypoints", "kp_mask", "kp_desc", "lines",
                                           "line_mask", "u_right")}


def numbers(progs, refs) -> dict:
    """The pooled shares and the largest descriptor gap over frames."""
    rows = [compare_frame(p, r) for p, r in zip(progs, refs)]

    def share(key, total):
        t = sum(r[total] for r in rows)
        return sum(r[key] for r in rows) / t if t else 1.0

    return {"kp_unpaired": share("kp_unpaired", "kp_total"),
            "desc_gap": max((r["desc_gap"] for r in rows), default=float("inf")),
            "line_unpaired": share("line_unpaired", "line_total"),
            "stereo_unpaired": share("stereo_unpaired", "stereo_total")}


def untracked(trajectory, stream, n_handed: int) -> int:
    """Frames of the ``n_handed`` handed over, from the first tracked one on,
    without a pose in the trajectory (all of them when none was tracked)."""
    if not trajectory:
        return n_handed
    dt = float(stream.timestamps[1] - stream.timestamps[0])
    first = int(round(trajectory[0][0] / dt))
    have = {int(round(ts / dt)) for ts, _ in trajectory}
    return sum(1 for k in range(first, n_handed) if k not in have)


def window_of(problem) -> window_ba.Window:
    """The window problem of a ``local_ba`` call's first argument, read by
    field name."""
    fr = problem.frames
    return window_ba.Window(
        fr.Rwb, fr.twb, problem.pose_fixed, problem.points, problem.point_fixed,
        problem.point_obs, problem.point_obs_mask, problem.lines, problem.line_fixed,
        problem.line_obs, problem.line_obs_stereo, problem.line_obs_mask,
        problem.line_obs_sigma, problem.Rcb, problem.tcb)


def local_ba_numbers(call, config: dict) -> dict:
    """The local BA's numbers of one kept call ``(args, kwargs, (problem,
    point inliers, line inliers))``."""
    args, _, (out, p_in, l_in) = call
    w = window_of(args[0])
    r = rectification(config["camera"])
    cam = {k: r[k] for k in ("fx", "fy", "cx", "cy", "bf")}
    thr = config["vo"]["optimization"]["backend"]
    sched = config["local_ba"]
    ref = window_ba.solve(w, cam, thr, int(sched["iters1"]), int(sched["iters2"]))
    f64 = torch.float64
    dev = ref.twb.device
    free = ~w.pose_fixed.to(dev)
    seen = (w.point_mask.any(1) & ~w.point_fixed).to(dev)
    po = out.frames

    def gap(gaps, keep, how=torch.max):
        gaps = gaps[keep]
        return float(how(gaps)) if gaps.numel() else 0.0

    prog_state = (po.Rwb, po.twb, out.points, out.lines)
    c_prog = window_ba.robust_cost(w, cam, thr, prog_state)
    c_ref = window_ba.robust_cost(w, cam, thr, ref[:4])
    flips = (((p_in.to(dev) != ref.point_inlier) & w.point_mask.to(dev)).sum()
             + ((l_in.to(dev) != ref.line_inlier) & w.line_mask.to(dev)).sum())
    got = {"lba_pose_gap_m": gap((po.twb.to(dev, f64) - ref.twb).norm(dim=-1), free),
           "lba_rot_gap": gap((po.Rwb.to(dev, f64) - ref.Rwb).flatten(1).norm(dim=-1), free),
           "lba_point_gap_m": gap((out.points.to(dev, f64) - ref.points).norm(dim=-1), seen,
                                  torch.median),
           "lba_cost_gap": abs(c_prog - c_ref) / max(c_ref, 1e-300),
           "lba_flag_flips": int(flips)}
    return {k: (float("inf") if v != v else v) for k, v in got.items()}


LBA_NUMBERS = ("lba_pose_gap_m", "lba_rot_gap", "lba_point_gap_m", "lba_cost_gap",
               "lba_flag_flips")


def judge(picked: dict, stream, trajectory, n_handed: int, config: dict, limits: dict, device,
          local_ba=None):
    """The checks of a run: ``picked`` maps window frame indices to the
    program's ``Frame``; ``trajectory`` is the builder's (timestamp, Twc)
    list; ``n_handed`` the frames handed over, warm-up and window;
    ``local_ba`` the ``local_ba`` calls to compare (none: the window ran no
    local BA, and the local BA's numbers are not read)."""
    idx = sorted(picked)
    refs = reference_frames([stream.images[k] for k in idx], config, device)
    got = numbers([program_frame(picked[k]) for k in idx], refs)
    got["ate_m"] = trajectory_error(trajectory, stream, int(config["trajectory_gate_frames"]))
    got["untracked_frames"] = untracked(trajectory, stream, n_handed)
    names = ["kp_unpaired", "desc_gap", "line_unpaired", "stereo_unpaired"]
    if local_ba:
        rows = [local_ba_numbers(call, config) for call in local_ba]
        for k in LBA_NUMBERS:
            got[k] = float(np.median([r[k] for r in rows]))
            print(f"reading {k} = {got[k]!r}, worst call {max(r[k] for r in rows)!r} of "
                  f"{len(rows)}" + ("" if k in limits else " (not compared)"), file=sys.stderr)
        names += [k for k in LBA_NUMBERS if k in limits]
    else:
        print("note: the window ran no local BA", file=sys.stderr)
    limits = dict(limits, ate_m=config["trajectory_gate_m"])
    return [Check(name, got[name], limits[name]) for name in names + ["ate_m",
                                                                       "untracked_frames"]]
