"""The correctness comparison of the VI cells.

The VO cells' frontend numbers and trajectory gate
(:mod:`slambench.reference.vo_check`), and the stereo-inertial path held to
the plain float64 reference :mod:`slambench.reference.vi_ba`, each solve
done again from the problem the program built. Numbers (each with its limit
in the workload file's ``check.limits``):

- ``kp_unpaired``, ``desc_gap``, ``line_unpaired``, ``stereo_unpaired``:
  as ``vo_check``, on frames of the window drawn from the seed and the
  slowest one;
- ``ate_m``: as ``vo_check``, over the trajectory from the IMU
  initialization's first keyframe on (the initialization drops the older
  keyframes and rotates the map into the gravity-aligned world; frames
  tracked against the dropped ones keep the old world), its limit the
  configuration's; ``untracked_frames``: as ``vo_check``;
- ``vi_frames_missed``: window frames that did not go through the F = 2 VI
  tracking solve (exact: limit 0);
- ``preint_gap``: over keyframes from the IMU initialization's first on,
  drawn from the seed, the largest difference of the preintegrated dR, dV
  (m/s), dP (m) and dT (s) from the reference's, integrating the stream's
  raw samples over the same interval at the same linearization biases, and
  of its 9×9 covariance and bias-walk covariance, each relative to its
  largest entry; the walk's gap to ``Propagate``'s reading of the rows of
  no length is printed, not compared (a departure the program shares with
  the JAX package, ROADMAP §1);
- ``vi_pose_gap_m``, ``vi_rot_gap``, ``vi_vel_gap``: over F = 2 tracking
  solves of the window drawn from the seed, solved again by the reference
  from the program's states and observations, its IMU factor integrated by
  the reference from the stream's raw samples over the factor's span at its
  linearization biases: the largest distance of the frame's position,
  Frobenius norm of its rotation's difference and velocity difference;
- ``vlba_pose_gap_m``, ``vlba_rot_gap``, ``vlba_point_gap_m``,
  ``vlba_vel_gap``, ``vlba_bias_gap``, ``vlba_cost_gap``: over VI local BAs
  of the window drawn from the seed, solved again by the reference's VI
  window BA, its IMU factors integrated from the raw samples as above, each
  the median over the calls (as ``vo_check``'s local BA numbers; the worst
  call is printed) of the largest gap over the free frames (the median over
  the observed points), the biases' over both, and the robust cost at the
  program's result relative to the reference's;
- ``vlba_stuck``: the window's VI local BAs (every one, exact: limit 0)
  whose result is not finite or whose free frames did not move at all, as
  when every LM step is rejected, so that a window left unoptimized does
  not hide in the medians;
- ``init_gravity_gap``, ``init_bg_gap``: the warm-up's IMU initialization
  solved again by the reference from its poses and seeds, each keyframe's
  deltas and information integrated by the reference from the raw samples
  over the keyframe's span at the closed-form gyro bias: the distance of
  the two gravity directions (unit vectors) and the largest gyro-bias
  difference;
- ``bg_err``: the initialized gyro bias against the seed's true bias,
  averaged over the initialization's span, the largest axis (rad/s).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slambench.harness.common import Check
from slambench.reference import vi_ba, vo_check
from slambench.reference.vo_check import window_of
from slambench.traffic.rig import rectification

F64 = torch.float64


def vi_window_of(problem, camera: dict = None, factors: vi_ba.Factors = None
                 ) -> vi_ba.VIWindow:
    """The VI problem of a program's ``BAProblem`` with IMU factors, read by
    field name: the measurements and the state. With the configuration's
    ``camera`` block, the model's constants (the body-to-camera transform and
    gravity's magnitude) are the configuration's, not the program's; with
    ``factors`` (:func:`stream_factors`), the IMU factors are those."""
    imu, fr = problem.imu, problem.frames
    fa = factors if factors is not None else vi_ba.Factors(
        imu.idx_i, imu.idx_j, imu.dR, imu.dV, imu.dP, imu.JRg, imu.JVg, imu.JVa, imu.JPg,
        imu.JPa, imu.bg_lin, imu.ba_lin, imu.dT, imu.info, imu.info_walk, imu.mask)
    base, g = window_of(problem), float(problem.g_value)
    if camera is not None:
        Tcb = torch.as_tensor(np.linalg.inv(_Tbc(camera)), device=base.Rcb.device)
        base = base._replace(Rcb=Tcb[:3, :3], tcb=Tcb[:3, 3])
        g = float(camera["g_value"])
    return vi_ba.VIWindow(base, fr.vel, fr.bg, fr.ba, problem.vel_fixed, fa, problem.Rwg, g)


def _Tbc(camera):
    T = np.array(camera["cam0"]["T"], np.float64).reshape(4, 4)
    return np.linalg.inv(T) if int(camera["cam0"].get("T_type", 0)) else T


def _cam(config):
    r = rectification(config["camera"])
    return {k: r[k] for k in ("fx", "fy", "cx", "cy", "bf")}


def _thr(config, block):
    return {k: float(v) for k, v in config["vo"]["optimization"][block].items()
            if k != "rate"}


def _noise(camera):
    sq = float(np.sqrt(float(camera["rate_hz"])))
    return (float(camera["gyroscope_noise_density"]) * sq,
            float(camera["accelerometer_noise_density"]) * sq,
            float(camera["gyroscope_random_walk"]) / sq,
            float(camera["accelerometer_random_walk"]) / sq)


def _gap(a, b, keep=None, how=torch.max):
    d = (torch.as_tensor(a).to(F64) - torch.as_tensor(b).to(F64).to(
        torch.as_tensor(a).device))
    d = d.reshape(d.shape[0], -1).norm(dim=-1) if d.dim() > 1 else d.abs()
    if keep is not None:
        d = d[keep.to(d.device)]
    return float(how(d)) if d.numel() else 0.0


def _integrate(stream, camera, t0, t1, bg, ba, walk_on_empty_rows=False) -> dict:
    """The reference's preintegration of the stream's raw samples over
    [t0, t1] at the biases (bg, ba)."""
    rate = float(camera["rate_hz"])
    s = stream.imu
    keep = (s[:, 0] >= t0 - 1.5 / rate) & (s[:, 0] <= t1 + 1.5 / rate)
    return vi_ba.preintegrate(*vi_ba.midpoint_rows(s[keep], t0, t1), np.asarray(bg, np.float64),
                              np.asarray(ba, np.float64), _noise(camera), walk_on_empty_rows)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300))


def preint_gap(keyframe, stream, camera) -> float:
    """The largest gap of a keyframe's preintegration (``vio``'s
    ``_keyframe_preints`` row) from the reference's over the same samples:
    the deltas' absolute gaps and the 9×9 and walk covariances' relative."""
    t0, t1, bg, ba, dR, dV, dP, dT, cov = keyframe
    ref = _integrate(stream, camera, t0, t1, bg, ba)
    return float(max(np.abs(dR - ref["dR"]).max(), np.abs(dV - ref["dV"]).max(),
                     np.abs(dP - ref["dP"]).max(), abs(float(dT) - ref["dT"]),
                     _rel(cov[:9, :9], ref["cov"][:9, :9]), _rel(cov[9:, 9:], ref["cov"][9:, 9:])))


def walk_gap_propagate(keyframe, stream, camera) -> float:
    """The relative gap of a keyframe's bias-walk information from the one
    ``Propagate``'s reading of the rows of no length gives."""
    t0, t1, bg, ba, *_, cov = keyframe
    ref = _integrate(stream, camera, t0, t1, bg, ba, walk_on_empty_rows=True)
    return _rel(vi_ba.information(cov)[1], vi_ba.information(ref["cov"])[1])


def stream_factors(spans, problem, stream, camera) -> vi_ba.Factors:
    """The IMU factors of ``problem`` (its topology: which frames each links,
    and its mask) integrated by the reference from the stream's raw samples:
    ``spans`` holds each factor's (start, end, bg, ba) in the factors' order."""
    imu = problem.imu
    dev = imu.dR.device
    rows = [_integrate(stream, camera, t0, t1, bg, ba) for t0, t1, bg, ba in spans]
    infos = [vi_ba.information(r["cov"]) for r in rows]

    def t(a):
        return torch.as_tensor(np.stack(a), dtype=F64, device=dev)

    return vi_ba.Factors(
        imu.idx_i, imu.idx_j, *(t([r[k] for r in rows]) for k in
                                ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")),
        t([sp[2] for sp in spans]), t([sp[3] for sp in spans]),
        torch.as_tensor([r["dT"] for r in rows], dtype=F64, device=dev),
        t([i[0] for i in infos]), t([i[1] for i in infos]), imu.mask)


def pose_numbers(call, config, spans, stream) -> dict:
    """The F = 2 tracking solve's numbers of one kept call ``(args, kwargs,
    (problem, point inliers, line inliers, count))``, its IMU factor's
    ``spans`` (:func:`stream_factors`)."""
    args, kw, (out, _, _, _) = call
    w = vi_window_of(args[0], config["camera"],
                     stream_factors(spans, args[0], stream, config["camera"]))
    ref = vi_ba.pose_only(w, _cam(config), _thr(config, "tracking"), vi_ba.IMU_INFO_SCALE,
                          rounds=int(kw.get("rounds", 3)), iters=int(kw.get("iters", 10))).state
    fr = out.frames
    got = {"vi_pose_gap_m": _gap(fr.twb[1:], ref.twb[1:]),
           "vi_rot_gap": _gap(fr.Rwb[1:], ref.Rwb[1:]),
           "vi_vel_gap": _gap(fr.vel[1:], ref.vel[1:])}
    return {k: (float("inf") if v != v else v) for k, v in got.items()}


def local_ba_numbers(call, config, spans, stream) -> dict:
    """The VI local BA's numbers of one kept ``local_ba`` call, its IMU
    factors' ``spans`` (:func:`stream_factors`)."""
    args, _, (out, _, _) = call
    w = vi_window_of(args[0], config["camera"],
                     stream_factors(spans, args[0], stream, config["camera"]))
    cam, thr, sched = _cam(config), _thr(config, "backend"), config["local_ba"]
    ref = vi_ba.window_ba(w, cam, thr, vi_ba.IMU_INFO_SCALE, int(sched["iters1"]),
                          int(sched["iters2"])).state
    base = w.base
    dev = ref.twb.device
    free = ~base.pose_fixed.to(dev)
    seen = (base.point_mask.any(1) & ~base.point_fixed).to(dev)
    fr = out.frames
    prog = vi_ba.State(fr.Rwb, fr.twb, fr.vel, fr.bg, fr.ba, out.points, out.lines)
    c_prog = vi_ba.cost(w, cam, thr, vi_ba.IMU_INFO_SCALE, prog)
    c_ref = vi_ba.cost(w, cam, thr, vi_ba.IMU_INFO_SCALE, ref)
    got = {"vlba_pose_gap_m": _gap(fr.twb, ref.twb, free),
           "vlba_rot_gap": _gap(fr.Rwb, ref.Rwb, free),
           "vlba_point_gap_m": _gap(out.points, ref.points, seen, torch.median),
           "vlba_vel_gap": _gap(fr.vel, ref.vel, free),
           "vlba_bias_gap": max(_gap(fr.bg, ref.bg, free), _gap(fr.ba, ref.ba, free)),
           "vlba_cost_gap": abs(c_prog - c_ref) / max(c_ref, 1e-300)}
    return {k: (float("inf") if v != v else v) for k, v in got.items()}


def init_numbers(call, stream, span, camera) -> dict:
    """The IMU initialization's numbers of the kept call and its keyframes'
    spans ((call, spans): the poses and seeds the call's, the deltas
    integrated from the raw samples, gravity's magnitude the
    configuration's) and the true bias over ``span`` (first and last time of
    the initialization)."""
    (args, kw, (vels, bg, ba, Rwg)), spans = call
    args = list(args)
    rows = [_integrate(stream, camera, t0, t1, bg_, ba_) for t0, t1, bg_, ba_ in spans]
    dev = torch.as_tensor(args[1]).device

    def t(a):
        return torch.as_tensor(np.stack(a), dtype=F64, device=dev)

    pre = {k: t([r[k] for r in rows]) for k in
           ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")}
    pre["dT"] = torch.as_tensor([r["dT"] for r in rows], dtype=F64, device=dev)
    pre["info"] = t([vi_ba.information(r["cov"])[0] for r in rows])
    args[6] = pre
    args[7] = float(camera["g_value"])
    ref = vi_ba.imu_initialization(*args, **kw)
    g_prog = torch.as_tensor(Rwg).to(F64)[:, 2]
    g_ref = ref[3][:, 2].to(g_prog.device)
    t = stream.imu[:, 0]
    keep = (t >= span[0]) & (t <= span[1])
    truth = stream.imu_bias[keep, :3].mean(0)
    return {"init_gravity_gap": float((g_prog - g_ref).norm()),
            "init_bg_gap": _gap(bg, ref[1]),
            "bg_err": float(np.abs(torch.as_tensor(bg).double().cpu().numpy() - truth).max())}


def stuck(calls) -> int:
    """The kept VI ``local_ba`` calls whose result is not finite or whose free
    frames are, bit for bit, where they started."""
    n = 0
    for args, _, (out, _, _) in calls:
        fr0, fr = args[0].frames, out.frames
        free = ~args[0].pose_fixed
        finite = all(bool(torch.isfinite(x).all()) for x in (*fr, out.points, out.lines))
        moved = any(bool((a[free] != b[free]).any()) for a, b in zip(fr, fr0))
        n += int(not (finite and moved))
    return n


POSE_NUMBERS = ("vi_pose_gap_m", "vi_rot_gap", "vi_vel_gap")
LBA_NUMBERS = ("vlba_pose_gap_m", "vlba_rot_gap", "vlba_point_gap_m", "vlba_vel_gap",
               "vlba_bias_gap", "vlba_cost_gap")


def judge(picked: dict, stream, trajectory, n_handed: int, t_align: float, config: dict,
          limits: dict, device, *, vi_frames_missed: int, pose_calls, local_ba, init_call,
          keyframes, init_span, all_local_ba=()):
    """The checks of a VI run: the frontend and trajectory numbers of
    ``vo_check`` and the VI numbers above, each beside its limit.
    ``pose_calls`` and ``local_ba``: (kept call, its factors' spans) pairs;
    ``all_local_ba``: every VI local BA call of the window."""
    idx = sorted(picked)
    refs = vo_check.reference_frames([stream.images[k] for k in idx], config, device)
    got = vo_check.numbers([vo_check.program_frame(picked[k]) for k in idx], refs)
    aligned = [(ts, T) for ts, T in trajectory if ts >= t_align - 1e-9]
    got["ate_m"] = vo_check.trajectory_error(aligned, stream,
                                             int(config["trajectory_gate_frames"]))
    got["untracked_frames"] = vo_check.untracked(trajectory, stream, n_handed)
    got["vi_frames_missed"] = vi_frames_missed
    got["preint_gap"] = max((preint_gap(k, stream, config["camera"]) for k in keyframes),
                            default=float("inf"))
    walk = max((walk_gap_propagate(k, stream, config["camera"]) for k in keyframes), default=0.0)
    print(f"reading: the bias-walk information departs from Propagate's by {walk!r} "
          f"(relative, largest of {len(keyframes)} keyframes; not compared)", file=sys.stderr)
    rows = [pose_numbers(c, config, sp, stream) for c, sp in pose_calls]
    for k in POSE_NUMBERS:
        got[k] = max((r[k] for r in rows), default=float("inf"))
    got["vlba_stuck"] = stuck(all_local_ba)
    rows = [local_ba_numbers(c, config, sp, stream) for c, sp in local_ba]
    for k in LBA_NUMBERS:
        got[k] = float(np.median([r[k] for r in rows])) if rows else float("inf")
        print(f"reading {k} = {got[k]!r}, worst call "
              f"{max((r[k] for r in rows), default=float('inf'))!r} of {len(rows)}",
              file=sys.stderr)
    if init_call is not None:
        got.update(init_numbers(init_call, stream, init_span, config["camera"]))
    else:
        got.update(init_gravity_gap=float("inf"), init_bg_gap=float("inf"), bg_err=float("inf"))
    print(f"reading: {len(pose_calls)} tracking solves, {len(local_ba)} VI local BAs, "
          f"{len(keyframes)} keyframes' preintegrations compared", file=sys.stderr)
    limits = dict(limits, ate_m=config["trajectory_gate_m"])
    names = ["kp_unpaired", "desc_gap", "line_unpaired", "stereo_unpaired", "ate_m",
             "untracked_frames", "vi_frames_missed", "preint_gap", *POSE_NUMBERS, "vlba_stuck",
             *LBA_NUMBERS,
             "init_gravity_gap", "init_bg_gap", "bg_err"]
    return [Check(name, got[name], limits[name]) for name in names]
